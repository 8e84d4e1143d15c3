from d9d_tpu_torch.model_state.mapper.abc import (
    ModelStateMapper,
    StateDict,
    StateGroup,
)
from d9d_tpu_torch.model_state.mapper.compose import (
    ModelStateMapperParallel,
    ModelStateMapperPrefixScope,
    ModelStateMapperSequential,
    ModelStateMapperShard,
    filter_empty_mappers,
)
from d9d_tpu_torch.model_state.mapper.leaf import (
    ModelStateMapperCast,
    ModelStateMapperChunkTensors,
    ModelStateMapperConcatenateTensors,
    ModelStateMapperIdentity,
    ModelStateMapperRename,
    ModelStateMapperSelectChildModules,
    ModelStateMapperSqueeze,
    ModelStateMapperStackTensors,
    ModelStateMapperTranspose,
    ModelStateMapperUnsqueeze,
    ModelStateMapperUnstackTensors,
)

__all__ = [
    "ModelStateMapper",
    "ModelStateMapperCast",
    "ModelStateMapperChunkTensors",
    "ModelStateMapperConcatenateTensors",
    "ModelStateMapperIdentity",
    "ModelStateMapperParallel",
    "ModelStateMapperPrefixScope",
    "ModelStateMapperRename",
    "ModelStateMapperSelectChildModules",
    "ModelStateMapperSequential",
    "ModelStateMapperShard",
    "ModelStateMapperSqueeze",
    "ModelStateMapperStackTensors",
    "ModelStateMapperTranspose",
    "ModelStateMapperUnsqueeze",
    "ModelStateMapperUnstackTensors",
    "StateDict",
    "StateGroup",
    "filter_empty_mappers",
]
