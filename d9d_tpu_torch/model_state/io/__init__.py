from d9d_tpu_torch.model_state.io.dto import (
    MODEL_STATE_INDEX_FILE_NAME,
    ModelStateIndex,
    ModelStateIndexMeta,
)
from d9d_tpu_torch.model_state.io.module import (
    identity_mapper_from_names,
    identity_mapper_from_params,
    load_params,
    named_params,
    param_state_generator,
    save_params,
)
from d9d_tpu_torch.model_state.io.reader import read_index, read_model_state
from d9d_tpu_torch.model_state.io.writer import (
    write_model_state_distributed,
    write_model_state_local,
    write_model_state_pipeline_parallel,
)

__all__ = [
    "MODEL_STATE_INDEX_FILE_NAME",
    "ModelStateIndex",
    "ModelStateIndexMeta",
    "identity_mapper_from_names",
    "identity_mapper_from_params",
    "load_params",
    "named_params",
    "param_state_generator",
    "read_index",
    "read_model_state",
    "save_params",
    "write_model_state_distributed",
    "write_model_state_local",
    "write_model_state_pipeline_parallel",
]
