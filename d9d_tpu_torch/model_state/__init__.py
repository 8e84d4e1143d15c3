"""The port's model state: the mapper graph (``mapper/``), safetensors
checkpoints (``io/``) and the JAX package's weights carried across
(``from_jax.py``)."""

from d9d_tpu_torch.model_state.from_jax import load_jax_params
from d9d_tpu_torch.model_state.io import *  # noqa: F401,F403
from d9d_tpu_torch.model_state.mapper import *  # noqa: F401,F403
from d9d_tpu_torch.model_state.io import __all__ as _io_all
from d9d_tpu_torch.model_state.mapper import __all__ as _mapper_all

__all__ = ["load_jax_params", *_io_all, *_mapper_all]
