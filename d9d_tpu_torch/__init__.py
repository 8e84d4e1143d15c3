"""PyTorch/CUDA port of ``d9d_tpu`` for NVIDIA Hopper: its serving path and
its single-device training path so far.

The directory layout mirrors ``d9d_tpu`` so every module has a findable
counterpart (``ops/rope.py``, ``nn/attention.py``, ``loop/generate.py``,
``loop/train.py``…). Nothing here imports ``jax`` or the JAX package; the
kernels the JAX package wrote in Pallas for these paths (flash forward,
flash backward, flash decode) are hand-written CUDA C++ under ``csrc/``,
compiled with ``nvcc`` at first use.

Dispatch rule, everywhere: a tensor that lies on the CPU takes the plain
PyTorch version of a kernel; a CUDA tensor launches the kernel or raises.
There is no environment switch and no silent fallback. Entry points default
to ``torch.device("cuda")`` and raise when there is no card; pass
``device="cpu"`` explicitly (as the CPU tests do).
"""

__version__ = "0.1.0"
