"""PyTorch/CUDA port of the ``d9d_tpu`` serving path for NVIDIA Hopper.

The directory layout mirrors ``d9d_tpu`` so every module has a findable
counterpart (``ops/rope.py``, ``nn/attention.py``, ``loop/generate.py``…).
Nothing here imports ``jax`` or the JAX package; the two kernels the JAX
package wrote in Pallas for this path (flash prefill, flash decode) are
hand-written CUDA C++ under ``csrc/``, compiled with ``nvcc`` at first use.

Dispatch rule, everywhere: a tensor that lies on the CPU takes the plain
PyTorch version of a kernel; a CUDA tensor launches the kernel or raises.
There is no environment switch and no silent fallback. Entry points default
to ``torch.device("cuda")`` and raise when there is no card; pass
``device="cpu"`` explicitly (as the CPU tests do).
"""

__version__ = "0.1.0"
