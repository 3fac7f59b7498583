"""Hand-written Hopper kernels: one module per kernel, each with its plain
PyTorch version beside it, plus the nvcc/ctypes build (``build.py``).

On a CPU tensor a wrapper takes the plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from . import build, chol, conditional, qvar, serve_cond  # noqa: F401
