"""dgps_with_iwvi_torch — the PyTorch/CUDA port of dgps_with_iwvi_tpu.

Deep Gaussian processes with importance-weighted variational inference on
one NVIDIA H100. The JAX package ``dgps_with_iwvi_tpu`` is the reference;
this package mirrors its layout and names (``ops/``, ``models/``,
``training/``, ``serving.py``) so each module's counterpart is easy to
find, and keeps its array layouts at the public functions (X ``[S, B,
d]``, Kuf and A ``[S, M, B]``, q_sqrt ``[D, M, M]``, q_mu ``[M, D]``).

The package imports ``torch`` and never ``jax`` or the reference package.
Every Pallas kernel of the reference that the ported paths run is a
hand-written CUDA kernel for Hopper under ``csrc/``, built with nvcc at
first use (``ops/hopper/build.py``). Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on a CPU tensor each kernel wrapper
takes its plain PyTorch version.

Ported so far: the serving path (``models.predict_y_and_log_density`` and
``serving.Scorer``) and the single-device trainer (``training``: the
objectives, natural gradients, ``make_trainer`` and ``fit``). Data, CLI,
checkpoints and the parallel trainer come in later slices (ROADMAP.md).
"""

__version__ = "0.1.0"

from . import models, ops, params, serving, training  # noqa: F401
