"""Build, load and count the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process
(``-gencode arch=compute_90a,code=sm_90a -O3 -shared``) into a shared
library with a plain C interface, at first use, into ``_build/`` beside
this package's sources (listed in ``.gitignore``). The library's file name
carries a hash of its source, so an edited kernel is rebuilt and a stale
one is never loaded. Libraries are loaded with ``ctypes``.

``build_all()`` starts every nvcc at once and waits for all of them, so a
cold start costs one compile, not the sum. ``launches()`` counts, per
kernel, the launches its wrapper made: a wrapper adds one where it
launches and nowhere else, so a caller can show that a run went through
the kernel (``reset_launches`` / ``launches``). A wrapper that launches
one variant of a kernel (the epilogue with or without its mean, say) also
names the variant, counted under ``"<kernel>:<variant>"`` by
``variant_launches``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

KERNELS = ("chol_inv", "epilogue", "epilogue_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_launches = {name: 0 for name in KERNELS}
_variant_launches: dict = {}

_libs: dict = {}
_lock = threading.Lock()
_plain_requested = False


@contextlib.contextmanager
def plain_versions():
    """Inside this block every wrapper takes its plain PyTorch version,
    on the card too: the explicit request a test or the chip smoke run
    makes to compare a whole path against its kernels."""
    global _plain_requested
    saved = _plain_requested
    _plain_requested = True
    try:
        yield
    finally:
        _plain_requested = saved


def use_plain(t) -> bool:
    """Whether a wrapper given tensor `t` takes its plain version: for a
    CPU tensor, or inside `plain_versions()`."""
    return t.device.type == "cpu" or _plain_requested


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0
    _variant_launches.clear()


def launches() -> dict:
    """{kernel: launches since the last reset_launches()}."""
    return dict(_launches)


def variant_launches() -> dict:
    """{"<kernel>:<variant>": launches since the last reset_launches()}."""
    return dict(_variant_launches)


def count_launch(name: str, variant: str | None = None) -> None:
    _launches[name] += 1
    if variant is not None:
        key = f"{name}:{variant}"
        _variant_launches[key] = _variant_launches.get(key, 0) + 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the Hopper "
                       "kernels are built from csrc/ on the machine with the "
                       "card")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Popen of the nvcc that builds `name`, or None when already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for one build; returns the compiler's output (ptxas -v)."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def build_all() -> dict:
    """Build every kernel library in parallel; returns {name: nvcc log}."""
    with _lock:
        started = {name: _start(name) for name in KERNELS}
        return {name: _finish(name, s) for name, s in started.items()}


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of one kernel, built at first use.

    signatures: {function: (argtypes, restype)}, declared on first load
    (ctypes would otherwise pass every pointer as a 32-bit int)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error code; every
    library exports `<name>_error_string`."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
