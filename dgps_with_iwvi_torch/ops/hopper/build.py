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
``variant_launches``. A wrapper also hands over its call's work
(``cost.Work``: bytes and operations from its shapes), summed per
kernel and variant by ``launch_costs`` with each launch's bound
(``cost.bound``): launches run one after another, so the bound of a
window is the sum of its launches' bounds, not the bound of their summed
work. While a CUDA graph captures
(``capturing``), a launch and its work are recorded into the graph's
tally instead, since a capture runs nothing; ``replayed`` adds the tally
once per replay of the graph. All of this is host arithmetic at a launch
or a capture; a replay adds a tally and nothing else.
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

from . import cost

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

KERNELS = ("chol_inv", "epilogue", "epilogue_bwd", "serve_cond", "conditional")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_launches = {name: 0 for name in KERNELS}
_variant_launches: dict = {}
# {"<kernel>" or "<kernel>:<variant>": [launches, bytes, bf16 ops, f32 ops,
# bound ms, the part of it of launches bound by operations]} of the
# launches that handed their work over
COST_FIELDS = ("launches", "bytes", "bf16_ops", "f32_ops", "bound_ms",
               "ops_bound_ms")
_costs: dict = {}
# tallies of the CUDA graphs being captured, innermost last; a list that
# every thread sees, since autograd's device thread launches the backward
_captures: list = []

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


def plain_requested() -> bool:
    """Whether the caller is inside `plain_versions()`."""
    return _plain_requested


def use_plain(t) -> bool:
    """Whether a wrapper given tensor `t` takes its plain version: for a
    CPU tensor, or inside `plain_versions()`."""
    return t.device.type == "cpu" or _plain_requested


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0
    _variant_launches.clear()
    _costs.clear()


def launches() -> dict:
    """{kernel: launches since the last reset_launches()}."""
    return dict(_launches)


def variant_launches() -> dict:
    """{"<kernel>:<variant>": launches since the last reset_launches()}."""
    return dict(_variant_launches)


def launch_costs() -> dict:
    """{"<kernel>" or "<kernel>:<variant>": {"launches", "bytes",
    "bf16_ops", "f32_ops", "bound_ms", "ops_bound_ms"}} summed over the
    launches since the last reset_launches() that handed over their work
    (``cost.Work``): each launch adds its work, its bound (``cost.bound``)
    and, where operations bound it, that bound again."""
    return {key: dict(zip(COST_FIELDS, v)) for key, v in _costs.items()}


def count_launch(name: str, variant: str | None = None, work=None) -> None:
    """Count one launch of kernel `name` (and of its `variant`), with the
    call's work (``cost.Work``) where given."""
    keys = [name] if variant is None else [name, f"{name}:{variant}"]
    if work is not None:
        ms, by = cost.bound(*work)
        work = (1, *work, ms, ms if by == "operations" else 0.0)
    if _captures:
        tally = _captures[-1]
        for key in keys:
            tally[key] = tally.get(key, 0) + 1
        if work is not None:
            _add_work(tally.costs, keys[-1], work)
        return
    _add({key: 1 for key in keys})
    if work is not None:
        _add_work(_costs, keys[-1], work)


def _add_work(costs: dict, key: str, values) -> None:
    acc = costs.setdefault(key, [0] + [0.0] * (len(COST_FIELDS) - 1))
    for i, v in enumerate(values):
        acc[i] += v


def _add(tally: dict) -> None:
    for key, n in tally.items():
        if ":" in key:
            _variant_launches[key] = _variant_launches.get(key, 0) + n
        else:
            _launches[key] += n


class Tally(dict):
    """A capture's launches {kernel or "<kernel>:<variant>": launches},
    with their work in ``costs`` (keyed as ``launch_costs``)."""

    def __init__(self):
        super().__init__()
        self.costs: dict = {}


@contextlib.contextmanager
def capturing():
    """Inside this block (a CUDA graph's capture) a launch is recorded,
    not counted: yields the ``Tally``, which ``replayed`` adds once per
    replay."""
    tally = Tally()
    _captures.append(tally)
    try:
        yield tally
    finally:
        # by identity: two tallies may hold equal counts
        del _captures[next(i for i, t in enumerate(_captures)
                           if t is tally)]


def replayed(tally: Tally) -> None:
    """Count the launches, and their work, of one replay of a graph whose
    capture recorded `tally`."""
    _add(tally)
    for key, values in tally.costs.items():
        _add_work(_costs, key, values)


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
