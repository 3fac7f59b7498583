"""ctypes bindings for the repo's native data library
(port of dgps_with_iwvi_tpu/data/native_loader.py).

Binds ``native/libdgpdata.so`` (``native/src/dgp_data.cpp``) in place:
delimited-text parsing for year-scale files, the fused standardization
pass and kmeans++ inducing-point initialization. The library is built with
``make -C native`` at first use; where it cannot be built, the numpy
parser, the numpy standardization and scipy's ``kmeans2`` take over.
The ABI is plain C, consumed via ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdgpdata.so")

_i64 = ctypes.c_int64
_u64 = ctypes.c_uint64
_pd = ctypes.POINTER(ctypes.c_double)
_pi = ctypes.POINTER(_i64)


@lru_cache(maxsize=1)
def load_library(build: bool = True):
    """dlopen the native library, building it on first use. None if it
    cannot be built or loaded (a half-written or foreign ``.so``): callers
    fall back to numpy, and ``build_model`` to Lloyd's."""
    if not os.path.exists(_LIB_PATH) and build:
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.dgp_parse_table.restype = ctypes.c_int
    lib.dgp_parse_table.argtypes = [ctypes.c_char_p, ctypes.POINTER(_pd),
                                    _pi, _pi]
    lib.dgp_free.argtypes = [ctypes.c_void_p]
    lib.dgp_standardize.argtypes = [_pd, _i64, _i64, _i64, _pd, _pd,
                                    ctypes.c_double]
    lib.dgp_kmeans.argtypes = [_pd, _i64, _i64, _i64, _i64, _u64, _pd]
    return lib


def native_available() -> bool:
    return load_library() is not None


def _parse_table_numpy(path: str) -> np.ndarray:
    """Pure-python fallback matching dgp_parse_table semantics: any of
    ',;\\t ' delimits, '#'/blank lines skipped, leading header lines (the
    UCI wine/protein/kin8nm CSVs) skipped until the first numeric row."""
    rows: list[list[float]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.replace(",", " ").replace(";", " ").split()
            try:
                vals = [float(t) for t in toks]
            except ValueError:
                if not rows:  # header line before any data
                    continue
                raise
            rows.append(vals)
    if not rows:
        raise ValueError(
            f"{path}: no numeric rows parsed (empty file, or every line was "
            "non-numeric/comment — is this the right file format?)")
    if any(len(r) != len(rows[0]) for r in rows):
        raise ValueError(f"{path}: ragged rows")
    return np.asarray(rows, np.float64).reshape(len(rows), -1)


def parse_table(path: str) -> np.ndarray:
    """Parse a delimited numeric text file -> [n, d] float64 array."""
    lib = load_library()
    if lib is None:
        return _parse_table_numpy(path)
    out = _pd()
    rows, cols = _i64(), _i64()
    rc = lib.dgp_parse_table(path.encode(), ctypes.byref(out),
                             ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise ValueError(f"dgp_parse_table({path!r}) failed with code {rc}")
    n, d = rows.value, cols.value
    try:
        arr = np.ctypeslib.as_array(out, shape=(n, d)).copy()
    finally:
        lib.dgp_free(out)
    return arr


def standardize(X: np.ndarray, n_train: int, eps: float = 1e-10):
    """In-place-equivalent standardization by the first n_train rows' stats.

    Returns (X_standardized, mean, std) — std floored to 1 where <= eps,
    matching datasets.get_regression_data conventions.
    """
    X = np.ascontiguousarray(X, np.float64).copy()
    n, d = X.shape
    lib = load_library()
    if lib is None:
        mean = X[:n_train].mean(0)
        std = X[:n_train].std(0)
        std = np.where(std <= eps, 1.0, std)
        return (X - mean) / std, mean, std
    mean = np.empty(d)
    std = np.empty(d)
    lib.dgp_standardize(X.ctypes.data_as(_pd), n, d, n_train,
                        mean.ctypes.data_as(_pd), std.ctypes.data_as(_pd),
                        eps)
    return X, mean, std


def kmeans(X: np.ndarray, k: int, iters: int = 20, seed: int = 0) -> np.ndarray:
    """kmeans++ / Lloyd inducing-point init on the host: [k, d]."""
    X = np.ascontiguousarray(X, np.float64)
    n, d = X.shape
    lib = load_library()
    if lib is None:
        from scipy.cluster.vq import kmeans2

        centers, _ = kmeans2(X, k, iter=iters, minit="++", seed=seed)
        return centers
    centers = np.empty((k, d))
    lib.dgp_kmeans(X.ctypes.data_as(_pd), n, d, k, iters, seed,
                   centers.ctypes.data_as(_pd))
    return centers
