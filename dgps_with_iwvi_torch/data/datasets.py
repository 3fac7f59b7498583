"""UCI regression datasets: registry, splits, normalization
(port of dgps_with_iwvi_tpu/data/datasets.py).

The bayesian_benchmarks conventions (bb:bayesian_benchmarks/data.py): a
90/10 train/test split keyed by a split index, X and Y standardized by
the TRAIN split's mean/std, test log-likelihood reported in ORIGINAL y
units by subtracting log(sigma_y_train).

The module is numpy only and gives the reference's arrays bit for bit. It
downloads nothing; the loader resolves, in order:
  1. a pre-staged file `<data_dir>/<name>.npz` with arrays X [N, D], Y [N, 1];
  2. a raw delimited table `<data_dir>/<name>.{csv,txt,data}`, split into
     (X, Y) by the dataset's UCI_INGEST spec;
  3. a deterministic synthetic surrogate matched to the dataset's (N, D)
     metadata, a fixed random-feature nonlinear regression with
     heteroscedastic noise seeded by the dataset name, tagged by
     `Dataset.synthetic`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, Tuple

import numpy as np

# name -> (N, D) of the real UCI regression suite (bb conventions). D is the
# RAW feature count as staged; ingest may drop constant columns (naval).
UCI_REGISTRY: Dict[str, Tuple[int, int]] = {
    "boston": (506, 13),
    "concrete": (1030, 8),
    "energy": (768, 8),
    "kin8nm": (8192, 8),
    "naval": (11934, 16),
    "power": (9568, 4),
    "protein": (45730, 9),
    "wine_red": (1599, 11),
    "yacht": (308, 6),
    "year": (515345, 90),
}


@dataclasses.dataclass(frozen=True)
class IngestSpec:
    """Per-dataset raw-file conventions (bb:bayesian_benchmarks/data.py).

    The UCI files are NOT uniformly 'last column is the target': protein's
    target (RMSD) is the FIRST column, energy ships TWO targets (bb keeps
    only Y1 = heating load), naval has two trailing targets (bb keeps the
    first, compressor decay) plus constant feature columns to drop, wine_red
    is ';'-delimited with a header row, year's target is the first column.
    Loading a staged file with the generic rule would silently train on the
    wrong target, so each dataset pins its layout here and the loader
    REFUSES files whose column count doesn't match (no guessing).
    """

    expect_cols: int          # total columns in the raw table (targets incl.)
    target: str = "last"      # 'last' | 'first': where the target block sits
    n_targets: int = 1        # size of the target block
    use_target: int = 0       # which column of the block is THE target
    drop_constant: bool = False  # drop zero-variance feature columns (naval)


# bb:bayesian_benchmarks/data.py per-dataset classes, re-expressed as specs.
# Excel-shipped sets (concrete/energy/power) must be staged as CSV (values,
# with or without a header row — headers are auto-skipped).
UCI_INGEST: Dict[str, IngestSpec] = {
    "boston": IngestSpec(expect_cols=14),               # housing.data, MEDV last
    "concrete": IngestSpec(expect_cols=9),              # strength last
    "energy": IngestSpec(expect_cols=10, n_targets=2),  # Y1 heating (not Y2)
    "kin8nm": IngestSpec(expect_cols=9),                # openml csv, y last
    "naval": IngestSpec(expect_cols=18, n_targets=2,    # compressor decay;
                        drop_constant=True),            # cols 8/11 constant
    "power": IngestSpec(expect_cols=5),                 # PE last
    "protein": IngestSpec(expect_cols=10, target="first"),  # CASP.csv, RMSD
    "wine_red": IngestSpec(expect_cols=12),             # ';' + header, quality
    "yacht": IngestSpec(expect_cols=7),                 # resistance last
    "year": IngestSpec(expect_cols=91, target="first"),  # YearPredictionMSD
}


def ingest_table(name: str, table) -> tuple[np.ndarray, np.ndarray]:
    """Split a parsed raw table into (X, Y) per the dataset's IngestSpec."""
    spec = UCI_INGEST.get(name)
    if spec is None:  # unknown dataset: generic last-column rule
        return table[:, :-1], table[:, -1:]
    if table.shape[1] != spec.expect_cols:
        raise ValueError(
            f"dataset {name!r}: staged file has {table.shape[1]} columns, "
            f"expected {spec.expect_cols} "
            f"({spec.n_targets} target(s) {spec.target}). Refusing to guess "
            f"the target column — check the staged file's format.")
    if spec.target == "first":
        Y = table[:, spec.use_target:spec.use_target + 1]
        X = table[:, spec.n_targets:]
    else:
        k = table.shape[1] - spec.n_targets
        Y = table[:, k + spec.use_target:k + spec.use_target + 1]
        X = table[:, :k]
    if spec.drop_constant:
        keep = X.std(0) > 0.0
        X = X[:, keep]
    return X, Y

DEFAULT_DATA_DIR = os.environ.get(
    "DGP_DATA_DIR", os.path.join(os.path.expanduser("~"), ".dgp_data"))

# element count above which the fused C++ standardize pass takes over
# (year-scale tables; numerically identical to the numpy path — tested)
NATIVE_STANDARDIZE_MIN_ELEMS = 2_000_000


@dataclasses.dataclass
class Dataset:
    """Standardized train/test split, mirroring bb's regression data object."""

    name: str
    X_train: np.ndarray   # [Ntr, D] standardized
    Y_train: np.ndarray   # [Ntr, 1] standardized
    X_test: np.ndarray
    Y_test: np.ndarray
    X_mean: np.ndarray
    X_std: np.ndarray
    Y_mean: np.ndarray
    Y_std: np.ndarray     # needed to report metrics in original units
    split: int = 0
    synthetic: bool = False

    @property
    def N(self) -> int:
        return self.X_train.shape[0]

    @property
    def D(self) -> int:
        return self.X_train.shape[1]


def _synthetic_regression(name: str, n: int, d: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic nonlinear regression surrogate for offline runs.

    Random-feature target: y = w.cos(Omega x + b) + heteroscedastic noise,
    with all randomness seeded from the dataset name so every run
    regenerates identical data.
    """
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    n_feat = 64
    Omega = rng.randn(d, n_feat) / np.sqrt(d)
    b = rng.uniform(0, 2 * np.pi, n_feat)
    w = rng.randn(n_feat) / np.sqrt(n_feat)
    f = np.cos(X @ Omega + b) @ w
    noise_scale = 0.1 + 0.1 * (np.tanh(f) + 1.0)  # heteroscedastic
    y = f + noise_scale * rng.randn(n)
    return X.astype(np.float64), y[:, None].astype(np.float64)


def _load_raw(name: str, data_dir: str) -> tuple[np.ndarray, np.ndarray, bool]:
    path = os.path.join(data_dir, f"{name}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            X, Y = np.asarray(z["X"], np.float64), np.asarray(z["Y"], np.float64)
        if Y.ndim == 1:
            Y = Y[:, None]
        return X, Y, False
    # raw delimited text parsed by the native C++ loader
    # (native/src/dgp_data.cpp) — the fast path for year-scale files.
    # (X, Y) split follows the per-dataset UCI conventions in UCI_INGEST.
    for ext in (".csv", ".txt", ".data"):
        tpath = os.path.join(data_dir, f"{name}{ext}")
        if os.path.exists(tpath):
            from . import native_loader

            table = native_loader.parse_table(tpath)
            X, Y = ingest_table(name, table)
            return X, Y, False
    if name in UCI_REGISTRY:
        n, d = UCI_REGISTRY[name]
        X, Y = _synthetic_regression(name, n, d)
        return X, Y, True
    raise FileNotFoundError(
        f"dataset {name!r}: no pre-staged file at {path} and not in the UCI "
        f"registry ({sorted(UCI_REGISTRY)})")


def get_regression_data(
    name: str,
    split: int = 0,
    prop: float = 0.9,
    data_dir: str = DEFAULT_DATA_DIR,
    dtype=np.float32,
    max_n: int | None = None,
) -> Dataset:
    """bb.data.get_regression_data equivalent.

    Split: seeded permutation by split index; first prop*N rows train.
    Standardization by train mean/std (zero-variance dims get std 1).
    """
    X, Y, synthetic = _load_raw(name, data_dir)
    if max_n is not None and X.shape[0] > max_n:
        X, Y = X[:max_n], Y[:max_n]
    N = X.shape[0]
    # split permutation stays numpy-MT on purpose: bb keys its splits off
    # np.random (SURVEY.md §2.5), and published-number parity depends on
    # reproducing the same train/test membership per split index
    perm = np.random.RandomState(split).permutation(N)
    n_train = int(prop * N)
    tr, te = perm[:n_train], perm[n_train:]

    from . import native_loader

    if (X.size >= NATIVE_STANDARDIZE_MIN_ELEMS
            and native_loader.native_available()):
        # year-scale path: gather rows once into split order, then ONE
        # fused C++ pass computes train stats and standardizes in place
        # (native/src/dgp_data.cpp dgp_standardize), where the numpy chain
        # allocates several temporaries of the table's size
        Xs, X_mean, X_std = native_loader.standardize(X[perm], n_train)
        Ys, Y_mean, Y_std = native_loader.standardize(Y[perm], n_train)
        return Dataset(
            name=name,
            X_train=Xs[:n_train].astype(dtype),
            Y_train=Ys[:n_train].astype(dtype),
            X_test=Xs[n_train:].astype(dtype),
            Y_test=Ys[n_train:].astype(dtype),
            X_mean=X_mean, X_std=X_std, Y_mean=Y_mean, Y_std=Y_std,
            split=split, synthetic=synthetic)

    X_mean, X_std = X[tr].mean(0), X[tr].std(0)
    X_std = np.where(X_std <= 1e-10, 1.0, X_std)
    Y_mean, Y_std = Y[tr].mean(0), Y[tr].std(0)
    Y_std = np.where(Y_std <= 1e-10, 1.0, Y_std)

    std = lambda A, m, s: ((A - m) / s).astype(dtype)
    return Dataset(
        name=name,
        X_train=std(X[tr], X_mean, X_std), Y_train=std(Y[tr], Y_mean, Y_std),
        X_test=std(X[te], X_mean, X_std), Y_test=std(Y[te], Y_mean, Y_std),
        X_mean=X_mean, X_std=X_std, Y_mean=Y_mean, Y_std=Y_std,
        split=split, synthetic=synthetic)


def _label_split_dataset(name, X, Y, synthetic, split, prop, dtype) -> Dataset:
    """Shared tail of the label-preserving loaders: seeded split,
    X-standardization by train stats (with the zero-variance floor), labels
    passed through untouched (Y_mean = 0, Y_std = 1 so no un-normalization
    ever applies)."""
    N = X.shape[0]
    perm = np.random.RandomState(split).permutation(N)
    n_train = int(prop * N)
    tr, te = perm[:n_train], perm[n_train:]
    X_mean, X_std = X[tr].mean(0), X[tr].std(0)
    X_std = np.where(X_std <= 1e-10, 1.0, X_std)
    ones = np.ones(Y.shape[1])
    std = lambda A: ((A - X_mean) / X_std).astype(dtype)
    return Dataset(
        name=name,
        X_train=std(X[tr]), Y_train=Y[tr].astype(dtype),
        X_test=std(X[te]), Y_test=Y[te].astype(dtype),
        X_mean=X_mean, X_std=X_std, Y_mean=0.0 * ones, Y_std=ones,
        split=split, synthetic=synthetic)


def get_classification_data(
    name: str,
    split: int = 0,
    prop: float = 0.9,
    data_dir: str = DEFAULT_DATA_DIR,
    dtype=np.float32,
    max_n: int | None = None,
) -> Dataset:
    """Binary-classification variant (bb get_classification_data analog):
    X standardized by train stats, labels left as {0, 1}. Pre-staged files
    hold labels in Y / the last column; the synthetic surrogate thresholds
    its latent function at the median."""
    X, Y, synthetic = _load_raw(name, data_dir)
    if synthetic:
        Y = (Y > np.median(Y)).astype(np.float64)
    assert set(np.unique(Y)) <= {0.0, 1.0}, "labels must be binary {0,1}"
    if max_n is not None and X.shape[0] > max_n:
        X, Y = X[:max_n], Y[:max_n]
    return _label_split_dataset(name, X, Y, synthetic, split, prop, dtype)


def get_multiclass_data(
    name: str,
    split: int = 0,
    prop: float = 0.9,
    data_dir: str = DEFAULT_DATA_DIR,
    dtype=np.float32,
    max_n: int | None = None,
    n_classes: int = 3,
) -> Dataset:
    """C-class variant: X standardized by train stats, labels kept as one
    integer column in [0, C). Pre-staged files hold class indices in Y (the
    label set must be {0..C-1}); the synthetic surrogate bins its latent
    function into C equal-mass quantile bins, giving a class boundary
    structure a DGP can actually learn."""
    X, Y, synthetic = _load_raw(name, data_dir)
    if synthetic:
        edges = np.quantile(Y[:, 0], np.linspace(0, 1, n_classes + 1)[1:-1])
        Y = np.searchsorted(edges, Y[:, 0]).astype(np.float64)[:, None]
    assert Y.shape[1] == 1, "multiclass labels must be one integer column"
    labels = np.unique(Y)
    assert set(labels) <= set(float(c) for c in range(n_classes)), \
        f"labels {labels} must be integers in [0, {n_classes})"
    if max_n is not None and X.shape[0] > max_n:
        X, Y = X[:max_n], Y[:max_n]
    return _label_split_dataset(name, X, Y, synthetic, split, prop, dtype)
