"""The port's data layer against the reference's: the same arrays, bit for
bit, from the name-seeded surrogates (every registry entry, splits 0-2,
through all three loaders), from the staged fixture tables (on the native
and the numpy parser), and through the native standardize pass; the same
refusals. Both modules are numpy only, so nothing here needs a tolerance.
"""

import os

import numpy as np
import pytest

from dgps_with_iwvi_tpu.data import datasets as jdata
from dgps_with_iwvi_tpu.data import native_loader as jnative
from dgps_with_iwvi_torch.data import datasets as tdata
from dgps_with_iwvi_torch.data import native_loader as tnative

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURE_NAMES = sorted(os.path.splitext(f)[0] for f in os.listdir(FIXTURES))
FIELDS = ("X_train", "Y_train", "X_test", "Y_test", "X_mean", "X_std",
          "Y_mean", "Y_std")
LOADERS = ("get_regression_data", "get_classification_data",
           "get_multiclass_data")


def _assert_same(port, ref):
    assert (port.name, port.split, port.synthetic) == (
        ref.name, ref.split, ref.synthetic)
    for f in FIELDS:
        a, b = np.asarray(getattr(port, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f


def _needs_native():
    if not tnative.native_available():
        pytest.skip("native library not buildable (no C++ toolchain)")


def _numpy_parser(monkeypatch):
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "load_library", lambda build=True: None)


def test_registry_and_ingest_specs_equal_the_reference():
    assert tdata.UCI_REGISTRY == jdata.UCI_REGISTRY
    assert ({k: vars(v) for k, v in tdata.UCI_INGEST.items()}
            == {k: vars(v) for k, v in jdata.UCI_INGEST.items()})
    assert tdata.NATIVE_STANDARDIZE_MIN_ELEMS == \
        jdata.NATIVE_STANDARDIZE_MIN_ELEMS


@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize("name", sorted(set(jdata.UCI_REGISTRY) - {"year"}))
def test_surrogates_equal_the_reference(name, loader, tmp_path):
    """An empty data_dir: every loader falls back to the surrogate."""
    for split in range(3):
        port = getattr(tdata, loader)(name, split, data_dir=str(tmp_path))
        ref = getattr(jdata, loader)(name, split, data_dir=str(tmp_path))
        assert port.synthetic
        _assert_same(port, ref)


def test_year_surrogate_equals_the_reference():
    """year's full 515345 x 90 table is too large for a test: the same
    generator at 2000 rows."""
    Xp, Yp = tdata._synthetic_regression("year", 2000, 90)
    Xr, Yr = jdata._synthetic_regression("year", 2000, 90)
    assert np.array_equal(Xp, Xr) and np.array_equal(Yp, Yr)


@pytest.mark.parametrize("parser", ["native", "numpy"])
@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_tables_parse_and_split_like_the_reference(name, parser,
                                                           monkeypatch):
    if parser == "native":
        _needs_native()
    else:
        _numpy_parser(monkeypatch)
    Xp, Yp, synth_p = tdata._load_raw(name, FIXTURES)
    Xr, Yr, synth_r = jdata._load_raw(name, FIXTURES)
    assert not synth_p and not synth_r
    assert np.array_equal(Xp, Xr) and np.array_equal(Yp, Yr)
    np.testing.assert_array_equal(Yp[:, 0], 1000.0 + np.arange(5))
    for split in range(2):
        _assert_same(
            tdata.get_regression_data(name, split, data_dir=FIXTURES,
                                      dtype=np.float64),
            jdata.get_regression_data(name, split, data_dir=FIXTURES,
                                      dtype=np.float64))


@pytest.mark.parametrize("name,data_dir", [("kin8nm", None),
                                           ("wine_red", FIXTURES)])
def test_native_standardize_path_equals_the_reference(name, data_dir,
                                                      monkeypatch, tmp_path):
    """The fused C++ standardize pass, taken below its size threshold."""
    _needs_native()
    for mod in (jdata, tdata):
        monkeypatch.setattr(mod, "NATIVE_STANDARDIZE_MIN_ELEMS", 0)
    data_dir = data_dir or str(tmp_path)
    for split in range(2):
        _assert_same(tdata.get_regression_data(name, split, data_dir=data_dir),
                     jdata.get_regression_data(name, split, data_dir=data_dir))


def test_column_count_refusal_on_both_sides(tmp_path):
    bad = "\n".join(",".join(str(float(j)) for j in range(9))
                    for _ in range(4))
    (tmp_path / "protein.csv").write_text(bad + "\n")
    for mod in (jdata, tdata):
        with pytest.raises(ValueError, match="Refusing to guess"):
            mod._load_raw("protein", str(tmp_path))


def test_unknown_dataset_raises_on_both_sides(tmp_path):
    for mod in (jdata, tdata):
        with pytest.raises(FileNotFoundError, match="not in the UCI"):
            mod.get_regression_data("nope", data_dir=str(tmp_path))


@pytest.mark.parametrize("backend", ["native", "scipy"])
def test_kmeans_equals_the_reference(backend, monkeypatch):
    if backend == "native":
        _needs_native()
    else:
        _numpy_parser(monkeypatch)
    X = np.random.RandomState(0).randn(300, 4)
    np.testing.assert_array_equal(tnative.kmeans(X, 16, seed=5),
                                  jnative.kmeans(X, 16, seed=5))


@pytest.fixture
def unloadable_library(tmp_path, monkeypatch):
    """The library path holds a file that dlopen refuses, as a half-written
    .so from an interrupted ``make`` would be."""
    bad = tmp_path / "libdgpdata.so"
    bad.write_bytes(b"not a shared object")
    monkeypatch.setattr(tnative, "_LIB_PATH", str(bad))
    tnative.load_library.cache_clear()
    yield
    tnative.load_library.cache_clear()


def test_an_unloadable_library_falls_back_to_numpy(unloadable_library):
    assert tnative.load_library() is None
    assert not tnative.native_available()
    path = os.path.join(FIXTURES, sorted(os.listdir(FIXTURES))[0])
    np.testing.assert_array_equal(tnative.parse_table(path),
                                  jnative._parse_table_numpy(path))
