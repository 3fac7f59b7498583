"""The port's IW-vs-VI experiment (``experiments/iw_vs_vi.py``) against the
reference's ``benchmarks/iw_vs_vi.py``, on the CPU.

The reference's functions are taken from its source with ``ast`` and run
in a namespace of their own: importing the script would set JAX's
configuration and a compile-cache directory. Its data generator must give
the same bits; its ``iw_diagnostics`` the same ESS in float64 (rtol 1e-9)
on the same parameters, carried across with ``params_from_numpy``, and
its own draws injected: layer i's noise is ``normal(fold_in(key, i))``,
[K, B, d] for a latent or inner GP layer, none for the final layer.
Then ``run_one`` and ``main`` at a small size.

The claim itself (IW beats VI on bimodal LG, over seeds 0-3) is pinned on
the card, in phase 14 of ``chip_smoke.py``, not here: one run at the
reference's pin size (N=256, M=16, 1500 steps) takes 18-19 s on the CPU,
so the eight runs would take most of this suite's headroom.
"""

import ast
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.experiments import iw_vs_vi as ivv
from dgps_with_iwvi_torch.models import BuildArgs, LVLayerConfig, build_config
from dgps_with_iwvi_tpu.models import BuildArgs as JBuildArgs
from dgps_with_iwvi_tpu.models import build_model as jbuild_model
from torch_threads import one_thread  # noqa: F401  (autouse)

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "iw_vs_vi.py")
# the reference's 14 runs in its order (l.151-164)
TAGS = [f"{d}/{c}-{m}" for d in ("bimodal", "unimodal")
        for c in ("LG", "LGG", "GG") for m in ("VI", "IW20")]
TAGS[6:6] = ["bimodal/LG-IW1", "bimodal/LG-IW5"]


def _reference_source():
    with open(SCRIPT) as f:
        return ast.parse(f.read())


def _reference_functions(*names) -> dict:
    """The reference's top-level functions `names`, defined in a namespace
    holding what they use (jax, jnp, np)."""
    tree = _reference_source()
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"jax": jax, "jnp": jnp, "np": np}
    exec(compile(ast.Module(body=body, type_ignores=[]), SCRIPT, "exec"), ns)
    return {n: ns[n] for n in names}


def _run_one_keys() -> set:
    """The keys of the dict the reference's run_one returns."""
    fn = next(n for n in _reference_source().body
              if isinstance(n, ast.FunctionDef) and n.name == "run_one")
    out = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "out")
    return {k.value for k in out.keys}


def _table_headers() -> list:
    """The reference's table header and rule lines (``_write_md``): its
    whole-line string constants that open and close with '|'."""
    fn = next(n for n in _reference_source().body
              if isinstance(n, ast.FunctionDef) and n.name == "_write_md")
    return [n.value for n in ast.walk(fn) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and len(n.value) > 2
            and n.value[0] == n.value[-1] == "|"]


def test_flags_default_to_the_reference():
    """The reference's defaults and --quick sizes; --device and --seed
    added, the output in the working directory."""
    fn = next(n for n in _reference_source().body
              if isinstance(n, ast.FunctionDef) and n.name == "main")
    ref = {c.args[0].value: ast.literal_eval(k.value)
           for c in ast.walk(fn) if isinstance(c, ast.Call)
           and getattr(c.func, "attr", None) == "add_argument"
           for k in c.keywords if k.arg == "default"
           and c.args[0].value != "--out"}
    a = ivv.parse_args([])
    assert {f"--{k}": getattr(a, k) for k in ("iterations", "n_train",
                                               "n_test", "M")} == ref
    assert (a.out, a.device, a.seed, a.quick) == ("IW_VS_VI", "cuda", 0,
                                                  False)
    q = ivv.parse_args(["--quick", "--iterations", "9"])
    assert (q.iterations, q.n_train, q.n_test, q.M) == (500, 256, 256, 16)


@pytest.mark.parametrize("bimodal", [True, False])
def test_data_is_the_reference_bits(bimodal):
    ref = _reference_functions("make_data", "standardized")
    for a, b in zip(ivv.make_data(300, 3, bimodal),
                    ref["make_data"](300, 3, bimodal), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(ivv.standardized(200, 100, 0, bimodal),
                    ref["standardized"](200, 100, 0, bimodal), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _reference_draws(config, key, K, B) -> list:
    """The reference's per-layer noise of one propagate over B rows."""
    eps = []
    for i, c in enumerate(config.layers):
        if getattr(c, "final", False):
            eps.append(None)
            continue
        d = c.d_w if isinstance(c, LVLayerConfig) else c.d_out
        eps.append(torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, i), (K, B, d), jnp.float64))))
    return eps


@pytest.mark.parametrize("conf", ["LG", "LGG"])
def test_iw_diagnostics_matches_the_reference(conf):
    ref = _reference_functions("iw_diagnostics")["iw_diagnostics"]
    X, Y, _, _, _ = ivv.standardized(96, 8, 0, True)
    X, Y = X.astype(np.float64), Y.astype(np.float64)
    args = dict(configuration=conf, mode="IW", num_inducing=12,
                num_iw_samples=5)
    jconfig, jparams = jbuild_model(jax.random.PRNGKey(4), JBuildArgs(**args),
                                    jnp.asarray(X), jnp.asarray(Y))
    jparams = jax.device_get(jparams)
    # a posterior away from the prior: the weights are not uniform
    rng = np.random.default_rng(1)
    for lp in jparams["layers"]:
        if "q_mu" in lp:
            lp["q_mu"] = 0.5 * rng.standard_normal(lp["q_mu"].shape)
    key = jax.random.PRNGKey(9)
    want = ref(jparams, jconfig, jnp.asarray(X[:64]), jnp.asarray(Y[:64]),
               key, K=20)
    config = build_config(BuildArgs(**args), 1, 1, X.shape[0])
    params = tparams.params_from_numpy(jparams, "cpu")
    got = ivv.iw_diagnostics(params, config, torch.from_numpy(X[:64]),
                             torch.from_numpy(Y[:64]), K=20,
                             eps=_reference_draws(config, key, 20, 64))
    assert 1.0 < want < 20.0
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_run_one_returns_every_reference_key():
    data = ivv.standardized(64, 48, 0, True)
    out = ivv.run_one("bimodal/LGG-IW20", "LGG", "IW", 20, data,
                      iterations=20, M=8, device="cpu")
    assert _run_one_keys() | {"steps_per_s"} == set(out)
    assert (out["tag"], out["configuration"], out["mode"], out["K"]) == (
        "bimodal/LGG-IW20", "LGG", "IW", 20)
    assert all(math.isfinite(out[k]) for k in (
        "test_loglik", "test_rmse", "elbo_vi", "bound_iw20", "ess20",
        "train_s", "steps_per_s"))
    assert 1.0 <= out["ess20"] <= 20.0
    # the K=20 bound is at least the one-sample bound in expectation
    assert out["bound_iw20"] > out["elbo_vi"]


def test_main_writes_the_reference_runs_and_tables(tmp_path, monkeypatch):
    seen = []
    run_one = ivv.run_one

    def spy(tag, *a, **kw):
        seen.append((tag, kw["device"].type, kw["M"], kw["iterations"],
                     kw["seed"]))
        return run_one(tag, *a, **kw)

    monkeypatch.setattr(ivv, "run_one", spy)
    out = str(tmp_path / "ivv")
    rec = ivv.main(["--iterations", "3", "--n_train", "40", "--n_test", "24",
                    "--M", "6", "--seed", "2", "--device", "cpu", "--out",
                    out])
    assert [s[0] for s in seen] == TAGS
    assert set(s[1:] for s in seen) == {("cpu", 6, 3, 2)}
    with open(out + ".json") as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(rec))
    assert [r["tag"] for r in saved["rows"]] == TAGS
    assert (saved["backend"], saved["n_train"], saved["n_test"], saved["M"],
            saved["iterations"], saved["seed"]) == ("cpu", 40, 24, 6, 3, 2)
    assert saved["points"] == ivv.points(saved["rows"])
    with open(out + ".md") as f:
        md = f.read()
    headers = _table_headers()
    assert len(headers) == 4
    for line in headers:
        assert line in md.splitlines(), line
    assert md.count("\n| LG |") == 1 and md.count("\n| IW") == 3
    for point in saved["points"]:
        assert f"\n{point}. " in md
    assert md.count("**holds**") + md.count("**does not hold**") == 2


@pytest.mark.parametrize("change,want", [
    ({}, {"1": True, "2": True}),
    ({"bimodal/LGG-IW20": 1.2}, {"1": False, "2": True}),
    ({"bimodal/LG-IW5": 0.3}, {"1": False, "2": True}),
    ({"bimodal/GG-VI": 1.02}, {"1": True, "2": False}),
])
def test_points_read_the_rows(change, want):
    nll = {"bimodal/LG-VI": 0.17, "bimodal/LG-IW20": 0.04,
           "bimodal/LGG-VI": 1.076, "bimodal/LGG-IW20": 0.27,
           "bimodal/GG-VI": 1.08, "bimodal/LG-IW1": 0.25,
           "bimodal/LG-IW5": 0.08}
    nll.update(change)
    rows = [{"tag": t, "test_loglik": -v} for t, v in nll.items()]
    assert ivv.points(rows) == want
    assert ivv.points(rows[:2]) == {"1": None, "2": None}
