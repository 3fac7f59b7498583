"""Randomized parity: seeded random configurations through the port and
the JAX reference, in float64 on the CPU.

The generator is ``tests/test_fuzz_configs.py``'s ``_random_config``
widened to the port's breadth: seven kernel kinds (rbf, matern12/32/52,
rq, linear and an ``rbf+linear`` composite), every likelihood family of
``ops/likelihoods.py``, multiscale features, ``white=False``, q_diag,
non-amortized latent layers, and VI with S=3 or IW with K=4. q_diag is
never drawn with ``white=False``, which both packages refuse.

Each configuration is built in both packages from the reference's
``init_dgp`` parameters (carried across with ``params.params_from_numpy``,
with a random q(u) so the whitened terms do not cancel), and the
reference's per-layer normals are injected into the port. Held at
rtol 1e-6: ``elbo``, the gradient of every parameter, and
``predict_y_and_log_density``. The atol is tied to each array's scale,
1e-8 of its largest magnitude: matern12's kink at zero distance leaves
gradient entries that cancel to ~1e-9 of their neighbours, where the two
packages' sums of the same terms in another order differ in the last
bits.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgps_with_iwvi_tpu.models import dgp as jdgp
from dgps_with_iwvi_tpu.models import layers as jlayers
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.models import dgp as tdgp
from dgps_with_iwvi_torch.models import layers as tlayers

SEEDS = list(range(10))
RTOL, ATOL_SCALE = 1e-6, 1e-8
S_VI, K_IW = 3, 4

KERNELS = ["rbf", "matern12", "matern32", "matern52", "rq", "linear",
           "rbf+linear"]
LIKELIHOODS = ["gaussian", "switched_gaussian", "bernoulli", "student_t",
               "poisson", "exponential", "gamma", "beta", "multiclass",
               "ordinal", "softmax"]
N_CLASSES, N_TASKS = 3, 2


def _random_config(seed: int) -> dict:
    """Seed's configuration as plain fields, built into either package by
    ``_build``. The likelihood and the final layer's kernel cycle with the
    seed, so that ten seeds reach every family and kind; the rest is
    drawn."""
    rng = random.Random(seed)
    likelihood = LIKELIHOODS[seed % len(LIKELIHOODS)]
    d_x = rng.choice([1, 3, 7])
    if likelihood in ("multiclass", "softmax", "ordinal"):
        d_y = 1
        d_out = N_CLASSES if likelihood != "ordinal" else 1
    elif likelihood == "switched_gaussian":
        d_y, d_out = 2, 1          # the target, then the task index
    else:
        d_y = rng.choice([1, 2])
        d_out = d_y
    n = rng.choice([17, 33])
    n_layers = rng.randint(1, 4)
    q_diag = rng.random() < 0.3
    white = q_diag or rng.random() < 0.7

    def gp(d_in, d_out, final):
        kind = KERNELS[seed % len(KERNELS)] if final else rng.choice(KERNELS)
        return dict(kind="gp", d_in=d_in, d_out=d_out,
                    num_inducing=rng.choice([3, 6]), kernel_kind=kind,
                    white=white, q_diag=q_diag, final=final,
                    feature=("multiscale" if kind == "rbf"
                             and rng.random() < 0.5 else "points"),
                    mean_function=(rng.choice(["skip", "zero", "auto"])
                                   if final else "auto"))

    layers, width = [], d_x
    for _ in range(n_layers - 1):
        if rng.random() < 0.4:
            d_w = rng.choice([1, 2])
            amortized = rng.random() < 0.7
            layers.append(dict(kind="lv", d_w=d_w, d_in=width, d_y=d_y,
                               d_x=d_x, amortized=amortized,
                               num_data=0 if amortized else n))
            width += d_w
        else:
            w = rng.choice([2, 5])
            layers.append(gp(width, w, False))
            width = w
    layers.append(gp(width, d_out, True))
    return dict(layers=layers, n=n, d_x=d_x, d_y=d_y, likelihood=likelihood,
                objective=rng.choice(["vi", "iw"]))


def _build(mod, spec: dict):
    """The spec's DGPConfig in one package (`mod`: its models.layers)."""
    from importlib import import_module

    dgp = import_module(mod.__name__.rsplit(".", 1)[0] + ".dgp")
    layers = []
    for lay in spec["layers"]:
        kw = {k: v for k, v in lay.items() if k != "kind"}
        layers.append(mod.GPLayerConfig(**kw) if lay["kind"] == "gp"
                      else mod.LVLayerConfig(**kw))
    return dgp.DGPConfig(layers=tuple(layers), num_data=spec["n"],
                         objective=spec["objective"], num_samples=S_VI,
                         num_iw_samples=K_IW, likelihood=spec["likelihood"])


def _likelihood_kwargs(kind: str):
    return {"switched_gaussian": {"num_tasks": N_TASKS},
            "ordinal": {"num_classes": N_CLASSES}}.get(kind)


def _data(spec: dict, rng: np.random.Generator):
    n, d_x, d_y, kind = spec["n"], spec["d_x"], spec["d_y"], spec["likelihood"]
    X = rng.standard_normal((n, d_x))
    f = np.sin(X.sum(-1, keepdims=True))
    if kind in ("gaussian", "student_t"):
        Y = f + 0.1 * rng.standard_normal((n, d_y))
    elif kind == "switched_gaussian":
        Y = np.concatenate([f, rng.integers(0, N_TASKS, (n, 1))], 1)
    elif kind == "bernoulli":
        Y = (f + 0.3 * rng.standard_normal((n, d_y)) > 0).astype(float)
    elif kind == "poisson":
        Y = rng.poisson(np.exp(f), (n, d_y)).astype(float)
    elif kind in ("exponential", "gamma"):
        Y = np.exp(f) * rng.exponential(1.0, (n, d_y))
    elif kind == "beta":
        Y = np.clip(1.0 / (1.0 + np.exp(-f - 0.3 * rng.standard_normal(
            (n, d_y)))), 0.02, 0.98)
    else:  # class labels in one column
        Y = np.digitize(f, np.quantile(f, [1 / 3, 2 / 3])).astype(float)
    return X, Y


def _randomize(params, rng: np.random.Generator):
    """A random q(u) on every GP layer, multiscale windows off their
    initial width, and random per-point latents."""
    for lp in params["layers"]:
        if "q_mu_w" in lp:
            lp["q_mu_w"] = 0.5 * rng.standard_normal(lp["q_mu_w"].shape)
        if "q_mu" not in lp:
            continue
        lp["q_mu"] = 0.5 * rng.standard_normal(lp["q_mu"].shape)
        q = lp["q_sqrt"]
        if q.ndim == 3:
            lp["q_sqrt"] = (np.tril(0.2 * rng.standard_normal(q.shape))
                            + 0.5 * np.eye(q.shape[-1]))
        else:
            lp["q_sqrt"] = 0.5 + 0.1 * rng.standard_normal(q.shape)
        if "raw_Z_scales" in lp:
            lp["raw_Z_scales"] = lp["raw_Z_scales"] + 0.3 * \
                rng.standard_normal(lp["raw_Z_scales"].shape)


def _layer_noise(key, jconfig, lead: int, B: int) -> list:
    """The reference's per-layer normals of a propagate keyed by `key`:
    a latent layer's [lead, B, d_w], an inner GP layer's [lead, B, d_out]."""
    eps = []
    for i, cfg in enumerate(jconfig.layers):
        if isinstance(cfg, jlayers.GPLayerConfig) and cfg.final:
            eps.append(None)
            continue
        width = (cfg.d_w if isinstance(cfg, jlayers.LVLayerConfig)
                 else cfg.d_out)
        eps.append(torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, i), (lead, B, width), jnp.float64))))
    return eps


def _close(got, ref, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    atol = ATOL_SCALE * float(np.max(np.abs(ref), initial=0.0))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL, atol=atol,
                               err_msg=what)


def model(seed: int):
    """(spec, jconfig, jparams as numpy, config, params, X, Y) of seed."""
    spec = _random_config(seed)
    rng = np.random.default_rng(seed)
    X, Y = _data(spec, rng)
    jconfig, config = _build(jlayers, spec), _build(tlayers, spec)
    jparams = jax.device_get(jax.jit(lambda k: jdgp.init_dgp(
        k, jconfig, dtype=jnp.float64,
        likelihood_kwargs=_likelihood_kwargs(spec["likelihood"])))(
        jax.random.PRNGKey(seed)))
    _randomize(jparams, rng)
    params = tparams.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float64), jparams), "cpu")
    return spec, jconfig, jparams, config, params, X, Y


@pytest.mark.parametrize("seed", SEEDS)
def test_random_config_matches_reference(seed):
    spec, jconfig, jparams, config, params, X, Y = model(seed)
    n = spec["n"]
    lead = S_VI if spec["objective"] == "vi" else K_IW
    key = jax.random.PRNGKey(100 + seed)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    idx = jnp.arange(n)

    jval, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jdgp.elbo(p, jconfig, Xj, Yj, key, data_idx=idx)))(
        jax.tree.map(jnp.asarray, jparams))

    leaves = []

    def track(t):
        if isinstance(t, dict):
            return {k: track(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(track(v) for v in t)
        t = t.detach().clone().requires_grad_(t.is_floating_point())
        leaves.append(t)
        return t

    tparams_g = track(params)
    val = tdgp.elbo(tparams_g, config, torch.from_numpy(X),
                    torch.from_numpy(Y), None,
                    eps=_layer_noise(key, jconfig, lead, n),
                    data_idx=torch.arange(n))
    _close(val, jval, f"elbo, {spec}")
    grads = torch.autograd.grad(val, [t for t in leaves if t.requires_grad],
                                allow_unused=True)
    it = iter(grads)
    got = [next(it) if t.requires_grad else None for t in leaves]
    ref = jax.tree.leaves(jax.device_get(jgrads))
    assert len(got) == len(ref)
    for k, (g, r) in enumerate(zip(got, ref)):
        _close(np.zeros(np.shape(r)) if g is None else g, r,
               f"gradient leaf {k}, {spec}")

    pkey = jax.random.PRNGKey(200 + seed)
    (jm, jv), jld = jax.jit(lambda p: jdgp.predict_y_and_log_density(
        p, jconfig, Xj, Yj, pkey, S_VI))(jax.tree.map(jnp.asarray, jparams))
    with torch.no_grad():
        (m, v), ld = tdgp.predict_y_and_log_density(
            params, config, torch.from_numpy(X), torch.from_numpy(Y), None,
            S_VI, eps=_layer_noise(pkey, jconfig, S_VI, n))
    _close(m, jm, f"predictive mean, {spec}")
    _close(v, jv, f"predictive variance, {spec}")
    _close(ld, jld, f"log density, {spec}")
