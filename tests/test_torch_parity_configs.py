"""Training parity of the port against the JAX reference beyond the
flagship configuration, on the CPU in float64.

Each case builds one model configuration with the reference's builder,
sets a random q(u) from a numpy seed, and runs ten steps of the
reference's jitted trainer and of the port's trainer from the same
parameters. The reference's own draws are injected into the port: the
minibatch rows ``randint(kb, (B,), 0, N)`` and the noise
``normal(fold_in(ke, i), ...)`` of layer i, with ``kb1, kb2, ke1, ke2 =
split(key, 4)`` as its ``step_fn`` splits them (the alternating schedule
takes both pairs). Loss and every state leaf are held at rtol 1e-8,
atol 1e-12, the limits of the fifty-step flagship test in
``tests/test_torch_training.py``: float64 runs every precision class
exactly on both sides, and ten steps of Adam and natural gradients
compound only the last digits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgps_with_iwvi_tpu.models import BuildArgs as JBuildArgs
from dgps_with_iwvi_tpu.models import build_model as jbuild_model
from dgps_with_iwvi_tpu.models import layers as jlayers
from dgps_with_iwvi_tpu.training import TrainConfig as JTrainConfig
from dgps_with_iwvi_tpu.training import make_trainer as jmake_trainer
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.models import BuildArgs, build_config
from dgps_with_iwvi_torch.training import TrainConfig, make_trainer

N, B, D_X, M, K = 64, 32, 3, 16, 4
STEPS = 10
RTOL, ATOL = 1e-8, 1e-12

# (id, build arguments, natgrad, schedule)
CASES = [
    ("LGG-natgrad-all", dict(configuration="LGG"), "all", "joint"),
    ("GLG-natgrad-all", dict(configuration="GLG"), "all", "joint"),
    ("GGG-natgrad-final", dict(configuration="GGG"), "final", "joint"),
    ("LLGG-natgrad-final", dict(configuration="LLGG"), "final", "joint"),
    ("GG-q_diag-natgrad-all", dict(configuration="GG", q_diag=True), "all",
     "joint"),
    ("LGG-q_diag-natgrad-final", dict(configuration="LGG", q_diag=True),
     "final", "joint"),
    ("LGG-mean-linear", dict(configuration="LGG", mean_function="linear"),
     "final", "joint"),
    ("GG-mean-constant", dict(configuration="GG", mean_function="constant"),
     "final", "joint"),
    ("LGG-non-amortized", dict(configuration="LGG", amortized=False),
     "final", "joint"),
    ("LGG-alternating", dict(configuration="LGG"), "final", "alternating"),
    ("GG-q_diag-alternating", dict(configuration="GG", q_diag=True), "final",
     "alternating"),
]


def _data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D_X))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    return X, Y, rng


def _randomize_q(params, rng):
    """A random q(u) on every GP layer: the whitened terms cancel at the
    builder's initialization, so only a random q(u) exercises them."""
    for lp in params["layers"]:
        if "q_mu" not in lp:
            continue
        lp["q_mu"] = 0.5 * rng.standard_normal(lp["q_mu"].shape)
        q = lp["q_sqrt"]
        if q.ndim == 3:
            lp["q_sqrt"] = (np.tril(0.2 * rng.standard_normal(q.shape))
                            + 0.5 * np.eye(q.shape[-1]))
        else:  # q_diag: the square roots of the diagonal
            lp["q_sqrt"] = 0.5 + 0.1 * rng.standard_normal(q.shape)


def _draws(key, jconfig, batch):
    """(idx, eps) of the reference's step_fn for one key, for both halves
    of the alternating schedule: per layer, the noise of a latent layer
    [K, B, d_w], of an inner GP layer [K, B, d_out], none for the final."""
    kb1, kb2, ke1, ke2 = jax.random.split(key, 4)
    out = []
    for kb, ke in ((kb1, ke1), (kb2, ke2)):
        idx = (np.arange(N) if batch >= N else
               np.asarray(jax.random.randint(kb, (batch,), 0, N)))
        b = min(batch, N)
        eps = []
        for i, cfg in enumerate(jconfig.layers):
            if isinstance(cfg, jlayers.LVLayerConfig):
                width = cfg.d_w
            elif cfg.final:
                eps.append(None)
                continue
            else:
                width = cfg.d_out
            e = jax.random.normal(jax.random.fold_in(ke, i), (K, b, width),
                                  jnp.float64)
            eps.append(torch.from_numpy(np.array(e)))
        out.append((torch.from_numpy(np.array(idx)), eps))
    return out


def _state_close(state, jstate):
    ours = tparams.state_to_numpy(state)
    ref = jax.device_get({"rest": jstate.rest, "natvars": jstate.natvars})
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for t, j in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("build_kw,natgrad,schedule",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_ten_steps_track_reference(build_kw, natgrad, schedule):
    X, Y, rng = _data()
    args = dict(mode="IW", num_inducing=M, num_iw_samples=K, **build_kw)
    jconfig, jparams = jbuild_model(jax.random.PRNGKey(0),
                                    JBuildArgs(**args), jnp.asarray(X),
                                    jnp.asarray(Y))
    jparams = jax.device_get(jparams)
    _randomize_q(jparams, rng)
    tc_kw = dict(lr=5e-3, gamma=1e-2, natgrad=natgrad, schedule=schedule,
                 minibatch_size=B)

    jinit, jstep, _, _ = jmake_trainer(jconfig, JTrainConfig(**tc_kw))
    jstep = jax.jit(jstep)
    jstate = jinit(jax.tree.map(jnp.asarray, jparams))
    config = build_config(BuildArgs(**args), D_X, 1, N)
    params = tparams.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float64), jparams), "cpu")
    init, step, _, _ = make_trainer(config, TrainConfig(**tc_kw))
    state = init(params)

    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    for s in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(11), s)
        jstate, jloss = jstep(jstate, Xj, Yj, key)
        (i1, e1), (i2, e2) = _draws(key, jconfig, B)
        if schedule == "alternating":
            state, loss = step(state, Xt, Yt, idx=(i1, i2), eps=(e1, e2))
        else:
            state, loss = step(state, Xt, Yt, idx=i1, eps=e1)
    assert state.step == STEPS
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               rtol=RTOL, atol=0)
    _state_close(state, jstate)
