"""The port's sharded trainer, evaluation and checkpoints
(``dgps_with_iwvi_torch/parallel``) on a 2x2 ('dp', 'k') mesh of four
gloo ranks on the CPU, against the port's single-device trainer and the
JAX reference's sharded trainer (the counterparts of
tests/test_parallel.py).

One world runs every case (``torch_dist_worker.suite``); the ranks get
their draws as numpy arrays and the tests compare what they return.
Everything is float64. Against the single-device port, the same draws
assembled into one global batch (rows in 'dp' order, samples in 'k'
order): loss and gradients at rtol 1e-10, ten steps at 1e-10 (the only
difference is the order of the sums across ranks). Against the reference
(its 2x2 mesh over four of the conftest's eight CPU devices, its draws
from its own sharded keys): loss and gradients at 1e-9, ten steps at rtol
1e-8 and atol 1e-12, the limits of the fifty-step flagship test in
tests/test_torch_training.py. Sharded evaluation equals unsharded at rtol
1e-12; checkpoints and resumes are bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as JP

import torch_dist_worker as W
from dgps_with_iwvi_tpu.models import BuildArgs as JBuildArgs
from dgps_with_iwvi_tpu.models import DGPConfig as JDGPConfig
from dgps_with_iwvi_tpu.models import GPLayerConfig as JGPLayerConfig
from dgps_with_iwvi_tpu.models import build_model as jbuild_model
from dgps_with_iwvi_tpu.models import init_dgp as jinit_dgp
from dgps_with_iwvi_tpu.parallel import make_mesh as jmake_mesh
from dgps_with_iwvi_tpu.parallel import \
    make_parallel_trainer as jmake_parallel_trainer
from dgps_with_iwvi_tpu.parallel import replicate as jreplicate
from dgps_with_iwvi_tpu.parallel import shard_arrays as jshard_arrays
from dgps_with_iwvi_tpu.parallel.sharding import \
    _sharded_objective as j_sharded_objective
from dgps_with_iwvi_tpu.training import TrainConfig as JTrainConfig
from dgps_with_iwvi_tpu.training.train import _merge_params, _split_params
from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.evaluation import evaluate
from dgps_with_iwvi_torch.models import (BuildArgs, DGPConfig, GPLayerConfig,
                                         LVLayerConfig, build_config)
from dgps_with_iwvi_torch.parallel import distributed
from dgps_with_iwvi_torch.parallel.sharding import global_row_ids
from dgps_with_iwvi_torch.training import (TrainConfig, loss_and_grads,
                                           make_trainer)

N_DP, N_K = 2, 2
N, D_X, M, K, B = 64, 3, 8, 4, 16
B_LOCAL, K_LOCAL = B // N_DP, K // N_K
TC = dict(lr=5e-3, gamma=1e-2, natgrad="final", minibatch_size=B)


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D_X))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((n, 1))
    return X, Y, rng


def _randomize_q(params, rng):
    """A random q(u) on every GP layer (at the builder's initialization
    the whitened terms cancel)."""
    for lp in params["layers"]:
        if "q_mu" in lp:
            lp["q_mu"] = 0.5 * rng.standard_normal(lp["q_mu"].shape)
            lp["q_sqrt"] = (np.tril(0.2 * rng.standard_normal(
                lp["q_sqrt"].shape)) + 0.5 * np.eye(lp["q_sqrt"].shape[-1]))


def _lgg(rng, X, Y, **kw):
    """(JAX config, port config, params as numpy) of LGG IW, M=8, K=4,
    from the reference's builder with a random q(u)."""
    args = dict(configuration="LGG", mode="IW", num_inducing=M,
                num_iw_samples=K, **kw)
    jconfig, jparams = jbuild_model(jax.random.PRNGKey(0), JBuildArgs(**args),
                                    jnp.asarray(X), jnp.asarray(Y))
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float64),
                           jax.device_get(jparams))
    _randomize_q(jparams, rng)
    return jconfig, build_config(BuildArgs(**args), D_X, 1, X.shape[0]), \
        jparams


def _widths(config):
    """Per layer, the width of its noise (None for the final layer)."""
    return [None if getattr(c, "final", False) else
            (c.d_w if isinstance(c, LVLayerConfig) else c.d_out)
            for c in config.layers]


def _numpy_draws(rng, config, n, lead=K_LOCAL):
    """Per-(dp, k) draws from numpy: rows of each 'dp' chunk of n rows,
    noise per rank."""
    return {"idx": [rng.integers(0, n // N_DP, B_LOCAL) for _ in range(N_DP)],
            "eps": [[[None if w is None else
                      rng.standard_normal((lead, B_LOCAL, w))
                      for w in _widths(config)] for _ in range(N_K)]
                    for _ in range(N_DP)]}


def _jax_draws(key, config, n_local):
    """The reference's sharded draws of one step key
    (parallel/sharding.py:167-183): rows randint(fold_in(kb, i_dp)), the
    noise of layer i normal(fold_in(fold_in(fold_in(ke, i_dp), i_k), i))."""
    kb, ke = jax.random.split(key)
    out = {"idx": [], "eps": []}
    for i in range(N_DP):
        out["idx"].append(np.asarray(jax.random.randint(
            jax.random.fold_in(kb, i), (B_LOCAL,), 0, n_local)))
        per_k = []
        for k in range(N_K):
            kloc = jax.random.fold_in(jax.random.fold_in(ke, i), k)
            per_k.append([None if w is None else np.asarray(jax.random.normal(
                jax.random.fold_in(kloc, j), (K_LOCAL, B_LOCAL, w),
                jnp.float64)) for j, w in enumerate(_widths(config))])
        out["eps"].append(per_k)
    return out


def _global(draws, n_local, num_data):
    """One process's (idx, eps) of the same step: rows in 'dp' order as
    global row ids, samples in 'k' order."""
    idx = np.concatenate([global_row_ids(i, d, n_local, num_data)
                          for i, d in enumerate(draws["idx"])])
    eps = []
    for j, e in enumerate(draws["eps"][0][0]):
        eps.append(None if e is None else torch.from_numpy(np.concatenate(
            [np.concatenate([draws["eps"][i][k][j] for k in range(N_K)], 0)
             for i in range(N_DP)], 1)))
    return torch.from_numpy(idx), eps


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict/list of arrays (None leaves dropped)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}.{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}[{i}]").items()}
    return {} if tree is None else {prefix: np.asarray(tree)}


def _close(ours, ref, rtol, atol=0.0):
    a, b = _flat(ours), _flat(ref)
    assert set(a) <= set(b), sorted(set(a) - set(b))
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _single_steps(case, draws_list, n_local):
    """The single-device port on the same global draws: losses, state."""
    config, tc = case["config"], case["tc"]
    init, step, _, _ = make_trainer(config, tc)
    state = init(tparams.params_from_numpy(case["params"], "cpu"))
    X, Y = torch.from_numpy(case["X"]), torch.from_numpy(case["Y"])
    losses = []
    for d in draws_list:
        if tc.schedule == "alternating":
            (i1, e1), (i2, e2) = (_global(x, n_local, config.num_data)
                                  for x in d)
            state, loss = step(state, X, Y, idx=(i1, i2), eps=(e1, e2))
        else:
            idx, eps = _global(d, n_local, config.num_data)
            state, loss = step(state, X, Y, idx=idx, eps=eps)
        losses.append(float(loss))
    return losses, tparams.state_to_numpy(state)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    X, Y, rng = _data()
    out = {}

    # 1. the deterministic 'G' VI model (no draw reaches the loss)
    Xd, Yd, _ = _data(n=128, seed=1)
    jcfg = JDGPConfig(layers=(JGPLayerConfig(d_in=D_X, d_out=1,
                                             num_inducing=M,
                                             mean_function="zero",
                                             final=True),),
                      num_data=128, objective="vi", num_samples=2)
    jp = jax.tree.map(lambda a: np.asarray(a, np.float64), jax.device_get(
        jinit_dgp(jax.random.PRNGKey(0), jcfg, dtype=jnp.float64)))
    _randomize_q(jp, rng)
    cfg = DGPConfig(layers=(GPLayerConfig(d_in=D_X, d_out=1, num_inducing=M,
                                          mean_function="zero",
                                          final=True),),
                    num_data=128, objective="vi", num_samples=2)
    tc_det = TrainConfig(lr=1e-2, natgrad="final", minibatch_size=32)
    skey = jax.random.PRNGKey(123)
    kb, _ = jax.random.split(skey)
    det_draws = {"idx": [np.asarray(jax.random.randint(
        jax.random.fold_in(kb, i), (16,), 0, 64)) for i in range(N_DP)],
        "eps": [[[None]] * N_K] * N_DP}
    out["det"] = {"program": "grads", "config": cfg, "tc": tc_det,
                  "params": jp, "X": Xd, "Y": Yd, "draws": det_draws,
                  "jax": (jcfg, skey)}

    # 2. LGG IW K=4, ten steps on the reference's sharded draws
    jconfig, config, params = _lgg(rng, X, Y)
    key = jax.random.PRNGKey(21)
    out["iw"] = {"program": "steps", "config": config,
                 "tc": TrainConfig(**TC), "params": params, "X": X, "Y": Y,
                 "steps": [_jax_draws(jax.random.fold_in(key, s), config,
                                      N // N_DP) for s in range(10)],
                 "jax": (jconfig, key)}

    # 3. the cross-'k' logsumexp
    out["logsumexp"] = {"program": "logsumexp",
                        "lw": 3.0 * rng.standard_normal((N_K * 5, 16)),
                        "c": rng.standard_normal(16)}

    # 4 and 14. generator-driven training: lower loss, replicas equal
    Xt, Yt, _ = _data(n=128, seed=2)
    out["train"] = {"program": "train", "seed": 4,
                    "config": build_config(BuildArgs(
                        configuration="LGG", mode="IW", num_inducing=M,
                        num_iw_samples=K), D_X, 1, 128),
                    "tc": TrainConfig(lr=1e-2, gamma=0.05, natgrad="final",
                                      minibatch_size=32, steps_per_call=15),
                    "X": Xt, "Y": Yt}

    # 5. the refusals
    one_gp = (GPLayerConfig(d_in=2, d_out=1, num_inducing=4, final=True),)
    out["refusals"] = {"program": "refusals", "configs": {
        "K": DGPConfig(layers=one_gp, num_data=10, objective="iw",
                       num_iw_samples=3),
        "S": DGPConfig(layers=one_gp, num_data=10, objective="vi",
                       num_samples=1)}}

    # 6. gamma warm-up, 13. the alternating schedule
    for name, kw in (("warmup", dict(gamma_warmup=5)),
                     ("alternating", dict(schedule="alternating"))):
        steps = [_numpy_draws(rng, config, N) for _ in range(10)]
        if name == "alternating":
            steps = [(s, _numpy_draws(rng, config, N)) for s in steps]
        out[name] = {"program": "steps", "config": config,
                     "tc": TrainConfig(**TC, **kw), "params": params,
                     "X": X, "Y": Y, "steps": steps}

    # 8. non-amortized latent layer, N = 63 padded to 64 over 'dp'
    n_pad = 63
    _, cfg_na, p_na = _lgg(rng, X[:n_pad], Y[:n_pad], amortized=False)
    draws = _numpy_draws(rng, cfg_na, n_pad + 1)
    draws["idx"][1][:2] = [31, 30]          # 63 -> row 0; 62 is real
    out["padded"] = {"program": "grads", "config": cfg_na,
                     "tc": TrainConfig(**TC), "params": p_na,
                     "X": X[:n_pad], "Y": Y[:n_pad], "draws": draws}

    # 9. checkpoint onto the mesh, 10. fit(mesh=) resume
    small = TrainConfig(lr=1e-2, gamma=0.05, natgrad="final",
                        minibatch_size=B, iterations=40, steps_per_call=10)
    out["checkpoint"] = {"program": "checkpoint", "config": config,
                         "tc": small, "params": params, "X": X, "Y": Y,
                         "ckpt": str(tmp / "ck")}
    out["fit_resume"] = {"program": "fit_resume", "config": config,
                         "tc": small, "params": params, "X": X, "Y": Y,
                         "ckpt": str(tmp / "ck_fit")}

    # 11. sharded evaluation, chunks of 8 (a multiple of the 4 ranks) and
    # of 7 (split 2 + 2 + 2 + 1 and padded)
    Xe, Ye, _ = _data(n=30, seed=3)
    out["evaluate"] = {"program": "evaluate",
                       "config": dataclasses.replace(config, num_samples=5),
                       "params": params, "X": Xe, "Y": Ye, "seed": 7,
                       "y_std": np.array([[2.5]]), "S": 5,
                       "batch_sizes": [8, 7]}
    return out


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    payload = {name: {k: v for k, v in case.items() if k != "jax"}
               for name, case in cases.items()}
    return W.spawn_world("suite", N_DP * N_K,
                         tmp_path_factory.mktemp("world"), payload)


def _single_grads(case):
    config, tc = case["config"], case["tc"]
    state = make_trainer(config, tc)[0](
        tparams.params_from_numpy(case["params"], "cpu"))
    n_local = -(-case["X"].shape[0] // N_DP)
    idx, eps = _global(case["draws"], n_local, config.num_data)
    loss, g_nat, g_rest = loss_and_grads(
        config, tc, state, torch.from_numpy(case["X"]),
        torch.from_numpy(case["Y"]), idx=idx, eps=eps)
    return float(loss), W.numpy_tree(g_nat), W.numpy_tree(g_rest)


@pytest.mark.parametrize("case", ["det", "padded"])
def test_loss_and_gradients_match_single_device(cases, world, case):
    """The summed loss and gradients of one sharded step equal the
    single-device step on the same global batch (rtol 1e-10), on every
    rank: the deterministic 'G' VI model, and a non-amortized latent
    layer on N = 63 rows padded to 64, whose padded row maps back to row
    0 (``global_row_ids``)."""
    loss, g_nat, g_rest = _single_grads(cases[case])
    for r in world:
        got = r[case]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-10)
        _close(got["g_nat"], g_nat, rtol=1e-10, atol=1e-14)
        _close(got["g_rest"], g_rest, rtol=1e-10, atol=1e-14)


def test_deterministic_model_matches_reference_sharded_step(cases, world):
    """The same step against the reference's make_parallel_trainer on its
    2x2 mesh: its loss, and the gradients of its sharded objective summed
    over that mesh, at rtol 1e-9."""
    case = cases["det"]
    jcfg, skey = case["jax"]
    jmesh = jmake_mesh(N_DP, N_K, devices=jax.devices()[:N_DP * N_K])
    jtc = JTrainConfig(lr=1e-2, natgrad="final", minibatch_size=32,
                       iterations=1, steps_per_call=1)
    jp = jax.tree.map(jnp.asarray, case["params"])
    init, step, _, _ = jmake_parallel_trainer(jcfg, jtc, jmesh)
    Xs, Ys = jshard_arrays(jmesh, jnp.asarray(case["X"]),
                           jnp.asarray(case["Y"]))
    _, jloss = jax.jit(step)(jreplicate(jmesh, init(jp)), Xs, Ys, skey)

    idx, _ = _global(case["draws"], 64, 128)
    xb = jnp.asarray(case["X"])[idx.numpy()]
    yb = jnp.asarray(case["Y"])[idx.numpy()]
    natvars, rest = _split_params(jp, (0,))

    def local(nv, rs, xl, yl, gidx):
        def f(nv_, rs_):
            return j_sharded_objective(_merge_params(rs_, nv_, (0,)), jcfg,
                                       xl, yl, gidx, skey, N_K, N_DP * N_K)
        value, grads = jax.value_and_grad(f, argnums=(0, 1))(nv, rs)
        return lax.psum(value, ("dp", "k")), lax.psum(grads, ("dp", "k"))

    jl, (jg_nat, jg_rest) = jax.jit(jax.shard_map(
        local, mesh=jmesh,
        in_specs=(JP(), JP(), JP("dp", None), JP("dp", None), JP("dp")),
        out_specs=(JP(), JP()), check_vma=False))(
            natvars, rest, xb, yb, jnp.asarray(idx.numpy()))
    np.testing.assert_allclose(float(jl), float(jloss), rtol=1e-12)
    got = world[0]["det"]
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-9)
    ref_nat = jax.device_get(jg_nat)
    for key in ("q_mu", "q_S"):
        np.testing.assert_allclose(got["g_nat"][0][key], ref_nat[0][key],
                                   rtol=1e-9, atol=1e-13)
    _close(got["g_rest"], jax.device_get(jg_rest), rtol=1e-9, atol=1e-13)


def test_ten_sharded_iw_steps_track_reference_chunk(cases, world):
    """LGG IW K=4 on the 2x2 mesh, the reference's own sharded draws
    injected: the losses and the state after ten steps equal the
    reference's sharded chunk (rtol 1e-8, atol 1e-12), and the
    single-device port on the same draws (rtol 1e-10)."""
    case = cases["iw"]
    jconfig, key = case["jax"]
    jmesh = jmake_mesh(N_DP, N_K, devices=jax.devices()[:N_DP * N_K])
    jtc = JTrainConfig(**TC, iterations=10, steps_per_call=10)
    init, _, chunk, _ = jmake_parallel_trainer(jconfig, jtc, jmesh)
    jstate = jreplicate(jmesh, init(jax.tree.map(jnp.asarray,
                                                 case["params"])))
    Xs, Ys = jshard_arrays(jmesh, jnp.asarray(case["X"]),
                           jnp.asarray(case["Y"]))
    jstate, jlosses = jax.jit(chunk)(jstate, Xs, Ys, key)
    ref = jax.device_get({"rest": jstate.rest, "natvars": jstate.natvars})
    single_losses, single = _single_steps(case, case["steps"], N // N_DP)
    for r in world:
        got = r["iw"]
        np.testing.assert_allclose(got["losses"], np.asarray(jlosses),
                                   rtol=1e-8)
        _close(got["state"], ref, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(got["losses"], single_losses, rtol=1e-10)
        _close(got["state"], single, rtol=1e-10, atol=1e-14)


def test_cross_k_logsumexp_equals_full_logsumexp(cases, world):
    """Each rank's logsumexp over its K/n_k rows, taken across 'k', equals
    the logsumexp over all K (rtol 1e-12); the gradient of each rank's
    sum(c * lse) on its rows equals that of the loss summed over the 'k'
    ranks, n_k * c * softmax (the sum all-reduce's transpose)."""
    case = cases["logsumexp"]
    lw = torch.from_numpy(case["lw"]).requires_grad_()
    full = torch.logsumexp(lw, 0)
    (g,) = torch.autograd.grad(N_K * torch.sum(torch.from_numpy(case["c"])
                                               * full), (lw,))
    rows = lw.shape[0] // N_K
    for r in world:
        got = r["logsumexp"]
        np.testing.assert_allclose(got["lse"], full.detach().numpy(),
                                   rtol=1e-12)
        k = got["i_k"]
        np.testing.assert_allclose(got["grad"],
                                   g[k * rows:(k + 1) * rows].numpy(),
                                   rtol=1e-12, atol=1e-15)


def test_sharded_iw_training_lowers_the_loss(world):
    for r in world:
        first, second = r["train"]["mean_losses"]
        assert second < first, (first, second)
        assert np.isfinite([first, second]).all()


def test_replicas_stay_bitwise_equal_and_replicate_is_a_no_op(world):
    """After two generator-driven chunks every rank holds the same state
    bit for bit (no broadcast in a step), and replicate() of parameters
    that every rank built from one seed changed none of them."""
    digests = {r["train"]["digest"] for r in world}
    assert len(digests) == 1, digests
    for r in world:
        assert r["train"]["agree"]
        assert r["train"]["replicate_changed_nothing"]


@pytest.mark.parametrize("which,message", [
    ("K", r"K=3 must divide over n_k=2"),
    ("S", r"S=1 must divide over n_k=2: an uneven split"),
])
def test_sample_counts_must_divide_over_k(world, which, message):
    import re

    for r in world:
        got = r["refusals"][which]
        assert got is not None and re.search(message, got), got


def test_gamma_warmup_matches_single_device_schedule(cases, world):
    """With gamma_warmup=5, ten sharded steps equal the single-device
    trainer's on the same draws (rtol 1e-10): both take their step size
    from training.train.gamma_schedule, which
    tests/test_torch_training.py holds to the reference's."""
    case = cases["warmup"]
    losses, state = _single_steps(case, case["steps"], N // N_DP)
    no_warmup = dict(case, tc=TrainConfig(**TC))
    _, state0 = _single_steps(no_warmup, case["steps"][:1], N // N_DP)
    _, state1 = _single_steps(case, case["steps"][:1], N // N_DP)
    assert not np.allclose(state0["natvars"][0]["q_S"],
                           state1["natvars"][0]["q_S"], rtol=1e-6)
    for r in world:
        np.testing.assert_allclose(r["warmup"]["losses"], losses, rtol=1e-10)
        _close(r["warmup"]["state"], state, rtol=1e-10, atol=1e-14)


def test_sharded_alternating_schedule_matches_single_device(cases, world):
    """The two-pass schedule: natgrad on one sharded minibatch, Adam on a
    fresh one, two summed reductions; ten steps equal the single-device
    alternating steps on the same draws (rtol 1e-10)."""
    case = cases["alternating"]
    losses, state = _single_steps(case, case["steps"], N // N_DP)
    for r in world:
        np.testing.assert_allclose(r["alternating"]["losses"], losses,
                                   rtol=1e-10)
        _close(r["alternating"]["state"], state, rtol=1e-10, atol=1e-14)


def test_global_row_ids_map_padded_rows_to_sources():
    """Padded chunk positions alias HEAD rows, not past the data."""
    num_data, n_dp, n_local = 126, 4, 32   # padded to 128
    idx = torch.arange(n_local)
    got = global_row_ids(3, idx, n_local, num_data).numpy()
    np.testing.assert_array_equal(
        got, np.concatenate([np.arange(96, 126), [0, 1]]))
    ids = np.concatenate([global_row_ids(i, idx, n_local, num_data).numpy()
                          for i in range(n_dp)])
    assert ids.min() >= 0 and ids.max() < num_data


def test_checkpoint_from_the_mesh_restores_bitwise(world):
    """Saved by rank 0 from the mesh, restored on every rank: the state and
    generator equal the saved ones bit for bit, and the next chunk from
    either gives the same losses; one file written."""
    for r in world:
        got = r["checkpoint"]
        assert got["restored_equal"]
        np.testing.assert_array_equal(got["continued_a"], got["continued_b"])
        assert got["files"] == ["step_10.pt"], got["files"]


def test_fit_mesh_resume_matches_uninterrupted(world):
    """fit(mesh=) resumed from its step-20 checkpoint ends where the
    uninterrupted 40 steps end, bit for bit, on every rank."""
    digests = {r["fit_resume"]["straight"] for r in world}
    assert len(digests) == 1
    for r in world:
        assert r["fit_resume"]["resumed"] == r["fit_resume"]["straight"]
    for a, b in zip(_flat(world[0]["fit_resume"]["params"]).values(),
                    _flat(world[3]["fit_resume"]["params"]).values()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch_size", [8, 7])
def test_sharded_evaluate_matches_unsharded(cases, world, batch_size):
    """evaluate(mesh=) splits every chunk's rows over the four ranks and
    gathers them: its metrics equal the unsharded evaluate's at the same
    seed (rtol 1e-12), on every rank."""
    case = cases["evaluate"]
    ref = evaluate(tparams.params_from_numpy(case["params"], "cpu"),
                   case["config"], case["X"], case["Y"], case["seed"],
                   y_std=case["y_std"], num_samples=case["S"],
                   batch_size=batch_size, device="cpu")
    for r in world:
        got = r["evaluate"][batch_size]
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, err_msg=k)


def test_initialize_is_a_no_op_in_a_single_process(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert not distributed.is_multiprocess()
    assert distributed.rank() == 0 and distributed.world_size() == 1


def test_initialize_refuses_an_address_without_a_world_size(monkeypatch):
    """A coordinator with no world size would have every process train
    its own model: refused before any group is made (reference
    distributed.py:63-74)."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(ValueError, match="also needs world_size"):
        distributed.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
