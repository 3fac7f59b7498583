"""Rank programs of the port's torch.distributed tests
(tests/test_torch_parallel.py, tests/test_torch_multiprocess.py).

``spawn_world`` starts `world` processes through the package's
``parallel.launch.spawn_ranks``; each joins a gloo world through a
``FileStore`` under the test's temporary directory (no TCP port, so
parallel test workers cannot collide), runs one program of this module
with one CPU thread, and saves what it returns to ``rank<r>.pt`` for the
test to compare. This module
imports torch and the port only: the JAX reference runs in the test
process, which hands its draws to the ranks as numpy arrays.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from dgps_with_iwvi_torch import params as tparams
from dgps_with_iwvi_torch.evaluation import evaluate
from dgps_with_iwvi_torch.models import init_dgp
from dgps_with_iwvi_torch.parallel import (make_mesh, make_parallel_trainer,
                                           replicate, shard_arrays)
from dgps_with_iwvi_torch.parallel import sharding
from dgps_with_iwvi_torch.parallel.launch import spawn_ranks
from dgps_with_iwvi_torch.parallel.mesh import coordinate
from dgps_with_iwvi_torch.training import TrainConfig, fit
from dgps_with_iwvi_torch.training.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)


def spawn_world(program: str, world: int, tmp_path, payload,
                timeout: float = 300.0) -> list:
    """Run `program` on `world` gloo ranks; returns each rank's result.
    Fails the test if a rank raises, exits non-zero or outlasts
    `timeout` seconds."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    spawn_ranks(_entry, world, os.path.join(tmp, f"{program}.store"),
                program, payload, tmp, timeout_s=timeout)
    return [torch.load(os.path.join(tmp, f"{program}.rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def sleeper(rank: int, world: int, seconds: float) -> None:
    """A rank that only waits (the deadline's test)."""
    time.sleep(seconds)


def _entry(rank: int, world: int, store: str, program: str, payload,
           out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        result = getattr(sys.modules[__name__], program)(payload)
        torch.save(result, os.path.join(out_dir, f"{program}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def numpy_tree(tree):
    """A tree of tensors (None kept) as numpy arrays."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return None if tree is None else tree.detach().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eps(layers):
    return [None if e is None else _t(e) for e in layers]


def _rank_draws(draws, mesh):
    """This rank's (idx, eps) from per-(dp, k) draws
    {"idx": [n_dp][B_local], "eps": [n_dp][n_k][layers]}."""
    i_dp, i_k = coordinate(mesh)
    return _t(draws["idx"][i_dp]), _eps(draws["eps"][i_dp][i_k])


def _setup(case, mesh):
    """(config, tc, state, X_local, Y_local, init_fn, step_fn, chunk_fn,
    params_fn) of a case {"config", "tc", "params", "X", "Y"}."""
    config, tc = case["config"], case["tc"]
    init, step, chunk, params_fn = make_parallel_trainer(config, tc, mesh)
    state = replicate(mesh, init(tparams.params_from_numpy(case["params"],
                                                           "cpu")))
    Xl, Yl = shard_arrays(mesh, _t(case["X"]), _t(case["Y"]))
    return config, tc, state, Xl, Yl, init, step, chunk, params_fn


def _steps(case, mesh) -> dict:
    """Injected-draw steps (pairs under 'alternating'): the losses and the
    final state."""
    _, tc, state, Xl, Yl, _, step, _, _ = _setup(case, mesh)
    losses = []
    for draws in case["steps"]:
        if tc.schedule == "alternating":
            (i1, e1), (i2, e2) = (_rank_draws(d, mesh) for d in draws)
            state, loss = step(state, Xl, Yl, idx=(i1, i2), eps=(e1, e2))
        else:
            idx, eps = _rank_draws(draws, mesh)
            state, loss = step(state, Xl, Yl, idx=idx, eps=eps)
        losses.append(float(loss))
    return {"losses": losses, "state": tparams.state_to_numpy(state),
            "digest": sharding.state_digest(state)}


def _grads(case, mesh) -> dict:
    """One joint step's summed loss and gradients at the initial state."""
    config, tc, state, Xl, Yl, *_ = _setup(case, mesh)
    idx, eps = _rank_draws(case["draws"], mesh)
    loss, g_nat, g_rest = sharding.loss_and_grads(config, tc, mesh, state,
                                                  Xl, Yl, idx=idx, eps=eps)
    return {"loss": float(loss), "g_nat": numpy_tree(g_nat),
            "g_rest": numpy_tree(g_rest)}


def _logsumexp(case, mesh) -> dict:
    """cross_k_logsumexp of this rank's slice of lw, and the gradient of
    sum(c * lse) on its slice."""
    _, i_k = coordinate(mesh)
    n_k = mesh.size(1)
    lw_all = _t(case["lw"])
    K_local = lw_all.shape[0] // n_k
    lw = lw_all[i_k * K_local:(i_k + 1) * K_local].clone().requires_grad_()
    lse = sharding.cross_k_logsumexp(lw, mesh.get_group("k"), n_k)
    (g,) = torch.autograd.grad(torch.sum(_t(case["c"]) * lse), (lw,))
    return {"lse": lse.detach().numpy(), "grad": g.numpy(), "i_k": i_k}


def _train(case, mesh) -> dict:
    """Two generator-driven chunks: their mean losses, each rank's digest
    of the state, and whether replicate() of the same-seed parameters
    changed them."""
    config, tc = case["config"], case["tc"]
    params = init_dgp(torch.Generator().manual_seed(case["seed"]), config,
                      dtype=torch.float64, device="cpu")
    before = sharding.state_digest(params)
    replicate(mesh, params)
    init, _, chunk, _ = make_parallel_trainer(config, tc, mesh)
    state = init(params)
    Xl, Yl = shard_arrays(mesh, _t(case["X"]), _t(case["Y"]))
    gen = torch.Generator().manual_seed(1)
    state, l1 = chunk(state, Xl, Yl, gen)
    state, l2 = chunk(state, Xl, Yl, gen)
    return {"mean_losses": [float(l1.mean()), float(l2.mean())],
            "replicate_changed_nothing":
                sharding.state_digest(params) == before,
            "digest": sharding.state_digest(state),
            "agree": sharding.replicas_agree(mesh, state)}


def _refusals(case, mesh) -> dict:
    out = {}
    for name, config in case["configs"].items():
        try:
            make_parallel_trainer(config, TrainConfig(), mesh)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _checkpoint(case, mesh) -> dict:
    """A chunk, a save from the mesh, a restore onto a fresh replicated
    template, then one more chunk from each."""
    config, tc, state, Xl, Yl, init, _, chunk, _ = _setup(case, mesh)
    gen = torch.Generator().manual_seed(3)
    state, _ = chunk(state, Xl, Yl, gen)
    ckpt = case["ckpt"]
    save_checkpoint(ckpt, state.step, state, gen, mesh=mesh)
    like = {"state": replicate(mesh, init(tparams.params_from_numpy(
        case["params"], "cpu"))), "generator": torch.Generator()}
    restored = restore_checkpoint(ckpt, state.step, like, mesh=mesh)
    equal = (sharding.state_digest(restored)
             == sharding.state_digest({"state": state, "generator": gen}))
    _, la = chunk(state, Xl, Yl, gen)
    _, lb = chunk(restored["state"], Xl, Yl, restored["generator"])
    return {"restored_equal": equal, "continued_a": la.numpy(),
            "continued_b": lb.numpy(),
            "files": sorted(os.listdir(ckpt))}


def _fit_resume(case, mesh) -> dict:
    """fit(mesh=) for 40 steps saving at step 20, then resumed from it."""
    config, tc = case["config"], case["tc"]
    params = tparams.params_from_numpy(case["params"], "cpu")
    X, Y = _t(case["X"]), _t(case["Y"])
    ckpt = case["ckpt"]
    gen = torch.Generator().manual_seed(5)

    def cb(step, loss, st):
        if step == 20:
            save_checkpoint(ckpt, step, st, gen, mesh=mesh)

    straight, _ = fit(gen, config, params, X, Y, tc, callback=cb, mesh=mesh)
    init = make_parallel_trainer(config, tc, mesh)[0]
    like = {"state": init(tparams.params_from_numpy(case["params"], "cpu")),
            "generator": torch.Generator()}
    restored = restore_checkpoint(ckpt, 20, like, mesh=mesh)
    resumed, _ = fit(restored["generator"], config, params, X, Y, tc,
                     state=restored["state"], mesh=mesh)
    return {"straight": sharding.state_digest(straight),
            "resumed": sharding.state_digest(resumed),
            "params": numpy_tree(resumed)}


def _evaluate(case, mesh) -> dict:
    params = tparams.params_from_numpy(case["params"], "cpu")
    return {bs: evaluate(params, case["config"], case["X"], case["Y"],
                         case["seed"], y_std=case["y_std"],
                         num_samples=case["S"], batch_size=bs, mesh=mesh,
                         device="cpu")
            for bs in case["batch_sizes"]}


def suite(payload) -> dict:
    """The 2x2 world of tests/test_torch_parallel.py: every case of the
    payload on one mesh."""
    mesh = make_mesh(2, 2, device="cpu")
    programs = {"grads": _grads, "steps": _steps, "logsumexp": _logsumexp,
                "train": _train, "refusals": _refusals,
                "checkpoint": _checkpoint, "fit_resume": _fit_resume,
                "evaluate": _evaluate}
    return {name: programs[case["program"]](case, mesh)
            for name, case in payload.items()}


def local_chunks(payload) -> dict:
    """Generator-driven chunks from the global arrays and from each rank's
    own chunk (local=True): the losses of both on this rank; then chunks
    of unequal size, which every rank must refuse."""
    mesh = make_mesh(2, 2, device="cpu")
    n_dp, _ = mesh.size(0), mesh.size(1)
    i_dp, _ = coordinate(mesh)
    config, tc = payload["config"], payload["tc"]
    X, Y = _t(payload["X"]), _t(payload["Y"])
    size = X.shape[0] // n_dp
    out = {}
    for form in ("global", "local"):
        init, _, chunk, _ = make_parallel_trainer(config, tc, mesh)
        state = init(tparams.params_from_numpy(payload["params"], "cpu"))
        if form == "global":
            Xl, Yl = shard_arrays(mesh, X, Y)
        else:
            Xl, Yl = shard_arrays(
                mesh, X[i_dp * size:(i_dp + 1) * size],
                Y[i_dp * size:(i_dp + 1) * size], local=True)
        _, losses = chunk(state, Xl, Yl, torch.Generator().manual_seed(9))
        out[form] = losses.numpy()
    try:
        shard_arrays(mesh, X[:size + dist.get_rank()],
                     Y[:size + dist.get_rank()], local=True)
        out["unequal"] = None
    except ValueError as e:
        out["unequal"] = str(e)
    return out


def cli(payload) -> dict:
    """dgp-train-torch --shard, then --resume, then dgp-serve-torch --shard,
    each on every rank of the world, as torchrun would launch them."""
    from dgps_with_iwvi_torch.experiments import main, serve

    rows = [main.run(main.parse_args(payload["train"]))]
    rows.append(main.run(main.parse_args(payload["resume"])))
    served = serve.run(serve.parse_args(payload["serve"]))
    return {"rows": rows, "served": served}
