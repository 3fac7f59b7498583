"""The sharded training step, and the data and state around it
(port of dgps_with_iwvi_tpu/parallel/sharding.py:35-279).

Minibatch rows are split over 'dp', the K importance samples (S Monte
Carlo samples for 'vi') over 'k'. Each rank's local loss is

    -(N / B_global) * (datafit - local_kl) / n_k  +  (KL - log_prior) / P

with P = n_dp * n_k ranks, so that its sum over the mesh is the
single-device objective. The IW logsumexp runs across the 'k' ranks: a
MAX all-reduce of the detached per-row maximum, then a SUM all-reduce of
the shifted exponentials whose backward is itself a SUM all-reduce, so
each rank's gradient carries the other 'k' ranks' terms (a plain
``dist.all_reduce`` there runs, and silently drops them). The loss and
every gradient then go through one SUM all-reduce over the world, one
flat buffer per step (two under the 'alternating' schedule). Parameters
and optimizer state stay replicated: every rank applies the same natgrad
closed form and the same Adam step to the same summed gradients, which
keeps the replicas bitwise equal without a broadcast.

Randomness. Each rank holds the same CPU training generator and draws one
64-bit seed from it per step. From that seed a rank derives its rows
generator from (seed, i_dp), shared across 'k', and its noise generator
from (seed, i_dp, i_k), distinct per rank (``rank_generators``). A
checkpoint therefore keeps the one generator's state, and a resume
replays the run bit for bit. The draws differ from the single-device
trainer's, whose one generator gives both rows and noise.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
import torch.distributed as dist

from ..models import dgp
from ..models.layers import LatentVarMode
from ..ops import likelihoods
from ..ops import priors as priors_mod
from ..training import natgrad as ng
from ..training import train
from ..training.train import TrainConfig, TrainState
from .mesh import coordinate, mesh_shape


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce over `group` whose backward is the same all-reduce
    of the incoming gradient (the transpose of a psum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _k_sum(x, k_group, n_k: int):
    return x if n_k == 1 else _AllReduceSum.apply(x, k_group)


def cross_k_logsumexp(lw: torch.Tensor, k_group, n_k: int) -> torch.Tensor:
    """logsumexp over the sample axis 0 of lw [K_local, B], taken across
    the 'k' ranks: [B], the same on each. The max shift only stabilizes
    (a logsumexp's gradient does not depend on it), so it is detached."""
    m = torch.amax(lw.detach(), dim=0)
    if n_k > 1:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=k_group)
    return m + torch.log(_k_sum(torch.sum(torch.exp(lw - m), dim=0),
                                k_group, n_k))


def _sharded_objective(params, config: dgp.DGPConfig, xb, yb, idx,
                       generator, eps, numerics, *, n_dp: int, n_k: int,
                       k_group):
    """This rank's share of -ELBO; its sum over the mesh is the global
    loss (reference l.35-94, term for term)."""
    P_total = n_dp * n_k
    scale = config.num_data / (xb.shape[0] * n_dp)
    factors = dgp.prefactor_gp_layers(params, config)
    if config.objective == "iw":
        K = config.num_iw_samples
        fmean, fvar, log_w, _ = dgp.propagate(
            params, config, xb, (K // n_k,),
            lv_mode=LatentVarMode.POSTERIOR, Y=yb, data_idx=idx, eps=eps,
            generator=generator, factors=factors, numerics=numerics)
        ve = likelihoods.dispatch_variational_expectations(
            params["likelihood"], fmean, fvar, yb, kind=config.likelihood)
        iw = cross_k_logsumexp(ve + log_w, k_group, n_k) - math.log(float(K))
        datafit, local_kl_term = torch.sum(iw), 0.0
    else:
        S_local = config.num_samples // n_k
        fmean, fvar, _, local_kl = dgp.propagate(
            params, config, xb, (S_local,),
            lv_mode=LatentVarMode.POSTERIOR, Y=yb, data_idx=idx, eps=eps,
            generator=generator, factors=factors, numerics=numerics)
        ve = likelihoods.dispatch_variational_expectations(
            params["likelihood"], fmean, fvar, yb, kind=config.likelihood)
        ve_mean = _k_sum(torch.sum(ve, dim=0), k_group, n_k) / (S_local * n_k)
        datafit, local_kl_term = torch.sum(ve_mean), torch.sum(local_kl)
    kl = dgp.gp_kls(params, config, factors)
    if config.priors:
        # a global term like the KL: once per rank, over P
        kl = kl - priors_mod.log_prior(params, config.priors)
    # the datafit counted once per 'k' rank -> / n_k; the KL once per rank
    return -(scale * (datafit - local_kl_term)) / n_k + kl / P_total


def global_row_ids(i_dp, idx, N_local: int, num_data: int):
    """Map a 'dp' chunk's minibatch rows to global dataset rows.

    Chunks are contiguous along axis 0 (``shard_arrays``), padded to a
    multiple of n_dp with copies of the HEAD rows: padded global positions
    g in [num_data, num_data + rem) alias source rows g - num_data, which
    the modulo maps them back to. Without it a padded row would index past
    the per-datapoint q(w) of a non-amortized latent layer."""
    return (i_dp * N_local + idx) % num_data


def _seed(*words) -> int:
    """A 64-bit seed from integer words, mixed by numpy's SeedSequence
    (as ``evaluation.metrics.chunk_seed`` mixes)."""
    return int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1, np.uint64)[0])


def draw_step_seed(generator: torch.Generator) -> int:
    """One step's seed from the CPU training generator (no device sync)."""
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=generator))


def rank_generators(seed: int, i_dp: int, i_k: int, device) -> tuple:
    """(rows, noise) generators of rank (i_dp, i_k) for one step: the rows
    from (seed, i_dp), the same on every 'k' rank of a 'dp' row; the noise
    from (seed, i_dp, i_k)."""
    rows = torch.Generator(device=device).manual_seed(_seed(seed, i_dp))
    noise = torch.Generator(device=device).manual_seed(
        _seed(seed, i_dp, i_k))
    return rows, noise


def _sum_over_world(parts: list) -> list:
    """SUM all-reduce of the tensors in `parts` (None entries skipped) as
    one flat buffer; returns the summed tensors in the same places."""
    present = [t for t in parts if t is not None]
    flat = torch.cat([t.reshape(-1) for t in present])
    dist.all_reduce(flat)
    out, off = [], 0
    for t in parts:
        if t is None:
            out.append(None)
            continue
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


class _ShardedStep:
    """The pieces of one sharded step on this rank, shared by
    ``make_parallel_trainer`` and ``loss_and_grads``."""

    def __init__(self, config: dgp.DGPConfig, tc: TrainConfig, mesh):
        self.n_dp, self.n_k = mesh_shape(mesh)
        self.i_dp, self.i_k = coordinate(mesh)
        if config.objective == "iw":
            if config.num_iw_samples % self.n_k:
                raise ValueError(f"K={config.num_iw_samples} must divide "
                                 f"over n_k={self.n_k}")
        elif config.num_samples % self.n_k:
            raise ValueError(
                f"S={config.num_samples} must divide over n_k={self.n_k}: "
                "an uneven split would change the VI estimator's effective "
                "sample count vs the single-device run")
        self.config, self.tc = config, tc
        self.layer_ids = ng.natgrad_layer_ids(config, tc.natgrad)
        # the sharded path always samples rows with replacement; a global
        # batch of at least N takes the full-batch precision set all the
        # same, as the reference does
        self.policy = train.resolve_full_batch(
            config, tc, tc.minibatch_size >= config.num_data)
        self.B_local = max(tc.minibatch_size // self.n_dp, 1)
        k_group = mesh.get_group("k")

        def objective(params, cfg, xb, yb, generator, eps, idx, numerics):
            return _sharded_objective(params, cfg, xb, yb, idx, generator,
                                      eps, numerics, n_dp=self.n_dp,
                                      n_k=self.n_k, k_group=k_group)

        self.objective = objective

    def generators(self, generator, device) -> tuple:
        if generator is None:
            return None, None
        return rank_generators(draw_step_seed(generator), self.i_dp,
                               self.i_k, device)

    def batch(self, X, Y, idx, rows) -> tuple:
        """(xb, yb, global row ids) of this rank's rows `idx` of its chunk,
        or B_local rows drawn from `rows`."""
        if idx is None:
            if rows is None:
                raise ValueError("a minibatch draw needs idx or a CPU "
                                 "torch.Generator")
            idx = torch.randint(0, X.shape[0], (self.B_local,),
                                generator=rows, device=X.device)
        idx = idx.to(X.device)
        return X[idx], Y[idx], global_row_ids(self.i_dp, idx, X.shape[0],
                                              self.config.num_data)

    def grads(self, natvars, rest, batch, noise, eps, wrt_nat: bool,
              wrt_rest: bool) -> tuple:
        """(loss, nat_grads, rest_grads) summed over the world."""
        loss, g_nat, g_rest = train._grads(
            self.policy, self.layer_ids, natvars, rest, batch, noise, eps,
            wrt_nat, wrt_rest, objective=self.objective)
        keys = train._nat_leaves(g_nat)
        summed = _sum_over_world([loss.reshape(1)]
                                 + [g_nat[j][k] for j, k in keys] + g_rest)
        for (j, k), g in zip(keys, summed[1:1 + len(keys)]):
            g_nat[j][k] = g
        return summed[0][0], g_nat, summed[1 + len(keys):]


def make_parallel_trainer(config: dgp.DGPConfig, tc: TrainConfig, mesh):
    """Sharded (init_fn, step_fn, chunk_fn, params_fn) over a ('dp', 'k')
    mesh, with the single-device trainer's state, natgrad and Adam.

    step_fn(state, X, Y, generator=None, *, idx=None, eps=None)
        -> (state, loss summed over the mesh). X, Y: this rank's 'dp'
        chunk (``shard_arrays``); generator: the CPU training generator,
        the same on every rank. Injected draws, as the single-device
        step_fn takes them: idx this rank's [B_local] rows of its chunk,
        eps its K/n_k (S/n_k) samples of its rows per layer; under the
        'alternating' schedule each is a pair.
    chunk_fn(state, X, Y, generator) -> (state, losses [steps_per_call])
    """
    parts = _ShardedStep(config, tc, mesh)
    layer_ids = parts.layer_ids
    init_fn, _, _, params_fn = train.make_trainer(config, tc)

    def step_fn(state: TrainState, X, Y, generator=None, *, idx=None,
                eps=None):
        gamma = train.gamma_schedule(tc, state.step)
        rows, noise = parts.generators(generator, X.device)
        if layer_ids and tc.schedule == "alternating":
            idx1, idx2 = idx if idx is not None else (None, None)
            eps1, eps2 = eps if eps is not None else (None, None)
            _, g_nat, _ = parts.grads(state.natvars, state.rest,
                                      parts.batch(X, Y, idx1, rows), noise,
                                      eps1, True, False)
            natvars = ng.natgrad_update(state.natvars, g_nat, gamma)
            loss, _, g_rest = parts.grads(natvars, state.rest,
                                          parts.batch(X, Y, idx2, rows),
                                          noise, eps2, False, True)
        else:
            loss, g_nat, g_rest = parts.grads(
                state.natvars, state.rest, parts.batch(X, Y, idx, rows),
                noise, eps, bool(layer_ids), True)
            natvars = (ng.natgrad_update(state.natvars, g_nat, gamma)
                       if layer_ids else state.natvars)
        train._adam_step(state, g_rest)
        return TrainState(state.rest, natvars, state.opt_state,
                          state.step + 1), loss

    def chunk_fn(state: TrainState, X, Y, generator):
        """steps_per_call steps; the losses stay on the device."""
        losses = []
        for _ in range(tc.steps_per_call):
            state, loss = step_fn(state, X, Y, generator)
            losses.append(loss)
        return state, torch.stack(losses)

    return init_fn, step_fn, chunk_fn, params_fn


def loss_and_grads(config: dgp.DGPConfig, tc: TrainConfig, mesh,
                   state: TrainState, X, Y, generator=None, *, idx=None,
                   eps=None):
    """(loss, nat_grads, rest_grads) of one joint sharded step at `state`,
    summed over the mesh, with nothing updated (the counterpart of
    ``training.loss_and_grads``; arguments as ``step_fn``)."""
    parts = _ShardedStep(config, tc, mesh)
    rows, noise = parts.generators(generator, X.device)
    loss, g_nat, g_rest = parts.grads(
        state.natvars, state.rest, parts.batch(X, Y, idx, rows), noise, eps,
        bool(parts.layer_ids), True)
    return loss, g_nat, train._rest_grad_tree(state.rest, g_rest)


def shard_arrays(mesh, X, Y, local: bool = False) -> tuple:
    """This rank's 'dp' chunk of (X, Y).

    From the global arrays: the i_dp-th of n_dp contiguous chunks, N
    padded to a multiple of n_dp with copies of the head rows (harmless
    under with-replacement minibatching: ``global_row_ids`` maps the
    padded rows back to their sources). With local=True, X and Y already
    are this rank's chunk (ranks of one 'dp' row pass the same one, in
    'dp' order); every chunk must have the same size, which one
    all-reduce checks."""
    n_dp, _ = mesh_shape(mesh)
    if local:
        n = torch.tensor([X.shape[0], -X.shape[0]], dtype=torch.int64,
                         device=mesh.device_type)
        dist.all_reduce(n, op=dist.ReduceOp.MAX)
        if int(n[0]) != -int(n[1]):
            raise ValueError(
                f"shard_arrays(local=True): the ranks' chunks have from "
                f"{-int(n[1])} to {int(n[0])} rows; pad or trim each "
                "rank's split to one size")
        return X, Y
    rem = (-X.shape[0]) % n_dp
    if rem:
        X = torch.cat([X, X[:rem]])
        Y = torch.cat([Y, Y[:rem]])
    size = X.shape[0] // n_dp
    i_dp, _ = coordinate(mesh)
    return X[i_dp * size:(i_dp + 1) * size], Y[i_dp * size:(i_dp + 1) * size]


def _tensors(tree) -> list:
    """Every tensor of a params tree, a TrainState (its Adam's moments
    included, in parameter order) or a list of them."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, torch.optim.Optimizer):
        return [t for group in tree.param_groups for p in group["params"]
                for t in _tensors(tree.state.get(p, {}))]
    return [tree] if isinstance(tree, torch.Tensor) else []


def replicate(mesh, tree):
    """Broadcast every tensor of a params tree or a TrainState (Adam's
    state included) from rank 0, in place; returns the tree. Ranks that
    built the same state from one seed hold it already, and this changes
    nothing. Collectives run on the mesh's device type, on contiguous
    buffers (NCCL takes no others)."""
    with torch.no_grad():
        for t in _tensors(tree):
            buf = t.detach().to(mesh.device_type).contiguous()
            dist.broadcast(buf, src=0)
            t.detach().copy_(buf)
    if isinstance(tree, TrainState):
        step = torch.tensor([tree.step], dtype=torch.int64,
                            device=mesh.device_type)
        dist.broadcast(step, src=0)
        tree = tree._replace(step=int(step))
    return tree


def state_digest(tree) -> int:
    """A 56-bit digest of the bytes of every value in `tree` (tensors,
    optimizers, generators, numbers), in a fixed order."""
    h = hashlib.sha256()

    def visit(x):
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                h.update(str(k).encode())
                visit(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous().reshape(-1)
            h.update(str(t.dtype).encode())
            h.update(t.view(torch.uint8).numpy().tobytes())
        elif isinstance(x, torch.optim.Optimizer):
            visit(x.state_dict())
        elif isinstance(x, torch.Generator):
            visit(x.get_state())
        else:
            h.update(repr(x).encode())

    visit(tree)
    return int.from_bytes(h.digest()[:7], "little")


def replicas_agree(mesh, tree) -> bool:
    """Whether every rank holds a bitwise equal `tree` (one all-reduce of
    its digest)."""
    d = state_digest(tree)
    t = torch.tensor([d, -d], dtype=torch.int64, device=mesh.device_type)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t[0]) == -int(t[1])


def gather_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """[P, *t.shape]: every rank's `t` (same shape on each), on every
    rank, by one SUM all-reduce of a zero buffer that each rank fills at
    its own index (gloo's all-gather takes no CUDA tensors; a sum with
    zeros is exact)."""
    t = t.to(mesh.device_type)
    buf = t.new_zeros((dist.get_world_size(),) + tuple(t.shape))
    buf[dist.get_rank()] = t
    dist.all_reduce(buf)
    return buf
