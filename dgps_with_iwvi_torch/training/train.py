"""Training: natural gradients on the final q(u), Adam on the rest
(port of dgps_with_iwvi_tpu/training/train.py:38-381).

One step draws a minibatch uniformly WITH replacement, evaluates -ELBO,
takes its gradient, applies the natgrad closed form to the natgrad blocks
and Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the root)
to everything else. Schedules: 'joint' (one forward/backward feeds both)
and 'alternating' (natgrad on one minibatch, then Adam on a fresh one).

Differences from the reference, by design:
- PyTorch runs eagerly, so ``chunk_fn`` is a Python loop of
  ``steps_per_call`` steps with no host sync inside, and
  ``TrainConfig.scan_unroll`` (a ``lax.scan`` knob) has no counterpart.
- The state is updated in place: Adam steps the ``rest`` tensors it holds
  (a ``torch.optim.Adam``), and ``step_fn`` returns the same objects.
- Randomness is an explicit ``torch.Generator``, or injected: ``idx`` (the
  minibatch rows) and ``eps`` (per-layer noise, see ``models.dgp.propagate``);
  for the alternating schedule each is a pair, one per minibatch.
- The full-batch escalation (B >= N) is a resolved precision set passed to
  the objective (``ops.precision.Numerics``), not module switches swapped
  around the loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..models import dgp
from ..ops.precision import Numerics
from . import natgrad as ng


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 5e-3
    gamma: float = 1e-2
    # linear warm-up of the natgrad step from gamma_start over
    # gamma_warmup steps (0: constant gamma)
    gamma_start: float = 1e-4
    gamma_warmup: int = 0
    natgrad: str = "none"          # 'none' | 'final' | 'all'
    schedule: str = "joint"        # 'joint' | 'alternating'
    minibatch_size: int = 512
    iterations: int = 10000
    steps_per_call: int = 100
    # class of the solve path's transposed dots: 'auto' resolves to 'same'
    # (the primal's class), as in the reference; 'high'/'default' opt in
    solve_bwd_precision: str = "auto"
    # 'auto': a full-batch step (B >= N) runs at the exact class
    full_batch_precision: str = "auto"


_PREC_ORDER = {"default": 0, "high": 1, "highest": 2}
FULL_BATCH_MIN_VAR = "highest"
FULL_BATCH_MIN_SOLVE = "highest"


def resolve_solve_bwd(tc: TrainConfig) -> str:
    """TrainConfig.solve_bwd_precision with 'auto' resolved to 'same'."""
    if tc.solve_bwd_precision == "auto":
        return "same"
    return tc.solve_bwd_precision


def _numerics(config, solve_bwd: str, kuf_residual: bool = True) -> Numerics:
    return Numerics(var=config.var_precision, solve=config.solve_precision,
                    solve_bwd=None if solve_bwd == "same" else solve_bwd,
                    kuf_residual=kuf_residual)


def resolve_full_batch(config, tc: TrainConfig, full_batch: bool):
    """(config, Numerics) of a step: on the full-batch path (unless
    full_batch_precision is 'off') the q-variance and solve classes rise
    to 'highest', the solve backward runs at the primal's class and the
    gram keeps no output residual (the reference's gate-derived set,
    ``train.py:91-135``)."""
    solve_bwd = resolve_solve_bwd(tc)
    if not full_batch or tc.full_batch_precision == "off":
        return config, _numerics(config, solve_bwd)
    cfg = config
    if _PREC_ORDER[cfg.var_precision] < _PREC_ORDER[FULL_BATCH_MIN_VAR]:
        cfg = dataclasses.replace(cfg, var_precision=FULL_BATCH_MIN_VAR)
    if _PREC_ORDER[cfg.solve_precision] < _PREC_ORDER[FULL_BATCH_MIN_SOLVE]:
        cfg = dataclasses.replace(cfg, solve_precision=FULL_BATCH_MIN_SOLVE)
    return cfg, _numerics(cfg, "same", kuf_residual=False)


def gamma_schedule(tc: TrainConfig, step: int) -> float:
    """Natgrad step size at `step` (linear warm-up, then constant)."""
    if tc.gamma_warmup <= 0:
        return tc.gamma
    frac = min(max(step / tc.gamma_warmup, 0.0), 1.0)
    return tc.gamma_start + (tc.gamma - tc.gamma_start) * frac


class TrainState(NamedTuple):
    rest: Any        # params minus the natgrad (q_mu, q_sqrt) blocks
    natvars: Any     # [{q_mu, q_S, q_Sinv, q_logdet}] per natgrad block
    opt_state: Any   # torch.optim.Adam over the leaves of `rest`
    step: int


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


_NAT_KEYS = ("q_mu", "q_S", "q_v")   # the differentiated natvar entries


def _nat_leaves(natvars) -> list:
    return [(j, k) for j, nv in enumerate(natvars) for k in _NAT_KEYS
            if k in nv]


def _minibatch(tc: TrainConfig, X, Y, generator, idx):
    """(xb, yb, idx): the rows `idx`, or B rows drawn with replacement
    from `generator`; the whole set when B >= N."""
    N = X.shape[0]
    if tc.minibatch_size >= N:
        return X, Y, torch.arange(N, device=X.device)
    if idx is None:
        if generator is None:
            raise ValueError("a minibatch draw needs idx or a "
                             "torch.Generator")
        idx = torch.randint(0, N, (tc.minibatch_size,), generator=generator,
                            device=X.device)
    idx = idx.to(X.device)
    return X[idx], Y[idx], idx


def _grads(policy, layer_ids, natvars, rest, batch, generator, eps,
           wrt_nat: bool, wrt_rest: bool):
    """(loss, nat_grads, rest_grads) of -ELBO with the natvars' (m, S) as
    fresh leaves; rest_grads in the order of the Adam leaves (None where
    the loss does not reach a leaf)."""
    cfg, numerics = policy
    nat = [{k: (v.detach().requires_grad_(wrt_nat) if k in _NAT_KEYS
                else v) for k, v in nv.items()} for nv in natvars]
    keys = _nat_leaves(nat) if wrt_nat else []
    rest_leaves = ([t for t in _leaves(rest) if t.requires_grad]
                   if wrt_rest else [])
    xb, yb, idx = batch
    params = ng.insert_natvars(rest, nat, layer_ids)
    loss = -dgp.elbo(params, cfg, xb, yb, generator, eps=eps, data_idx=idx,
                     numerics=numerics)
    grads = torch.autograd.grad(loss, [nat[j][k] for j, k in keys]
                                + rest_leaves, allow_unused=True)
    nat_grads = [{} for _ in nat]
    for (j, k), g in zip(keys, grads):
        nat_grads[j][k] = torch.zeros_like(nat[j][k]) if g is None else g
    return loss.detach(), nat_grads, list(grads[len(keys):])


def loss_and_grads(config: dgp.DGPConfig, tc: TrainConfig,
                   state: TrainState, X, Y, generator=None, *, idx=None,
                   eps=None):
    """(loss, nat_grads, rest_grads) of one joint step at `state`, with
    nothing updated: nat_grads per natgrad block, rest_grads a tree like
    ``state.rest`` (zeros where the loss does not reach a leaf)."""
    layer_ids = ng.natgrad_layer_ids(config, tc.natgrad)
    full = tc.minibatch_size >= X.shape[0]
    batch = _minibatch(tc, X, Y, generator, idx)
    loss, g_nat, g_rest = _grads(resolve_full_batch(config, tc, full),
                                 layer_ids, state.natvars, state.rest, batch,
                                 generator, eps, bool(layer_ids), True)
    it = iter(g_rest)
    rest_grads = _map(lambda t: (lambda g: torch.zeros_like(t) if g is None
                                 else g)(next(it)) if t.requires_grad
                      else None, state.rest)
    return loss, g_nat, rest_grads


def make_trainer(config: dgp.DGPConfig, tc: TrainConfig):
    """Returns (init_fn, step_fn, chunk_fn, params_fn).

    init_fn(params) -> TrainState
    step_fn(state, X, Y, generator=None, *, idx=None, eps=None)
        -> (state, loss)
    chunk_fn(state, X, Y, generator) -> (state, losses [steps_per_call])
    params_fn(state) -> canonical full params
    """
    layer_ids = ng.natgrad_layer_ids(config, tc.natgrad)
    policies = {fb: resolve_full_batch(config, tc, fb)
                for fb in (False, True)}

    def init_fn(params) -> TrainState:
        natvars = ng.extract_natvars(params, layer_ids)
        layers = list(params["layers"])
        for i in layer_ids:
            layers[i] = {k: v for k, v in layers[i].items()
                         if k not in ("q_mu", "q_sqrt")}
        rest = _map(lambda t: t.detach().clone().requires_grad_(
            t.is_floating_point()), dict(params, layers=layers))
        adam = torch.optim.Adam([t for t in _leaves(rest) if t.requires_grad],
                                lr=tc.lr, betas=(0.9, 0.999), eps=1e-8)
        return TrainState(rest, natvars, adam, 0)

    def _adam(state, rest_grads):
        params = [t for t in _leaves(state.rest) if t.requires_grad]
        for p, g in zip(params, rest_grads):
            p.grad = g
        state.opt_state.step()
        for p in params:
            p.grad = None

    def step_fn(state: TrainState, X, Y, generator=None, *, idx=None,
                eps=None):
        policy = policies[tc.minibatch_size >= X.shape[0]]
        gamma = gamma_schedule(tc, state.step)
        if layer_ids and tc.schedule == "alternating":
            idx1, idx2 = idx if idx is not None else (None, None)
            eps1, eps2 = eps if eps is not None else (None, None)
            batch = _minibatch(tc, X, Y, generator, idx1)
            _, g_nat, _ = _grads(policy, layer_ids, state.natvars, state.rest,
                                 batch, generator, eps1, True, False)
            natvars = ng.natgrad_update(state.natvars, g_nat, gamma)
            batch2 = _minibatch(tc, X, Y, generator, idx2)
            loss, _, g_rest = _grads(policy, layer_ids, natvars, state.rest,
                                     batch2, generator, eps2, False, True)
        else:
            batch = _minibatch(tc, X, Y, generator, idx)
            loss, g_nat, g_rest = _grads(policy, layer_ids, state.natvars,
                                         state.rest, batch, generator, eps,
                                         bool(layer_ids), True)
            natvars = (ng.natgrad_update(state.natvars, g_nat, gamma)
                       if layer_ids else state.natvars)
        _adam(state, g_rest)
        return TrainState(state.rest, natvars, state.opt_state,
                          state.step + 1), loss

    def chunk_fn(state: TrainState, X, Y, generator):
        """steps_per_call steps; the losses stay on the device."""
        losses = []
        for _ in range(tc.steps_per_call):
            state, loss = step_fn(state, X, Y, generator)
            losses.append(loss)
        return state, torch.stack(losses)

    def params_fn(state: TrainState):
        rest = _map(lambda t: t.detach().clone(), state.rest)
        if not layer_ids:
            return rest
        return ng.natvars_to_canonical(state.natvars, rest, layer_ids)

    return init_fn, step_fn, chunk_fn, params_fn


def fit(generator: torch.Generator, config: dgp.DGPConfig, params,
        X: torch.Tensor, Y: torch.Tensor, tc: TrainConfig, callback=None,
        state: TrainState | None = None, mesh=None):
    """Single-device training loop: chunks of steps_per_call steps up to
    tc.iterations; callback(step, mean_loss, state) after every chunk.

    The reference fires the callback one chunk behind its asynchronous
    dispatch; here the state is updated in place, so the callback runs
    right after its chunk and sees that chunk's state. Pass ``state`` to
    continue a run (from a chunk boundary; checkpoints come with ROADMAP
    queue 6). Returns (canonical params, state)."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded trainer is not ported yet (ROADMAP queue 8)")
    init_fn, _, chunk_fn, params_fn = make_trainer(config, tc)
    if state is None:
        state = init_fn(params)
    if state.step % tc.steps_per_call:
        raise ValueError(
            f"resume step {state.step} is not a multiple of steps_per_call="
            f"{tc.steps_per_call}")
    n_chunks = -(-tc.iterations // tc.steps_per_call)
    for c in range(state.step // tc.steps_per_call, n_chunks):
        state, losses = chunk_fn(state, X, Y, generator)
        if callback is not None:
            callback((c + 1) * tc.steps_per_call, float(losses.mean()), state)
    return params_fn(state), state
