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
  Where the reference jits that chunk (l.345), ``fit`` on the card
  replays one CUDA graph per step (``graphed_chunk_fn``,
  ``utils.graphs``); the ``mesh=`` trainer and the CPU path stay eager.
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
from ..utils import graphs
from ..utils.trace import span
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


def _neg_elbo(params, cfg, xb, yb, generator, eps, idx, numerics):
    return -dgp.elbo(params, cfg, xb, yb, generator, eps=eps, data_idx=idx,
                     numerics=numerics)


def _grads(policy, layer_ids, natvars, rest, batch, generator, eps,
           wrt_nat: bool, wrt_rest: bool, objective=_neg_elbo):
    """(loss, nat_grads, rest_grads) of `objective` (default -ELBO) with
    the natvars' (m, S) as fresh leaves; rest_grads in the order of the
    Adam leaves (None where the loss does not reach a leaf)."""
    cfg, numerics = policy
    nat = [{k: (v.detach().requires_grad_(wrt_nat) if k in _NAT_KEYS
                else v) for k, v in nv.items()} for nv in natvars]
    keys = _nat_leaves(nat) if wrt_nat else []
    rest_leaves = ([t for t in _leaves(rest) if t.requires_grad]
                   if wrt_rest else [])
    xb, yb, idx = batch
    params = ng.insert_natvars(rest, nat, layer_ids)
    loss = objective(params, cfg, xb, yb, generator, eps, idx, numerics)
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
    return loss, g_nat, _rest_grad_tree(state.rest, g_rest)


def _rest_grad_tree(rest, g_rest):
    """The Adam-ordered gradients as a tree like `rest` (zeros where the
    loss does not reach a leaf, None for a leaf Adam does not step)."""
    it = iter(g_rest)
    return _map(lambda t: (lambda g: torch.zeros_like(t) if g is None
                           else g)(next(it)) if t.requires_grad else None,
                rest)


def _adam_step(state, rest_grads) -> None:
    """One step of the state's Adam on the gradients of its leaves (a
    leaf with a None gradient is left alone, as torch's Adam does)."""
    params = [t for t in _leaves(state.rest) if t.requires_grad]
    for p, g in zip(params, rest_grads):
        p.grad = g
    state.opt_state.step()
    for p in params:
        p.grad = None


def make_trainer(config: dgp.DGPConfig, tc: TrainConfig):
    """Returns (init_fn, step_fn, chunk_fn, params_fn).

    init_fn(params) -> TrainState
    step_fn(state, X, Y, generator=None, *, idx=None, eps=None, gamma=None)
        -> (state, loss); gamma: the natgrad step size, a float or a 0-d
        float64 tensor (default ``gamma_schedule(tc, state.step)``)
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
        leaves = [t for t in _leaves(rest) if t.requires_grad]
        # capturable: its step count and bias corrections stay on the card,
        # so that a CUDA graph can capture the update (fit)
        adam = torch.optim.Adam(
            leaves, lr=tc.lr, betas=(0.9, 0.999), eps=1e-8,
            capturable=bool(leaves) and leaves[0].device.type == "cuda")
        return TrainState(rest, natvars, adam, 0)

    def step_fn(state: TrainState, X, Y, generator=None, *, idx=None,
                eps=None, gamma=None):
        policy = policies[tc.minibatch_size >= X.shape[0]]
        if gamma is None:
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
        _adam_step(state, g_rest)
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


def write_step(step_fn, state: TrainState, X, Y, generator, gamma, loss):
    """One ``step_fn`` step whose results stay in static tensors: gamma
    read from the 0-d float64 tensor `gamma`, the new natvars written into
    ``state.natvars``' own tensors (Adam already steps ``state.rest`` in
    place) and the loss into `loss`. The step that ``fit``'s CUDA graph
    captures: a replay reads and writes the same tensors.

    A step run for real (the graph's warm-up) gives a natvar tensor the
    strides of the step's new value where they differ (``set_``: the
    same tensor object, the new value's storage), so that the captured
    step reads its natvars in the layout an eager step reads them: cuBLAS
    picks its kernel by its operands' strides, and the initial natvars'
    layout (``natgrad.extract_natvars``) is not the update's. Inside a
    capture the values are copied into the tensors as they are."""
    new, value = step_fn(state, X, Y, generator, gamma=gamma)
    capturing = X.is_cuda and torch.cuda.is_current_stream_capturing()
    for old_nv, new_nv in zip(state.natvars, new.natvars):
        for k, v in new_nv.items():
            old = old_nv[k]
            if v is old:
                continue
            if not capturing and old.stride() != v.stride():
                old.set_(v)
            else:
                old.copy_(v)
    loss.copy_(value)


def graphed_chunk_fn(step_fn, tc: TrainConfig, state: TrainState, X, Y,
                     generator):
    """``chunk_fn`` on the card: every step replays one CUDA graph of
    ``write_step`` on `state`'s tensors (``utils.graphs``; the first step
    runs for real as the graph's warm-up, then the step is captured), with
    `generator` registered so that each replay draws as an eager step
    would. The chunk function then takes this `state`, `X`, `Y` and
    `generator` only, as the graph holds their tensors; the state it
    returns holds the same tensors. Gamma is written to a static scalar
    before each step in which it changes. The function's ``graphs`` is its
    ``utils.graphs.GraphCache``."""
    cache = graphs.GraphCache(X.device, (generator,))
    gamma = torch.zeros((), dtype=torch.float64, device=X.device)
    loss = torch.zeros((), dtype=X.dtype, device=X.device)
    gamma_held = None

    def body():
        write_step(step_fn, state, X, Y, generator, gamma, loss)

    def chunk_fn(state_: TrainState, X_, Y_, generator_):
        nonlocal gamma_held
        if (state_.rest is not state.rest
                or state_.natvars is not state.natvars or X_ is not X
                or Y_ is not Y or generator_ is not generator):
            raise ValueError("a graphed chunk runs on the state, data and "
                             "generator it was made for")
        losses = torch.empty((tc.steps_per_call,), dtype=loss.dtype,
                             device=loss.device)
        for i in range(tc.steps_per_call):
            g = gamma_schedule(tc, state_.step + i)
            if g != gamma_held:
                gamma.fill_(g)
                gamma_held = g
            cache((), body)
            losses[i].copy_(loss)
        return state_._replace(step=state_.step + tc.steps_per_call), losses

    chunk_fn.graphs = cache
    return chunk_fn


def fit(generator: torch.Generator, config: dgp.DGPConfig, params,
        X: torch.Tensor, Y: torch.Tensor, tc: TrainConfig, callback=None,
        state: TrainState | None = None, mesh=None):
    """Training loop: chunks of steps_per_call steps up to tc.iterations;
    callback(step, mean_loss, state) after every chunk.

    The reference fires the callback one chunk behind its asynchronous
    dispatch; here the state is updated in place, so the callback runs
    right after its chunk and sees that chunk's state. Pass ``state`` to
    continue a run from a chunk boundary, e.g. one restored by
    ``training.checkpoint.restore_checkpoint`` together with the
    generator's state. Returns (canonical params, state).

    On the card each step replays one CUDA graph (``graphed_chunk_fn``):
    the state's tensors are then written in place, the natvars too.

    mesh: a ('dp', 'k') mesh (``parallel.make_mesh``) trains with the
    sharded step (``parallel.sharding``): X and Y are the global arrays,
    each rank keeps its 'dp' chunk, the state is replicated from rank 0
    and the callback gets the loss summed over every rank, the same on
    each. The generator is then a CPU generator, the same on every rank
    (one seed per step, drawn without a device sync)."""
    if mesh is not None:
        from ..parallel import sharding

        init_fn, _, chunk_fn, params_fn = sharding.make_parallel_trainer(
            config, tc, mesh)
        X, Y = sharding.shard_arrays(mesh, X, Y)
        state = sharding.replicate(mesh, init_fn(params) if state is None
                                   else state)
    else:
        init_fn, step_fn, chunk_fn, params_fn = make_trainer(config, tc)
        if state is None:
            state = init_fn(params)
        if X.device.type == "cuda":
            chunk_fn = graphed_chunk_fn(step_fn, tc, state, X, Y, generator)
    if state.step % tc.steps_per_call:
        raise ValueError(
            f"resume step {state.step} is not a multiple of steps_per_call="
            f"{tc.steps_per_call}")
    n_chunks = -(-tc.iterations // tc.steps_per_call)
    for c in range(state.step // tc.steps_per_call, n_chunks):
        with span("fit.chunk"):
            state, losses = chunk_fn(state, X, Y, generator)
        if callback is not None:
            with span("fit.readback"):
                loss = float(losses.mean())
            with span("fit.callback"):
                callback((c + 1) * tc.steps_per_call, loss, state)
    return params_fn(state), state
