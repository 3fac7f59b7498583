"""Test metrics: mixture test log-likelihood, RMSE and, for the label
families, accuracy (port of dgps_with_iwvi_tpu/evaluation/metrics.py:68-199).

Each test point is scored by the equally weighted mixture of S
prior-latent samples, p(y*) ~= (1/S) sum_s p(y* | m_s, v_s), through the
serving call ``models.predict_y_and_log_density``. The gaussian and
student_t families train on standardized labels: the log-likelihood
shifts by -sum log(sigma_y) and the RMSE scales by sigma_y, so both are in
original units. The other families train on labels as they are, so
their model units are original units.

The test set goes through in chunks of ``batch_size`` rows, the last one
padded to that size and masked, so every chunk runs at one shape. A chunk
draws its noise from its own torch generator, seeded from ``seed`` and the
chunk's first row: the counterpart of the reference's
``fold_in(key, start)``. Outputs stay on the device until every chunk is
queued and come to the host in one copy. The loop runs under
``torch.no_grad()``, so on the card ``DGPConfig.serve_pallas="auto"``
takes the inference kernel K4.

On the card each chunk is one replay of a CUDA graph (``GraphedEval``),
the counterpart of the reference's cached, jitted ``_batch_eval_fn``
(reference l.23-50): one program per (config, S, chunk rows, dtypes,
device, parameter shapes) in a module-level cache of ``EVAL_GRAPHS``,
least recently used first out, so later calls with the same model
configuration (the suite's runs, monitors) replay the graph captured by
the first. A graph bakes the addresses it read at its capture, so it
reads only its own tensors: a copy of the parameters, into which each
call copies the caller's; the chunk, copied into static inputs with the
padded rows zeroed; a generator registered with the graph and reseeded
with ``chunk_seed`` before each replay, so chunk i draws the eager chunk
i's noise. A replay overwrites the graph's outputs, so each chunk's rows
are copied out before the next. The first chunk of a new program runs
for real (the warm-up) and is then captured; a test set of one chunk
thus replays first in the next call. The CPU path and the mesh path
stay eager.

Under a mesh (reference l.24-66) each chunk's rows are split over every
rank, params replicated, and the outputs gathered before the metrics. A
rank draws its chunk's whole noise from the chunk's generator and keeps
its own rows' share (``models.dgp.layer_noise``), so the sharded metrics
equal the unsharded ones; each rank thus draws P times its share of the
noise. The kernels run on every rank as they do unsharded (K4 included).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device
from ..models import layer_noise, predict_y_and_log_density
from ..parallel.distributed import rank, world_size
from ..parallel.sharding import gather_rows
from ..params import params_to_device
from ..training.train import _map
from ..utils import graphs

EVAL_GRAPHS = 4  # evaluation programs the cache keeps


def chunk_seed(seed: int, start: int) -> int:
    """Generator seed of the chunk whose first row is `start`: (seed,
    start) mixed into 64 bits by numpy's SeedSequence, so that the low 32
    bits, all that the CPU generator keeps, differ too."""
    return int(np.random.SeedSequence([int(seed), int(start)])
               .generate_state(1, np.uint64)[0])


def _predict(params, config, xb, yb, gen, num_samples: int):
    """(log_density [B], mix_mean [B, d_y]) of a chunk, its noise drawn
    from `gen`."""
    (mean, _), ld = predict_y_and_log_density(params, config, xb, yb, gen,
                                              num_samples)
    return ld, mean


def _batch_eval(params, config, xb, yb, seed: int, start: int,
                num_samples: int):
    """(log_density [B], mix_mean [B, d_y]) of the chunk at `start`."""
    gen = torch.Generator(device=xb.device).manual_seed(
        chunk_seed(seed, start))
    return _predict(params, config, xb, yb, gen, num_samples)


def _leaves(tree) -> list:
    """The tensors of a parameter tree, dict entries in sorted key order:
    two trees of one model line up whatever order their dicts were built
    in."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


class GraphedEval:
    """``_batch_eval`` replayed from one CUDA graph per chunk
    (``utils.graphs``). It reads only its own tensors: ``params``, a copy
    of the parameters it was made with (``load`` copies others in), and
    the static chunk ``x`` [rows, d_x] and ``y`` [rows, d_y], contiguous
    and in the caller's dtypes as the eager chunk is; its generator is
    registered with the graph. ``graphs`` is the
    ``utils.graphs.GraphCache``."""

    def __init__(self, params, config, num_samples: int, X, Y, rows: int):
        with torch.no_grad():
            self.params = _map(torch.clone, params)
        self.x = X.new_zeros((rows, X.shape[1]))
        self.y = Y.new_zeros((rows, Y.shape[1]))
        self._gen = torch.Generator(device=X.device)
        self.graphs = graphs.GraphCache(X.device, (self._gen,))
        self._body = lambda: _predict(self.params, config, self.x, self.y,
                                      self._gen, num_samples)

    def load(self, params) -> None:
        """Copy `params` (the same tree, shapes and dtypes) into the
        graph's own parameters."""
        for mine, theirs in zip(_leaves(self.params), _leaves(params),
                                strict=True):
            mine.copy_(theirs)

    def __call__(self, xb, yb, seed: int, start: int):
        """(log_density, mix_mean) of the chunk at `start` (xb, yb its
        real rows, at most ``rows``): the graph's own outputs, which the
        next call overwrites."""
        k = xb.shape[0]
        self.x[:k].copy_(xb)
        self.y[:k].copy_(yb)
        if k < self.x.shape[0]:  # the padded tail
            self.x[k:].zero_()
            self.y[k:].zero_()
        self._gen.manual_seed(chunk_seed(seed, start))
        return self.graphs((), self._body)


_programs: OrderedDict = OrderedDict()


def graphed_eval(params, config, num_samples: int, X, Y,
                 rows: int) -> GraphedEval:
    """The cached ``GraphedEval`` of this configuration, S, chunk rows,
    dtypes, device and parameter shapes, with `params` copied in; a new
    one (the least recently used of ``EVAL_GRAPHS`` dropped) if none."""
    key = (config, num_samples, rows, X.shape[1], Y.shape[1], X.dtype,
           Y.dtype, X.device,
           tuple((t.shape, t.dtype) for t in _leaves(params)))
    program = _programs.pop(key, None)
    if program is None:
        program = GraphedEval(params, config, num_samples, X, Y, rows)
        # every evaluate ends in a copy to the host, so no dropped graph
        # is still running
        while len(_programs) >= EVAL_GRAPHS:
            _programs.popitem(last=False)
    else:
        program.load(params)
    _programs[key] = program
    return program


def eval_programs() -> list:
    """The cached ``GraphedEval`` programs, least recently used first."""
    return list(_programs.values())


def drop_programs() -> None:
    """Empty the cache: the next ``evaluate`` captures anew, under the
    module switches then in force (a graph bakes those of its capture)."""
    _programs.clear()


def _piece_eval(params, config, xb, yb, seed: int, start: int,
                num_samples: int, rows: slice):
    """``_batch_eval`` for the chunk's `rows` only (padded with zero rows
    and noise to the slice's length), with the chunk's noise for those
    rows: the chunk's whole noise is drawn and sliced."""
    gen = torch.Generator(device=xb.device).manual_seed(
        chunk_seed(seed, start))
    noise = layer_noise(config, (num_samples,), xb.shape[0], gen,
                        dtype=xb.dtype)
    eps = [None if e is None else piece_rows(e, rows, 1) for e in noise]
    (mean, _), ld = predict_y_and_log_density(
        params, config, piece_rows(xb, rows, 0), piece_rows(yb, rows, 0),
        None, num_samples, eps=eps)
    return ld, mean


def piece_rows(t: torch.Tensor, rows: slice, dim: int) -> torch.Tensor:
    """t's `rows` along `dim`, zero-padded to the slice's length."""
    part = t.narrow(dim, rows.start, max(min(rows.stop, t.shape[dim])
                                         - rows.start, 0))
    pad = (rows.stop - rows.start) - part.shape[dim]
    if not pad:
        return part
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([part, t.new_zeros(shape)], dim)


def rank_rows(batch: int) -> slice:
    """This rank's rows of a batch split over every rank of the world:
    [r * piece, (r + 1) * piece) with piece = ceil(batch / ranks); rows
    past the batch are padding."""
    piece = -(-batch // world_size())
    return slice(rank() * piece, (rank() + 1) * piece)


def merge_rows(gathered: np.ndarray, batch: int) -> np.ndarray:
    """The inverse of the split: gathered [P, n_batches * piece, ...] (each
    rank's pieces of every batch, in order) -> [n_batches * batch, ...]
    in row order."""
    P, n = gathered.shape[:2]
    piece = -(-batch // P)
    tail = gathered.shape[2:]
    g = gathered.reshape((P, n // piece, piece) + tail).swapaxes(0, 1)
    return g.reshape((n // piece, P * piece) + tail)[:, :batch].reshape(
        (-1,) + tail)


def _replays(device: torch.device, mesh) -> bool:
    """Whether ``evaluate`` replays CUDA graphs: on the card, unsharded
    (under a mesh the gather goes through the host)."""
    return mesh is None and device.type == "cuda"


def _points(params, config, X, Y, seed: int, num_samples: int, bs: int,
            mesh, graphed: bool):
    """(log_density [n], mix_mean [n, d]) of every row of the device
    tensors X, Y, as numpy arrays, in chunks of `bs` rows: each chunk a
    replay of the cached ``GraphedEval`` if `graphed`, else eager (under
    `mesh`, this rank's rows of each chunk, gathered)."""
    n = X.shape[0]
    rows = None if mesh is None else rank_rows(bs)
    outs = []
    with torch.no_grad():
        program = (graphed_eval(params, config, num_samples, X, Y, bs)
                   if graphed else None)
        for start in range(0, n, bs):
            xb, yb = X[start:start + bs], Y[start:start + bs]
            if program is not None:
                ld, mean = program(xb, yb, seed, start)
                keep = xb.shape[0]  # copied out before the next replay
                outs.append(torch.cat([ld[:keep, None], mean[:keep]], 1))
                continue
            pad = bs - xb.shape[0]
            if pad:  # pad to the chunk size, mask after
                xb = torch.cat([xb, xb.new_zeros((pad,) + xb.shape[1:])])
                yb = torch.cat([yb, yb.new_zeros((pad,) + yb.shape[1:])])
            if rows is None:
                ld, mean = _batch_eval(params, config, xb, yb, seed, start,
                                       num_samples)
                outs.append(torch.cat([ld[:bs - pad, None],
                                       mean[:bs - pad]], 1))
            else:
                ld, mean = _piece_eval(params, config, xb, yb, seed, start,
                                       num_samples, rows)
                outs.append(torch.cat([ld[:, None], mean], 1))
        out = torch.cat(outs)
        if mesh is None:
            host = out.cpu().numpy()            # the one copy to the host
        else:
            host = merge_rows(gather_rows(mesh, out).cpu().numpy(), bs)[:n]
    return host[:, 0], host[:, 1:]


def evaluate(params, config, X_test, Y_test, seed: int, *, y_std,
             num_samples: int = 100, batch_size: int = 4096,
             likelihood: str = "gaussian", mesh=None,
             device="cuda") -> dict:
    """-> dict(test_loglik, test_rmse, test_loglik_normalized,
    test_rmse_normalized), plus test_accuracy for multiclass, softmax,
    bernoulli and ordinal and test_loglik_task_<t> per task for
    switched_gaussian.

    test_loglik is the mean per-point mixture log-density in ORIGINAL
    units; test_rmse the root-mean-square error of the mixture mean, in
    original units (NaN for multiclass and softmax, whose mean is the
    class probabilities). X_test [n, d_x] and Y_test [n, d_y] are numpy
    arrays or tensors in the model's dtype (standardized for gaussian and
    student_t); y_std the train split's label scale. Runs on `device`
    (the card unless the caller asks for the CPU); params are moved
    there. On the card each chunk replays a cached CUDA graph
    (``GraphedEval``).

    mesh: a ('dp', 'k') mesh (``parallel.make_mesh``): every chunk's rows
    are split over all its ranks and the outputs gathered; the metrics
    equal the unsharded ones and are the same on every rank."""
    device = resolve_device(device)
    params = params_to_device(params, device)
    X = torch.as_tensor(X_test).to(device)
    Y = torch.as_tensor(Y_test).to(device)
    lds, means = _points(params, config, X, Y, seed, num_samples,
                         min(batch_size, X.shape[0]), mesh,
                         _replays(device, mesh))
    return _metrics(lds, means, np.asarray(torch.as_tensor(Y_test).cpu()),
                    y_std, likelihood)


def _metrics(lds, means, ys, y_std, likelihood: str) -> dict:
    """``evaluate``'s metrics of the per-point log-densities [n], mixture
    means [n, d] and labels ys [n, d_y]."""
    ld_norm = float(lds.mean())
    if likelihood in ("multiclass", "softmax"):
        # means: mixture class probabilities [n, C]; ys: labels [n, 1]
        return {"test_loglik": ld_norm, "test_rmse": float("nan"),
                "test_loglik_normalized": ld_norm,
                "test_rmse_normalized": float("nan"),
                "test_accuracy": float(np.mean(
                    np.argmax(means, axis=-1) == ys[:, 0]))}
    if likelihood == "switched_gaussian":
        # ys = [targets..., task index]; pooled and per-task metrics, no
        # un-normalization
        tasks = np.round(ys[:, -1]).astype(int)
        rmse = float(np.sqrt(np.mean(np.sum((means - ys[:, :-1]) ** 2,
                                            -1))))
        out = {"test_loglik": ld_norm, "test_rmse": rmse,
               "test_loglik_normalized": ld_norm,
               "test_rmse_normalized": rmse}
        for t in np.unique(tasks):
            out[f"test_loglik_task_{t}"] = float(lds[tasks == t].mean())
        return out
    errs = means - ys                                  # in model units
    rmse_norm = float(np.sqrt(np.mean(np.sum(errs ** 2, -1))))
    if likelihood not in ("gaussian", "student_t"):
        # labels, counts, positives: model units are original units
        out = {"test_loglik": ld_norm, "test_rmse": rmse_norm,
               "test_loglik_normalized": ld_norm,
               "test_rmse_normalized": rmse_norm}
        if likelihood == "bernoulli":
            # means = mixture p(y=1): |p - y| < 0.5 is a correct label
            out["test_accuracy"] = float(
                np.mean(np.all(np.abs(errs) < 0.5, axis=-1)))
        elif likelihood == "ordinal":
            # the nearest label to the predictive mean
            out["test_accuracy"] = float(
                np.mean(np.round(means[:, 0]) == ys[:, 0]))
        return out
    y_std = np.asarray(y_std).reshape(1, -1)
    rmse_orig = float(np.sqrt(np.mean(np.sum((errs * y_std) ** 2, -1))))
    log_sigma = float(np.sum(np.log(y_std)))           # per-dim sum
    return {
        "test_loglik": ld_norm - log_sigma,
        "test_rmse": rmse_orig,
        "test_loglik_normalized": ld_norm,
        "test_rmse_normalized": rmse_norm,
    }
