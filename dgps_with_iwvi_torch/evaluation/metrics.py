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

Under a mesh (reference l.24-66) each chunk's rows are split over every
rank, params replicated, and the outputs gathered before the metrics. A
rank draws its chunk's whole noise from the chunk's generator and keeps
its own rows' share (``models.dgp.layer_noise``), so the sharded metrics
equal the unsharded ones; each rank thus draws P times its share of the
noise. The kernels run on every rank as they do unsharded (K4 included).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models import layer_noise, predict_y_and_log_density
from ..parallel.distributed import rank, world_size
from ..parallel.sharding import gather_rows
from ..params import params_to_device


def chunk_seed(seed: int, start: int) -> int:
    """Generator seed of the chunk whose first row is `start`: (seed,
    start) mixed into 64 bits by numpy's SeedSequence, so that the low 32
    bits, all that the CPU generator keeps, differ too."""
    return int(np.random.SeedSequence([int(seed), int(start)])
               .generate_state(1, np.uint64)[0])


def _batch_eval(params, config, xb, yb, seed: int, start: int,
                num_samples: int):
    """(log_density [B], mix_mean [B, d_y]) of the chunk at `start`."""
    gen = torch.Generator(device=xb.device).manual_seed(
        chunk_seed(seed, start))
    (mean, _), ld = predict_y_and_log_density(params, config, xb, yb, gen,
                                              num_samples)
    return ld, mean


def _piece_eval(params, config, xb, yb, seed: int, start: int,
                num_samples: int, rows: slice):
    """The same for the chunk's `rows` only (padded with zero rows and
    noise to the slice's length), with the chunk's noise for those rows:
    the chunk's whole noise is drawn and sliced."""
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
    there.

    mesh: a ('dp', 'k') mesh (``parallel.make_mesh``): every chunk's rows
    are split over all its ranks and the outputs gathered; the metrics
    equal the unsharded ones and are the same on every rank."""
    device = resolve_device(device)
    params = params_to_device(params, device)
    X = torch.as_tensor(X_test).to(device)
    Y = torch.as_tensor(Y_test).to(device)
    n = X.shape[0]
    bs = min(batch_size, n)
    rows = None if mesh is None else rank_rows(bs)

    outs = []
    with torch.no_grad():
        for start in range(0, n, bs):
            xb, yb = X[start:start + bs], Y[start:start + bs]
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
    lds, means = host[:, 0], host[:, 1:]
    ys = np.asarray(torch.as_tensor(Y_test).cpu())   # [n, d_y]
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
