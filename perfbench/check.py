"""The comparison that decides ``correct``: the program's outputs against
the plain reference's (``reference/dgp_ref.py``), on the same inputs and
the same draws. Each number is judged against its limit in
``limits/<cell>.json``; a number that is not finite fails.

Training (the first steps of the same step object the window drives;
step 1 runs for real as the graph's warm-up, the later ones replay the
captured step):

- ``loss_gap``: the largest |loss_p - loss_r| / |loss_r| over the
  checked steps;
- ``grad_gap``: each of the first ``GRAD_STEPS`` steps' gradient as each
  optimizer got it, worked out from its state around that step (Adam's
  g_t = (m_t - 0.9 m_{t-1}) / 0.1 from its first moments; the
  natural-gradient block's (dm, H) from its (m, S^-1) before and after),
  by the worst leaf of the worst step: | |g_p| - |g_r| | over the larger
  of |g_r| and the median leaf's |g_r|. Step 1's g_r is the reference's
  from the shared weights; a later step's is the reference's at the
  program's own state before that step, on the same draw;
- ``change_gap``: the same of each leaf's change over the checked steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone under Adam), taken at
  the median leaf and not the worst: Adam moves every element by about
  its learning rate whatever the size of its gradient, so an element
  whose gradient is near zero moves one way or the other by the sign of
  its rounding, and in a small leaf (the encoder's 20-weight head) that
  one element sets the leaf's change. The worst leaf's figure is kept
  beside it as a reading (``change_gap_worst_leaf``), not judged;
- ``nat_change_gap``: the worst leaf of the natural-gradient block,
  (m, S), by the same measure: that block takes no Adam step, so no
  element of it moves by the sign of its rounding, and a fault that
  hits it alone shows here and not at the median leaf.

Scoring (every row of a sample of the window's calls):

- ``mean_gap``: max |mean_p - mean_r| / sqrt(var_r);
- ``var_gap``: max |var_p - var_r| / var_r;
- ``logdens_gap``: max |log_density_p - log_density_r| (nats).
"""

from __future__ import annotations

import math
import statistics

import torch

ADAM_B1 = 0.9
NEGLIGIBLE_GRAD = 1e-3
GRAD_STEPS = 2
NATURAL = ("final.q_mu", "final.q_S")


def _gaps(prog: dict, ref: dict, keys) -> list:
    """Per leaf: | |prog| - |ref| | over the larger of |ref| and the
    median leaf's |ref|; inf where a gap is not finite."""
    norms = {k: float(torch.linalg.vector_norm(ref[k])) for k in keys}
    median = statistics.median(norms.values())
    gaps = []
    for k in keys:
        p = float(torch.linalg.vector_norm(prog[k].double()))
        scale = max(norms[k], median)
        gap = abs(p - norms[k]) / scale if scale > 0 else math.inf
        gaps.append(gap if math.isfinite(gap) else math.inf)
    return gaps


def program_grads(moments: list, natvars: list, gamma: float) -> list:
    """Each step's gradient as each optimizer of the program got it, from
    Adam's first moments after steps 1..n (``moments``) and the
    natural-gradient block's (m, S, S^-1) before step 1 and after each
    step (``natvars``, n + 1 of them): Adam's leaves from m_t = 0.9
    m_{t-1} + 0.1 g_t, the block's (dm, H) from P = S^-1 + 2 gamma H and
    S'^-1 m' = S^-1 m - gamma (dm - 2 H m)."""
    out, prev = [], None
    for t, m in enumerate(moments):
        g = {k: (v.double() - (ADAM_B1 * prev[k].double()
                               if prev is not None else 0.0))
             / (1.0 - ADAM_B1) for k, v in m.items()}
        prev = m
        nat0, nat1 = natvars[t], natvars[t + 1]
        Sinv0, Sinv1 = nat0["q_Sinv"].double(), nat1["q_Sinv"].double()
        m0 = nat0["q_mu"].double().transpose(0, 1)[..., None]  # [D, M, 1]
        m1 = nat1["q_mu"].double().transpose(0, 1)[..., None]
        H = (Sinv1 - Sinv0) / (2.0 * gamma)
        deta = (Sinv0 @ m0 - Sinv1 @ m1) / gamma
        g["final.q_mu"] = (deta + 2.0 * H @ m0)[..., 0].transpose(0, 1)
        g["final.q_S"] = H
        out.append(g)
    return out


def train_numbers(prog_losses, prog_grads: list, ref_grads: list,
                  prog_start: dict, prog_after: dict, ref: dict) -> tuple:
    """(the compared numbers, readings kept beside them). ``prog_grads``
    and ``ref_grads`` hold the two sides' gradients of the first
    GRAD_STEPS steps; ``ref`` the reference's run from the shared
    weights."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog_losses,
                                                  ref["losses"])]
    if len(losses) != len(ref["losses"]) or not all(
            math.isfinite(x) for x in losses):
        loss_gap = math.inf
    else:
        loss_gap = max(losses)
    keys = sorted(ref_grads[0])
    grad_gaps = []
    for t in range(GRAD_STEPS):
        prog = prog_grads[t] if t < len(prog_grads) else {}
        missing = t >= len(ref_grads) or any(k not in prog for k in keys)
        grad_gaps.append(math.inf if missing else max(
            _gaps(prog, ref_grads[t], keys)))
    gnorm = {k: float(torch.linalg.vector_norm(ref_grads[0][k]))
             for k in keys}
    median = statistics.median(gnorm.values())
    moved = [k for k in keys if gnorm[k] >= NEGLIGIBLE_GRAD * median]
    d_prog = {k: prog_after[k].double() - prog_start[k].double()
              for k in moved}
    d_ref = {k: ref["params"][k] - ref["start"][k] for k in moved}
    change = dict(zip(moved, _gaps(d_prog, d_ref, moved)))
    natural = [change[k] for k in NATURAL if k in change]
    return {"loss_gap": loss_gap, "grad_gap": max(grad_gaps),
            "change_gap": statistics.median(change.values()),
            "nat_change_gap": max(natural) if natural else math.inf}, {
        "change_gap_worst_leaf": max(change.values()),
        **{f"grad_gap_step{t + 1}": v for t, v in enumerate(grad_gaps)}}


def score_numbers(pairs) -> tuple:
    """(the compared numbers, {}) of pairs: [((mean, var, ld) of the
    program, (mean, var, ld) of the reference)] of float64 tensors, mean
    and var [rows, d], ld [rows]."""
    mean_gap = var_gap = ld_gap = 0.0
    for (mp, vp, lp), (mr, vr, lr) in pairs:
        mean_gap = max(mean_gap, float(torch.max(
            torch.abs(mp - mr) / torch.sqrt(vr))))
        var_gap = max(var_gap, float(torch.max(torch.abs(vp - vr) / vr)))
        ld_gap = max(ld_gap, float(torch.max(torch.abs(lp - lr))))
        if not all(torch.isfinite(t).all() for t in (mp, vp, lp)):
            return dict.fromkeys(("mean_gap", "var_gap", "logdens_gap"),
                                 math.inf), {}
    return {"mean_gap": mean_gap, "var_gap": var_gap,
            "logdens_gap": ld_gap}, {}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit; a number without a limit fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        passed = (limit is not None and math.isfinite(value)
                  and value <= limit)
        ok = ok and passed
        out[name] = {"value": value, "limit": limit}
    return ok, out
