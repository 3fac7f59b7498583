"""Training monitor: periodic rate and ELBO prints, optional TensorBoard
(port of dgps_with_iwvi_tpu/training/monitor.py).

gpflow's monitor task model (PrintTimingsTask, ScalarFuncToTensorBoardTask,
ModelToTensorBoardTask): steps/s and the objective on a cadence, plus the
model's hyperparameters (kernel variance and lengthscales, likelihood
noise, natgrad gamma) as scalars. TensorBoard is written where
``torch.utils.tensorboard`` imports, which needs the ``tensorboard``
package.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from ..models.layers import GPLayerConfig
from ..ops import kernels, likelihoods
from ..ops.transforms import positive


def hyperparameter_scalars(rest, config, tc=None, step=None) -> dict:
    """Named hyperparameter scalars of a training state.

    ``rest`` is the non-natgrad parameter tree (``TrainState.rest``: the
    kernel hyperparameters, the likelihood noise and the encoder live
    there); ``config`` the DGPConfig; with ``tc`` and ``step``, also the
    natgrad step size. One copy to the host for the whole dict."""
    out = {}
    for i, cfg in enumerate(config.layers):
        if not isinstance(cfg, GPLayerConfig):
            continue
        kp = rest["layers"][i]["kernel"]
        # a composite kernel: the first leaf's scalars, as the reference
        # logs them; a leaf logs the keys its family has
        if "terms" in kp:
            kp = kp["terms"][0][0]
        if "raw_variance" in kp:
            out[f"hypers/layer{i}/kernel_variance"] = torch.mean(
                kernels.kernel_variance(kp))
        if "raw_lengthscales" in kp:
            ls = kernels.kernel_lengthscales(kp)
            out[f"hypers/layer{i}/lengthscale_mean"] = torch.mean(ls)
            out[f"hypers/layer{i}/lengthscale_min"] = torch.min(ls)
            out[f"hypers/layer{i}/lengthscale_max"] = torch.max(ls)
        # every other positive leaf parameter (rq alpha, periodic period,
        # arc-cosine variances, polynomial offset), its mean
        for k, v in kp.items():
            name = k.removeprefix("raw_")
            if k.startswith("raw_") and name not in ("variance",
                                                     "lengthscales"):
                out[f"hypers/layer{i}/kernel_{name}"] = torch.mean(
                    positive(v))
    if config.likelihood == "gaussian":
        out["hypers/likelihood_noise_variance"] = likelihoods.noise_variance(
            rest["likelihood"])
    values = torch.stack([v.detach().reshape(()) for v in out.values()])
    scalars = dict(zip(out, values.cpu().tolist()))
    if tc is not None and step is not None and tc.natgrad != "none":
        from .train import gamma_schedule

        scalars["hypers/natgrad_gamma"] = float(gamma_schedule(tc, step))
    return scalars


class Monitor:
    def __init__(self, print_every: int = 500, log_dir: str | None = None,
                 printer: Callable[[str], None] = print,
                 scalars_fn: Callable[[object], dict] | None = None):
        """scalars_fn(state) -> {tag: float}: extra scalars (the
        hyperparameters) recorded at each callback and written to
        TensorBoard. Build one from hyperparameter_scalars."""
        self.print_every = print_every
        self.printer = printer
        self.scalars_fn = scalars_fn
        self._t0 = None
        self._last_step = 0
        self._last_t = None
        self.history: list[dict] = []
        self._tb = None
        if log_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # no tensorboard package
                pass
            else:
                self._tb = SummaryWriter(log_dir)

    def __call__(self, step: int, loss: float, state=None) -> None:
        now = time.time()
        if self._t0 is None:
            # first record: no interval yet (and it would include the
            # first chunk's set-up): rate 0, the clock starts here
            self._t0 = now
            self._last_t = now
            self._last_step = step
        rate = (step - self._last_step) / max(now - self._last_t, 1e-9)
        rec = {"step": step, "elbo": -loss, "steps_per_sec": rate,
               "wall": now - self._t0}
        scalars = {}
        if self.scalars_fn is not None and state is not None:
            scalars = self.scalars_fn(state)
            rec.update(scalars)
        self.history.append(rec)
        if self._tb is not None:
            self._tb.add_scalar("elbo", -loss, step)
            self._tb.add_scalar("steps_per_sec", rate, step)
            for tag, val in scalars.items():
                self._tb.add_scalar(tag, val, step)
            self._tb.flush()
        if self.print_every and (step % self.print_every == 0
                                 or step - self._last_step >= self.print_every):
            self.printer(
                f"step {step:>8d}  elbo {-loss:>14.4f}  {rate:>8.1f} steps/s")
        self._last_step = step
        self._last_t = now

    def close(self) -> None:
        """Close the TensorBoard writer, if any."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    @property
    def mean_steps_per_sec(self) -> float:
        if len(self.history) < 2:
            return float("nan")
        h0, h1 = self.history[0], self.history[-1]
        return (h1["step"] - h0["step"]) / max(h1["wall"] - h0["wall"], 1e-9)

    @property
    def median_steps_per_sec(self) -> float:
        """Median per-callback rate: robust to a single stall of the host,
        which can move the mean far."""
        rates = [h["steps_per_sec"] for h in self.history[1:]
                 if h["steps_per_sec"] > 0]
        if not rates:
            return float("nan")
        rates.sort()
        return rates[len(rates) // 2]
