#!/usr/bin/env python
"""The card's measured memory and matrix peaks, the roofline's inputs
(port of benchmarks/peak_probe.py).

Three chains of one operation each, timed by the reference's two-point
iteration fit (``two_point``, l.33-43): the median time of a chain of
``n_hi`` iterations less that of ``n_lo``, over the difference, so a
fixed cost per call (the host's launch of the chain, the final
synchronize) cancels.

- Memory: ``y = c x`` between two 512 MiB f32 arrays, far larger than
  the 50 MB L2, counting the read and the write (1 GiB per iteration):
  one vectorized kernel, the reference's ``x * c + d`` without its add,
  which eager PyTorch would run as a second kernel over the array.
- Dense bf16 tensor cores: an [8192]^3 product with an f32 output,
  ``torch.mm(..., out_dtype=torch.float32)`` as ``ops/precision.py``
  calls it (2 x 8192^3 FLOP per iteration).
- f32 outside the tensor cores: an [4096]^3 f32 product with TF32 off,
  set for the probe and restored after it.

These are library products on purpose: they measure the card, and port
no kernel. Each reading is printed beside its data-sheet value
(``utils.flops``), and ``nvidia-smi`` samples the SM clock, its maximum,
the power draw and the power limit while each probe runs. A reading
above 105% of its data-sheet value is an error of the probe's
arithmetic: the tool then exits non-zero. Without ``--quick`` each probe
then holds its load for 3 s more, so that the samples see it.

    python -m dgps_with_iwvi_torch.experiments.peak_probe \\
        [--out PEAKS.json] [--quick] [--device cpu]

``--quick`` runs shorter chains (n_lo 5, n_hi 25, 3 rounds). On ``--device
cpu`` the chains run on the host at a small size, for rehearsal: no
device rate and no data-sheet check.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from dgps_with_iwvi_torch.device import backend, resolve_device
from dgps_with_iwvi_torch.ops.hopper import cost

LIMIT = 1.05  # a reading past this share of the data sheet is impossible
LOAD_S = 3.0  # seconds each probe's load is held for the samples
SMI = "clocks.sm,clocks.max.sm,power.draw,power.limit"
SIZES = {"cuda": {"hbm": 128 * 1024 * 1024, "bf16": 8192, "f32": 4096},
         "cpu": {"hbm": 1 << 20, "bf16": 128, "f32": 128}}


def two_point(make_chain, rounds=5, n_lo=20, n_hi=100):
    """Seconds per iteration of a chain: make_chain(iters) -> (fn, args),
    fn(*args) a 0-d tensor whose ``float`` waits for the chain (the
    reference's fit, l.33-43)."""
    def run(iters):
        fn, args = make_chain(iters)
        float(fn(*args))
        ts = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            float(fn(*args))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))
    return (run(n_hi) - run(n_lo)) / (n_hi - n_lo)


def hbm_chain(n: int, device):
    """make_chain of ``y = c x`` over n f32 elements, ping-ponging between
    two arrays (one kernel, n reads and n writes an iteration)."""
    bufs = [torch.arange(n, dtype=torch.float32, device=device) * 1e-9,
            torch.empty(n, dtype=torch.float32, device=device)]

    def make(iters):
        def chain(bufs):
            for i in range(iters):
                torch.mul(bufs[i % 2], 0.999999, out=bufs[(i + 1) % 2])
            return bufs[iters % 2][0]
        return chain, (bufs,)
    return make


def matmul_chain(m: int, dtype, device):
    """make_chain of [m, m] @ [m, m] products in `dtype` with an f32
    output (``out_dtype`` for bf16, as ``ops/precision.py`` calls it)."""
    gen = torch.Generator(device=device).manual_seed(0)
    A = (torch.randn((m, m), generator=gen, device=device) * 1e-3).to(dtype)
    B = (torch.randn((m, m), generator=gen, device=device) * 1e-3).to(dtype)
    # the host has no out_dtype product: its bf16 rehearsal casts after
    card_bf16 = dtype == torch.bfloat16 and A.device.type == "cuda"
    kw = {"out_dtype": torch.float32} if card_bf16 else {}

    def make(iters):
        def chain(A, B):
            for _ in range(iters):
                out = torch.mm(A, B, **kw)
            return out[0, 0].float()
        return chain, (A, B)
    return make


class Sampler:
    """``nvidia-smi`` sampling SMI's fields every 200 ms while it is open,
    read by a thread; the block starts once the first sample is in (the
    tool takes a second to start), and ``samples`` holds those taken
    after it. Nothing on the CPU."""

    def __init__(self, device):
        self.device, self.samples = device, []
        self._proc = self._thread = None
        self._lines: list = []

    def _read(self):
        for line in self._proc.stdout:
            if line.strip():
                self._lines.append(line.strip())

    def __enter__(self):
        if self.device.type == "cuda":
            self._proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={SMI}", "--format=csv,noheader",
                 "-lms", "200", "-i", str(self.device.index or 0)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            self._thread = threading.Thread(target=self._read, daemon=True)
            self._thread.start()
            deadline = time.monotonic() + 10.0
            while not self._lines and time.monotonic() < deadline:
                time.sleep(0.05)
            self._start = len(self._lines)
        return self

    def __exit__(self, *exc):
        if self._proc is not None:
            self._proc.terminate()
            self._proc.wait(timeout=30)
            self._thread.join(timeout=30)
            self.samples = self._lines[self._start:]
        return False


def hold(make, iters: int, seconds: float) -> None:
    """Run chains of `iters` iterations back to back for `seconds`, so
    that the samples see the card under this load for that long."""
    fn, args = make(iters)
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        float(fn(*args))


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for f32 products inside the block, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def summary(samples: list) -> dict:
    """Medians and maxima of SMI's samples ("1980 MHz, 1980 MHz, 650.12 W,
    700.00 W"); {} without samples."""
    cols = []
    for line in samples:
        try:
            cols.append([float(v.split()[0]) for v in line.split(",")])
        except (ValueError, IndexError):
            continue  # a sample the card did not fill ("[N/A]")
    if not cols:
        return {}
    sm, sm_max, draw, limit = np.array(cols).T
    return {"samples": len(cols), "sm_mhz_median": float(np.median(sm)),
            "sm_mhz_max_allowed": float(sm_max.max()),
            "power_w_median": float(np.median(draw)),
            "power_w_max": float(draw.max()),
            "power_limit_w": float(limit.max())}


def probe(device="cuda", quick: bool = False) -> dict:
    """{"backend", "hbm", "bf16", "f32"}: each probe's seconds per
    iteration, rate, data-sheet rate and share of it, and the
    nvidia-smi samples taken while it ran."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    size = SIZES[device.type]
    fit = dict(rounds=3, n_lo=5, n_hi=25) if quick else {}
    load_s = 0.0 if quick or not on_card else LOAD_S
    peak_bf16, peak_f32, peak_bytes = cost.peaks()
    probes = [
        ("hbm", "bytes/s", hbm_chain(size["hbm"], device),
         2 * size["hbm"] * 4, peak_bytes,
         f"c x over {size['hbm'] * 4 >> 20} MiB f32, read + write"),
        ("bf16", "FLOP/s", matmul_chain(size["bf16"], torch.bfloat16, device),
         2 * size["bf16"] ** 3, peak_bf16,
         f"[{size['bf16']}]^3 bf16 product, f32 output"),
        ("f32", "FLOP/s", matmul_chain(size["f32"], torch.float32, device),
         2 * size["f32"] ** 3, peak_f32,
         f"[{size['f32']}]^3 f32 product, TF32 off"),
    ]
    rec = {"backend": backend(device), "quick": quick, "smi_fields": SMI}
    for name, unit, make, work, sheet, what in probes:
        with _tf32_off(), Sampler(device) as smi:
            if on_card:
                torch.cuda.synchronize()
            dt = two_point(make, **fit)
            hold(make, fit.get("n_hi", 100), load_s)
        rate = work / dt
        rec[name] = {"what": what, "s_per_iter": dt, "work_per_iter": work,
                     "unit": unit, "rate": rate, "clocks_power": smi.samples,
                     "under_load": summary(smi.samples)}
        if on_card:
            rec[name].update(data_sheet=sheet, share=rate / sheet)
    return rec


def report(rec: dict) -> list:
    lines = [f"{rec['backend']}"]
    for name in ("hbm", "bf16", "f32"):
        r = rec[name]
        scale = 1e12
        line = (f"{name}: {r['s_per_iter'] * 1e6:.1f} us/iter, {r['what']} "
                f"-> {r['rate'] / scale:.3f}e12 {r['unit']}")
        if "data_sheet" in r:
            line += (f" ({100 * r['share']:.1f}% of the data sheet's "
                     f"{r['data_sheet'] / scale:.3g}e12)")
        lines.append(line)
        u = r["under_load"]
        if u:
            lines.append(
                f"  while it ran ({u['samples']} samples): SM clock median "
                f"{u['sm_mhz_median']:.0f} MHz of "
                f"{u['sm_mhz_max_allowed']:.0f} max, power median "
                f"{u['power_w_median']:.1f} W, max {u['power_w_max']:.1f} W,"
                f" limit {u['power_limit_w']:.1f} W")
    return lines


def check(rec: dict) -> list:
    """The readings above LIMIT of their data-sheet value."""
    return [f"{name}: {100 * rec[name]['share']:.1f}% of the data sheet"
            for name in ("hbm", "bf16", "f32")
            if rec[name].get("share", 0.0) > LIMIT]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="write the record as JSON")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    rec = probe(a.device, a.quick)
    print("\n".join(report(rec)), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rec, f, indent=1)
    bad = check(rec)
    if bad:
        print("peak_probe: impossible reading (the probe's arithmetic is "
              "wrong): " + "; ".join(bad), file=sys.stderr)
        sys.exit(1)
    return rec


if __name__ == "__main__":
    main()
