#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA card. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its
limit); the same numbers end standard error. ``--trace 0`` measures the
cell's end-to-end metrics, ``--trace 1`` its per-layer ones from a
profiler trace. Without a card, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded once the window has closed, it
exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed place inside the checkout
CACHE = ROOT / ".perfbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "dgps_with_iwvi_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    a = parse_args(argv)
    import torch

    from perfbench import harness

    bench = harness.load_benchmark(ROOT)
    chips = harness.cell_entry(bench, a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # one intra-op thread: with a pool of four, the scoring loop's tail
    # latency swung 10-19 ms from one 10 s stretch to the next, with
    # one it held 9.5-10.2 ms
    torch.set_num_threads(1)
    result = harness.run(ROOT, a.workload, a.seed, a.seconds,
                         bool(a.trace), T0, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded {', '.join(bad)}; the port must not",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
