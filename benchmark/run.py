#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (a configuration under a traffic
mix) and its metrics are named in `BENCHMARK.json`; their files are found
by name (`benchmark/lib/cell.py`). The run draws its corpus and queries
on the card from `--seed`, fits the system under test (the PyTorch/CUDA
package `similaritysearchbyrdf_tpu_torch`), warms up, measures a window of
`--seconds` seconds, and checks a sample of the window's answers against
the plain reference in `benchmark/reference/`. Its last line on standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` `breakdown`, the seconds of each phase
(`phases`), and last `check`, each compared number beside its limit; the
same numbers are the last lines on standard error.

It exits non-zero and prints no result when no CUDA card is visible, when
fewer cards are visible than the cell asks for, when the program cannot be
loaded, or when the JAX package (or jax, jaxlib, flax) was loaded in the
process. Kernel builds go to `build/` inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "similaritysearchbyrdf_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def finite(obj):
    """The result with every non-finite float written as the largest finite
    one of its sign (JSON has no infinity; a NaN reads as +max), so the line
    parses and a limit still fails."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return -sys.float_info.max if obj < 0 else sys.float_info.max
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches of the kernel builders at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from benchmark.lib import cell as cells

    bench = cells.benchmark()
    spec = cells.workload(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"run: the cell needs {spec['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    from benchmark.lib.runner import run_cell

    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"run: the process loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    result = finite(result)
    for name, v in result["check"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
