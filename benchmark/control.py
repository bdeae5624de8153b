#!/usr/bin/env python3
"""The control of `correct`: the plain reference, one step of precision lower
(f32 to TF32, bf16 to fp8, int8 to int4; `reference/common.Precision`),
put in the program's place, must come out not correct.

    python3 benchmark/control.py --workload <cell> [<cell> ...] --seeds <n> [<n> ...] \
        [--seconds 2]

runs each cell once a seed through the harness (`lib/runner.run_cell`)
with the control as the system under test, at the cell's own sizes and
traffic, and prints one JSON line a run: the cell, the seed, `correct` and
each compared number beside its limit. The benchmark's own runs never run
it. The numbers it reads are the upper readings the limits in the
configurations' `check_limits` are set below.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def control_engine(base):
    """An engine module whose system under test is `base`'s reference at
    the control's precision."""
    import torch

    ref = base.reference

    def build(cfg, device):
        return {"device": torch.device(device), "cfg": cfg}

    def fit(state, corpus):
        state["index"] = ref.build(state["cfg"], corpus, control=True)

    def query(state, cfg, queries):
        q = torch.as_tensor(queries, device=state["device"])
        out = [state["index"].query(q[i:i + base.REF_BATCH], cfg["k"])
               for i in range(0, q.shape[0], base.REF_BATCH)]
        ids = torch.cat([o[0] for o in out]).cpu().numpy()
        return ids, torch.cat([o[1] for o in out]).cpu().numpy()

    return types.SimpleNamespace(build=build, fit=fit, query=query, reference=ref,
                                 REF_BATCH=base.REF_BATCH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    from benchmark.lib import cell as cells
    from benchmark.lib.runner import run_cell

    bench = cells.benchmark()
    for name in args.workload:
        base = cells.engine(cells.config(bench, cells.workload(bench, name)["config"]))
        for seed in args.seeds:
            t0 = time.perf_counter()
            r = run_cell(bench, name, seed, args.seconds, False, "cuda:0", t0,
                         engine=control_engine(base))
            print(json.dumps({"workload": name, "seed": seed, "correct": r["correct"],
                              "answers": r["attempted"], "check": r["check"],
                              "seconds": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
