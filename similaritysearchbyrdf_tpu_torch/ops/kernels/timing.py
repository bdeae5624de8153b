"""Time the PyTorch port's coarse-score and group-max kernels on one GPU.

Run from the root of a checkout of the repo (`-m` imports the port from the
current directory, so two checkouts can be compared on one card):

    python3 -m similaritysearchbyrdf_tpu_torch.ops.kernels.timing [--reps 50]

Seeded random operands at the shapes `chip_smoke.py` gives the kernels:
K2 at the bench config (B 1024 x 512 blocks of 8 rows, cs 32, 30 tables of
20,000 rows), K2b at window_1m's (B 128 x 1024 windows of 64, cs 32, 10
tables of 2^20 rows, 38% of windows live) and at flat_20k's re-score
(B 1024 x 30 windows of 64, cs 128, the int8 sketch as one table), K3 at
folded_8m's (10 tables of 2^20 folded rows of 128 lanes, cs 16, B 64 x 128
live windows of 512 rows, each query's windows consecutive from one random
row of one table, as the folded query lays them out; with and without the
second output), and K4 int8 at flat_20k's (unpacked, B 1024 x 24,576 x 128)
and flat_8m's (B 1024 x 8,003,584 x 96: packed, unpacked, and packed with
the supergroup tier of 16 groups). `flat_8m_query` times the whole flat
engine at flat_8m's shape instead: `FlatIndex()` at its defaults fitted on
8,000,000 x 96 unit vectors around 50,000 seeded centres (made on the card),
1,024 of them as queries, host clock around `query_device` and a sync (its
qps is 1,024 / that time). `--only K3` times only the entries whose names
start with one of the given prefixes. Prints the card's name and power
limit, then one JSON line of medians of `--reps` timings (ms) after 3
warm-up calls.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--only", nargs="*", default=[],
                    help="time only entries whose names start with one of these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("timing: needs a CUDA device", file=sys.stderr)
        return 2
    from . import coarse_fold as K3
    from . import coarse_gather as K2
    from . import flat_groupmax as K4

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def median_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(args.reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def wanted(*names):
        return not args.only or any(n.startswith(p) for n in names for p in args.only)

    out = {}
    if wanted("K2_bench"):
        tier, q = i8(30, 20_000, 32), bf16(1024, 32)
        table, blk = ints(0, 30, (1024, 512)), ints(0, 20_000 - 8, (1024, 512))
        out["K2_bench"] = median_ms(lambda: K2.coarse_block_scores_kernel(tier, q, table, blk, 8))

    if wanted("K2b_window_1m"):
        tier, q = i8(10, 1 << 20, 32), bf16(128, 32)
        table, blk = ints(0, 10, (128, 1024)), ints(0, ((1 << 20) - 64) // 8, (128, 1024)) * 8
        live = torch.rand((128, 1024), generator=gen, device=dev) < 0.38
        end = blk + 64
        out["K2b_window_1m"] = median_ms(lambda: K2.coarse_window_scores_kernel(
            tier, q, table, blk, blk, end, live, 64))

    if wanted("K3_folded_8m", "K3_folded_8m_emit2"):
        b, mb, wpr, capf = 64, 128, 512, 1 << 20
        folded, qi8 = i8(10, capf, 128), i8(b, 16)
        table = ints(0, 10, (b, 1)).expand(b, mb).contiguous()
        rs = (ints(0, (capf - mb * wpr) // 8, (b, 1)) * 8
              + torch.arange(mb, device=dev, dtype=torch.int32) * wpr).contiguous()
        for name, emit2 in (("K3_folded_8m", False), ("K3_folded_8m_emit2", True)):
            if wanted(name):
                out[name] = median_ms(lambda: K3.coarse_rowmax_kernel(
                    folded, qi8, table, rs, wpr, 8, 6, emit2))
        del folded

    if wanted("K2b_flat_20k", "K4_flat_20k_unpacked"):
        sk = i8(24_576, 128)
        sk[20_000:] = 0
        q = bf16(1024, 128)
        zeros = torch.zeros((1024, 30), dtype=torch.int32, device=dev)
        blk = ints(0, 20_000 // 64, (1024, 30)) * 64
        n_end, live = torch.full_like(zeros, 20_000), torch.ones_like(zeros, dtype=torch.bool)
        if wanted("K2b_flat_20k"):
            out["K2b_flat_20k"] = median_ms(lambda: K2.coarse_window_scores_kernel(
                sk[None], q, zeros, blk, zeros, n_end, live, 64))
        if wanted("K4_flat_20k_unpacked"):
            q8 = i8(1024, 128)
            out["K4_flat_20k_unpacked"] = median_ms(lambda: K4.flat_groupmax_kernel(sk, q8, 64))
    k4_8m = {"K4_flat_8m_packed": dict(pack_arg=True), "K4_flat_8m_unpacked": {},
             "K4_flat_8m_emit16": dict(pack_arg=True, emit_sg=16)}
    if wanted(*k4_8m):
        sk, q8 = i8(8_003_584, 96), i8(1024, 96)
        for name, kw in k4_8m.items():
            if wanted(name):
                out[name] = median_ms(lambda: K4.flat_groupmax_kernel(sk, q8, 64, **kw))
    if wanted("flat_8m_query"):
        from ...ops.flat import FlatIndex
        from ...vectors import DenseBatch

        n, d = 8_000_000, 96
        centres = torch.randn((50_000, d), generator=gen, device=dev)
        pick = torch.randint(0, 50_000, (n,), generator=gen, device=dev)
        x = centres[pick] / centres[pick].norm(dim=1, keepdim=True)
        x += 0.05 * torch.randn((n, d), generator=gen, device=dev)
        x /= x.norm(dim=1, keepdim=True)
        del centres, pick
        flat = FlatIndex(device=dev).fit(DenseBatch(np.arange(n, dtype=np.int32), x))
        queries, qids = x[:1024].clone(), np.arange(1024, dtype=np.int32)
        del x
        times = []
        for i in range(3 + args.reps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            flat.query_device(queries, k=10, query_ids=qids)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        out["flat_8m_query"] = float(np.median(times[3:]))
    print(json.dumps({"checkout": os.getcwd(), "reps": args.reps, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
