"""Time the PyTorch port's kernels on one GPU.

Run from the root of a checkout of the repo (`-m` imports the port from the
current directory, so two checkouts can be compared on one card):

    python3 -m similaritysearchbyrdf_tpu_torch.ops.kernels.timing [--reps 50]

Seeded random operands at the shapes `chip_smoke.py` gives the kernels:
K1 at the bench config's D 100, T 10, C 32, P 3 (`K1_bench_query`: B 1024
with margins, as the query hashes; `K1_fit`: B 8192 without, the fit's
chunk of `fit_batch_size` rows), K2 at the bench config (B 1024 x 512
blocks of 8 rows, cs 32, 30 tables of 20,000 rows), K2b at window_1m's
(B 128 x 1024 windows of 64, cs 32, 10
tables of 2^20 rows, 38% of windows live; `K2b_window_1m` with every slot of
a live window valid, `K2b_window_1m_ragged` laid out as the 1M fit's query
lays them out, each query's live windows a prefix of its 1024, 28.8% of
all slots valid, ranges cutting live windows) and at flat_20k's re-score
(B 1024 x 30 windows of 64, cs 128, the int8 sketch as one table), K3 at
folded_8m's (10 tables of 2^20 folded rows of 128 lanes, cs 16, B 64 x 128
live windows of 512 rows, each query's windows consecutive from one random
row of one table, as the folded query lays them out; with and without the
second output), and K4 int8 at flat_20k's (unpacked, B 1024 x 24,576 x 128)
and flat_8m's (B 1024 x 8,003,584 x 96: packed, unpacked, and packed with
the supergroup tier of 16 groups). `K2_bench_fit` times K2 on the operands
of `chip_smoke.py`'s kernels phase instead: the bench corpus
(`bench.make_data(seed=42)`), the bench config's fit and the blocks of its
first 1,024 queries, made by the checkout's own forest; `K2b_window_1m_fit`
times K2b on the operands of its kernels_window: the same 1M corpus,
fit and 128 queries' windows, made by the checkout's own forest (each
`*_operands` entry counts them, so two checkouts can be shown to time the
same ones). `flat_8m_query` times the whole flat engine at flat_8m's shape:
`FlatIndex()` at its defaults fitted on 8,000,000 x 96 unit vectors around
50,000 seeded centres (made on the card), 1,024 of them as queries, host
clock around `query_device` and a sync (its qps is 1,024 / that time).
`K1_one_row` times K1 on one row (B 1, margins) and `floor_one_block` K2 on
one block: what a launch costs whatever its work. `host` times the K1 and
K2 wrappers' host work step by step on the host clock (`wrapper_host_us`),
at K1_bench_query's and K2_bench's operands. The sparse_1m entries time the
two kernels at the sparse path's D 4096: `K4_sparse_1m` the sparse flat
engine's scan (int8, B 1024 x 1,007,616 x 4096, G 64, unpacked),
`K1_sparse_fit` and `K1_sparse_query` the hash of densified rows (B 8192
and 64, T 10, P 3, C 32, no margins); beside each, `product_ms` times the
product alone (device time, as `device_ms`) as a yardstick the port never
calls (`torch._int_mm` in slabs
of 131,072 rows for K4, a full-f32 `torch.matmul` for K1), which is not the
same function. `K1_width` times K1 at D 128-1024 (B 64 and 8192 without
margins, B 1024 with), the widths around the narrow and wide forms'
crossover. `K2b_sparse_flat` times K2b at the sparse flat engine's exact2
re-score: the int8 sketch of 1,007,616 x 4096 as one table, B 1024 x 30
windows of 64 rows, every window live; each query's 30 windows are distinct
and drawn uniformly from the first 15,300 of the sketch's 15,744, which
makes about 13,260 distinct windows of 30,720, the share the smoke's
operands have (3.47 of 8.05 GB). `K2b_ivf_256` times it at persist_1m's
loaded IVF query: 200,000 rows of cs 128 in 781 clusters of 64-448 rows,
B 1024 queries each probing 32 distinct clusters drawn uniformly (about 42
queries a cluster, as IVF's), their windows of 256 rows laid out by
`ops/ivf.py`'s own `_flatten_windows`. `K2_sparse_cs64` times K2 at the
sparse tier's cs 64: 30 tables of 1,007,680 rows, B 64 x 2048 blocks of 8
drawn from 410,000 positions, which leaves the smoke's distinct share
(57.5 of 67.1 MB). Each prints its gathered and distinct bytes under
`share`.
`--only K3` times only the entries whose names start with one of the given
prefixes. Prints the card's name and power limit, then one JSON line of
medians of `--reps` timings (ms) after 3 warm-up calls, two per kernel
(`median_event_ms`): `ms`, CUDA events around one call on an idle card,
which counts the wrapper's host time (its Python checks, the output
allocation and the launch) in any kernel shorter than that; and
`device_ms`, the same with the card first held busy, which times the
device alone.
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

BUSY_CYCLES = 2_000_000   # about 1 ms of device spin at the H100's 1.98 GHz


def median_event_ms(fn, reps: int, warm: int = 3, busy: bool = False) -> float:
    """Median CUDA-event time of one call of `fn` on the current device,
    after `warm` calls. Without `busy` the start event fires on an idle card,
    so the time counts the host's work in `fn` until its kernel is enqueued
    (a kernel's `ms`). With `busy` the card first spins for about a
    millisecond, the host's work overlaps the spin, and the events time the
    device alone (a kernel's `device_ms`)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if busy:
            torch.cuda._sleep(BUSY_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_times(fn, reps: int) -> dict:
    """A kernel's `ms` and `device_ms` (`median_event_ms`)."""
    return {"ms": median_event_ms(fn, reps), "device_ms": median_event_ms(fn, reps, busy=True)}


def host_us(fn, reps: int, sync_every: int = 64) -> float:
    """Median host-clock µs of one call of `fn`, after 3 warm-up calls. No
    sync falls inside a timed call: the card is synchronised every
    `sync_every` calls, between them, so launches never fill the queue."""
    times = []
    for i in range(reps + 3):
        if i % sync_every == 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times[3:])) * 1e6


def wrapper_host_us(wrapper, lib_call, out_shapes, check_operands, reps: int) -> dict:
    """A kernel wrapper's host work, step by step (`host_us` each): the
    whole `wrapper` call (its kernel enqueued, not waited for), its operand
    check (`check_operands`), the allocation of its outputs (`out_shapes`:
    (shape, dtype) pairs), `build.library()`, the current stream through
    `torch.cuda.current_stream` and as the raw handle, and the ctypes launch
    with its argument conversion (`lib_call(lib, stream)` on preallocated
    outputs). What the wrapper takes beyond the steps it runs is its own
    Python: shape and type checks, bookkeeping."""
    from . import build

    dev = torch.device("cuda", torch.cuda.current_device())
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    steps = {
        "wrapper": wrapper,
        "check_operands": check_operands,
        "alloc": lambda: [torch.empty(sh, dtype=dt, device=dev) for sh, dt in out_shapes],
        "library": build.library,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "ctypes_launch": lambda: lib_call(lib, stream),
    }
    return {name: host_us(fn, reps) for name, fn in steps.items()}


def bench_config(**kw):
    """`bench.py`'s index config (`bench.py:88-118`, with
    use_pallas_hash=True) as the port's `RDFConfig`, with `kw` replaced."""
    from ... import RDFConfig, TableConfig

    return RDFConfig(
        vector_dim=100, table_num=10, permutation_num=3, family_size=100, partition_bits=3,
        lsh_table=TableConfig(chain_length=32, bucket_overflow=500), query_batch_size=1024,
        max_candidates=4096, top_k=10, seed=31258, coarse_dim=32, coarse_dtype="int8",
        coarse_refine=384, use_pallas_hash=True).replace(**kw)


def block_operands(forest, xb) -> tuple:
    """K2's arguments (tier, q_low, table, blk_start, bs) for the block-mode
    query of the rows `xb` on the fitted `forest`: margin probes (budget 16,
    the bench query's), then the 8-slot blocks of up to the config's m_cap
    slots, as the query lays them out."""
    from ...index import forest as F

    state, layout = forest.state, forest.layout
    h, margins = F.hash_dense_with_margins(state.model, xb)
    probes, pvalid = F._probe_hashes_margin(h, margins, layout, 16)
    home = F.partition_of_hash(h, state.part_proj)
    base, table, _, _, _, bs = F.gather_blocks(
        state.tables, h, home, layout, 0, forest.conf.max_candidates, True, probes, pvalid)
    blk_start = base + torch.arange(base.shape[1], device=xb.device) * bs
    q_low = (xb @ state.coarse_proj).to(torch.bfloat16).contiguous()
    return (state.coarse_tier, q_low, table.to(torch.int32).contiguous(),
            blk_start.to(torch.int32).contiguous(), bs)


def block_fit_operands(dev) -> tuple:
    """K2's operands in `chip_smoke.py`'s kernels phase: the bench config
    fitted on the bench corpus (`bench.make_data(seed=42)`, from the
    checkout's root), and the blocks of its first 1,024 rows as queries.
    Returns the kernel's arguments and a count of them."""
    from bench import make_data

    from ... import DenseBatch, RDFForest

    x = torch.as_tensor(make_data(seed=42), device=dev)
    forest = RDFForest(bench_config(), device=dev).fit(
        DenseBatch(np.arange(x.shape[0], dtype=np.int32), x))
    ops = block_operands(forest, x[:1024].contiguous())
    tier, q_low, table, blk, _ = ops
    count = {"blocks": table.numel(), "index_sum": int(table.long().sum() + blk.long().sum()),
             "tier_sum": int(tier.long().sum()), "query_sum": float(q_low.float().sum())}
    return ops, count


def window_operands(big, xq, m_cap: int, probe_budget: int) -> tuple:
    """K2b's arguments (tier, q_low, table, blk_start, start, end, live, win)
    for the window-mode query of the rows `xq` on the fitted forest `big`:
    margin probes, then the aligned 64-slot windows of up to `m_cap` slots,
    as the query lays them out."""
    from ...index import forest as F

    state, layout = big.state, big.layout
    h, margins = F.hash_dense_with_margins(state.model, xq)
    probes, pvalid = F._probe_hashes_margin(h, margins, layout, probe_budget)
    home = F.partition_of_hash(h, state.part_proj)
    base, table, start, end, _, win = F.gather_blocks(
        state.tables, h, home, layout, 0, m_cap, True, probes, pvalid, window=64)
    tier = state.coarse_tier
    blk = torch.clamp(base + torch.arange(base.shape[1], device=xq.device) * win,
                      max=tier.shape[1] - win)
    live = ((blk < end) & (blk + win > start)).contiguous()
    args = [a.to(torch.int32).contiguous() for a in (table, blk, start, end)]
    q_low = (xq @ state.coarse_proj).to(torch.bfloat16).contiguous()
    return (tier, q_low, *args, live, win)


def window_fit_operands(dev) -> tuple:
    """K2b's operands in `chip_smoke.py`'s kernels_window: the 1M x 100
    clustered corpus (seed 7, 20,000 centres, noise 0.05), the bench config
    with a head tier, and the windows of the first 128 queries at m_cap
    65536 (probe budget 16). Returns the kernel's arguments and a count of
    them."""
    from ... import DenseBatch, RDFForest

    n, d = 1_000_000, 100
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(20_000, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, 20_000, n)] + 0.05 * rng.normal(size=(n, d))
    x = torch.as_tensor((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32),
                        device=dev)
    big = RDFForest(bench_config(coarse_head_pool=64), device=dev).fit(
        DenseBatch(np.arange(n, dtype=np.int32), x))
    ops = window_operands(big, x[:128].contiguous(), 65536, 16)
    tier, q_low, table, blk, start, end, live, win = ops
    pos = blk.long()[..., None] + torch.arange(win, device=dev)
    valid = live[..., None] & (pos >= start[..., None]) & (pos < end[..., None])
    count = {"live_windows": int(live.sum()), "valid_slots": int(valid.sum()),
             "index_sum": int(sum(a.long().sum() for a in (table, blk, start, end))),
             "tier_sum": int(tier.long().sum()), "query_sum": float(q_low.float().sum())}
    return ops, count


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--only", nargs="*", default=[],
                    help="time only entries whose names start with one of these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("timing: needs a CUDA device", file=sys.stderr)
        return 2
    from . import build
    from . import coarse_fold as K3
    from . import coarse_gather as K2
    from . import flat_groupmax as K4
    from . import hash_kernel as K1

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

    def wanted(*names):
        return not args.only or any(n.startswith(p) for n in names for p in args.only)

    out, device, info, product = {}, {}, {}, {}

    def timed(name, fn):
        t = kernel_times(fn, args.reps)
        out[name], device[name] = t["ms"], t["device_ms"]

    if wanted("K1_bench_query", "K1_fit", "K1_one_row", "host"):
        # the bench config's hash model shapes: T 10 chains of C 32 over D 100, P 3
        kgen = torch.Generator(device=dev).manual_seed(1)
        proj = torch.randn((10, 32, 100), generator=kgen, device=dev)
        perm = torch.stack([torch.stack([torch.randperm(32, generator=kgen, device=dev)
                                         for _ in range(3)]) for _ in range(10)]).to(torch.int32)
        xq = torch.randn((1024, 100), generator=kgen, device=dev)
        xf = torch.randn((8192, 100), generator=kgen, device=dev)
        if wanted("K1_bench_query"):
            timed("K1_bench_query", lambda: K1.hash_dense_kernel(xq, proj, perm, True))
        if wanted("K1_fit"):
            timed("K1_fit", lambda: K1.hash_dense_kernel(xf, proj, perm))
        if wanted("K1_one_row"):
            x1 = xq[:1].contiguous()
            timed("K1_one_row", lambda: K1.hash_dense_kernel(x1, proj, perm, True))
    if wanted("K2_bench", "host"):
        tier, q = i8(30, 20_000, 32), bf16(1024, 32)
        table, blk = ints(0, 30, (1024, 512)), ints(0, 20_000 - 8, (1024, 512))
        if wanted("K2_bench"):
            timed("K2_bench", lambda: K2.coarse_block_scores_kernel(tier, q, table, blk, 8))
    if wanted("host"):
        h1 = torch.empty((1024, 30), dtype=torch.int64, device=dev)
        m1 = torch.empty((1024, 30, 32), device=dev)
        s2 = torch.empty((1024, 512, 8), device=dev)
        info["host_us_K1_bench_query"] = wrapper_host_us(
            lambda: K1.hash_dense_kernel(xq, proj, perm, True),
            lambda lib, s: lib.rdf_hash_dense(
                xq.data_ptr(), proj.data_ptr(), perm.data_ptr(), h1.data_ptr(), m1.data_ptr(),
                1024, 100, 10, 32, 3, s),
            [((1024, 30), torch.int64), ((1024, 30, 32), torch.float32)],
            lambda: build.check_operands("hash_dense_kernel", xq.device, x=xq, proj=proj,
                                         perm=perm), 2000)
        info["host_us_K2_bench"] = wrapper_host_us(
            lambda: K2.coarse_block_scores_kernel(tier, q, table, blk, 8),
            lambda lib, s: lib.rdf_coarse_block_scores(
                tier.data_ptr(), q.data_ptr(), table.data_ptr(), blk.data_ptr(), s2.data_ptr(),
                30, 20_000, 32, 1024, 512, 8, 0, s),
            [((1024, 512, 8), torch.float32)],
            lambda: build.check_operands("coarse_block_scores_kernel", tier.device,
                                         ("tier", "q_low"), tier=tier, q_low=q, table=table,
                                         blk_start=blk), 2000)
    if wanted("K2_bench_fit"):
        blk_args, info["K2_bench_fit_operands"] = block_fit_operands(dev)
        timed("K2_bench_fit", lambda: K2.coarse_block_scores_kernel(*blk_args))
        del blk_args

    if wanted("K2b_window_1m", "K2b_window_1m_ragged"):
        tier, q = i8(10, 1 << 20, 32), bf16(128, 32)
        table, blk = ints(0, 10, (128, 1024)), ints(0, ((1 << 20) - 64) // 8, (128, 1024)) * 8
        live = torch.rand((128, 1024), generator=gen, device=dev) < 0.38
        end = blk + 64
        if wanted("K2b_window_1m"):
            timed("K2b_window_1m", lambda: K2.coarse_window_scores_kernel(
                tier, q, table, blk, blk, end, live, 64))
        if wanted("K2b_window_1m_ragged"):
            # the 1M fit's layout and shares: a query's live windows are a
            # prefix of its 1024 (its share drawn uniformly from 18-58%, 38%
            # on average), and a live window is cut with probability 0.4842
            # by 1-63 slots (uniform) at its start or its end, leaving 75.8%
            # of its slots valid on average, 28.8% of all slots; a dead
            # window's range is empty. Its own generator keeps the other
            # entries' operands as before.
            rgen = torch.Generator(device=dev).manual_seed(8)
            share = torch.rand((128, 1), generator=rgen, device=dev) * 0.40 + 0.18
            r_live = torch.arange(1024, device=dev) < (share * 1024).round()
            cut = torch.where(torch.rand((128, 1024), generator=rgen, device=dev) < 0.4842,
                              torch.randint(1, 64, (128, 1024), generator=rgen, device=dev,
                                            dtype=torch.int32), 0)
            at_end = torch.rand((128, 1024), generator=rgen, device=dev) < 0.5
            r_start = torch.where(r_live & ~at_end, blk + cut, blk)
            r_end = torch.where(r_live, torch.where(at_end, end - cut, end), blk)
            timed("K2b_window_1m_ragged", lambda: K2.coarse_window_scores_kernel(
                tier, q, table, blk, r_start, r_end, r_live, 64))

    if wanted("K3_folded_8m", "K3_folded_8m_emit2"):
        b, mb, wpr, capf = 64, 128, 512, 1 << 20
        folded, qi8 = i8(10, capf, 128), i8(b, 16)
        table = ints(0, 10, (b, 1)).expand(b, mb).contiguous()
        rs = (ints(0, (capf - mb * wpr) // 8, (b, 1)) * 8
              + torch.arange(mb, device=dev, dtype=torch.int32) * wpr).contiguous()
        for name, emit2 in (("K3_folded_8m", False), ("K3_folded_8m_emit2", True)):
            if wanted(name):
                timed(name, lambda: K3.coarse_rowmax_kernel(
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
            timed("K2b_flat_20k", lambda: K2.coarse_window_scores_kernel(
                sk[None], q, zeros, blk, zeros, n_end, live, 64))
        if wanted("K4_flat_20k_unpacked"):
            q8 = i8(1024, 128)
            timed("K4_flat_20k_unpacked", lambda: K4.flat_groupmax_kernel(sk, q8, 64))
    if wanted("K2b_window_1m_fit"):
        fit_args, info["K2b_window_1m_fit_operands"] = window_fit_operands(dev)
        timed("K2b_window_1m_fit", lambda: K2.coarse_window_scores_kernel(*fit_args))
        del fit_args
        torch.cuda.empty_cache()
    k4_8m = {"K4_flat_8m_packed": dict(pack_arg=True), "K4_flat_8m_unpacked": {},
             "K4_flat_8m_emit16": dict(pack_arg=True, emit_sg=16)}
    if wanted(*k4_8m):
        sk, q8 = i8(8_003_584, 96), i8(1024, 96)
        for name, kw in k4_8m.items():
            if wanted(name):
                timed(name, lambda: K4.flat_groupmax_kernel(sk, q8, 64, **kw))
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
    if wanted("K1_sparse_fit", "K1_sparse_query"):
        from ..precision import full_f32

        # sparse_1m's hash model shapes at D 4096: T 10 chains of C 32, P 3
        kgen = torch.Generator(device=dev).manual_seed(2)
        proj = torch.randn((10, 32, 4096), generator=kgen, device=dev)
        perm = torch.stack([torch.stack([torch.randperm(32, generator=kgen, device=dev)
                                         for _ in range(3)]) for _ in range(10)]).to(torch.int32)
        pmat = proj.view(320, 4096)
        for name, b in (("K1_sparse_fit", 8192), ("K1_sparse_query", 64)):
            if wanted(name):
                x = torch.randn((b, 4096), generator=kgen, device=dev)
                timed(name, lambda: K1.hash_dense_kernel(x, proj, perm))
                with full_f32():
                    product[name] = median_event_ms(lambda: torch.matmul(x, pmat.T), args.reps,
                                                    busy=True)
    if wanted("K1_width"):
        wgen = torch.Generator(device=dev).manual_seed(3)
        for d in (128, 192, 256, 384, 512, 1024):
            proj = torch.randn((10, 32, d), generator=wgen, device=dev)
            perm = torch.stack([torch.stack([torch.randperm(32, generator=wgen, device=dev)
                                             for _ in range(3)])
                                for _ in range(10)]).to(torch.int32)
            for b, margins in ((64, False), (1024, True), (8192, False)):
                x = torch.randn((b, d), generator=wgen, device=dev)
                timed(f"K1_width_d{d}_b{b}", lambda: K1.hash_dense_kernel(x, proj, perm, margins))
    if wanted("K4_sparse_1m"):
        sk, q8 = i8(1_007_616, 4096), i8(1024, 4096)
        timed("K4_sparse_1m", lambda: K4.flat_groupmax_kernel(sk, q8, 64))

        def int_mm_slabs():
            for r0 in range(0, sk.shape[0], 131_072):
                torch._int_mm(q8, sk[r0:r0 + 131_072].t())

        product["K4_sparse_1m"] = median_event_ms(int_mm_slabs, args.reps, busy=True)
        del sk
        torch.cuda.empty_cache()
    if wanted("K2b_sparse_flat"):
        npad, win, b, mb = 1_007_616, 64, 1024, 30
        sk = i8(1, npad, 4096)
        q = bf16(b, 4096)
        pick = torch.rand((b, 15_300), generator=gen, device=dev).argsort(dim=1)[:, :mb]
        blk = (pick * win).to(torch.int32).contiguous()
        zeros = torch.zeros_like(blk)
        n_end, live = torch.full_like(blk, npad), torch.ones_like(blk, dtype=torch.bool)
        info["K2b_sparse_flat_share"] = {
            "gathered_bytes": b * mb * win * 4096,
            "distinct_bytes": int(torch.unique(blk).numel()) * win * 4096}
        timed("K2b_sparse_flat", lambda: K2.coarse_window_scores_kernel(
            sk, q, zeros, blk, zeros, n_end, live, win))
        del sk
        torch.cuda.empty_cache()
    if wanted("K2b_ivf_256"):
        from ..ivf import _flatten_windows, ivf_window_budget

        n, kc, nprobe, win, b = 200_000, 781, 32, 256, 1024
        # the IVF layout: each cluster's rows from an 8-aligned start, as
        # `_cluster_perm` lays them out (starts [K+1], true ends [K])
        sizes = torch.randint(64, 449, (kc,), generator=gen, device=dev)
        sizes = (sizes * n // sizes.sum()).clamp(min=1)
        sizes[-1] += n - sizes.sum()
        starts = torch.zeros(kc + 1, dtype=torch.int64, device=dev)
        starts[1:] = torch.cumsum((sizes + 7) // 8 * 8, 0)
        ends = starts[:-1] + sizes
        npad = int(starts[-1])
        sk = i8(npad, 128)
        q = bf16(b, 128)
        sel = torch.rand((b, kc), generator=gen, device=dev).argsort(dim=1)[:, :nprobe]
        wb = ivf_window_budget(starts, ends, nprobe, win)
        blk, end_b, live = _flatten_windows(starts[sel], ends[sel], win, wb)
        blk_dma = blk.clamp(max=npad - win)
        ivf_args = (sk[None], q, torch.zeros_like(blk, dtype=torch.int32),
                    blk_dma.to(torch.int32).contiguous(), blk.to(torch.int32).contiguous(),
                    end_b.to(torch.int32).contiguous(), live.contiguous(), win)
        valid = live & (blk < end_b)
        info["K2b_ivf_256_share"] = {
            "windows": list(blk.shape),
            "gathered_bytes": int(valid.sum()) * win * 128,
            "distinct_bytes": int(torch.unique(blk_dma[valid]).numel()) * win * 128}
        timed("K2b_ivf_256", lambda: K2.coarse_window_scores_kernel(*ivf_args))
        del sk, ivf_args
    if wanted("K2_sparse_cs64"):
        l, caprows, b, mb = 30, 1_007_680, 64, 2048
        tier, q = i8(l, caprows, 64), bf16(b, 64)
        pos = torch.randint(0, l * (caprows - 8), (410_000,), generator=gen, device=dev)
        pick = pos[torch.randint(0, 410_000, (b, mb), generator=gen, device=dev)]
        table = (pick // (caprows - 8)).to(torch.int32).contiguous()
        blk = (pick % (caprows - 8)).to(torch.int32).contiguous()
        info["K2_sparse_cs64_share"] = {
            "gathered_bytes": b * mb * 8 * 64,
            "distinct_bytes": int(torch.unique(
                (pick[..., None] // (caprows - 8)) * caprows + pick[..., None] % (caprows - 8)
                + torch.arange(8, device=dev)).numel()) * 64}
        timed("K2_sparse_cs64", lambda: K2.coarse_block_scores_kernel(tier, q, table, blk, 8))
        del tier
        torch.cuda.empty_cache()
    if wanted("floor"):
        # the timer's floor: K2 on one 8-row block, about the least any launch does
        t1, q1, i1 = i8(1, 64, 32), bf16(1, 32), ints(0, 1, (1, 1))
        timed("floor_one_block", lambda: K2.coarse_block_scores_kernel(t1, q1, i1, i1, 8))
    print(json.dumps({"checkout": os.getcwd(), "reps": args.reps, "ms": out,
                      "device_ms": device, **({"product_ms": product} if product else {}),
                      **info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
