"""One run of one cell: set-up, the measured window, the traced slice, the check.

Set-up (counted in `setup_s`, from the start of the process): the program
and its kernel library loaded (built on a cold checkout), the corpus and
queries drawn on the device from the seed, their exact ground truth, the
program's fit (`build_s`), and warm-up calls of the cell's own shapes.
Then the window (`window.run`), tracing off. A traced run (`trace`) then
profiles a fixed slice of `trace_calls` further calls with the per-layer
readers' ranges installed. Last, with the program freed, the check: the
corpus is drawn again from the seed and the plain reference answers a
sample of the window's queries (`check.py`). Nothing of the check counts
in any metric.
"""

from __future__ import annotations

import gc
import time
import types
from typing import Optional

import numpy as np
import torch

from . import cell as cells
from . import check, data, hooks, trace as tracing, truth, window


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _deep_update(base: dict, over: dict) -> dict:
    out = dict(base)
    for key, val in over.items():
        out[key] = _deep_update(out[key], val) if isinstance(val, dict) and key in out else val
    return out


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None, engine=None) -> dict:
    """→ the result line's dict (with `check` last). `overrides` and
    `traffic_overrides` change the configuration and the traffic mix (tests
    run tiny sizes on the CPU); `engine` replaces the engine module (tests
    plant faults in it)."""
    device = torch.device(device)
    cellspec = cells.workload(bench, name)
    cfg = cells.config(bench, cellspec["config"])
    if overrides:
        cfg = _deep_update(cfg, overrides)
    traffic = {**cells.traffic(cellspec["traffic"]), **(traffic_overrides or {})}
    eng = engine or cells.engine(cfg)
    k, per = cfg["k"], traffic["queries_per_call"]
    phases = {}
    truth.f32_matmuls()
    if device.type == "cuda":
        from similaritysearchbyrdf_tpu_torch.ops.kernels import build as kernel_build

        kernel_build.library()                   # built here on a cold checkout
    program = eng.build(cfg, device)
    phases["imports_and_library_s"] = time.perf_counter() - t_start

    t0 = time.perf_counter()
    x, q = data.make(cfg, seed, device)
    _sync(device)
    phases["data_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gt = truth.exact_topk(x, q, k)
    _sync(device)
    phases["ground_truth_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.fit(program, x)
    _sync(device)
    build_s = phases["fit_s"] = time.perf_counter() - t0
    del x
    q_host = q.cpu().numpy()
    pool = q_host.shape[0]

    def call(qq):
        return eng.query(program, cfg, qq)

    t0 = time.perf_counter()
    for i in range(traffic["warmup_calls"]):
        call(q_host[window.pool_slice(i * per, per, pool)])
    _sync(device)
    phases["warmup_s"] = time.perf_counter() - t0
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    win = window.run(call, q_host, per, k, seconds)
    _sync(device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    # the median call of each quarter of the window: how the host drifts in a run
    phases["window_quarters_call_ms"] = [
        float(np.median(p)) * 1e3 if p.size else None
        for p in np.array_split(np.asarray(win["latencies_s"]), 4)]
    gt_np = gt.cpu().numpy()
    ctx = types.SimpleNamespace(
        cell=name, cfg=cfg, traffic=traffic, rows=cfg["rows"], setup_s=setup_s,
        build_s=build_s, window=win, gt=gt_np, window_peak_bytes=window_peak, trace=None)
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1,
                "memory_peak_bytes": max(setup_peak, window_peak) if cuda else None}
    out = {}
    kind = "per_layer" if trace else "end_to_end"
    specs = cells.metrics_of(bench, name, kind)
    readers = {m["name"]: cells.reader(m["name"]) for m in specs}
    if trace:
        with hooks.installed(h for r in readers.values() for h in getattr(r, "HOOKS", [])) \
                as records:
            with tracing.profiled() as prof:
                from torch.profiler import record_function

                with record_function(tracing.SLICE):
                    for c in range(traffic["trace_calls"]):
                        call(q_host[window.pool_slice(win["next"] + c * per, per, pool)])
                    _sync(device)
        span = tracing.slice_range(prof.events)
        ctx.trace = {"events": prof.events, "window": span,
                     "queries": traffic["trace_calls"] * per, "records": records}
        dev_events = tracing.device_events(prof.events, span)
        dev_info["busy_s"] = tracing.busy_us(dev_events) * 1e-6
        dev_info["window_s"] = (span[1] - span[0]) * 1e-6
        out["breakdown"] = tracing.breakdown(prof.events, span)
    metrics = {}
    for m in specs:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    ctx.trace = None

    # the check, with the program's state freed
    del program, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    x, q = data.make(cfg, seed, device)
    picked = check.sample(len(win["qidx"]), traffic["checked_answers"], seed)
    qi = win["qidx"][picked]
    uq, inv = np.unique(qi, return_inverse=True)
    ref_ids, _ = eng.reference.answers(cfg, x, q[torch.as_tensor(uq, device=device)], k,
                                       batch=eng.REF_BATCH)
    inv_t = torch.as_tensor(inv, device=device)
    values = check.numbers(torch.as_tensor(win["ids"][picked], device=device),
                           torch.as_tensor(win["scores"][picked], device=device),
                           ref_ids[inv_t], x, q[torch.as_tensor(qi, device=device)])
    table = check.judged(values, cfg["check_limits"], win["failed"])
    _sync(device)
    phases["reference_s"] = time.perf_counter() - t0
    return {"correct": check.correct(table), "attempted": win["attempted"],
            "failed": win["failed"], "metrics": metrics, "device": dev_info, **out,
            "phases": phases, "check": table}
