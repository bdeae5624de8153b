"""Reading a torch.profiler trace of the benchmark's traced slice.

The traced run profiles a fixed number of calls (the traffic's
`trace_calls`) inside one `record_function` range, `SLICE`, that ends in a
synchronise. The trace is exported in the Chrome format and read back as a
list of event dicts: host events (`cpu_op`, `user_annotation`, the CUDA
runtime and driver calls) carry a thread and a time range, device events
(`kernel`, `gpu_memcpy`, `gpu_memset`) a time range and the `correlation`
of the host call that launched them. Everything below works on that list,
so the tests feed it made-up events.

- busy time: the union of the device events' intervals inside the slice;
  idle share = 1 - busy / slice length (the arithmetic of the port's
  `chip_smoke.device_profile`, applied to the traced slice);
- device time of a range: the device events launched while a host range
  of that name was open on the launching thread;
- breakdown: the device operations that took most time, and the longest
  idle gaps, summed by the host operation that launched the device event
  which ended the gap.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import types
from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Tuple

SLICE = "bench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


@contextlib.contextmanager
def profiled():
    """Profile the block (host and CUDA activity); yields a holder whose
    `events` is filled with the trace's events on exit."""
    from torch.profiler import ProfilerActivity, profile

    holder = types.SimpleNamespace(events=[])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield holder
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def _x(events: Iterable[dict], cats) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _span(e: dict) -> Tuple[float, float]:
    t0 = float(e["ts"])
    return t0, t0 + float(e.get("dur", 0.0))


def slice_range(events: List[dict]) -> Tuple[float, float]:
    """(start, end) in microseconds of the host range `SLICE`."""
    rng = [e for e in _x(events, ("user_annotation",)) if e.get("name") == SLICE]
    if not rng:
        raise ValueError(f"the trace has no {SLICE!r} range")
    return _span(rng[0])


def device_events(events: List[dict], window: Optional[Tuple[float, float]] = None
                  ) -> List[dict]:
    """The device events, clipped to `window` (those wholly outside it
    dropped)."""
    out = []
    for e in _x(events, DEVICE_CATS):
        t0, t1 = _span(e)
        if window is not None:
            t0, t1 = max(t0, window[0]), min(t1, window[1])
            if t1 <= t0:
                continue
        out.append({**e, "ts": t0, "dur": t1 - t0})
    return out


def busy_us(dev: List[dict]) -> float:
    """Microseconds in which some device event ran: the union of their
    intervals (streams may overlap)."""
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(_span(e) for e in dev):
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total


def kernel_count(dev: List[dict]) -> int:
    return sum(1 for e in dev if e.get("cat") == "kernel")


def _launches(events: List[dict]) -> Dict[int, dict]:
    """correlation id → the host call that launched it."""
    out = {}
    for e in _x(events, LAUNCH_CATS):
        c = (e.get("args") or {}).get("correlation")
        if c is not None:
            out[c] = e
    return out


class _Ranges:
    """Host ranges of one name per thread, for point-in-range lookups."""

    def __init__(self, events: List[dict], name: str):
        self.by_tid: Dict[object, List[Tuple[float, float]]] = {}
        for e in _x(events, HOST_CATS):
            if e.get("name") == name:
                self.by_tid.setdefault(e.get("tid"), []).append(_span(e))
        for spans in self.by_tid.values():
            spans.sort()

    def holds(self, tid, t: float) -> bool:
        spans = self.by_tid.get(tid, [])
        i = bisect_right(spans, (t, float("inf"))) - 1
        # ranges of one name do not nest, so the last that starts before t decides
        return i >= 0 and spans[i][0] <= t <= spans[i][1]


def range_device_us(events: List[dict], name: str,
                    window: Optional[Tuple[float, float]] = None) -> float:
    """Device microseconds of the events launched inside host ranges named
    `name` (by the launching call's thread and start time)."""
    ranges = _Ranges(events, name)
    launch = _launches(events)
    total = 0.0
    for e in device_events(events, window):
        host = launch.get((e.get("args") or {}).get("correlation"))
        if host is not None and ranges.holds(host.get("tid"), float(host["ts"])):
            total += float(e["dur"])
    return total


def _innermost_ops(ops: List[dict], queries: List[Tuple[object, float]]) -> List[str]:
    """For each (thread, time) query, the name of the innermost host
    operation open on that thread at that time ("host" where none is): one
    sweep per thread, a stack of the open operations (a thread's
    operations nest)."""
    by_tid: Dict[object, List[dict]] = {}
    for e in ops:
        by_tid.setdefault(e.get("tid"), []).append(e)
    for lst in by_tid.values():
        lst.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
    out = ["host"] * len(queries)
    order = sorted(range(len(queries)), key=lambda i: (str(queries[i][0]), queries[i][1]))
    pos: Dict[object, int] = {}
    stacks: Dict[object, list] = {}
    for i in order:
        tid, t = queries[i]
        lst, stack = by_tid.get(tid, []), stacks.setdefault(tid, [])
        j = pos.get(tid, 0)
        while j < len(lst) and float(lst[j]["ts"]) <= t:
            t0, t1 = _span(lst[j])
            while stack and stack[-1][1] < t0:
                stack.pop()
            stack.append((lst[j].get("name", "host"), t1))
            j += 1
        pos[tid] = j
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[i] = stack[-1][0]
    return out


def breakdown(events: List[dict], window: Tuple[float, float], top: int = 10) -> dict:
    """{"device_ops": [[name, seconds], ...], "idle_gaps": [[name,
    seconds], ...]}: the device operations by total time, and the idle
    gaps of the window summed by the host operation that launched the
    device event ending each gap (the window's tail: "end of slice")."""
    dev = sorted(device_events(events, window), key=lambda e: float(e["ts"]))
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.get("name", "?")] = by_name.get(e.get("name", "?"), 0.0) + float(e["dur"])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    launch = _launches(events)
    host_ops = [e for e in _x(events, ("cpu_op",))
                if window[0] <= float(e["ts"]) <= window[1]]
    ended = []                          # (gap us, launching host call or None)
    end = window[0]
    for e in dev:
        t0, t1 = _span(e)
        if t0 > end:
            ended.append((t0 - end, launch.get((e.get("args") or {}).get("correlation"))))
        end = max(end, t1)
    labels = _innermost_ops(host_ops, [(h.get("tid"), float(h["ts"])) for _, h in ended
                                       if h is not None])
    gaps: Dict[str, float] = {}
    it = iter(labels)
    for gap, host in ended:
        label = next(it) if host is not None else "unknown"
        gaps[label] = gaps.get(label, 0.0) + gap
    if window[1] > end:
        gaps["end of slice"] = gaps.get("end of slice", 0.0) + (window[1] - end)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:120], v * 1e-6] for k, v in ops],
            "idle_gaps": [[k[:120], v * 1e-6] for k, v in idle]}


def launches_per_query(ctx) -> Optional[float]:
    """Kernels launched in the traced slice per query it sent."""
    t = ctx.trace
    if t is None:
        return None
    n = kernel_count(device_events(t["events"], t["window"]))
    return n / t["queries"] if n else None


def idle_share(ctx) -> Optional[float]:
    """1 - device busy time / slice length over the traced slice."""
    t = ctx.trace
    if t is None:
        return None
    busy = busy_us(device_events(t["events"], t["window"]))
    length = t["window"][1] - t["window"][0]
    return 1.0 - busy / length if busy > 0 and length > 0 else None
