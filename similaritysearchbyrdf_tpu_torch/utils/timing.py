"""Tracing spans and profiler traces.

Counterpart of `similaritysearchbyrdf_tpu/utils/timing.py`. The reference
has no tracing (ad-hoc `System.currentTimeMillis` prints); here nested
spans record host-clock seconds per name, optionally synchronising the
tracer's CUDA device before and after so a span measures the device's work
and not only its enqueue, and `torch_profile` writes a `torch.profiler`
trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

from ..models.families import Device, resolve_device


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on `device`; a CPU device has none. A failed
    synchronise raises."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """Spans by '/'-joined nested name. `device` (default: the first CUDA
    card) is the one `sync=True` waits for; it is resolved at the first
    synchronised span, so making a tracer needs no card."""

    def __init__(self, device: Device = None) -> None:
        self.device = device
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self._stack: List[str] = []

    def _sync(self) -> None:
        synchronize(resolve_device(self.device))

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False) -> Iterator[None]:
        """Time a block; `sync=True` waits for the device first and after."""
        if sync:
            self._sync()
        full = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                self._sync()
            self.spans[full].append(time.perf_counter() - t0)
            self._stack.pop()

    def summary(self) -> List[Tuple[str, int, float, float]]:
        """[(name, count, total_s, mean_s)] by total time, largest first."""
        rows = [(name, len(v), sum(v), sum(v) / len(v)) for name, v in self.spans.items()]
        return sorted(rows, key=lambda r: -r[2])

    def report(self) -> str:
        lines = [f"{'span':40s} {'n':>5s} {'total_ms':>10s} {'mean_ms':>10s}"]
        for name, n, tot, mean in self.summary():
            lines.append(f"{name:40s} {n:5d} {tot*1e3:10.2f} {mean*1e3:10.2f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.spans.clear()


default_tracer = Tracer()
span = default_tracer.span


@contextlib.contextmanager
def torch_profile(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with `torch.profiler` (the CPU, and CUDA when a
    card is present) and write its Chrome trace to `logdir/trace.json`
    (viewable in Perfetto or chrome://tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
