"""Tracing spans and profiler traces.

Counterpart of `similaritysearchbyrdf_tpu/utils/timing.py`. The reference
has no tracing (ad-hoc `System.currentTimeMillis` prints). Here the query
paths open named spans at their stage boundaries, and the spans are on
exactly while a `torch.profiler` session records: start any profiler
session (`torch.profiler.profile(...)`), or trace a block with
`torch_profile(logdir)`, whose `trace.json` then holds them. Outside a
profiler a span is one shared null context: it records nothing and costs
one check of the profiler's state.

A span on is a `torch.profiler.record_function(name)` range, a
`user_annotation` event in the same Kineto trace as the CUDA kernels, on
the same clock, nested under the spans open on the calling thread; its
host-clock seconds are also added to the '/'-joined `summary()` and
`report()`. A span never waits for the device.

The spans of `RDFForest.query` (`index/forest.py`), `IVFFlatIndex.query`
(`ops/ivf.py`) and `FlatIndex.query` (`ops/flat.py`), each call under one
`rdf.query`:

  rdf.chunk        one query batch (`query_dense_many`; one `ivf_topk`,
                   `flat_topk_grouped` or `flat_topk` call)
  rdf.hash         K1 and the probe bits (forest only)
  rdf.candidates   partitions, bucket lookup, dedup, priority sorts and
                   flatten; IVF: centroid scores, cluster select, window
                   flatten and prune
  rdf.score        the coarse query and K2b; on the folded tier the int8
                   query, K3, the row mask and the group max; flat: the
                   int8 query, K4 and the dead-group mask (the scan: a
                   block's product)
  rdf.select       the prefilter and top-m select, the selected rows; on
                   the folded tier the packed group select and the
                   selected slots' row ids; flat: the argpack select
                   (`select_packed_rows`), or exact2's group select, K2b
                   re-score and row select (the scan: a block's merge)
  rdf.sgtier       inside the flat `rdf.select`: the argpack select's
                   level 1 read from K4's emitted supergroup tier (the
                   boundary and dead supergroups recomputed), where it is
                   taken in place of a reduce over the key slab
  rdf.stage2       the folded tier's staged int8 re-score and id dedup
                   (`_stage2`, or `_dedup_selected` where it runs instead)
  rdf.rerank       the exact re-score and top-k (flat and IVF: opened by
                   the caller of `_exact_refine`, once)
  rdf.graph.replay inside `rdf.candidates`: the forest chunk's lookup and
                   flatten replayed as a CUDA graph (`index/chunk_graphs.py`;
                   its hash stage replays inside `rdf.hash`); dispatch, not
                   a wait
  rdf.sync.<site>  each host wait: `upload` (the queries and their ids to
                   the device), `patterns` and `priority` (the forest's
                   probe constants, uploaded on a cold call only: once per
                   device and probe shape), `graph_capture` (a chunk key's
                   capture, on its second use: it synchronises),
                   `window_budget` (IVF's cluster offsets to the host),
                   `answers` (ids and scores to the host)
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch
from torch.profiler import record_function

# one call of about 0.2 us: whether a profiler session records
_profiler_enabled = torch._C._autograd._profiler_enabled
NULL_SPAN = contextlib.nullcontext()


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on `device`; a CPU device has none. A failed
    synchronise raises."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """Spans by '/'-joined nested name (per thread), recorded while a
    `torch.profiler` session records."""

    def __init__(self) -> None:
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self._local = threading.local()

    def span(self, name: str):
        """A context for a block named `name`: `NULL_SPAN` unless a profiler
        records, else a `record_function` range timed on the host clock."""
        if not _profiler_enabled():
            return NULL_SPAN
        return self._recorded(name)

    @contextlib.contextmanager
    def _recorded(self, name: str) -> Iterator[None]:
        stack = self._local.__dict__.setdefault("stack", [])
        full = "/".join(stack + [name])
        stack.append(name)
        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            self.spans[full].append(time.perf_counter() - t0)
            stack.pop()

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
    card is present) and write its Chrome trace, the spans included, to
    `logdir/trace.json` (viewable in Perfetto or chrome://tracing)."""
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
