"""CUDA graphs of a query chunk's leading stages.

A chunk of the forest's windowed query (on a lane tier or a folded one)
runs the same two leading stages with the same shapes on every call: the
hash (K1 and the probe bits) and the candidates (partitions, bucket
lookup, dedup and priority sorts, flatten). Run eagerly they are about 150
small launches a chunk, and on the card the host issuing them, not the
device running them, sets the pace.
`ChainGraphs` captures the two stages once as two CUDA graphs on one
memory pool and replays them: a copy of the chunk's queries into the
graphs' static input, one graph launch a stage, and between them the one
eager step that calls cuBLAS (the partitions' product). The kernels and
their order are the eager ones, so the outputs are equal bit for bit.

`chain_for(owner, key, build)` keeps each owner's graphs by key (the
forest state, and the chunk's shape and options). A key's first use runs
eagerly, which also warms every operation the capture records; its second
captures; later ones replay. An owner holds at most `MAX_KEYS` keys, and
its graphs go when it does, so a refit (a new state) never replays a graph
that reads the old one's tensors.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Optional, Tuple

import torch

from ..utils.timing import span

MAX_KEYS = 8        # chunk keys an owner tracks; past them, its chunks stay eager

# id(owner) → {key: None once seen, the ChainGraphs once captured}
_OWNERS: Dict[int, Dict[tuple, Optional["ChainGraphs"]]] = {}


class ChainGraphs:
    """Two stages of one chunk shape captured as CUDA graphs on one pool,
    with an eager step between them: `first(queries)` → a tuple of tensors
    (or None), `between(*first's)` → a tuple of tensors, and
    `second(*first's, *between's)` → a tuple of tensors. Library calls that
    keep a workspace per stream (cuBLAS) belong in `between`, which runs on
    the caller's stream: on the capture stream they would hold a second
    workspace for as long as the graphs live. No callable is kept. The
    outputs are static: each replay overwrites them, so a caller clones what
    outlives the chunk."""

    def __init__(self, queries: torch.Tensor, first: Callable, between: Callable,
                 second: Callable):
        dev = queries.device
        with span("rdf.sync.graph_capture"), torch.cuda.device(dev):
            self.queries = queries.clone()
            # one eager run first, which fills the caches the stages read
            # (a capture may not upload) and shapes `between`'s inputs
            warm = first(self.queries)
            self.between_in = tuple(t.clone() for t in between(*warm))
            second(*warm, *self.between_in)
            del warm
            stream = torch.cuda.Stream(dev)
            pool = torch.cuda.graph_pool_handle()
            self.first_graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.first_graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.first_out = first(self.queries)
            self.second_graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.second_graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.second_out = second(*self.first_out, *self.between_in)

    def run_first(self, queries: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
        """Copy the chunk's queries in and replay the first stage → its
        static outputs."""
        self.queries.copy_(queries)
        self.first_graph.replay()
        return self.first_out

    def run_second(self, *between_out: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Copy `between`'s outputs in and replay the second stage → its
        static outputs."""
        for static, t in zip(self.between_in, between_out):
            static.copy_(t)
        self.second_graph.replay()
        return self.second_out


def chain_for(owner, key: tuple, build: Callable[[], ChainGraphs]) -> Optional[ChainGraphs]:
    """`owner`'s graphs of `key`: None on the key's first use (the caller
    runs eagerly) and past `MAX_KEYS` keys, built by `build()` on its second
    use, the same object after."""
    keys = _OWNERS.get(id(owner))
    if keys is None:
        keys = _OWNERS[id(owner)] = {}
        weakref.finalize(owner, _OWNERS.pop, id(owner), None)
    if key not in keys:
        if len(keys) < MAX_KEYS:
            keys[key] = None
        return None
    if keys[key] is None:
        keys[key] = build()
    return keys[key]
