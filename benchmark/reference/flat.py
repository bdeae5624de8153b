"""Plain reference of the quantized-flat engine (brute-force int8 sketch scan).

The semantics the port's `FlatIndex` implements at its defaults (mode
grouped, an int8 sketch, refine 128, groups of 64 rows), written as plain
torch and numpy from the configuration alone:

build  an int8 sketch of the corpus at one global scale 127 / max |x|
       (computed in float64, applied as its f32 value), rounded half to
       even and clipped to +-127; the exact tier is the f32 corpus. The
       sketch is padded with zero rows to a multiple of 64, as the port
       pads its own, so the last group holds rows that score 0.
query  each query in int8 at its own scale 127 / max |q|; exact integer
       scores of every sketch row, a block of rows at a time; then one of
       the port's two candidate routes, by the port's rule (`argpack` for
       an int8 sketch of at least `ARGPACK_MIN_ROWS` rows whose packed key
       fits int32, as it does at D 96; else `exact2`):
       argpack  per 64-row group the key score * 64 + member of its best
                row, ties to the highest member; the top `refine` keys of
                all live groups by one stable select (ties to the lower
                group); each key names its row, and one naming a padding
                row names no candidate;
       exact2   per group its best score; the top max(r_groups, 3k) live
                groups by one stable select; every row of those groups
                scored against the bf16-rounded query in f32 (padding rows
                -inf); the top `refine` rows by one stable select;
       then the exact f32 inner products of the candidates and their top
       k, ties in candidate order.

The port selects in two levels (supergroup maxima, then their children);
that select is exact, so one level is the semantics here. Where keys tie
at the `refine`-th place, the two can keep different groups of the tied
ones: the port orders tied keys by the rank of their supergroup's
maximum, this reference by group index. (Below `2 * refine * 32`
groups, the port's argpack select takes one level by score alone, tied
scores in group order rather than by member.) exact2's bf16 re-score
sums in another order than K2b, so rows whose scores differ in the last
bit may change places at its cut.

Nothing of the port is imported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .common import Precision, top_sorted

GROUP = 64                 # rows a group
ARGPACK_MIN_ROWS = 1 << 20  # the port's rule: argpack from 1M rows (int8 sketch)
SCORE_ROWS = 1 << 16       # sketch rows scored at once ([B, rows] f32 and int64)
QUANT_ROWS = 1 << 20       # corpus rows quantized at once


class ReferenceFlat:
    def __init__(self, cfg: dict, device, prec: Precision):
        ix = cfg["index"]
        if ix["mode"] != "grouped" or ix["sketch_dtype"] != "int8":
            raise ValueError("the flat reference models mode grouped on an int8 sketch")
        self.ix, self.dev, self.prec = ix, device, prec

    def fit(self, x: torch.Tensor) -> "ReferenceFlat":
        n, d = x.shape
        self.n = n
        self.corpus = x.to(torch.float32)
        amax = float(self.corpus.abs().max()) if n else 0.0
        scale = float(np.float32(127.0 / max(amax, 1e-30)))
        rows = -(-n // GROUP) * GROUP
        self.sketch = torch.zeros((rows, d), dtype=torch.int8, device=self.dev)
        for c0 in range(0, n, QUANT_ROWS):
            rows_f = self.corpus[c0:c0 + QUANT_ROWS]
            self.sketch[c0:c0 + rows_f.shape[0]] = self.prec.quantize(rows_f, scale)
        return self

    def _group_best(self, qf: torch.Tensor, argpack: bool) -> torch.Tensor:
        """int64[B, NG]: per group the key score * 64 + member of its best
        row (ties to the highest member), or with `argpack` False its best
        score. The integer scores are f32 products of integers, exact while
        every partial sum stays below 2^24 (D 96: at most 1,548,384)."""
        member = torch.arange(GROUP, device=self.dev)
        out = []
        for r0 in range(0, self.sketch.shape[0], SCORE_ROWS):
            s = (qf @ self.sketch[r0:r0 + SCORE_ROWS].to(torch.float32).T).to(torch.int64)
            s = s.view(s.shape[0], -1, GROUP)
            out.append((s * GROUP + member).amax(dim=2) if argpack else s.amax(dim=2))
        return torch.cat(out, dim=1)

    def query(self, queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        ix, prec, n = self.ix, self.prec, self.n
        q = queries.to(torch.float32)
        qscale = 127.0 / q.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        qf = prec.quantize(q, qscale).to(torch.float32)
        refine = ix["refine"]
        if n >= ARGPACK_MIN_ROWS:
            keys = self._group_best(qf, argpack=True)
            top = top_sorted(keys, min(refine, keys.shape[1]))[1]
            kept = torch.gather(keys, 1, top)
            cand = top * GROUP + (kept & (GROUP - 1))
            valid = cand < n
        else:
            gmax = self._group_best(qf, argpack=False)
            rg = min(max(ix["r_groups"], 3 * k), gmax.shape[1])
            gidx = top_sorted(gmax, rg)[1]
            rows = (gidx[:, :, None] * GROUP + torch.arange(GROUP, device=self.dev)).flatten(1)
            sk = self.sketch[rows].to(torch.float32)                      # [B, RG*64, D]
            sc = (sk * prec.bf16(q)[:, None, :]).sum(dim=2)
            sc = torch.where(rows < n, sc, float("-inf"))
            sel_s, sel = top_sorted(sc, min(refine, sc.shape[1]))
            cand = torch.gather(rows, 1, sel)
            valid = torch.isfinite(sel_s)
        safe = cand.clamp(0, max(n - 1, 0))
        exact = torch.bmm(prec.f32(self.corpus[safe]), prec.f32(q)[:, :, None])[..., 0]
        exact = torch.where(valid, exact, float("-inf"))
        top_s, ti = top_sorted(exact, k)
        ids = torch.gather(safe, 1, ti)
        return torch.where(torch.isfinite(top_s), ids, -1), top_s


def build(cfg: dict, corpus: torch.Tensor, control: bool = False) -> ReferenceFlat:
    """The reference built on `corpus` (the control with `control`)."""
    return ReferenceFlat(cfg, corpus.device, Precision(control)).fit(corpus)


def answers(cfg: dict, corpus: torch.Tensor, queries: torch.Tensor, k: int,
            control: bool = False, batch: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the reference on `corpus` and answer `queries` (row ids)."""
    index = build(cfg, corpus, control)
    out = [index.query(queries[i:i + batch], k) for i in range(0, queries.shape[0], batch)]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])
