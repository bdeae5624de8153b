"""Plain reference of the IVF-Flat engine (clustered flat index).

The semantics the port's `IVFFlatIndex` implements at its defaults,
written as plain torch and numpy from the configuration alone:

build  spherical Lloyd k-means on the bf16-rounded rows: the initial
       centroids are the rows of numpy's seeded draw; each iteration
       assigns every row to the centroid of largest inner product (exact
       products of bf16 values, summed in f32; the first on ties) and
       moves each centroid to the mean of its rows, summed exactly in
       64-bit fixed point, scaled to unit norm (an empty cluster keeps its
       centroid). The rows are laid out cluster by cluster in corpus order,
       each cluster padded to a multiple of 8 rows, beside an int8 sketch of
       them (one global scale 127 / max |x|, round half to even).
query  the `nprobe` clusters whose bf16 centroids score best against the
       bf16 query; their rows in windows of `win` rows; each sketch row of
       a window scored against the bf16 query, -inf outside its cluster's
       [start, end); the best `refine` rows re-scored with exact f32 inner
       products; the top k.

Nothing of the port is imported.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .common import Precision, top_sorted, window_scores

ASSIGN_CHUNK = 8192        # rows assigned at once ([chunk, K] f32 scores)
SUM_CHUNK = 1 << 20        # rows summed into the clusters at once


class ReferenceIVF:
    def __init__(self, cfg: dict, device, prec: Precision):
        self.ix, self.dev, self.prec = cfg["index"], device, prec

    def _assign(self, xb: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
        ct = self.prec.bf16(cent).T
        out = torch.empty(xb.shape[0], dtype=torch.int64, device=self.dev)
        for c0 in range(0, xb.shape[0], ASSIGN_CHUNK):
            out[c0:c0 + ASSIGN_CHUNK] = (xb[c0:c0 + ASSIGN_CHUNK] @ ct).argmax(dim=1)
        return out

    def _update(self, xb: torch.Tensor, assign: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
        n, d = xb.shape
        k = cent.shape[0]
        bits = 62 - math.frexp(float(xb.abs().max()))[1] - n.bit_length()
        sums = torch.zeros((k, d), dtype=torch.int64, device=self.dev)
        for c0 in range(0, n, SUM_CHUNK):
            fixed = torch.round(xb[c0:c0 + SUM_CHUNK].to(torch.float64) * 2.0 ** bits)
            sums.index_add_(0, assign[c0:c0 + SUM_CHUNK], fixed.to(torch.int64))
        counts = torch.bincount(assign, minlength=k)
        mean = (sums.to(torch.float64) * 2.0 ** -bits
                / counts.clamp(min=1)[:, None].to(torch.float64)).to(torch.float32)
        new = torch.where((counts > 0)[:, None], mean, cent.to(torch.float32))
        new = new / torch.linalg.vector_norm(new, dim=1, keepdim=True).clamp(min=1e-20)
        return new.to(torch.bfloat16)

    def fit(self, x: torch.Tensor) -> "ReferenceIVF":
        ix = self.ix
        n, d = x.shape
        dp = -(-d // 32) * 32
        xp = torch.nn.functional.pad(x.to(torch.float32), (0, dp - d))
        k = int(np.clip(n // ix["target_cluster"], 16, 65536))
        rng = np.random.default_rng(ix["seed"] ^ 0xC1)
        pool = np.arange(n)
        init = rng.choice(pool, size=k, replace=pool.size < k)
        xb = self.prec.bf16(xp)
        cent = xb[torch.as_tensor(init, device=self.dev)].to(torch.bfloat16)
        assign = None
        for _ in range(ix["iters"]):
            assign = self._assign(xb, cent)
            cent = self._update(xb, assign, cent)
        del xb
        a = assign.cpu().numpy()
        order = np.argsort(a, kind="stable")
        counts = np.bincount(a, minlength=k)
        starts = np.zeros(k + 1, np.int64)
        starts[1:] = np.cumsum((counts + 7) // 8 * 8)
        first = np.zeros(k + 1, np.int64)
        first[1:] = np.cumsum(counts)
        perm = np.full(int(starts[-1]), -1, np.int64)
        perm[starts[a[order]] + np.arange(n) - first[a[order]]] = order
        perm = torch.as_tensor(perm, device=self.dev)
        self.ids = perm
        self.corpus = xp[perm.clamp(min=0)].masked_fill_((perm < 0)[:, None], 0.0)
        del xp
        amax = float(self.corpus.abs().max())
        scale = float(np.float32(127.0 / max(amax, 1e-30)))
        self.sketch = torch.empty(self.corpus.shape, dtype=torch.int8, device=self.dev)
        for c0 in range(0, self.corpus.shape[0], SUM_CHUNK):
            self.sketch[c0:c0 + SUM_CHUNK] = self.prec.quantize(self.corpus[c0:c0 + SUM_CHUNK],
                                                                scale)
        self.cent = cent
        self.starts = torch.as_tensor(starts, device=self.dev)
        self.ends = torch.as_tensor(starts[:-1] + counts, device=self.dev)
        return self

    def window_budget(self, nprobe: int, win: int, cap: int = 4096) -> int:
        """Windows a query needs so that no probed cluster is cut: the window
        counts of the `nprobe` largest clusters, summed."""
        lens = (self.ends - self.starts[:-1]).cpu().numpy()
        wc = -np.sort(-((lens + win - 1) // win))[:nprobe]
        return int(min(max(int(wc.sum()), nprobe), cap))

    def query(self, queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        ix, prec, dev = self.ix, self.prec, self.dev
        npad, dp = self.sketch.shape
        win, nprobe = ix["win"], min(ix["nprobe"], self.cent.shape[0])
        wb = self.window_budget(ix["nprobe"], win)
        b = queries.shape[0]
        qp = torch.nn.functional.pad(queries.to(torch.float32), (0, dp - queries.shape[1]))
        qb = prec.bf16(qp)
        sel = top_sorted(qb @ prec.bf16(self.cent).T, nprobe)[1]             # [B, P]
        s0, s1 = self.starts[sel], self.ends[sel]
        wc = (s1 - s0 + win - 1) // win
        cum = torch.cumsum(wc, 1)
        j = torch.arange(wb, device=dev)
        owner = torch.searchsorted(cum, j.expand(b, wb).contiguous(), right=True)
        oc = owner.clamp(max=nprobe - 1)
        blk = torch.gather(s0, 1, oc) + (j - torch.gather(cum - wc, 1, oc)) * win
        end = torch.gather(s1, 1, oc)
        live = (owner < nprobe) & (blk < end)
        blk_read = blk.clamp(max=max(npad - win, 0))
        tier = self.sketch[None] if npad >= win else torch.nn.functional.pad(
            self.sketch, (0, 0, 0, win - npad))[None]
        sc = window_scores(tier, qb, torch.zeros_like(blk), blk_read, blk, end, live, win)
        pos = (blk_read[..., None] + torch.arange(win, device=dev)).reshape(b, -1)
        top_s, si = top_sorted(sc.reshape(b, -1), min(ix["refine"], wb * win))
        fin = torch.isfinite(top_s)
        cand = torch.where(fin, torch.gather(pos, 1, si), npad).clamp(0, npad - 1)
        exact = torch.bmm(prec.f32(self.corpus[cand]), prec.f32(qp)[:, :, None])[..., 0]
        exact = torch.where(fin, exact, float("-inf"))
        top, ti = top_sorted(exact, k)
        uid = torch.gather(self.ids[cand], 1, ti)
        return torch.where(torch.isfinite(top), uid, -1), top


def build(cfg: dict, corpus: torch.Tensor, control: bool = False) -> ReferenceIVF:
    """The reference built on `corpus` (the control with `control`)."""
    return ReferenceIVF(cfg, corpus.device, Precision(control)).fit(corpus)


def answers(cfg: dict, corpus: torch.Tensor, queries: torch.Tensor, k: int,
            control: bool = False, batch: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the reference on `corpus` and answer `queries` (row ids)."""
    index = build(cfg, corpus, control)
    out = [index.query(queries[i:i + batch], k) for i in range(0, queries.shape[0], batch)]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])
