"""Plain reference of the Dynamic Partition Forest on its folded tier.

The semantics the port's `RDFForest` implements with
`coarse_layout="folded"`, for the options the benchmark's folded
configuration uses (those of `reference/forest.py`, plus steps >= 0,
every slot of the best groups kept, `coarse_select_mult` 1, with or
without the staged rerank), written as plain torch and numpy from the
configuration alone:

fit    as `reference/forest.py` fits: hash, partition, composite keys,
       buckets, and the coarse tier, each row's projection on the seeded
       orthonormal basis quantized to int8 with one global scale, stored
       per table in key order (cs values a slot). `fold` = 128 / cs
       consecutive slots of a table make one folded row.
query  flip the `probe_budget` smallest-margin trie bits (plus the hash
       itself); XOR the home partition with every pattern of at most
       `steps` set bits; look up every (partition, probe) key, drop
       repeated ranges, order the rest by step distance, then probe rank;
       lay them out in aligned windows of `coarse_window` slots (a range's
       first window starts at its start rounded down to a multiple of
       max(group, 8 fold)) up to `max_candidates` slots. The query's f32
       projection is quantized to int8 with its own scale. Every slot packs
       (int8 dot << log2 group) | (slot mod group); each folded row keeps
       its maximum, and is dead unless its window is live and the row
       overlaps its range; each group of `coarse_group` slots keeps the
       maximum of its live rows. The best `coarse_refine / coarse_group`
       groups, by their value's top 32 - bits(groups) bits, give every slot
       of theirs; with `coarse_stage2`, those slots are re-scored with the
       same int8 dots, each id keeps its best copy, and the `coarse_stage2`
       best unique ids (ties by id) go on. Last, the exact f32 rerank, each
       id once.

Departures from the JAX package's description:
- a dead row reads -(2^31 - 1), as the JAX package's plain fallback has
  it (its TPU kernel leaves stale scratch there);
- group ties go to the higher group index, the low bits of the JAX
  package's packed select key (not "index order");
- values are int64 and never wrap (the JAX package packs int32);
- the tier is stored per table (the JAX package lane-packs 128 / cs
  tables a row, a TPU layout);
- only the packed one-operand group select is covered: a configuration
  whose groups leave too few value bits beside the index (more than a
  million groups a query) raises, as do `coarse_rows_keep` > 0,
  `coarse_select_mult` > 1 and an automatic window (`coarse_window` -1).

The random draws are numpy's, in the configuration's order, so the same
seed gives the same hash functions and basis as the port's. Nothing of
the port is imported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .common import Precision
from .forest import ReferenceForest

DEAD = -(2**31 - 1)      # a dead folded row's packed value
BIG = 2**62              # sorts after every row index


class FoldedForest(ReferenceForest):
    def __init__(self, cfg: dict, device, prec: Precision):
        ix = cfg["index"]
        for key, want in (("coarse_layout", "folded"), ("coarse_rows_keep", 0),
                          ("coarse_select_mult", 1)):
            if ix.get(key, want) != want:
                raise ValueError(f"the folded reference supports {key}={want!r} only")
        if cfg["query"].get("probe_mode") != "margin":
            raise ValueError("the folded reference queries with margin probes")
        super().__init__(cfg, device, prec)

    def _tier_dots(self, qi: torch.Tensor, tab: torch.Tensor, pos: torch.Tensor,
              chunk_elems: int = 1 << 26) -> torch.Tensor:
        """int64[B, ...]: the exact integer dot of tier row `pos` of table
        `tab` (both [B, ...]) with the query's integer vector qi [B, cs]."""
        b = qi.shape[0]
        per = max(1, pos[0].numel()) * self.tier.shape[2]
        step = max(1, chunk_elems // per)
        out = torch.empty(pos.shape, dtype=torch.int64, device=pos.device)
        q32 = qi.to(torch.int32)
        for b0 in range(0, b, step):
            g = self.tier[tab[b0:b0 + step], pos[b0:b0 + step]].to(torch.int32)
            qb = q32[b0:b0 + step].reshape((-1,) + (1,) * (g.dim() - 2) + (g.shape[-1],))
            out[b0:b0 + step] = (g * qb).sum(-1)
        return out

    def _ranges(self, queries: torch.Tensor):
        """The probed bucket ranges of every query, deduplicated and in
        priority order: (start, table, length) int64[B, R], length 0 for a
        dropped or empty range."""
        lay, qc, dev = self.layout, self.q, self.dev
        b, l = queries.shape[0], self.L
        h, margins = self.hash(queries, margins=True)
        vals, bit = torch.sort(margins[..., :lay.consumed], dim=-1, stable=True)
        nb = min(qc["probe_budget"], lay.consumed)
        probes = torch.cat([h[..., None] ^ (1 << bit[..., :nb]), h[..., None]], -1)  # [B, L, P]
        pvalid = torch.cat([torch.isfinite(vals[..., :nb]),
                            torch.ones_like(vals[..., :1], dtype=torch.bool)], -1)
        p = probes.shape[2]
        pats = [x for x in range(1 << lay.pbits) if bin(x).count("1") <= qc.get("steps", 0)]
        s = len(pats)
        parts = self.partition(h)[..., None] ^ torch.as_tensor(pats, device=dev)     # [B, L, S]
        keys = lay.keys(probes[:, :, None, :], parts[..., None])                     # [B, L, S, P]
        start, length = self._lookup(keys.reshape(b, l, s * p))
        valid = pvalid[:, :, None, :].expand(b, l, s, p).reshape(b, -1)
        start, length = start.reshape(b, -1), torch.where(valid, length.reshape(b, -1), 0)
        # key (t, s, p): table t, step pattern s, probe p (self 0, flips 1..)
        table_of = torch.arange(l, device=dev).repeat_interleave(s * p)
        dist = torch.as_tensor([bin(x).count("1") for x in pats], device=dev)
        rank = torch.roll(torch.arange(p, device=dev), -1)
        prio = (dist[:, None] * p + rank[None, :]).reshape(-1).repeat(l)
        # one copy of each (table, start) range, by priority, ties in (table, start) order
        rkey = torch.where(length > 0, table_of * (self.npad + 1) + start, 2**31 - 1)
        _, order = torch.sort((rkey << 32) | prio, dim=1, stable=True)
        rk = torch.gather(rkey, 1, order)
        ln = torch.gather(length, 1, order)
        dup = torch.cat([torch.zeros_like(rk[:, :1], dtype=torch.bool), rk[:, 1:] == rk[:, :-1]], 1)
        ln = torch.where(dup, 0, ln)
        _, order2 = torch.sort(torch.where(ln > 0, prio[order], 2**30), dim=1, stable=True)
        order = torch.gather(order, 1, order2)
        return torch.gather(start, 1, order), table_of[order], torch.gather(ln, 1, order2)

    def query(self, queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids int64[B, k], -1 none; scores f32[B, k]) of a query batch."""
        ix, dev = self.ix, self.dev
        b = queries.shape[0]
        l, caprows, cs = self.tier.shape
        m_cap, win, gsl = ix["max_candidates"], ix["coarse_window"], ix["coarse_group"]
        fold = max(1, 128 // cs)
        align = max(gsl, 8 * fold)
        if (win <= 0 or win % align or m_cap % win or win > caprows or gsl % fold
                or gsl & (gsl - 1)):
            raise ValueError(f"folded windows: window {win}, group {gsl}, fold {fold}, "
                             f"m_cap {m_cap}, {caprows} rows a table")
        mshift = gsl.bit_length() - 1
        score_bits = (cs * 127 * 127).bit_length() + 1
        st, tb, ln = self._ranges(queries)
        # aligned windows: a range's allocation starts at its align-aligned head
        head = st & (align - 1)
        alen = torch.where(ln > 0, (head + ln + win - 1) // win * win, 0)
        cum = torch.cumsum(alen, 1)
        mb_cap = m_cap // win
        first = torch.clamp((cum - alen) // win, max=mb_cap)
        mb = torch.arange(mb_cap, device=dev)
        owner = torch.searchsorted(first.contiguous(), mb.expand(b, mb_cap).contiguous(),
                                   right=True) - 1
        og = lambda a: torch.gather(a, 1, owner)
        blk = torch.clamp(og(st - head - (cum - alen)) + mb * win, 0, caprows - win)
        if bool((blk % fold != 0).any()):
            raise ValueError("a window does not start on a folded row")
        tab, s_b, e_b = og(tb), og(st), og(st + ln)
        live = (blk < e_b) & (blk + win > s_b)
        # the query: its f32 projection quantized with its own scale
        qf = self.prec.f32(queries) @ self.prec.f32(self.basis)
        qi = self.prec.quantize(qf, 127.0 / torch.clamp(qf.abs().amax(1, keepdim=True), min=1e-20))
        # every slot: (dot << mshift) | slot mod group, dead where its row is
        j = torch.arange(win, device=dev)
        pos = blk[..., None] + j                                          # [B, MB, win]
        dots = self._tier_dots(qi, tab[..., None].expand(-1, -1, win), pos)
        row0 = blk[..., None] + j // fold * fold                          # the slot's row's first slot
        row_live = live[..., None] & (row0 < e_b[..., None]) & (row0 + fold > s_b[..., None])
        packed = torch.where(row_live, (dots << mshift) | (j % gsl), DEAD)
        ngw = win // gsl
        groups = packed.reshape(b, mb_cap, ngw, gsl).amax(-1).reshape(b, -1)   # [B, W]
        # the best groups by their value's top 32 - bits_w bits, ties to the higher index
        width = mb_cap * ngw
        rgg = max(1, min(ix["coarse_refine"] // gsl, width))
        bits_w = max(1, (width - 1).bit_length())
        sh = max(0, score_bits + mshift - (32 - bits_w))
        if sh > mshift + 8:
            raise ValueError("the folded reference covers the packed group select only")
        lo = -(1 << (31 - bits_w))
        qv = torch.clamp(groups >> sh, min=lo)
        sel = self._select(qv, rgg)
        ok = torch.gather(qv, 1, sel) > lo
        mbi = sel // ngw
        base = torch.clamp(torch.gather(blk, 1, mbi) + sel % ngw * gsl, 0, caprows - gsl)
        t2 = torch.gather(tab, 1, mbi)
        spos = base[..., None] + torch.arange(gsl, device=dev)            # [B, RGG, gsl]
        cand = self.ids[t2[..., None], spos].reshape(b, -1)
        cand = torch.where(ok.repeat_interleave(gsl, dim=1) & (cand >= 0), cand, -1)
        stage2 = ix.get("coarse_stage2", 0)
        if 0 < stage2 < cand.shape[1]:
            sc = self._tier_dots(qi, t2[..., None].expand(-1, -1, gsl), spos).reshape(b, -1)
            cand = self._stage2(cand, sc, stage2)
        return self.rerank(cand, queries, k)

    @staticmethod
    def _select(qv: torch.Tensor, m: int) -> torch.Tensor:
        """Indices of the `m` largest of qv [B, W], ties to the higher index."""
        _, o = torch.sort(torch.flip(qv, dims=(1,)), dim=1, descending=True, stable=True)
        return qv.shape[1] - 1 - o[:, :m]

    @staticmethod
    def _stage2(cand: torch.Tensor, sc: torch.Tensor, keep: int) -> torch.Tensor:
        """The `keep` best unique ids of `cand` (-1 none), each at its best
        slot score `sc`, ordered by score descending then id; -1 padded."""
        b, m = cand.shape
        ids_s, perm = torch.sort(torch.where(cand >= 0, cand, BIG), dim=1, stable=True)
        sc_s = torch.gather(sc, 1, perm)
        new = torch.cat([torch.ones_like(ids_s[:, :1], dtype=torch.bool),
                         ids_s[:, 1:] != ids_s[:, :-1]], 1)
        seg = torch.cumsum(new.to(torch.int64), 1) - 1                   # each id's segment
        best = torch.full((b, m), -BIG, dtype=torch.int64, device=cand.device)
        best = best.scatter_reduce(1, seg, sc_s, "amax")
        uid = torch.full((b, m), BIG, dtype=torch.int64, device=cand.device).scatter(1, seg, ids_s)
        real = uid != BIG
        _, o = torch.sort(torch.where(real, -best, BIG), dim=1, stable=True)   # ids ascend within ties
        out = torch.where(torch.gather(real, 1, o), torch.gather(uid, 1, o), -1)
        return out[:, :keep]


def build(cfg: dict, corpus: torch.Tensor, control: bool = False) -> FoldedForest:
    """The reference fitted on `corpus` (the control with `control`)."""
    return FoldedForest(cfg, corpus.device, Precision(control)).fit(corpus)


def answers(cfg: dict, corpus: torch.Tensor, queries: torch.Tensor, k: int,
            control: bool = False, batch: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit the reference on `corpus` and answer `queries` (row ids)."""
    forest = build(cfg, corpus, control)
    out = [forest.query(queries[i:i + batch], k) for i in range(0, queries.shape[0], batch)]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])
