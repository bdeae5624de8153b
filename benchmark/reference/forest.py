"""Plain reference of the Dynamic Partition Forest in window mode.

The semantics the port's `RDFForest` implements, for the options the
benchmark's forest configurations use (angle family drawn by pulling from
an orthogonal family, typeOfIndex "original", margin probes, a random-basis
int8 coarse tier in 64-slot windows, an exact f32 rerank), written as
plain torch and numpy from the configuration alone:

fit    hash every row (the sign of each chain function's projection,
       permuted and packed MSB-first), its partition id (the sign of each
       partition function over the hash's 32 bits), the composite key
       partition | top seg bits | low trie bits; per table a stable sort by
       key and leaf buckets by the overflow rule (the shallowest trie depth
       whose prefix holds at most `bucket_overflow` rows); the coarse tier,
       each row's projection on a seeded orthonormal basis quantized to int8
       with one global scale, stored per table in key order.
query  flip the `probe_budget` smallest-margin trie bits (plus the hash
       itself), look every probe key up, drop repeated ranges, order the
       rest by probe rank, lay them out in aligned 64-slot windows up to
       `max_candidates` slots, score each slot's coarse row against the
       bf16 projection of the query, keep the best of each strided group
       of four slots, the top `coarse_refine`, and rerank those rows with
       exact f32 inner products, each id once.

The random draws are numpy's, in the configuration's order, so the same
seed gives the same hash functions and basis as the port's. Nothing of the
port is imported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .common import Precision, top_sorted, window_scores

ID_PAD = 64          # trailing -1 ids past each table, so windows near the end read in bounds
U32 = 0xFFFFFFFF


def _orthogonal_rows(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    blocks, left = [], n
    while left > 0:
        k = min(left, dim)
        blocks.append(np.linalg.qr(rng.random((dim, dim)))[0][:k])
        left -= k
    return np.concatenate(blocks, axis=0).astype(np.float32)


def angle_functions(seed: int, tables: int, chain: int, dim: int, perms: int,
                    family_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(proj f32[T, C, D], perm[T, P, C]): `chain` functions a table pulled
    from an orthogonal family of `family_size` rows, and P orders of each."""
    rng = np.random.default_rng(seed)
    family = _orthogonal_rows(rng, family_size, dim)
    proj = family[rng.integers(0, family_size, size=(tables, chain))]
    perm = np.stack([np.stack([rng.permutation(chain) for _ in range(perms)])
                     for _ in range(tables)])
    return proj, perm


class Layout:
    def __init__(self, ix: dict):
        tab = ix["lsh_table"]
        self.pbits = ix["partition_bits"]
        self.bucket_bits = tab.get("bucket_bits", 28)
        self.seg_bits = 32 - self.bucket_bits
        self.bpl = tab.get("dir_node_size", 32).bit_length() - 1
        levels = self.bucket_bits // self.bpl
        while self.pbits + self.seg_bits + self.bpl * levels > 32 and levels > 1:
            levels -= 1
        self.levels = levels
        self.consumed = self.bpl * levels

    def keys(self, h: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
        seg = h >> self.bucket_bits
        trie = h & ((1 << self.consumed) - 1)
        return ((part << (self.seg_bits + self.consumed)) | (seg << self.consumed) | trie) & U32


class ReferenceForest:
    def __init__(self, cfg: dict, device, prec: Precision):
        ix = cfg["index"]
        for key, want in (("family_name", "angle"), ("generate_by_pulling", True),
                          ("is_orthogonal", True), ("type_of_index", "original"),
                          ("coarse_dtype", "int8"), ("coarse_proj_mode", "random")):
            if ix.get(key, want) != want:
                raise ValueError(f"the reference forest supports {key}={want!r} only")
        self.ix, self.q, self.dev, self.prec = ix, cfg["query"], device, prec
        self.layout = Layout(ix)
        t, p, d = ix["table_num"], ix["permutation_num"], ix["vector_dim"]
        self.L = t * p
        proj, perm = angle_functions(ix["seed"], t, ix["lsh_table"]["chain_length"], d, p,
                                     ix["family_size"])
        self.proj = torch.as_tensor(proj, device=device)
        self.perm = torch.as_tensor(perm.astype(np.int64), device=device)
        self.part = torch.stack([
            torch.as_tensor(angle_functions(ix["seed"] + 7919 * (i + 1), 1, ix["partition_bits"],
                                            32, 1, ix["family_size"])[0][0], device=device)
            for i in range(self.L)])                                      # [L, pbits, 32]

    # -- hashing -------------------------------------------------------------
    def _dots(self, x: torch.Tensor) -> torch.Tensor:
        t, c, d = self.proj.shape
        f = self.prec.f32
        return (f(x) @ f(self.proj.reshape(t * c, d)).T).reshape(x.shape[0], t, c)

    def hash(self, x: torch.Tensor, margins: bool = False):
        """(hashes int64[B, L] unsigned, margins f32[B, L, 32] or None); table
        order P*t + p, chain position j packed at bit 31 - j."""
        dots = self._dots(x)
        b, t, c = dots.shape
        idx = self.perm[None].expand(b, -1, -1, -1)
        pick = lambda v: torch.gather(v[:, :, None, :].expand(-1, -1, idx.shape[2], -1), 3, idx)
        bits = pick(dots > 0).to(torch.int64)                          # [B, T, P, C]
        shifts = torch.arange(31, 31 - c, -1, device=x.device)
        h = (bits << shifts).sum(-1).reshape(b, -1)
        if not margins:
            return h, None
        a = pick(dots.abs())
        m = torch.cat([torch.full(a.shape[:-1] + (32 - c,), float("inf"), device=x.device),
                       torch.flip(a, dims=(-1,))], dim=-1)
        return h, m.reshape(b, -1, 32)

    def partition(self, h: torch.Tensor) -> torch.Tensor:
        bits = ((h[..., None] >> torch.arange(32, device=h.device)) & 1).to(torch.float32)
        dots = torch.einsum("blk,lpk->blp", bits, self.prec.f32(self.part))
        w = 1 << torch.arange(self.layout.pbits - 1, -1, -1, device=h.device)
        return ((dots > 0).to(torch.int64) * w).sum(-1)

    # -- fit -----------------------------------------------------------------
    def fit(self, x: torch.Tensor) -> "ReferenceForest":
        ix, lay = self.ix, self.layout
        n, d = x.shape
        pad = lambda v, m: -(-max(v, 1) // m) * m
        chunk = min(ix.get("fit_batch_size", 8192), pad(n, 256))
        npad = pad(n, chunk)
        corpus = torch.zeros((npad, d), dtype=torch.float32, device=self.dev)
        corpus[:n] = x
        keys = torch.empty((npad, self.L), dtype=torch.int64, device=self.dev)
        for c0 in range(0, npad, chunk):
            h, _ = self.hash(corpus[c0:c0 + chunk])
            keys[c0:c0 + chunk] = lay.keys(h, self.partition(h))
        keys[n:] = U32
        keys = keys.T.contiguous()                                        # [L, Npad]
        skeys, order = torch.sort(keys, dim=1, stable=True)
        ids = torch.where(order < n, order, -1)
        pos = torch.arange(npad, device=self.dev)
        bkeys, bstarts, bshift = [], [], []
        for t in range(self.L):
            start = torch.zeros(npad, dtype=torch.int64, device=self.dev)
            shift = torch.zeros(npad, dtype=torch.int64, device=self.dev)
            done = torch.zeros(npad, dtype=torch.bool, device=self.dev)
            for lev in range(lay.levels):
                s = lay.consumed - lay.bpl * (lev + 1)
                _, inv, cnt = torch.unique_consecutive(skeys[t] >> s, return_inverse=True,
                                                       return_counts=True)
                lo = (torch.cumsum(cnt, 0) - cnt)[inv]
                fit = ~done & ((cnt[inv] <= ix["lsh_table"]["bucket_overflow"])
                               | (lev == lay.levels - 1))
                start = torch.where(fit, lo, start)
                shift = torch.where(fit, s, shift)
                done |= fit
            first = start == pos
            bkeys.append((skeys[t][first] >> shift[first]) << shift[first])
            bstarts.append(pos[first])
            bshift.append(shift[first])
        nb = max(8, -(-max(len(k) for k in bkeys) // 128) * 128)
        self.bkeys = torch.full((self.L, nb), U32, dtype=torch.int64, device=self.dev)
        self.bstart = torch.full((self.L, nb), npad, dtype=torch.int64, device=self.dev)
        self.bend = torch.full((self.L, nb), npad, dtype=torch.int64, device=self.dev)
        self.bshift = torch.zeros((self.L, nb), dtype=torch.int64, device=self.dev)
        for t in range(self.L):
            m = len(bkeys[t])
            self.bkeys[t, :m], self.bstart[t, :m] = bkeys[t], bstarts[t]
            self.bshift[t, :m] = bshift[t]
            self.bend[t, :m - 1] = bstarts[t][1:]
            self.bend[t, m - 1] = npad
        self.npad = npad
        self.ids = torch.cat([ids, torch.full((self.L, ID_PAD), -1, dtype=torch.int64,
                                              device=self.dev)], 1)
        self.corpus = corpus
        # the coarse tier: a seeded orthonormal basis, one int8 scale
        cd = min(ix["coarse_dim"], d)
        if cd == d:
            basis = np.eye(d, dtype=np.float32)
        else:
            rng = np.random.default_rng(ix["seed"] ^ 0x5EED)
            basis = np.linalg.qr(rng.normal(size=(d, d)))[0][:, :cd].astype(np.float32)
        cs = next((w for w in (8, 16, 32, 64) if cd <= w), -(-cd // 128) * 128)
        self.basis = torch.as_tensor(np.pad(basis, ((0, 0), (0, cs - cd))), device=self.dev)
        low = self.prec.f32(corpus) @ self.prec.f32(self.basis)
        row_q = self.prec.quantize(low, 127.0 / torch.clamp(low.abs().max(), min=1e-20))
        self.tier = row_q[self.ids.clamp(min=0)].masked_fill_((self.ids < 0)[..., None], 0)
        return self

    # -- query ---------------------------------------------------------------
    def _lookup(self, keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """keys int64[B, L, P] → (start, length) of each key's leaf bucket in
        its table (length 0 where no bucket holds the key's prefix)."""
        b, l, p = keys.shape
        q = keys.permute(1, 0, 2).reshape(l, b * p)
        r = torch.searchsorted(self.bkeys, q, right=True) - 1
        rc = r.clamp(min=0)
        g = lambda a: torch.gather(a, 1, rc)
        sh = g(self.bshift)
        ok = (r >= 0) & ((q >> sh) == (g(self.bkeys) >> sh))
        start, length = g(self.bstart), torch.where(ok, g(self.bend) - g(self.bstart), 0)
        back = lambda a: a.reshape(l, b, p).permute(1, 0, 2)
        return back(start), back(length)

    def query(self, queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids int64[B, k], -1 none; scores f32[B, k]) of a query batch."""
        ix, lay, qc = self.ix, self.layout, self.q
        if qc.get("steps", 0) != 0 or qc.get("probe_mode") != "margin":
            raise ValueError("the reference forest queries with margin probes at steps 0")
        b = queries.shape[0]
        dev = self.dev
        m_cap, win = ix["max_candidates"], 64
        if ix.get("coarse_window", -1) != -1 or m_cap < 32768 or m_cap % win:
            raise ValueError("the reference forest runs window mode (m_cap >= 32768)")
        h, margins = self.hash(queries, margins=True)
        vals, bit = torch.sort(margins[..., :lay.consumed], dim=-1, stable=True)
        nb = min(qc["probe_budget"], lay.consumed)
        probes = torch.cat([h[..., None] ^ (1 << bit[..., :nb]), h[..., None]], -1)
        pvalid = torch.cat([torch.isfinite(vals[..., :nb]),
                            torch.ones_like(vals[..., :1], dtype=torch.bool)], -1)
        keys = lay.keys(probes, self.partition(h)[..., None])             # [B, L, P]
        start, length = self._lookup(keys)
        l, p = self.L, keys.shape[2]
        start, length = start.reshape(b, -1), torch.where(pvalid, length, 0).reshape(b, -1)
        table_of = torch.arange(l, device=dev).repeat_interleave(p)
        prio = torch.roll(torch.arange(p, device=dev), -1).repeat(l)     # self 0, flips 1..
        # one copy of each (table, start) range, by priority, ties in (table, start) order
        rkey = torch.where(length > 0, table_of * (self.npad + 1) + start, 2**31 - 1)
        _, order = torch.sort((rkey << 32) | prio, dim=1, stable=True)
        rk = torch.gather(rkey, 1, order)
        ln = torch.gather(length, 1, order)
        dup = torch.cat([torch.zeros_like(rk[:, :1], dtype=torch.bool), rk[:, 1:] == rk[:, :-1]], 1)
        ln = torch.where(dup, 0, ln)
        _, order2 = torch.sort(torch.where(ln > 0, prio[order], 2**30), dim=1, stable=True)
        order = torch.gather(order, 1, order2)
        st, tb, ln = torch.gather(start, 1, order), table_of[order], torch.gather(ln, 1, order2)
        # aligned 64-slot windows: a range starts at its 8-aligned head
        head = st & 7
        alen = torch.where(ln > 0, (head + ln + win - 1) // win * win, 0)
        cum = torch.cumsum(alen, 1)
        mb_cap = m_cap // win
        first = torch.clamp((cum - alen) // win, max=mb_cap)
        mb = torch.arange(mb_cap, device=dev)
        owner = torch.searchsorted(first.contiguous(), mb.expand(b, mb_cap).contiguous(),
                                   right=True) - 1
        og = lambda a: torch.gather(a, 1, owner)
        caprows = self.tier.shape[1]
        blk = torch.clamp(og(st - head - (cum - alen)) + mb * win, max=caprows - win)
        tab, s_b, e_b = og(tb), og(st), og(st + ln)
        live = (blk < e_b) & (blk + win > s_b)
        q_low = self.prec.bf16(self.prec.f32(queries) @ self.prec.f32(self.basis))
        scores = window_scores(self.tier, q_low, tab, blk, s_b, e_b, live, win)
        pos = (blk[..., None] + torch.arange(win, device=dev)).reshape(b, -1)
        tslot = tab.repeat_interleave(win, dim=1)
        scores = scores.reshape(b, -1)
        m2 = min(max(ix["coarse_refine"], (k + 1) * l), m_cap)
        if m2 * 8 <= m_cap:
            # strided tournament: the best of the 4 slots win/4 apart in a window
            shape = (b, mb_cap, 4, win // 4)
            am = scores.reshape(shape).argmax(dim=2, keepdim=True)
            pick = lambda a: torch.gather(a.reshape(shape), 2, am).reshape(b, -1)
            scores, pos, tslot = pick(scores), pick(pos), pick(tslot)
        vals2, idx = top_sorted(scores, m2)
        t2, p2 = torch.gather(tslot, 1, idx), torch.gather(pos, 1, idx)
        cand = self.ids[t2.clamp(0, l - 1), p2.clamp(0, self.npad - 1)]
        cand = torch.where(torch.isfinite(vals2) & (cand >= 0), cand, -1)
        return self.rerank(cand, queries, k)

    def rerank(self, cand: torch.Tensor, queries: torch.Tensor, k: int):
        f = self.prec.f32
        vecs = f(self.corpus[cand.clamp(min=0)])
        sc = torch.where(cand >= 0, torch.matmul(vecs, f(queries)[:, :, None])[..., 0],
                         float("-inf"))
        key = torch.where(cand >= 0, cand, 2**31 - 1)
        ids_s, order = torch.sort(key, dim=1, stable=True)
        sc_s = torch.gather(sc, 1, order)
        dup = torch.cat([torch.zeros_like(ids_s[:, :1], dtype=torch.bool),
                         ids_s[:, 1:] == ids_s[:, :-1]], 1)
        sc_s = torch.where(dup | (ids_s == 2**31 - 1), float("-inf"), sc_s)
        top, ti = top_sorted(sc_s, k)
        return torch.where(top > float("-inf"), torch.gather(ids_s, 1, ti), -1), top


def build(cfg: dict, corpus: torch.Tensor, control: bool = False) -> ReferenceForest:
    """The reference fitted on `corpus` (the control with `control`)."""
    return ReferenceForest(cfg, corpus.device, Precision(control)).fit(corpus)


def answers(cfg: dict, corpus: torch.Tensor, queries: torch.Tensor, k: int,
            control: bool = False, batch: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit the reference on `corpus` and answer `queries` (row ids)."""
    forest = build(cfg, corpus, control)
    out = [forest.query(queries[i:i + batch], k) for i in range(0, queries.shape[0], batch)]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])
