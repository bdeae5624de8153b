"""The top-k select over packed keys (`ops/kernels/topk_select.py`) on the CPU.

The plain versions equal the sorted prefix `torch.sort(keys)[0][:, :k]` on
unique int32 and int64 keys, both directions, at the widths and `k` the
folded forest uses and at their edges; rows of repeated dead sentinels (the
keys stage2 gives its dropped duplicates) come out as the sort has them. A
numpy model of the kernel's radix select (`csrc/topk_select.cu`: the digit
passes, the early stop, the compaction rule) picks the same multiset. The
forest's two rewritten selects equal the full sorts they replaced, and the
wrappers refuse what the kernel does not take. The kernel itself runs in
`tests/test_torch_topk_select_cuda.py`.
"""

import numpy as np
import pytest
import torch

from similaritysearchbyrdf_tpu_torch.index.forest import _first_dups
from similaritysearchbyrdf_tpu_torch.ops.kernels import topk_select as T
from similaritysearchbyrdf_tpu_torch.ops.kernels.coarse_fold import I32_DEAD

WIDTHS = [1, 7, 14_336, 32_768]
KS = [1, 1_792, 4_096, 40_000]


def unique_keys(b, n, dtype, seed):
    """int[b, n] keys, unique in each row, spread over the type's range."""
    rng = np.random.default_rng(seed)
    bits = 32 if dtype == torch.int32 else 64
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    rows = []
    for _ in range(b):
        r = rng.integers(lo, hi, size=2 * n + 8, dtype=np.int64 if bits == 64 else np.int32,
                         endpoint=True)
        rows.append(rng.choice(np.unique(r), n, replace=False))
    return torch.from_numpy(np.stack(rows)).to(dtype)


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_plain_equals_sorted_prefix(dtype, n, k, descending):
    keys = unique_keys(3, n, dtype, seed=n * 7 + k)
    got = T.topk_select(keys, k, descending)
    want = torch.sort(keys, dim=1, descending=descending)[0][:, :k]
    assert got.dtype == dtype and got.shape == (3, min(k, n))
    assert torch.equal(got, want)


def test_dead_sentinel_rows():
    """stage2's keys: dead entries repeat one value; a row may be all dead."""
    sent = 1 << 30
    dead = (2 * sent) << 31 | sent
    keys = torch.full((4, 14_336), dead, dtype=torch.int64)
    rng = np.random.default_rng(3)
    for r, live in enumerate([0, 5, 4_095, 9_000]):
        ids = torch.from_numpy(rng.permutation(1 << 20)[:live]).to(torch.int64)
        neg = torch.from_numpy(rng.integers(-4_000_000, 4_000_000, live)).to(torch.int64)
        keys[r, rng.permutation(14_336)[:live]] = ((neg + sent) << 31) | ids
    got = T.topk_select(keys, 4_096, descending=False)
    assert torch.equal(got, torch.sort(keys, dim=1)[0][:, :4_096])
    assert bool((got[0] == dead).all())
    assert int((got[1] != dead).sum()) == 5


def radix_select_model(u, kout, bits):
    """The kernel's select on one row of order keys (numpy uint64 holding
    `bits`-bit values): the multiset of the kout smallest."""
    prefix, pmask, krem = 0, 0, kout
    for shift in range(bits - 8, -1, -8):
        m = (u & np.uint64(pmask)) == np.uint64(prefix)
        d = ((u[m] >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)
        hist = np.bincount(d, minlength=256)
        incl = np.cumsum(hist)
        b = int(np.searchsorted(incl, krem))          # first bin with incl >= krem
        acc = int(incl[b] - hist[b])
        krem -= acc
        prefix |= b << shift
        pmask |= 255 << shift
        if hist[b] == krem:
            break
    top = u & np.uint64(pmask)
    lt = u[top < np.uint64(prefix)]
    eq = u[top == np.uint64(prefix)][:krem]
    assert len(lt) == kout - krem and len(eq) == krem
    return np.sort(np.concatenate([lt, eq]))


@pytest.mark.parametrize("case", ["unique32", "unique64", "dead64", "clustered32", "all_equal"])
@pytest.mark.parametrize("kout", [1, 100, 1_792, 2_000])
def test_radix_select_model(case, kout):
    rng = np.random.default_rng(kout)
    n = 2_000
    if case.endswith("32") or case == "all_equal":
        bits = 32
    else:
        bits = 64
    if case == "unique32":
        u = rng.permutation(1 << 24)[:n].astype(np.uint64) * 251
    elif case == "unique64":
        u = rng.integers(0, 2**63, n, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    elif case == "dead64":
        u = np.full(n, (3 << 61) | 5, dtype=np.uint64)
        u[: n // 3] = rng.integers(0, 2**61, n // 3, dtype=np.uint64)
    elif case == "clustered32":   # most keys share their top digits
        u = (np.uint64(0x7F000000) | rng.integers(0, 1 << 12, n).astype(np.uint64))
    else:
        u = np.full(n, 12345, dtype=np.uint64)
    assert np.array_equal(radix_select_model(u, kout, bits), np.sort(u)[:kout])


@pytest.mark.parametrize("rgg", [1, 1_792, 32_768])
def test_packed_select_equals_forest_pack(rgg):
    """The forest's one-operand group select: the int64 pack of the folded
    Deep cell (cs 16, group 8: sh 5, bits_w 15), sorted in full."""
    rng = np.random.default_rng(rgg)
    b, width, mshift, sh, bits_w = 3, 32_768, 3, 5, 15
    score = rng.integers(-16 * 127 * 127, 16 * 127 * 127 + 1, (b, width))
    g1 = torch.from_numpy((score << mshift) | rng.integers(0, 8, (b, width))).to(torch.int32)
    g1[:, rng.permutation(width)[: width // 3]] = I32_DEAD
    lo = -(1 << (31 - bits_w))
    flat = g1.to(torch.int64)
    pack = (torch.clamp(flat >> sh, min=lo) << bits_w) | torch.arange(width)
    want = torch.sort(pack, dim=1, descending=True)[0][:, :rgg]
    got = T.topk_packed_select(g1, rgg, sh, bits_w)
    assert got.dtype == torch.int32
    assert torch.equal(got.to(torch.int64), want)


@pytest.mark.parametrize("stage2", [1, 4_096, 14_335])
def test_stage2_key_equals_stable_sort(stage2):
    """`_stage2`'s select: the smallest ((-score + 2^30) << 31) | id keys give
    the ids of a stable sort by -score after the dedup sort, and -1 where
    that sort has only dead entries left."""
    rng = np.random.default_rng(stage2)
    b, m, sent = 3, 14_336, 1 << 30
    cand2 = torch.from_numpy(rng.integers(0, 3_000, (b, m)))    # many duplicate ids
    cand2[:, rng.permutation(m)[: m // 4]] = -1
    slot_sc = torch.from_numpy(rng.integers(-200, 200, (b, m))).to(torch.int32)  # ties
    idk = torch.where(cand2 >= 0, cand2, sent).to(torch.int64)
    negsc = torch.where(cand2 >= 0, -slot_sc, sent).to(torch.int64)
    key, _ = torch.sort((idk << 32) | (negsc + 2**31), dim=1)
    id_s = key >> 32
    neg_s = (key & 0xFFFFFFFF) - 2**31
    neg_s = torch.where(_first_dups(id_s) | (id_s == sent), sent, neg_s)
    neg2, order = torch.sort(neg_s, dim=1, stable=True)
    want = torch.where(neg2 != sent, torch.gather(id_s, 1, order), -1)[:, :stage2]
    top = T.topk_select(((neg_s + sent) << 31) | id_s, stage2, descending=False)
    got = torch.where(top < (2 * sent) << 31, top & (2**31 - 1), -1)
    assert torch.equal(got, want)


def test_refusals():
    keys = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    with pytest.raises(TypeError):
        T.topk_select(keys.float(), 2, True)
    with pytest.raises(TypeError):
        T.topk_select(keys.to(torch.int16), 2, True)
    with pytest.raises(ValueError, match="contiguous"):
        T.topk_select(keys.t(), 2, True)
    with pytest.raises(ValueError, match="device"):
        T.topk_select(torch.empty((3, 4), dtype=torch.int32, device="meta"), 2, True)
    with pytest.raises(ValueError, match="2-D"):
        T.topk_select(keys.reshape(-1), 2, True)
    with pytest.raises(ValueError, match="k must"):
        T.topk_select(keys, -1, True)
    with pytest.raises(TypeError):
        T.topk_packed_select(keys.long(), 2, 0, 4)
    with pytest.raises(ValueError, match="bits_w"):
        T.topk_packed_select(keys, 2, 0, 1)            # 4 columns need 2 bits
    with pytest.raises(ValueError, match="contiguous"):
        T.topk_packed_select(keys.t(), 2, 0, 4)


def test_plain_runs_never_count():
    before = T.LAUNCHES
    T.topk_select(torch.arange(8, dtype=torch.int64).reshape(2, 4), 2, False)
    T.topk_packed_select(torch.arange(8, dtype=torch.int32).reshape(2, 4), 2, 0, 2)
    assert T.LAUNCHES == before
