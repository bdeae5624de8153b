"""The top-k select over packed keys (`ops/kernels/topk_select.py`) on the CPU.

The plain versions equal the sorted prefix `torch.sort(keys)[0][:, :k]` on
unique int32 and int64 keys, both directions, at the widths and `k` the
folded forest uses and at their edges; rows of repeated dead sentinels (the
keys stage2 gives its dropped duplicates) come out as the sort has them. A
numpy model of the kernel's radix select (`csrc/topk_select.cu`: the digit
passes, the early stop, the compaction rule) picks the same multiset. The
forest's two rewritten selects equal the full sorts they replaced, and the
wrappers refuse what the kernel does not take. A model of the f32 form's
key (`f32_keys`: the order image of the value above the complemented
column) selected by `topk_select_plain` and decoded equals the stable
descending sort's prefix, values bit for bit and indices, on ties, signed
zeros, -inf rows, NaN, one column, no rows and k past the width; NaNs
with the sign bit or another payload fall where the card's sort puts them,
by their bits; the radix model with the f32 form's skipped column digits
picks the same keys.
The kernel itself runs in `tests/test_torch_topk_select_cuda.py`.
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


def radix_select_model(u, kout, bits, col_top=None):
    """The kernel's select on one row of order keys (numpy uint64 holding
    `bits`-bit values): the multiset of the kout smallest. With `col_top`
    (the f32 form) the passes over the low 32 bits at and above it are
    skipped, as the kernel skips column digits no column of the row has."""
    prefix, pmask, krem = 0, 0, kout
    for shift in range(bits - 8, -1, -8):
        if col_top is not None and col_top <= shift < 32:
            continue
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


def test_launches_sum_the_counted_kinds(monkeypatch):
    """`launches` sums `FORM_LAUNCHES` over the kinds asked for, every kind
    by default."""
    import collections

    monkeypatch.setattr(T, "FORM_LAUNCHES", collections.Counter(
        {"int32.shared": 2, "packed.row_device": 3, "int64.device": 5, "f32.shared": 7,
         "f32.device": 11}))
    assert T.launches() == 28
    assert T.launches(T.KEY_KINDS) == 10
    assert T.launches(("f32",)) == 18
    assert T.launches(("int64", "f32")) == 23
    assert sorted(T.KINDS) == ["f32", "int32", "int64", "packed"]


def test_plain_runs_never_count():
    before = T.launches()
    T.topk_select(torch.arange(8, dtype=torch.int64).reshape(2, 4), 2, False)
    T.topk_packed_select(torch.arange(8, dtype=torch.int32).reshape(2, 4), 2, 0, 2)
    assert T.launches() == before


NAN, INF = float("nan"), float("inf")
COL_MASK = (1 << 32) - 1


def f32_keys(scores):
    """scores f32[B, n] → the f32 form's unique keys int64[B, n],
    `(ord(v) << 32) | (2^32 - 1 - c)` less 2^63 (so signed order is the
    unsigned key's): ord maps the f32 bits in order, -0.0 as +0.0, a NaN
    above +inf without the sign bit and below -inf with it. Their
    descending order is the card's stable descending sort's."""
    u = scores.contiguous().view(torch.int32).to(torch.int64) & COL_MASK
    u = torch.where(scores == 0, 0, u)                        # -0.0 as +0.0
    ord_ = torch.where(u >= 1 << 31, COL_MASK - u, u + (1 << 31))
    col = torch.arange(scores.shape[1], device=scores.device)
    return ((ord_ - (1 << 31)) << 32) | (COL_MASK - col)


def decode_f32_keys(keys, scores):
    """Keys of `f32_keys(scores)` (or a selection of them, per row) →
    (their values f32, with the input's bits; their columns int64)."""
    col = COL_MASK - (keys & COL_MASK)
    return torch.gather(scores, 1, col), col


def f32_rows(case, b, n, seed):
    """f32[b, n] rows of one kind: scores of a select at the edges the
    stable sort's order rules cover."""
    rng = np.random.default_rng(seed)
    if case == "random":
        x = rng.standard_normal((b, n)).astype(np.float32)
    elif case == "ties":          # few distinct values: every select cuts a tie
        x = rng.integers(-3, 4, (b, n)).astype(np.float32) / 4
    elif case == "signed_zeros":  # -0.0 and +0.0 tie, beside small values
        x = np.where(rng.random((b, n)) < 0.5, -0.0, 0.0).astype(np.float32)
        x[:, ::7] = rng.choice([-1e-38, 1e-38, -1.0, 1.0], x[:, ::7].shape)
    elif case == "neg_inf":       # rows of -inf, all or nearly all
        x = np.full((b, n), -INF, dtype=np.float32)
        x[1:, ::11] = rng.standard_normal(x[1:, ::11].shape)
    elif case == "nan":           # the default NaN, and +-inf
        x = rng.standard_normal((b, n)).astype(np.float32)
        x[:, ::5] = NAN
        x[:, 2::9] = -INF
        x[:, 3::13] = INF
    else:
        raise ValueError(case)
    return torch.from_numpy(x)


def sorted_prefix_f32(x, k):
    s, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return s[:, :k], idx[:, :k]


F32_CASES = ["random", "ties", "signed_zeros", "neg_inf", "nan"]


@pytest.mark.parametrize("b,n,k", [(4, 257, 32), (3, 1_000, 128), (2, 1, 1), (2, 1, 5),
                                   (3, 40, 40), (3, 40, 64), (0, 17, 4), (5, 3, 0)])
@pytest.mark.parametrize("case", F32_CASES)
def test_f32_key_equals_stable_sort(case, b, n, k):
    """The f32 form's key: selected by `topk_select_plain`, decoded to
    (value, index), the stable descending sort's prefix, values bit for
    bit; with k >= n the whole sort, with B == 0 nothing."""
    x = f32_rows(case, b, n, seed=n * 31 + k)
    keys = f32_keys(x)
    assert keys.dtype == torch.int64 and keys.shape == x.shape
    assert int(torch.unique(keys, dim=1).shape[1] if b else n) == n      # unique in a row
    vals, idx = decode_f32_keys(T.topk_select_plain(keys, k, True), x)
    want_s, want_i = sorted_prefix_f32(x, k)
    assert idx.shape == want_i.shape == (b, min(k, n))
    assert torch.equal(idx, want_i)
    assert torch.equal(vals.view(torch.int32), want_s.view(torch.int32))


NAN_BITS = [0x3F800000,              # 0: 1.0
            -4194304,                # 1: a NaN with the sign bit, 0xFFC00000
            0x7FC00000,              # 2: the default NaN
            -8388608,                # 3: -inf
            0x7F800001,              # 4: a NaN with the least payload
            -0x80000000,             # 5: -0.0
            0x7F800000,              # 6: +inf
            0,                       # 7: +0.0
            -4194303,                # 8: a NaN with the sign bit, 0xFFC00001
            0x7FC00000]              # 9: the default NaN again


def test_f32_key_orders_nan_as_the_card():
    """NaN as the card's stable sort orders it at every width (the CPU's
    puts every NaN first, tied): without the sign bit above +inf, the
    larger payload first; with it below -inf, the larger payload last;
    -0.0 ties +0.0."""
    x = torch.tensor([NAN_BITS], dtype=torch.int32).view(torch.float32)
    vals, idx = decode_f32_keys(T.topk_select_plain(f32_keys(x), 10, True), x)
    assert idx[0].tolist() == [2, 9, 4, 6, 0, 5, 7, 3, 1, 8]
    assert torch.equal(vals.view(torch.int32), torch.gather(x, 1, idx).view(torch.int32))


@pytest.mark.parametrize("case", F32_CASES)
def test_f32_form_cpu_is_the_stable_sort(case):
    """`topk_select_f32` on a CPU tensor: the stable sort's prefix, int64
    indices, a non-contiguous input taken, no launch counted."""
    x = f32_rows(case, 6, 300, seed=5)
    forms = dict(T.FORM_LAUNCHES)
    for m in (1, 10, 300, 1_000):
        s, i = T.topk_select_f32(x, m)
        want_s, want_i = sorted_prefix_f32(x, m)
        assert s.dtype == torch.float32 and i.dtype == torch.int64
        assert torch.equal(i, want_i) and torch.equal(s.view(torch.int32),
                                                      want_s.view(torch.int32))
    s, i = T.topk_select_f32(x.t(), 4)
    assert torch.equal(i, sorted_prefix_f32(x.t().contiguous(), 4)[1])
    assert dict(T.FORM_LAUNCHES) == forms


@pytest.mark.parametrize("kout", [1, 10, 128, 1_024, 3_000])
@pytest.mark.parametrize("case", F32_CASES)
def test_radix_select_model_f32(case, kout):
    """The kernel's select over the f32 form's order keys ((~ord << 32) |
    column, ascending), skipping the column digits past the row's width,
    picks the stable sort's first kout keys."""
    n = 3_000
    x = f32_rows(case, 1, n, seed=kout)
    signed = f32_keys(x)[0].numpy()
    key = signed.view(np.uint64) ^ np.uint64(1 << 63)                 # the unsigned key
    u = ~key                                                            # smallest wanted
    col = (u & np.uint64(0xFFFFFFFF)).astype(np.int64)
    assert np.array_equal(np.sort(col), np.arange(n))
    col_top = 8 * -(-(n - 1).bit_length() // 8)
    got = radix_select_model(u, kout, 64, col_top)
    assert np.array_equal(got, np.sort(u)[:kout])
    want_i = sorted_prefix_f32(x, kout)[1][0].numpy()
    assert np.array_equal((got & np.uint64(0xFFFFFFFF)).astype(np.int64), want_i)


def test_f32_refusals():
    x = torch.zeros((3, 4))
    with pytest.raises(TypeError):
        T.topk_select_f32(x.double(), 2)
    with pytest.raises(TypeError):
        T.topk_select_f32(x.to(torch.bfloat16), 2)
    with pytest.raises(ValueError, match="2-D"):
        T.topk_select_f32(x.reshape(-1), 2)
    with pytest.raises(ValueError, match="k must"):
        T.topk_select_f32(x, -1)
    with pytest.raises(ValueError, match="device"):
        T.topk_select_f32(torch.empty((3, 4), device="meta"), 2)


def test_top_sorted_takes_the_sort_on_the_cpu():
    """`ops/rerank.top_sorted` on CPU tensors is the stable sort's prefix
    (the plain version the JAX package's tests hold)."""
    from similaritysearchbyrdf_tpu_torch.ops.rerank import top_sorted

    x = f32_rows("ties", 4, 500, seed=9)
    before = T.launches()
    s, i = top_sorted(x, 50)
    want_s, want_i = sorted_prefix_f32(x, 50)
    assert torch.equal(i, want_i) and torch.equal(s, want_s)
    assert T.launches() == before
