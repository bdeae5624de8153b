"""The top-k select kernel (`csrc/topk_select.cu`) on the card: bit for bit
equal to `torch.sort(keys)[0][:, :k]` at the folded Deep cell's shapes
(128 x 32,768 int32 keys to 1,792, with the group select's packing built in;
128 x 14,336 int64 keys to 4,096), at small and unaligned widths, on rows of
repeated keys, and past shared memory (rows read from device memory, winners
sorted in scratch). A small folded forest at the cell's settings (group 8,
windows of 512, rows_keep 0, stage2 4,096 of 14,336) answers bit-equal to
the same forest with the selects as full sorts, stage2's input and output
included, and each chunk launches the key forms twice. The f32 form
(`topk_select_f32`, which `ops/rerank.top_sorted` takes on the card)
equals the stable descending sort's prefix, values bit for bit and
indices, at the benchmark cells' select shapes, past shared memory, and on
rows of ties, signed zeros, -inf and NaN; each shape counts its launch
under the form it should take; and an IVF index at the IVF cell's settings
answers bit-equal to the same index selecting by full stable sorts. A
NaN falls where the card's sort puts it at every width, from one column
up: first without the sign bit, last with it, each by its bits (the CPU's
sort puts every NaN first). Needs
an NVIDIA GPU; run on the card without the suite's conftest, which
imports jax:

    python -m pytest --noconftest -q -m cuda tests/test_torch_topk_select_cuda.py
"""

import numpy as np
import pytest
import torch

from similaritysearchbyrdf_tpu_torch import (DenseBatch, IVFFlatIndex, RDFConfig, RDFForest,
                                             TableConfig)
from similaritysearchbyrdf_tpu_torch.index import forest as F
from similaritysearchbyrdf_tpu_torch.ops import flat as FL
from similaritysearchbyrdf_tpu_torch.ops import ivf as IVF
from similaritysearchbyrdf_tpu_torch.ops import rerank as R
from similaritysearchbyrdf_tpu_torch.ops.kernels import topk_select as T

pytestmark = pytest.mark.cuda
CHUNK = 128
# the IVF cell's window select: `ivf_window_budget` windows of 256 slots at
# its fit (ivf_deep96: 9,990,000 rows, 39,023 clusters, nprobe 32)
IVF_WB = 128


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def unique_keys(b, n, dtype, dev, seed):
    """int[b, n] on the card, unique in each row and spread over the type's
    range: int32 one random value in each of n equal spans, int64 random
    high bits over the column's rank; columns in random order."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    order = torch.rand((b, n), generator=gen, device=dev).argsort(dim=1)
    if dtype == torch.int32:
        span = 2**32 // n
        jitter = torch.randint(0, min(span, 2**31 - 1), (b, n), generator=gen, device=dev)
        vals = -(2**31) + order * span + jitter
    else:
        high = torch.randint(-(2**46), 2**46, (b, n), generator=gen, device=dev)
        vals = (high << 17) | order                  # n <= 2^17
    return vals.to(dtype).contiguous()


def sorted_prefix(keys, k, descending):
    return torch.sort(keys, dim=1, descending=descending)[0][:, :k]


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("b,n,k,dtype", [
    (128, 32_768, 1_792, torch.int32),      # the group select's shape
    (128, 14_336, 4_096, torch.int64),      # stage2's
    (5, 1, 1, torch.int32), (5, 1, 3, torch.int64),
    (9, 7, 3, torch.int32), (9, 7, 7, torch.int64), (9, 7, 100, torch.int32),
    (3, 1_000, 1, torch.int64), (3, 4_099, 4_097, torch.int32),
    (4, 65_536, 1_792, torch.int32),        # row past shared memory
    (2, 65_536, 65_536, torch.int32),       # and the winners too
    (2, 40_000, 30_000, torch.int64),
])
def test_kernel_equals_sorted_prefix(dev, b, n, k, dtype, descending):
    keys = unique_keys(b, n, dtype, dev, seed=n + k)
    got = T.topk_select(keys, k, descending)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, min(k, n)) and got.is_contiguous()
    assert torch.equal(got, sorted_prefix(keys, k, descending))


@pytest.mark.parametrize("n", [14_336, 65_536])
def test_kernel_on_repeated_keys(dev, n):
    """stage2's dead entries repeat one key; rows all of one value, rows of
    a few values, and live keys among dead ones."""
    sent = 1 << 30
    dead = (2 * sent) << 31 | sent
    keys = torch.full((6, n), dead, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(n)
    keys[1] = torch.randint(0, 3, (n,), generator=gen, device=dev)
    for r, live in ((2, 5), (3, 4_095), (4, 4_096), (5, 9_000)):
        pos = torch.randperm(n, generator=gen, device=dev)[:live]
        ids = torch.randperm(1 << 20, generator=gen, device=dev)[:live]
        neg = torch.randint(-4_000_000, 4_000_000, (live,), generator=gen, device=dev)
        keys[r, pos] = ((neg + sent) << 31) | ids
    for k in (1, 4_096, n):
        got = T.topk_select(keys, k, descending=False)
        assert torch.equal(got, sorted_prefix(keys, k, False))
        got = T.topk_select(keys.to(torch.int32), k, descending=True)
        assert torch.equal(got, sorted_prefix(keys.to(torch.int32), k, True))


def test_shapes_of_one_form_in_turn(dev):
    """The shared-memory allowance is set once per device and shape, not at
    each launch: a wide row of a form after a narrow one of the same form,
    and the narrow one again, each still launch and agree."""
    for n, k in ((64, 8), (32_768, 1_792), (64, 8), (28_000, 4_096), (32_768, 1_792)):
        keys = unique_keys(3, n, torch.int32, dev, seed=n)
        assert T._form(dev.index, n, k, 4) == 0
        assert torch.equal(T.topk_select(keys, k, True), sorted_prefix(keys, k, True))


@pytest.mark.parametrize("b,width,k,sh,bits_w", [
    (128, 32_768, 1_792, 5, 15),            # the folded Deep cell
    (7, 4_096, 1_000, 0, 12), (3, 65_536, 2_048, 9, 16), (2, 33, 40, 31, 6),
])
def test_packed_kernel_equals_forest_pack(dev, b, width, k, sh, bits_w):
    gen = torch.Generator(device=dev).manual_seed(width)
    vals = torch.randint(-(2**31) + 1, 2**31 - 1, (b, width), generator=gen, device=dev,
                         dtype=torch.int32)
    vals[:, ::3] = -(2**31 - 1)              # K3's dead rows
    vals[1:, 5::7] = vals[1:, 4::7][:, : vals[1:, 5::7].shape[1]]   # tied values
    got = T.topk_packed_select(vals, k, sh, bits_w)
    want = sorted_prefix(T.pack_keys_plain(vals, sh, bits_w), k, True)
    assert torch.equal(got, want)


def test_refuses_a_tensor_in_another_form(dev):
    keys = unique_keys(4, 64, torch.int32, dev, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        T.topk_select(keys.t(), 3, True)
    with pytest.raises(TypeError):
        T.topk_select(keys.float(), 3, True)


def eager(st, q, qi, layout, **kw):
    """The chunk query with every stage eager: `_query_chunk` with no chain."""
    o = F.QueryOptions(**kw)
    return F._query_chunk(st, q, qi, layout, o, F._coarse_plan(st, o), None)


def folded_forest(dev):
    rng = np.random.default_rng(96)
    n = 200_000
    centers = rng.normal(size=(2_000, 96))
    x = centers[rng.integers(0, 2_000, n)] + 0.35 * rng.normal(size=(n, 96))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    conf = RDFConfig(vector_dim=96, table_num=10, permutation_num=3, family_size=100,
                     generate_by_pulling=True, is_orthogonal=True, partition_bits=3,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=2000),
                     fit_batch_size=8192, query_batch_size=CHUNK, max_candidates=262_144,
                     top_k=10, seed=31258, coarse_dim=16, coarse_dtype="int8",
                     coarse_layout="folded", coarse_window=512, coarse_group=8,
                     coarse_rows_keep=0, coarse_refine=14_336, coarse_stage2=4_096)
    forest = RDFForest(conf, device=dev).fit(DenseBatch(np.arange(n, dtype=np.int32), x))
    q = torch.as_tensor(x[rng.integers(0, n, 3 * CHUNK + 40)], device=dev)
    return forest, q


KW = dict(steps=1, probe_mode="margin", probe_budget=16, m_cap=262_144, k=10,
          coarse_refine=14_336, coarse_window=512, coarse_group=8, rows_keep=0, stage2=4_096)


def test_folded_forest_equals_the_sort_path(dev, monkeypatch):
    forest, q = folded_forest(dev)
    st, layout = forest.state, forest.layout
    qi = torch.full((CHUNK,), -1, dtype=torch.int32, device=dev)
    chunks = [q[c:c + CHUNK] for c in range(0, q.shape[0], CHUNK)]
    seen = []
    real_stage2 = F._stage2

    def stage2(folded, qi8, base, t2, cand2, gsl, rpg, keep):
        out = real_stage2(folded, qi8, base, t2, cand2, gsl, rpg, keep)
        seen.append((cand2.clone(), out.clone()))
        return out

    monkeypatch.setattr(F, "_stage2", stage2)
    before, before_f32 = T.launches(T.KEY_KINDS), T.FORM_LAUNCHES["f32.shared"]
    got = [eager(st, c, qi[:c.shape[0]], layout, **KW) for c in chunks]
    torch.cuda.synchronize()
    assert T.launches(T.KEY_KINDS) == before + 2 * len(chunks)
    assert T.FORM_LAUNCHES["f32.shared"] > before_f32        # the rerank's top-k
    got_stage2, seen[:] = list(seen), []
    # the full sorts, cut to their prefix: the key forms' and top_sorted's
    monkeypatch.setattr(F, "topk_select", T.topk_select_plain)
    monkeypatch.setattr(F, "topk_packed_select", lambda v, k, sh, bits_w: T.topk_select_plain(
        T.pack_keys_plain(v, sh, bits_w), k, True))
    monkeypatch.setattr(R, "top_sorted", T.topk_select_f32_plain)
    launches = T.launches()
    want = [eager(st, c, qi[:c.shape[0]], layout, **KW) for c in chunks]
    assert T.launches() == launches
    assert len(got_stage2) == len(seen) == len(chunks)
    for (c_got, s_got), (c_want, s_want) in zip(got_stage2, seen):
        assert torch.equal(c_got, c_want)                  # the group select's slots
        assert torch.equal(s_got, s_want)                  # stage2's ids
        assert int((s_got >= 0).sum()) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b)
    ids = torch.cat([g[0] for g in got])
    assert int((ids >= 0).sum()) > 0.9 * ids.numel()


def f32_rows(case, b, n, dev, seed):
    """f32[b, n] on the card: scores of one kind (see the cases below)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if case == "random":
        return torch.randn((b, n), generator=gen, device=dev)
    if case == "int8_scores":    # K2b's int8 products times one scale: many ties
        q = torch.randint(-20_000, 20_001, (b, n), generator=gen, device=dev)
        x = q.to(torch.float32) * 3.0517578e-05
        return torch.where(torch.rand((b, n), generator=gen, device=dev) < 0.3, -INF, x)
    if case == "all_equal":
        return torch.full((b, n), 0.25, device=dev)
    if case == "signed_zeros":   # -0.0 and +0.0 tie, among few other values
        x = torch.where(torch.rand((b, n), generator=gen, device=dev) < 0.5, -0.0, 0.0)
        pick = torch.rand((b, n), generator=gen, device=dev)
        x = torch.where(pick < 0.02, 1.0, torch.where(pick > 0.98, -1.0, x))
        return x.contiguous()
    if case == "mostly_neg_inf":  # a few finite entries, fewer than some k
        x = torch.full((b, n), -INF, device=dev)
        live = torch.rand((b, n), generator=gen, device=dev) < 20 / n
        return torch.where(live, torch.randn((b, n), generator=gen, device=dev), x)
    if case in ("nan", "nan_positive"):   # NaN (of both signs), +-inf, values
        x = torch.randn((b, n), generator=gen, device=dev)
        x[:, ::5] = NAN
        x[:, 2::9] = -INF
        x[:, 3::13] = INF
        if case == "nan":        # the sign bit, other payloads
            x.view(torch.int32)[:, 1::17] = -4194304
            x.view(torch.int32)[:, 4::19] = 0x7F800001
            x.view(torch.int32)[:, 6::23] = -4194303
        return x
    raise ValueError(case)


NAN, INF = float("nan"), float("inf")


def assert_stable_prefix(x, k):
    """The f32 form against the card's stable descending sort's prefix."""
    got_s, got_i = T.topk_select_f32(x, k)
    torch.cuda.synchronize()
    want_s, want_i = T.topk_select_f32_plain(x, k)
    assert got_s.shape == got_i.shape == (x.shape[0], min(k, x.shape[1]))
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int64
    assert got_s.is_contiguous() and got_i.is_contiguous()
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))


F32_SHAPES = [
    (1_024, 39_023, 32, "shared"),          # IVF's centroid select
    (1_024, IVF_WB * 256, 128, "shared"),   # IVF's window select
    (128, 16_384, 1_024, "shared"),         # the forest's _select_rows chunk
    (32, 39_023, 32, "shared"),             # a single IVF query padded to 32 rows
    (1_024, 128, 10, "shared"),             # the refine's top-10
    (7, 1, 1, "shared"), (5, 33, 100, "shared"), (3, 4_099, 4_097, "shared"),
    (4, 65_536, 100, "row_device"),         # a row past shared memory
    (2, 100_000, 1_000, "row_device"),
    (2, 65_536, 20_000, "device"),          # and the winners too
]


@pytest.mark.parametrize("case", ["random", "int8_scores"])
@pytest.mark.parametrize("b,n,k,form", F32_SHAPES)
def test_f32_kernel_equals_stable_sort(dev, b, n, k, form, case):
    x = f32_rows(case, b, n, dev, seed=n + k)
    assert_stable_prefix(x, k)


@pytest.mark.parametrize("case", ["all_equal", "signed_zeros", "mostly_neg_inf", "nan",
                                  "nan_positive"])
@pytest.mark.parametrize("b,n,k", [(64, 39_023, 32), (64, 16_384, 1_024), (4, 65_536, 100),
                                   (2, 65_536, 20_000), (9, 300, 300), (5, 1, 1),
                                   (6, 7, 4), (6, 32, 10), (6, 100, 32), (6, 128, 128), (6, 129, 50)])
def test_f32_kernel_on_adversarial_rows(dev, b, n, k, case):
    assert_stable_prefix(f32_rows(case, b, n, dev, seed=k), k)


@pytest.mark.parametrize("b,n,k,form", F32_SHAPES)
def test_f32_form_counts(dev, b, n, k, form):
    """Each shape launches once, counted under the form it should take."""
    x = f32_rows("random", b, n, dev, seed=1)
    before = dict(T.FORM_LAUNCHES)
    T.topk_select_f32(x, k)
    after = dict(T.FORM_LAUNCHES)
    grew = {key: after[key] - before.get(key, 0) for key in after
            if after[key] != before.get(key, 0)}
    assert grew == {f"f32.{form}": 1}


def test_f32_empty_and_strided(dev):
    """No rows, k 0, and a transposed view (copied) launch nothing or agree."""
    before = T.launches()
    s, i = T.topk_select_f32(torch.empty((0, 50), device=dev), 10)
    assert s.shape == i.shape == (0, 10)
    s, i = T.topk_select_f32(torch.randn((4, 50), device=dev), 0)
    assert s.shape == i.shape == (4, 0)
    assert T.launches() == before
    x = torch.randn((300, 6), device=dev)
    s, i = T.topk_select_f32(x.t(), 17)
    want_s, want_i = T.topk_select_f32_plain(x.t().contiguous(), 17)
    assert torch.equal(i, want_i) and torch.equal(s, want_s)


def test_top_sorted_launches_no_sort(dev):
    """`top_sorted` on the card is one launch of the f32 form and runs no
    sort kernel."""
    x = torch.randn((256, 5_000), device=dev)
    before = T.launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        s, i = R.top_sorted(x, 64)
        torch.cuda.synchronize()
    assert T.launches() == before + 1
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("topk_select_f32_kernel" in nm for nm in names), names
    assert not any("Sort" in nm or "sort" in nm for nm in names), names


def ivf_corpus(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n // 300, d))
    x = centers[rng.integers(0, len(centers), n)] + 0.5 * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def test_ivf_equals_the_sort_path(dev, monkeypatch):
    """IVF at the IVF cell's settings (target_cluster 256, nprobe 32, win
    256, refine 128, 8 iterations, batches of 1,024) on a 400,000-row
    corpus: ids and scores bit-equal to the same index whose selects are
    full stable sorts, three f32 launches a batch (centroid, window and
    refine selects)."""
    n = 400_000
    x = ivf_corpus(n, 96, 3)
    index = IVFFlatIndex(target_cluster=256, nprobe=32, win=256, refine=128, iters=8,
                         query_batch=1_024, seed=0, device=dev).fit(
        DenseBatch(np.arange(n, dtype=np.int32), x))
    q = x[np.random.default_rng(4).integers(0, n, 2_048)]
    before = T.FORM_LAUNCHES["f32.shared"]
    got_i, got_s = index.query_device(q, k=10)
    torch.cuda.synchronize()
    assert T.FORM_LAUNCHES["f32.shared"] == before + 3 * 2
    monkeypatch.setattr(IVF, "top_sorted", T.topk_select_f32_plain)
    monkeypatch.setattr(FL, "top_sorted", T.topk_select_f32_plain)
    launches = T.launches()
    want_i, want_s = index.query_device(q, k=10)
    assert T.launches() == launches
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))
    assert int((got_i >= 0).sum()) > 0.99 * got_i.numel()
