"""The top-k select kernel (`csrc/topk_select.cu`) on the card: bit for bit
equal to `torch.sort(keys)[0][:, :k]` at the folded Deep cell's shapes
(128 x 32,768 int32 keys to 1,792, with the group select's packing built in;
128 x 14,336 int64 keys to 4,096), at small and unaligned widths, on rows of
repeated keys, and past shared memory (rows read from device memory, winners
sorted in scratch). A small folded forest at the cell's settings (group 8,
windows of 512, rows_keep 0, stage2 4,096 of 14,336) answers bit-equal to
the same forest with the selects as full sorts, stage2's input and output
included, and each chunk launches the kernel twice. Needs an NVIDIA GPU;
run on the card without the suite's conftest, which imports jax:

    python -m pytest --noconftest -q -m cuda tests/test_torch_topk_select_cuda.py
"""

import numpy as np
import pytest
import torch

from similaritysearchbyrdf_tpu_torch import DenseBatch, RDFConfig, RDFForest, TableConfig
from similaritysearchbyrdf_tpu_torch.index import forest as F
from similaritysearchbyrdf_tpu_torch.ops.kernels import topk_select as T

pytestmark = pytest.mark.cuda
CHUNK = 128


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
    before = T.LAUNCHES
    got = [eager(st, c, qi[:c.shape[0]], layout, **KW) for c in chunks]
    torch.cuda.synchronize()
    assert T.LAUNCHES == before + 2 * len(chunks)
    got_stage2, seen[:] = list(seen), []
    # the parent's selects: full sorts, cut to their prefix
    monkeypatch.setattr(F, "topk_select", T.topk_select_plain)
    monkeypatch.setattr(F, "topk_packed_select", lambda v, k, sh, bits_w: T.topk_select_plain(
        T.pack_keys_plain(v, sh, bits_w), k, True))
    want = [eager(st, c, qi[:c.shape[0]], layout, **KW) for c in chunks]
    assert T.LAUNCHES == before + 2 * len(chunks)
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
