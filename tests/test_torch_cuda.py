"""The port's CUDA kernels on the card against their plain PyTorch versions.

These need an NVIDIA GPU and nvcc (the kernels have no CPU mode), so they
carry the `cuda` marker and skip elsewhere. Run them on the card without
the suite's conftest, which imports jax:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from similaritysearchbyrdf_tpu_torch import DenseBatch, RDFConfig, RDFForest, TableConfig
from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_fold as K3
from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_gather as K2
from similaritysearchbyrdf_tpu_torch.ops.kernels import hash_kernel as K1

pytestmark = pytest.mark.cuda
U = 2.0 ** -24


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b,d,t,p,c", [(1, 7, 1, 1, 5), (130, 100, 10, 3, 32),
                                       (65, 33, 3, 4, 17), (8, 300, 2, 2, 32)])
def test_hash_kernel_matches_plain(dev, b, d, t, p, c):
    rng = np.random.default_rng(b * d)
    x = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32), device=dev)
    proj = torch.as_tensor(rng.normal(size=(t, c, d)).astype(np.float32), device=dev)
    perm = torch.as_tensor(np.stack([[rng.permutation(c) for _ in range(p)]
                                     for _ in range(t)]).astype(np.int32), device=dev)
    before = K1.LAUNCHES
    hk, mk = K1.hash_dense_kernel(x, proj, perm, emit_margins=True)
    assert K1.LAUNCHES == before + 1
    hp, mp = K1.hash_dense_plain(x, proj, perm, emit_margins=True)
    # a bit may differ only where its dot is within float noise of zero
    dots = torch.einsum("bd,tcd->btc", x.double(), proj.double())
    near = (dots.abs() < 1e-4)[:, :, None, :].expand(-1, -1, p, -1)
    bits = torch.gather(near, 3, perm.long()[None].expand(b, -1, -1, -1)).long()
    near_word = (bits << torch.arange(31, 31 - c, -1, device=dev)).sum(-1).reshape(b, -1)
    assert not ((hk ^ hp) & ~near_word).any()
    assert torch.equal(torch.isinf(mk), torch.isinf(mp))
    fin = torch.isfinite(mp)
    _, m_abs = K1.hash_dense_plain(x.abs(), proj.abs(), perm, emit_margins=True)
    assert ((mk - mp).abs()[fin] <= 2 * d * U * m_abs[fin] + 1e-30).all()
    assert torch.equal(K1.hash_dense_kernel(x, proj, perm)[0], hk)


@pytest.mark.parametrize("cs,bs", [(8, 8), (16, 1), (32, 8), (64, 8), (128, 3), (256, 8)])
def test_coarse_kernel_matches_plain(dev, cs, bs):
    rng = np.random.default_rng(cs + bs)
    l, caprows, b, mb = 5, 300, 7, 33
    tier = torch.as_tensor(rng.integers(-127, 128, size=(l, caprows, cs)).astype(np.int8),
                           device=dev)
    q = torch.as_tensor(rng.normal(size=(b, cs)).astype(np.float32), device=dev)
    q = q.to(torch.bfloat16)
    table = torch.as_tensor(rng.integers(-2, l + 2, size=(b, mb)).astype(np.int32), device=dev)
    start = torch.as_tensor(rng.integers(-20, caprows + 20, size=(b, mb)).astype(np.int32),
                            device=dev)
    before = K2.LAUNCHES
    got = K2.coarse_block_scores_kernel(tier, q, table, start, bs)
    assert K2.LAUNCHES == before + 1
    want = K2.coarse_block_scores_plain(tier, q, table, start, bs)
    bound = 2 * cs * U * K2.coarse_block_scores_plain(tier.abs(), q.abs(), table, start, bs)
    assert ((got - want).abs() <= bound + 1e-30).all()


@pytest.mark.parametrize("win", [8, 64, 256])
@pytest.mark.parametrize("cs", [16, 32])
def test_window_kernel_matches_plain(dev, win, cs):
    rng = np.random.default_rng(win + cs)
    l, caprows, b, mb = 4, 1200, 9, 40
    tier = torch.as_tensor(rng.integers(-127, 128, size=(l, caprows, cs)).astype(np.int8),
                           device=dev)
    q = torch.as_tensor(rng.normal(size=(b, cs)).astype(np.float32), device=dev)
    q = q.to(torch.bfloat16)
    blk = rng.integers(-2, (caprows + win) // 8, size=(b, mb)) * 8
    start = blk + rng.integers(-8, win, size=(b, mb))
    end = np.where(rng.random((b, mb)) < 0.3, blk, start + rng.integers(0, 2 * win, (b, mb)))
    args = [torch.as_tensor(a.astype(np.int32), device=dev) for a in
            (rng.integers(-1, l + 1, size=(b, mb)), blk, start, end)]
    live = (args[1] < args[3]) & (args[1] + win > args[2])
    assert 0 < float(live.float().mean()) < 1
    before = K2.WINDOW_LAUNCHES
    got = K2.coarse_window_scores_kernel(tier, q, *args, live, win)
    assert K2.WINDOW_LAUNCHES == before + 1
    want = K2.coarse_window_scores_plain(tier, q, *args, live, win)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    bound = 2 * cs * U * K2.coarse_block_scores_plain(tier.abs(), q.abs(), args[0], args[1], win)
    assert ((got - want).abs()[fin] <= bound[fin] + 1e-30).all()
    assert torch.equal(K2.coarse_window_scores_kernel(tier, q, *args, live.to(torch.uint8), win),
                       got)


@pytest.mark.parametrize("rpg", [1, 8])
@pytest.mark.parametrize("emit2", [False, True])
@pytest.mark.parametrize("cs", [16, 64])
def test_rowmax_kernel_matches_plain(dev, rpg, emit2, cs):
    rng = np.random.default_rng(rpg * 10 + cs + emit2)
    l, capf, b, mb, wpr = 3, 640, 7, 21, 64
    folded = torch.as_tensor(rng.integers(-127, 128, (l, capf, 128), dtype=np.int8), device=dev)
    qi8 = torch.as_tensor(rng.integers(-127, 128, (b, cs), dtype=np.int8), device=dev)
    table = torch.as_tensor(rng.integers(-1, l + 1, (b, mb)).astype(np.int32), device=dev)
    rs = rng.integers(0, capf // 8 + 4, (b, mb)) * 8
    rs = np.where(rng.random((b, mb)) < 0.25, -1, rs)
    rs = torch.as_tensor(rs.astype(np.int32), device=dev)      # dead, and past capf - wpr
    mshift = (rpg * 128 // cs).bit_length() - 1
    before = K3.LAUNCHES
    got = K3.coarse_rowmax_kernel(folded, qi8, table, rs, wpr, rpg, mshift, emit2)
    assert K3.LAUNCHES == before + 1
    want = K3.coarse_rowmax_plain(folded, qi8, table, rs, wpr, rpg, mshift, emit2)
    for g, w in zip(got if emit2 else (got,), want if emit2 else (want,)):
        assert g.dtype == torch.int32 and torch.equal(g, w)


def test_kernel_wrappers_raise_on_bad_input(dev):
    x = torch.zeros((4, 8), device=dev)
    proj = torch.zeros((2, 33, 8), device=dev)
    perm = torch.zeros((2, 1, 33), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        K1.hash_dense_kernel(x, proj, perm)                   # chain longer than 32
    with pytest.raises(TypeError):
        K1.hash_dense_kernel(x.double(), proj[:, :32], perm[..., :32])
    tier = torch.zeros((2, 16, 24), dtype=torch.int8, device=dev)
    q = torch.zeros((3, 24), dtype=torch.bfloat16, device=dev)
    ti = torch.zeros((3, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        K2.coarse_block_scores_kernel(tier, q, ti, ti, 8)     # cs 24 unsupported
    with pytest.raises(TypeError):
        K2.coarse_block_scores_kernel(tier[..., :16], q[:, :16].float(), ti, ti, 8)
    live = torch.ones((3, 4), dtype=torch.bool, device=dev)
    t16, q16 = tier[..., :16].contiguous(), q[:, :16].contiguous()
    with pytest.raises(ValueError):
        K2.coarse_window_scores_kernel(t16, q16, ti, ti, ti, ti, live, 12)   # win % 8
    with pytest.raises(TypeError):
        K2.coarse_window_scores_kernel(t16, q16, ti, ti, ti, ti, live.float(), 8)
    folded = torch.zeros((2, 16, 128), dtype=torch.int8, device=dev)
    qi8 = torch.zeros((3, 16), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        K3.coarse_rowmax_kernel(folded, qi8[:, :12].contiguous(), ti, ti, 8, 1, 3)  # cs 12
    with pytest.raises(ValueError):
        K3.coarse_rowmax_kernel(folded, qi8, ti, ti, 32, 1, 3)     # window past the table
    with pytest.raises(TypeError):
        K3.coarse_rowmax_kernel(folded, qi8.float(), ti, ti, 8, 1, 3)


def test_forest_on_card_matches_cpu(dev):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    ids = np.arange(3000, dtype=np.int32)
    conf = RDFConfig(vector_dim=32, table_num=4, permutation_num=2, family_size=40,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=48),
                     query_batch_size=64, max_candidates=4096, coarse_dim=16,
                     coarse_refine=64, seed=3)
    kw = dict(query_ids=ids[:128], probe_mode="margin", probe_budget=16)
    k1, k2 = K1.LAUNCHES, K2.LAUNCHES
    gpu, _ = RDFForest(conf, device=dev).fit(DenseBatch(ids, x)).query(x[:128], **kw)
    assert K1.LAUNCHES > k1 and K2.LAUNCHES > k2
    cpu, _ = RDFForest(conf).fit(DenseBatch(ids, x)).query(x[:128], **kw)
    assert (gpu == cpu).all(axis=1).mean() >= 0.99


@pytest.mark.parametrize("layout,extra", [
    ("lane", dict(m_cap=32768, window_keep=0)), ("lane", dict(m_cap=32768, window_keep=64)),
    ("folded", dict(rows_keep=0, coarse_window=256)),
    ("folded", dict(rows_keep=0, coarse_window=256, stage2=96, select_mult=2))])
def test_window_and_folded_on_card_match_cpu(dev, layout, extra):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    ids = np.arange(3000, dtype=np.int32)
    conf = RDFConfig(vector_dim=32, table_num=4, permutation_num=2, family_size=40,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=48),
                     query_batch_size=64, max_candidates=4096, coarse_dim=16,
                     coarse_refine=512, coarse_head_pool=16, coarse_layout=layout, seed=3)
    kw = dict(query_ids=ids[:128], probe_mode="margin", probe_budget=16, **extra)
    k2b, k3 = K2.WINDOW_LAUNCHES, K3.LAUNCHES
    gpu, _ = RDFForest(conf, device=dev).fit(DenseBatch(ids, x)).query(x[:128], **kw)
    assert (K3.LAUNCHES > k3) if layout == "folded" else (K2.WINDOW_LAUNCHES > k2b)
    cpu, _ = RDFForest(conf).fit(DenseBatch(ids, x)).query(x[:128], **kw)
    assert (gpu == cpu).all(axis=1).mean() >= 0.99
