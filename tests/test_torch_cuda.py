"""The port's CUDA kernels on the card against their plain PyTorch versions.

These need an NVIDIA GPU and nvcc (the kernels have no CPU mode), so they
carry the `cuda` marker and skip elsewhere. Run them on the card without
the suite's conftest, which imports jax:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from similaritysearchbyrdf_tpu_torch import (DenseBatch, DenseRDFInit, DynamicForest,
                                             FlatIndex, IVFFlatIndex, RDFConfig, RDFForest,
                                             RDFMap, TableConfig, fit_dense, flat_topk_grouped,
                                             generate_model, load_model_file,
                                             save_model_file)
from similaritysearchbyrdf_tpu_torch.experiments.harness import equal_up_to_ties
from similaritysearchbyrdf_tpu_torch.ops.exact import exact_search
from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_fold as K3
from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_gather as K2
from similaritysearchbyrdf_tpu_torch.ops.kernels import flat_groupmax as K4
from similaritysearchbyrdf_tpu_torch.ops import ivf as IVF
from similaritysearchbyrdf_tpu_torch.ops.kernels import hash_kernel as K1
from similaritysearchbyrdf_tpu_torch.ops.precision import matmul_f32

pytestmark = pytest.mark.cuda
U = 2.0 ** -24


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _check_hash(dev, b, d, t, p, c, seed, offset=0):
    """K1 against its plain version: no hash bit differs away from near-zero
    dots, margins within the f32 bound, the same hashes without margins.
    `offset` starts x that many floats into its buffer."""
    rng = np.random.default_rng(seed)
    buf = torch.as_tensor(rng.normal(size=b * d + offset).astype(np.float32), device=dev)
    x = buf[offset:].view(b, d)
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


@pytest.mark.parametrize("b,d,t,p,c", [(1, 7, 1, 1, 5), (130, 100, 10, 3, 32),
                                       (65, 33, 3, 4, 17), (8, 300, 2, 2, 32)])
def test_hash_kernel_matches_plain(dev, b, d, t, p, c):
    _check_hash(dev, b, d, t, p, c, b * d)


_CHAIN_PERMS = [(c, p) for c in (5, 17, 32) for p in (1, 2, 3, 4)]


@pytest.mark.parametrize("d", [7, 96, 100, 128, 300])
@pytest.mark.parametrize("b", [1, 7, 63, 64, 65, 1024, 8192])
def test_hash_kernel_rows_and_widths(dev, b, d):
    """Every B: one row, tiles of 32 rows cut short, the query's 1,024 and
    the fit's 8,192; every D: 7 (4-byte copies and a zero-padded last
    group), 96 to 128 (one staged chunk of 16-byte copies), 300 (three
    chunks, the last one short). C and P run through all 12 pairs of C 5,
    17, 32 and P 1-4 across the cases."""
    c, p = _CHAIN_PERMS[(b + d) % len(_CHAIN_PERMS)]
    _check_hash(dev, b, d, 10 if b <= 1024 else 3, p, c, b * 1000 + d)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("b", [1, 64, 8192])
@pytest.mark.parametrize("d", [1000, 4096, 5000])
def test_hash_kernel_wide_form(dev, d, b, offset):
    """The wide form (split-K f32 GEMM, then the epilogue kernel) at the
    sparse path's D 4096 and at D 1000 and 5000 (a short last k-slab, and a
    D that is no multiple of 32), at the query's B 64 (split across CTAs),
    the fit's B 8192 and one row; margins and none; rows one float into
    their buffer (4-byte copies)."""
    assert K1.kernel_form(d) == "wide"
    _check_hash(dev, b, d, 10, 3, 32, d + b + offset, offset=offset)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("c", [5, 17, 32])
def test_hash_kernel_chains_and_permutations(dev, c, p):
    _check_hash(dev, 65, 100, 10, p, c, 100 * c + p)


@pytest.mark.parametrize("d", [100, 101])
def test_hash_kernel_unaligned_rows(dev, d):
    """x starting one float into its buffer: not 16-byte aligned, so the
    rows are staged by 4-byte copies even where D is a multiple of 4."""
    _check_hash(dev, 65, d, 4, 3, 32, d, offset=1)


@pytest.mark.parametrize("cs,bs", [(8, 8), (16, 1), (24, 8), (32, 8), (64, 8), (96, 8),
                                   (128, 3), (224, 8), (256, 8), (800, 8), (2048, 2)])
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


@pytest.mark.parametrize("queries", ["integer", "float"])
@pytest.mark.parametrize("mb", [1, 33, 512])
@pytest.mark.parametrize("b", [1, 1024])
def test_block_kernel_main_shape(dev, b, mb, queries):
    """K2 at the block-mode main shape (int8, cs 32, 8-slot blocks), which
    takes its specialised kernel: B 1 and the bench's 1,024 queries, MB 1,
    33 (block counts that end mid-step) and 512, table ids out of range and
    starts past both ends of the tier, which the kernel clips. With integer
    queries (|q| <= 16) every partial sum is an integer below 2^24, so
    kernel and plain version agree bit for bit; with float queries within
    the f32 summation bound."""
    assert K2.block_kernel_form(32, 8, b, mb) == "b8"
    rng = np.random.default_rng(b * 1000 + mb)
    l, caprows, cs, bs = 30, 20_000, 32, 8
    tier = torch.as_tensor(rng.integers(-128, 128, size=(l, caprows, cs)).astype(np.int8),
                           device=dev)
    qv = (rng.integers(-16, 17, size=(b, cs)) if queries == "integer"
          else rng.normal(size=(b, cs)))
    q = torch.as_tensor(qv.astype(np.float32), device=dev).to(torch.bfloat16)
    table = torch.as_tensor(rng.integers(-2, l + 2, size=(b, mb)).astype(np.int32), device=dev)
    start = torch.as_tensor(rng.integers(-20, caprows + 20, size=(b, mb)).astype(np.int32),
                            device=dev)
    before = K2.LAUNCHES
    got = K2.coarse_block_scores_kernel(tier, q, table, start, bs)
    assert K2.LAUNCHES == before + 1
    want = K2.coarse_block_scores_plain(tier, q, table, start, bs)
    if queries == "integer":
        assert torch.equal(got, want)
    else:
        bound = 2 * cs * U * K2.coarse_block_scores_plain(tier.abs(), q.abs(), table, start, bs)
        assert ((got - want).abs() <= bound + 1e-30).all()


@pytest.mark.parametrize("cs,bs,b,mb,form", [
    (32, 8, 1024, 512, "b8"), (32, 8, 1, 1, "b8"), (32, 8, 7, 33, "b8"),
    (32, 4, 1024, 512, "generic"), (32, 16, 1024, 512, "generic"), (64, 8, 1024, 512, "b8"),
    (24, 8, 7, 33, "generic"), (16, 8, 1024, 512, "generic"),
    (32, 8, 1 << 16, 1 << 15, "generic")])
def test_block_kernel_form(dev, cs, bs, b, mb, form):
    """Only the block-mode main shapes (int8 cs 32 and the sparse tier's 64)
    take the specialised kernel; other widths and block sizes, and block
    counts past an int, the generic one. The Python mirror names the form
    the library chooses."""
    assert K2.block_kernel_form(cs, bs, b, mb) == form
    lib = K2.build.library()
    for bf16 in (0, 1):
        assert ("generic", "b8")[lib.rdf_coarse_block_form(cs, bs, b, mb, bf16)] == \
            K2.block_kernel_form(cs, bs, b, mb, bool(bf16))


@pytest.mark.parametrize("tier_dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("win", [8, 64, 256])
@pytest.mark.parametrize("cs", [16, 24, 32, 96, 128, 224, 800])
def test_window_kernel_matches_plain(dev, win, cs, tier_dtype):
    rng = np.random.default_rng(win + cs)
    l, caprows, b, mb = 4, 1200, 9, 40
    tier = torch.as_tensor(rng.integers(-127, 128, size=(l, caprows, cs)).astype(np.int8),
                           device=dev)
    if tier_dtype == torch.bfloat16:    # the flat engine's bf16 sketch as a tier
        tier = (tier.float() * 0.01).to(torch.bfloat16)
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


@pytest.mark.parametrize("tier_dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("cs", [2056, 4096])
def test_window_kernel_past_2048_columns_bit_equal(dev, cs, tier_dtype):
    """Past 2048 columns each lane walks its chunks and reads the query
    through L1. The queries are small integers (|q| <= 16) and the tier int8
    (or its exact bf16 copy), so every partial sum is an integer below 2^24,
    exact in f32 in any order: kernel and plain version agree bit for bit."""
    rng = np.random.default_rng(cs)
    l, caprows, b, mb, win = 2, 400, 5, 12, 64
    tier = torch.as_tensor(rng.integers(-127, 128, size=(l, caprows, cs)).astype(np.int8),
                           device=dev).to(tier_dtype)
    q = torch.as_tensor(rng.integers(-16, 17, size=(b, cs)).astype(np.float32), device=dev)
    q = q.to(torch.bfloat16)
    blk = rng.integers(0, (caprows - win) // 8, size=(b, mb)) * 8
    start = blk + rng.integers(-8, win, size=(b, mb))
    end = start + rng.integers(0, 2 * win, (b, mb))
    args = [torch.as_tensor(a.astype(np.int32), device=dev) for a in
            (rng.integers(0, l, size=(b, mb)), blk, start, end)]
    live = torch.as_tensor(rng.random((b, mb)) < 0.8, device=dev)
    got = K2.coarse_window_scores_kernel(tier, q, *args, live, win)
    want = K2.coarse_window_scores_plain(tier, q, *args, live, win)
    assert torch.isfinite(want).any() and torch.equal(got, want)
    if tier_dtype == torch.int8:   # K2 takes the same path past 2048 columns
        assert torch.equal(K2.coarse_block_scores_kernel(tier, q, args[0], args[1], 8),
                           K2.coarse_block_scores_plain(tier, q, args[0], args[1], 8))


@pytest.mark.parametrize("b,mb", [(1, 1), (1, 256), (7, 1), (3, 7), (128, 256), (37, 301),
                                  (131, 257)])
@pytest.mark.parametrize("tier_dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("cs", [32, 128])
def test_window_kernel_main_shapes_bit_equal(dev, cs, tier_dtype, b, mb):
    """K2b at the main path's shapes, 64-slot windows at cs 32 (window mode)
    and 128 (the flat engine's re-score); int8 takes the specialised kernel.
    The queries are small integers (|q| <= 16), so every partial sum is an
    integer below 2^24 and kernel and plain version agree bit for bit. Table
    ids out of range, windows clipped at caprows - 64, ranges that cut a
    window at one or both ends or miss it, dead windows, the first query's
    windows all dead, B 1, MB 1, window counts that end mid-step (21, 11,137,
    33,667) and the pruned shape (MB 256)."""
    rng = np.random.default_rng(cs * 1000 + b * mb)
    l, caprows, win = 3, 4096, 64
    tier = torch.as_tensor(rng.integers(-128, 128, size=(l, caprows, cs)).astype(np.int8),
                           device=dev).to(tier_dtype)
    q = torch.as_tensor(rng.integers(-16, 17, size=(b, cs)).astype(np.float32), device=dev)
    q = q.to(torch.bfloat16)
    blk = rng.integers(-2, (caprows + 16) // 8, size=(b, mb)) * 8
    cut_lo, cut_hi = rng.integers(1, 32, size=(2, b, mb))
    kind = rng.integers(0, 5, size=(b, mb))
    live_np = rng.random((b, mb)) < 0.7
    if b > 1:
        live_np[0] = False
    kind[-1, -1], live_np[-1, -1] = 1, True    # finite and -inf slots at every shape
    # 0 whole, 1 cut at both ends, 2 at the start, 3 at the end, 4 missed
    start = np.choose(kind, [blk - 3, blk + cut_lo, blk + cut_lo, blk - 3, blk + win])
    end = np.choose(kind, [blk + win + 3, blk + win - cut_hi, blk + win + 3, blk + win - cut_hi,
                           blk + win + 16])
    args = [torch.as_tensor(a.astype(np.int32), device=dev) for a in
            (rng.integers(-2, l + 2, size=(b, mb)), blk, start, end)]
    live = torch.as_tensor(live_np, device=dev)
    before = K2.WINDOW_LAUNCHES
    got = K2.coarse_window_scores_kernel(tier, q, *args, live, win)
    assert K2.WINDOW_LAUNCHES == before + 1
    want = K2.coarse_window_scores_plain(tier, q, *args, live, win)
    assert torch.isfinite(want).any() and torch.isneginf(want).any()
    assert torch.equal(got, want)
    assert torch.equal(K2.coarse_window_scores_kernel(tier, q, *args, live.to(torch.uint8), win),
                       got)
    if b > 1:
        assert torch.isneginf(got[0]).all()


@pytest.mark.parametrize("queries", ["integer", "float"])
@pytest.mark.parametrize("b,mb", [(1, 1), (7, 1), (3, 7), (64, 14), (37, 301), (1024, 14),
                                  (131, 257)])
@pytest.mark.parametrize("win", [64, 128])
def test_window_kernel_w96_matches_plain(dev, win, b, mb, queries):
    """K2b's w96 form (int8 cs 96, windows of 64 or 128 slots: IVF's and the
    D-96 flat engine's shapes) against its plain version: table ids out of
    range, windows whose start clips at 0 and at the table's end (caprows -
    win), ranges that cut a window at one or both ends, cut only its second
    half or miss it, dead windows, the first query's windows all dead, pair
    counts that end mid-step (1, 7, 21, 11,137, 33,667). Integer queries
    (|q| <= 16) make every partial sum an integer below 2^24, so the two
    agree bit for bit; float queries stay within the f32 bound with the same
    -inf slots. A second call gives the same words."""
    rng = np.random.default_rng(win * 100_000 + b * mb + len(queries))
    l, caprows = 3, 4096
    tier = torch.as_tensor(rng.integers(-128, 128, size=(l, caprows, 96)).astype(np.int8),
                           device=dev)
    qv = rng.integers(-16, 17, size=(b, 96)) if queries == "integer" else rng.normal(size=(b, 96))
    q = torch.as_tensor(qv.astype(np.float32), device=dev).to(torch.bfloat16)
    pool = np.array([-16, -8, 0, 8, caprows - win - 8, caprows - win, caprows - win + 8,
                     caprows])
    blk = np.where(rng.random((b, mb)) < 0.3, pool[rng.integers(0, len(pool), size=(b, mb))],
                   rng.integers(0, (caprows - win) // 8, size=(b, mb)) * 8)
    cut_lo, cut_hi = rng.integers(1, win // 2, size=(2, b, mb))
    kind = rng.integers(0, 6, size=(b, mb))
    live_np = rng.random((b, mb)) < 0.7
    if b > 1:
        live_np[0] = False
    kind[-1, -1], live_np[-1, -1] = 1, True    # finite and -inf slots at every shape
    # 0 whole, 1 cut at both ends, 2 at the start, 3 at the end, 4 missed,
    # 5 valid in the first half only (its second half loads nothing at 128)
    start = np.choose(kind, [blk - 3, blk + cut_lo, blk + cut_lo, blk - 3, blk + win, blk])
    end = np.choose(kind, [blk + win + 3, blk + win - cut_hi, blk + win + 3, blk + win - cut_hi,
                           blk + win + 16, blk + cut_lo])
    args = [torch.as_tensor(a.astype(np.int32), device=dev) for a in
            (rng.integers(-2, l + 2, size=(b, mb)), blk, start, end)]
    live = torch.as_tensor(live_np, device=dev)
    assert K2.window_kernel_form(96, win, b, mb) == "w96"
    before = K2.WINDOW_LAUNCHES
    got = K2.coarse_window_scores_kernel(tier, q, *args, live, win)
    assert K2.WINDOW_LAUNCHES == before + 1
    want = K2.coarse_window_scores_plain(tier, q, *args, live, win)
    assert torch.isfinite(want).any() and torch.isneginf(want).any()
    if queries == "integer":
        assert torch.equal(got, want)
    else:
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        fin = torch.isfinite(want)
        bound = 2 * 96 * U * K2.coarse_block_scores_plain(tier.abs(), q.abs(), args[0],
                                                          args[1], win)
        assert ((got - want).abs()[fin] <= bound[fin] + 1e-30).all()
    again = K2.coarse_window_scores_kernel(tier, q, *args, live.to(torch.uint8), win)
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    if b > 1:
        assert torch.isneginf(got[0]).all()


# (cs, lanes, wpr, rpg, B, MB, layout): every width of the kernel, windows
# shorter than one 16 KB ring stage (wpr 8), whole stages (64, 512 at fold
# 8) and a partial last stage (520); "mixed" has dead windows and windows
# past capf - wpr, "dead" only dead ones, "clamped" only clamped ones,
# "runs" consecutive windows of one table per query (the folded query's
# layout); B*MB from 3 (fewer than the grid's CTAs) to 38,400
_ROWMAX_CASES = [
    (16, 128, 8, 8, 7, 21, "mixed"), (16, 128, 64, 8, 7, 21, "mixed"),
    (16, 128, 512, 8, 5, 9, "runs"), (16, 128, 520, 8, 4, 6, "mixed"),
    (16, 128, 64, 1, 7, 21, "mixed"), (8, 128, 64, 8, 7, 21, "mixed"),
    (32, 128, 64, 2, 7, 21, "mixed"), (64, 128, 64, 1, 7, 21, "mixed"),
    (128, 128, 64, 1, 7, 21, "mixed"), (256, 256, 64, 1, 7, 21, "mixed"),
    (16, 128, 64, 8, 6, 11, "dead"), (32, 128, 64, 4, 6, 11, "clamped"),
    (16, 128, 64, 8, 1, 3, "mixed"), (16, 128, 8, 8, 64, 600, "mixed"),
]


@pytest.mark.parametrize("emit2", [False, True])
@pytest.mark.parametrize("cs,lanes,wpr,rpg,b,mb,layout", _ROWMAX_CASES)
def test_rowmax_kernel_matches_plain(dev, cs, lanes, wpr, rpg, b, mb, layout, emit2):
    rng = np.random.default_rng(cs + lanes + wpr + rpg + b + mb + emit2)
    l, capf = 3, max(640, 2 * wpr)
    folded = torch.as_tensor(rng.integers(-127, 128, (l, capf, lanes), dtype=np.int8),
                             device=dev)
    qi8 = torch.as_tensor(rng.integers(-127, 128, (b, cs), dtype=np.int8), device=dev)
    table = rng.integers(-1, l + 1, (b, mb))
    rs = rng.integers(0, capf // 8 + 4, (b, mb)) * 8
    if layout == "mixed":                                       # dead, and past capf - wpr
        rs = np.where(rng.random((b, mb)) < 0.25, -1, rs)
    elif layout == "dead":
        rs[:] = -1
    elif layout == "clamped":
        rs = capf - wpr + rng.integers(1, 64, (b, mb))
    else:                                                       # runs
        capf = mb * wpr + 64
        folded = torch.as_tensor(rng.integers(-127, 128, (l, capf, lanes), dtype=np.int8),
                                 device=dev)
        table = np.repeat(rng.integers(0, l, (b, 1)), mb, axis=1)
        rs = rng.integers(0, 8, (b, 1)) * 8 + np.arange(mb) * wpr
    table = torch.as_tensor(table.astype(np.int32), device=dev)
    rs = torch.as_tensor(rs.astype(np.int32), device=dev)
    mshift = (rpg * lanes // cs).bit_length() - 1
    before = K3.LAUNCHES
    got = K3.coarse_rowmax_kernel(folded, qi8, table, rs, wpr, rpg, mshift, emit2)
    assert K3.LAUNCHES == before + 1
    want = K3.coarse_rowmax_plain(folded, qi8, table, rs, wpr, rpg, mshift, emit2)
    for g, w in zip(got if emit2 else (got,), want if emit2 else (want,)):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    if layout == "dead":
        assert bool((got[0] if emit2 else got).eq(K3.I32_DEAD).all())


def test_kernel_wrappers_raise_on_bad_input(dev):
    x = torch.zeros((4, 8), device=dev)
    proj = torch.zeros((2, 33, 8), device=dev)
    perm = torch.zeros((2, 1, 33), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        K1.hash_dense_kernel(x, proj, perm)                   # chain longer than 32
    with pytest.raises(TypeError):
        K1.hash_dense_kernel(x.double(), proj[:, :32], perm[..., :32])
    tier = torch.zeros((2, 16, 20), dtype=torch.int8, device=dev)
    q = torch.zeros((3, 20), dtype=torch.bfloat16, device=dev)
    ti = torch.zeros((3, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        K2.coarse_block_scores_kernel(tier, q, ti, ti, 8)     # cs 20: not a multiple of 8
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
    with pytest.raises(ValueError):
        K3.coarse_rowmax_kernel(folded, qi8, ti, ti, 8, 3, 3)      # rpg not a power of 2
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
    cpu, _ = RDFForest(conf, device="cpu").fit(DenseBatch(ids, x)).query(x[:128], **kw)
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
    cpu, _ = RDFForest(conf, device="cpu").fit(DenseBatch(ids, x)).query(x[:128], **kw)
    assert (gpu == cpu).all(axis=1).mean() >= 0.99


def _check_groupmax_int8(dev, npad, group, d, b, esg_max=16):
    """K4 against its plain version, bit for bit, unpacked, packed and packed
    with the supergroup tier (where the key fits int32), on seeded random
    int8 operands with tied rows inside and across groups."""
    rng = np.random.default_rng(npad + group + d + b)
    sk = torch.as_tensor(rng.integers(-127, 128, (npad, d), dtype=np.int8), device=dev)
    q = torch.as_tensor(rng.integers(-127, 128, (b, d), dtype=np.int8), device=dev)
    sk[7::97] = sk[5]                                   # tied rows inside and across groups
    q[0], sk[3], sk[3, 0] = 127, 127, 126               # score 127^2 * d - 127
    ng = npad // group
    esg = min(esg_max, ng & -ng)                        # a power of two dividing NG
    packs = ((True, 0), (True, esg)) if d * 127 * 127 * group < 2**31 else ()
    for pack, emit in ((False, 0), *packs):
        before = K4.LAUNCHES
        got = K4.flat_groupmax_kernel(sk, q, group, pack_arg=pack, emit_sg=emit)
        assert K4.LAUNCHES == before + 1
        want = K4.flat_groupmax_plain(sk, q, group, pack_arg=pack, emit_sg=emit)
        for g, w in zip(got if emit else (got,), want if emit else (want,)):
            assert g.dtype == w.dtype and torch.equal(g, w), (pack, emit)


@pytest.mark.parametrize("npad", [2816, 3072])
@pytest.mark.parametrize("group", [16, 64, 256])
@pytest.mark.parametrize("d", [32, 96, 128, 224, 800, 1056])
@pytest.mark.parametrize("b", [1, 45, 64, 100, 128, 1024])
def test_groupmax_kernel_int8_matches_plain(dev, npad, group, d, b):
    """int8 dots are exact: K4 equals its plain version bit for bit, at
    ragged B and N (2816 rows end in a half 512-row block; at 3072 a
    supergroup spans blocks). D up to 128 takes the wgmma form (B 64 and 128
    fill one and two 64-query tiles; 1024 is the flat engine's batch), 224,
    800 and 1056 the K-looped form (1056 ends in a part-filled 128-byte
    slab); at 1056 query 0's score on row 3 passes 2^24 and is odd, so
    unpacked it is rounded once to f32 on both sides."""
    _check_groupmax_int8(dev, npad, group, d, b)


@pytest.mark.parametrize("b", [1, 63, 1000])
@pytest.mark.parametrize("group", [8, 64, 512])
@pytest.mark.parametrize("d", [224, 448, 800, 1056, 2080, 4096])
def test_groupmax_kernel_kloop_bit_equal(dev, d, group, b):
    """int8 past D 192 takes the K-looped wgmma form: bit for bit at every
    width up to the sparse path's 4096 (448 and 1056 end in a part-filled
    128-byte slab), G 8 (spans of 128 rows), 64 and 512 (two consumers fold
    a 512-row group), packed where the key fits int32 (D up to 2080 at G 64,
    224 at G 512) and with the supergroup tier; 2,624 rows end in a 64-row
    part of a 256-row tile (G 512: 2,560 rows, five tiles), B 63 and 1000
    end in part-filled query tiles."""
    assert K4.kernel_form(torch.int8, d) == "wgmma_kloop"
    _check_groupmax_int8(dev, 2560 if group == 512 else 2624, group, d, b)


@pytest.mark.parametrize("group", [8, 16, 32, 64])
@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("b", [1, 100, 1024])
def test_groupmax_kernel_int8_partial_tail(dev, group, d, b):
    """2624 rows: the last 512-row block holds 64 rows, half of one 128-row
    wgmma subtile; the zero-filled rest must reach no output word."""
    _check_groupmax_int8(dev, 2624, group, d, b)


@pytest.mark.parametrize("group", [8, 16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("b", [45, 1024])
def test_groupmax_kernel_every_group_emit16(dev, group, d, b):
    """Every G of the kernel at flat_8m's and flat_20k's widths, packed with
    the supergroup tier of 16 groups (groups of 128 to 512 rows span wgmma
    subtiles and, at 512, a whole block), plus one more block of 16 G rows."""
    npad = 16 * group * (-(-8192 // (16 * group)) + 1)
    _check_groupmax_int8(dev, npad, group, d, b)


@pytest.mark.parametrize("d", [32, 96, 128, 224, 800])
@pytest.mark.parametrize("b", [3, 64])
def test_groupmax_kernel_bf16_within_bound(dev, d, b):
    """bf16 products are exact in f32; only the summation order differs, so
    each group max is within 2*D*2^-24*sum|s*q| of the plain version's."""
    rng = np.random.default_rng(d * b)
    npad = 512 * 3 + 64 * 5
    sk = torch.as_tensor(rng.normal(size=(npad, d)).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32), device=dev)
    sk, q = sk.to(torch.bfloat16), q.to(torch.bfloat16)
    got = K4.flat_groupmax_kernel(sk, q, 64)
    want = K4.flat_groupmax_plain(sk, q, 64)
    bound = 2 * d * U * K4.flat_groupmax_plain(sk.abs(), q.abs(), 64)
    assert got.dtype == torch.float32 and ((got - want).abs() <= bound + 1e-30).all()


@pytest.mark.parametrize("b", [1, 45, 1000])
@pytest.mark.parametrize("group", [8, 16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 224, 800])
def test_groupmax_kernel_bf16_wgmma_forms(dev, d, group, b):
    """bf16 takes the wgmma form up to D 96 (rows of 192 bytes; blocks of
    256 rows up to G 256, of 512 at G 512) and the K-looped form past it,
    at every G from 8 to 512, B not a multiple of 64 and Npad an odd
    multiple of G (2,600-2,624 rows, ending mid-block; 2,560 at G 512):
    within the f32 bound of the plain version on float values, and on
    int8-valued operands word for word the int8 kernel's (every sum an
    integer below 2^24, exact in f32)."""
    assert K4.kernel_form(torch.bfloat16, d) == ("wgmma" if d <= 96 else "wgmma_kloop")
    rng = np.random.default_rng(d * 1000 + group + b)
    npad = group * (2600 // group | 1)
    sk = torch.as_tensor(rng.normal(size=(npad, d)).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32), device=dev)
    sk, q = sk.to(torch.bfloat16), q.to(torch.bfloat16)
    before = K4.LAUNCHES
    got = K4.flat_groupmax_kernel(sk, q, group)
    assert K4.LAUNCHES == before + 1
    want = K4.flat_groupmax_plain(sk, q, group)
    bound = 2 * d * U * K4.flat_groupmax_plain(sk.abs(), q.abs(), group)
    assert got.dtype == torch.float32 and ((got - want).abs() <= bound + 1e-30).all()
    assert torch.equal(K4.flat_groupmax_kernel(sk, q, group).view(torch.int32),
                       got.view(torch.int32))
    sk8 = torch.as_tensor(rng.integers(-127, 128, (npad, d), dtype=np.int8), device=dev)
    q8 = torch.as_tensor(rng.integers(-127, 128, (b, d), dtype=np.int8), device=dev)
    q8[0] = 0                                           # zero scores: +0, as int8's
    via_bf16 = K4.flat_groupmax_kernel(sk8.to(torch.bfloat16), q8.to(torch.bfloat16), group)
    assert torch.equal(via_bf16.view(torch.int32),
                       K4.flat_groupmax_kernel(sk8, q8, group).view(torch.int32))


def test_groupmax_kernel_raises_on_bad_input(dev):
    sk = torch.zeros((1024, 32), dtype=torch.int8, device=dev)
    q = torch.zeros((4, 32), dtype=torch.int8, device=dev)
    with pytest.raises(TypeError):
        K4.flat_groupmax_kernel(sk, q.float(), 64)                     # mixed types
    with pytest.raises(TypeError):
        K4.flat_groupmax_kernel(sk.float(), q.float(), 64)             # f32 sketch
    with pytest.raises(ValueError):
        K4.flat_groupmax_kernel(torch.zeros((1024, 64), dtype=torch.int8, device=dev)[:, :32],
                                q, 64)                                 # not contiguous
    with pytest.raises(ValueError):
        K4.flat_groupmax_kernel(torch.zeros((8192, 2112), dtype=torch.int8, device=dev),
                                torch.zeros((4, 2112), dtype=torch.int8, device=dev), 64,
                                pack_arg=True)                         # packed key overflows
    with pytest.raises(ValueError):
        K4.flat_groupmax_kernel(sk[:, :16].contiguous(), q[:, :16].contiguous(), 64)   # D % 32


def _flat_corpus(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, d))
    x = centers[rng.integers(0, 64, n)] + 0.3 * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("mode,d,dtype", [("grouped", 96, "int8"), ("grouped", 100, "int8"),
                                          ("grouped", 100, "bfloat16"), ("scan", 100, "int8"),
                                          ("grouped", 200, "int8"), ("grouped", 784, "int8"),
                                          ("grouped", 784, "bfloat16"), ("grouped", 2100, "int8")])
def test_flat_index_on_card_matches_cpu(dev, mode, d, dtype):
    """D 2100 (a 2112-column sketch): exact2, whose K2b re-score reads rows
    wider than 2048 columns."""
    x = _flat_corpus(6000, d, 2)
    ids = np.arange(6000, dtype=np.int32)
    kw = dict(refine=64, block=2048, mode=mode, sketch_dtype=dtype)
    k4, k2b = K4.LAUNCHES, K2.WINDOW_LAUNCHES
    gpu, _ = FlatIndex(device=dev, **kw).fit(DenseBatch(ids, x)).query(
        x[:128], k=10, query_ids=ids[:128])
    if mode == "grouped":
        assert K4.LAUNCHES > k4 and K2.WINDOW_LAUNCHES > k2b
    cpu, _ = FlatIndex(device="cpu", **kw).fit(DenseBatch(ids, x)).query(
        x[:128], k=10, query_ids=ids[:128])
    assert (gpu == cpu).all(axis=1).mean() >= 0.99


@pytest.mark.parametrize("emit", [0, 16])
def test_argpack_on_card_matches_cpu(dev, emit):
    x = _flat_corpus(140_000, 32, 3)
    q = x[:64]
    out = {}
    for where in (dev, torch.device("cpu")):
        flat = FlatIndex(device=where).fit(DenseBatch(np.arange(len(x), dtype=np.int32), x))
        qd = torch.as_tensor(q, device=where)
        qi = torch.arange(64, dtype=torch.int32, device=where)
        k4 = K4.LAUNCHES
        got, _ = flat_topk_grouped(flat.sketch, flat.corpus, flat.row_ids, qd, qi, 10,
                                   select_mode="argpack", gmax_emit_sg=emit)
        assert (K4.LAUNCHES > k4) == (where.type == "cuda")
        out[where.type] = got.cpu().numpy()
    assert (out["cuda"] == out["cpu"]).all(axis=1).mean() >= 0.99


@pytest.mark.parametrize("d", [96, 128, 224])
@pytest.mark.parametrize("b", [45, 1024])
def test_groupmax_kernel_emit32_at_the_select_width(dev, d, b):
    """The supergroup tier at the argpack select's own width, 32 groups of
    64 rows (2,048 rows a supergroup, four 512-row blocks), bit for bit on
    both forms, over five supergroups."""
    _check_groupmax_int8(dev, 64 * 32 * 5, 64, d, b, esg_max=32)


def test_flat_index_select_tier_is_bit_equal(dev, monkeypatch):
    """`FlatIndex` past 2^20 rows takes the argpack route, and its two-level
    select reads K4's emitted tier of 32 groups: ids and scores bit-equal to
    the same index queried with the tier off. 1,049,590 rows end inside a
    group and inside a supergroup, with three dead supergroups after it; the
    rows lean one way and half the queries are negated rows, so their keys
    are all negative and the recomputed tail decides their level 1."""
    from similaritysearchbyrdf_tpu_torch.ops import flat as FL

    n, d = 1_049_590, 96
    gen = torch.Generator(device=dev).manual_seed(11)
    centres = torch.randn((256, d), generator=gen, device=dev)
    x = centres[torch.randint(0, 256, (n,), generator=gen, device=dev)]
    x += 0.3 * torch.randn((n, d), generator=gen, device=dev)
    x[:, 0] += 2.0 * x.norm(dim=1)
    x /= x.norm(dim=1, keepdim=True)
    flat = FlatIndex(device=dev).fit(DenseBatch(np.arange(n, dtype=np.int32), x))
    assert FL._resolve_select_mode("auto", flat.sketch.dtype, n, d) == "argpack"
    sign = torch.where(torch.arange(1024, device=dev) % 2 == 1, -1.0, 1.0)[:, None]
    q = x[torch.randint(0, n, (1024,), generator=gen, device=dev)] * sign
    asked = []

    def recording(*args, **kw):
        asked.append(kw.get("emit_sg", 0))
        return K4.flat_groupmax_kernel(*args, **kw)

    monkeypatch.setattr(FL, "flat_groupmax_kernel", recording)
    ids, sc = flat.query_device(q, k=10)
    ids0, sc0 = flat_topk_grouped(flat.sketch, flat.corpus, flat.row_ids, q, None, 10,
                                  refine=flat.refine, gmax_emit_sg=0)
    assert asked == [32, 0]
    assert torch.equal(ids, ids0) and torch.equal(sc.view(torch.int32), sc0.view(torch.int32))
    assert (ids[1::2] >= 0).all() and torch.isfinite(sc).all()


def test_exact_tiers_ignore_global_tf32(dev):
    """With TF32 switched on for the whole process, the bench config's
    forest, the ground truth and flat_20k's two legs give the ids they give
    in full f32: the port pins full f32 at its exact products
    (`ops/precision.py`), and the caller's setting survives."""
    from bench import make_data

    from similaritysearchbyrdf_tpu_torch import flat_topk
    from similaritysearchbyrdf_tpu_torch.ops import flat as FL

    x = make_data(seed=42)
    ids = np.arange(len(x), dtype=np.int32)
    conf = RDFConfig(vector_dim=100, table_num=10, permutation_num=3, family_size=100,
                     partition_bits=3,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=500),
                     query_batch_size=1024, max_candidates=4096, top_k=10, seed=31258,
                     coarse_dim=32, coarse_dtype="int8", coarse_refine=384,
                     use_pallas_hash=True)
    qkw = dict(query_ids=ids[:1000], probe_mode="margin", probe_budget=16, steps=0)
    xd = torch.as_tensor(x, device=dev)
    rid = torch.as_tensor(ids, device=dev)
    q, qi = xd[:1024], rid[:1024]

    def run():
        forest = RDFForest(conf, device=dev).fit(DenseBatch(ids, x))
        sketch, _ = FL.build_flat_sketch(xd, "int8")
        return {"forest": forest.query(x[:1000], **qkw)[0],
                "exact": exact_search(x, x[:1000], 10, exclude_self=True, device=dev)[0],
                "flat_grouped": FlatIndex(device=dev).fit(DenseBatch(ids, x)).query(
                    x[:1000], k=10, query_ids=ids[:1000])[0],
                "flat_scan": flat_topk(sketch, xd, rid, q, qi, 10, refine=128)[0].cpu().numpy()}

    want = run()
    torch.set_float32_matmul_precision("high")
    try:
        assert torch.backends.cuda.matmul.allow_tf32
        got = run()
        assert torch.backends.cuda.matmul.allow_tf32       # the caller's setting is back
    finally:
        torch.set_float32_matmul_precision("highest")
    for name in want:
        assert np.array_equal(got[name], want[name]), name


def test_entry_points_default_to_the_card(dev):
    conf = RDFConfig(vector_dim=16, table_num=2, permutation_num=1, family_size=20,
                     lsh_table=TableConfig(chain_length=8, bucket_overflow=16), seed=5)
    x = _flat_corpus(300, 16, 4)
    batch = DenseBatch(np.arange(300, dtype=np.int32), x)
    assert RDFForest(conf).device == torch.device("cuda", 0)
    assert fit_dense(conf, batch).corpus.device == torch.device("cuda", 0)
    flat = FlatIndex(refine=32).fit(batch)
    assert flat.sketch.device == torch.device("cuda", 0)
    got, _ = flat.query(x[:4], k=3, exclude_self=False)
    gt, _ = exact_search(x, x[:4], 3)
    assert np.array_equal(got, gt)


@pytest.mark.parametrize("mb", [1, 33])
@pytest.mark.parametrize("cs", [8, 16, 24, 32, 64, 96, 128, 224, 256, 800, 2048, 2056])
def test_block_kernel_bf16_tier_matches_plain(dev, cs, mb):
    """K2 on a bf16 tier (a forest's bf16 coarse tier in block mode) takes
    the generic kernel at every width, MB 1 and a ragged 33, within the f32
    summation bound of its plain version."""
    assert K2.block_kernel_form(cs, 8, 7, mb, tier_bf16=True) == "generic"
    rng = np.random.default_rng(cs * 100 + mb)
    l, caprows, b, bs = 5, 300, 7, 8
    tier = torch.as_tensor(rng.normal(size=(l, caprows, cs)).astype(np.float32),
                           device=dev).to(torch.bfloat16)
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


@pytest.mark.parametrize("mb", [1, 33, 512])
def test_block_kernel_bf16_tier_bench_shape_bit_equal(dev, mb):
    """K2 on a bf16 tier at the bench shape (B 1024, bs 8, cs 32): integer
    tier values (|v| <= 127, exact in bf16) and small integer queries make
    every partial sum an integer below 2^24, so kernel and plain version
    agree bit for bit."""
    rng = np.random.default_rng(mb)
    l, caprows, b, cs, bs = 30, 20_000, 1024, 32, 8
    tier = torch.as_tensor(rng.integers(-127, 128, size=(l, caprows, cs)).astype(np.float32),
                           device=dev).to(torch.bfloat16)
    q = torch.as_tensor(rng.integers(-16, 17, size=(b, cs)).astype(np.float32),
                        device=dev).to(torch.bfloat16)
    table = torch.as_tensor(rng.integers(-2, l + 2, size=(b, mb)).astype(np.int32), device=dev)
    start = torch.as_tensor(rng.integers(-20, caprows + 20, size=(b, mb)).astype(np.int32),
                            device=dev)
    got = K2.coarse_block_scores_kernel(tier, q, table, start, bs)
    assert torch.equal(got, K2.coarse_block_scores_plain(tier, q, table, start, bs))


def _ivf_corpus(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(max(16, n // 200), d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, len(centers), n)] + 0.08 * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n", [6000, 24])
@pytest.mark.parametrize("win", [64, 128, 256])
def test_window_kernel_at_ivf_shapes(dev, win, n):
    """K2b on IVF's operands: the cluster-ordered int8 sketch as a one-table
    tier (L 1, cs 96), windows from `_flatten_windows`, start = the window
    start, end = its cluster's true end; 24 rows in 2 clusters make a
    sketch shorter than `win`, padded with zero rows as `ivf_topk` pads it."""
    x = _ivf_corpus(n, 96, win + n)
    st = IVF.build_ivf(torch.as_tensor(x, device=dev), np.arange(n, dtype=np.int32),
                       target_cluster=32, iters=3, k=2 if n == 24 else None)
    npad = st.sketch.shape[0]
    assert (npad < win) == (n == 24)
    q = torch.as_tensor(x[:64], device=dev).to(torch.bfloat16)
    sel = IVF.top_sorted(matmul_f32(q, st.centroids.T, torch.bfloat16), 4)[1]
    wb = IVF.ivf_window_budget(st.starts, st.ends, 4, win)
    blk, end, live = IVF._flatten_windows(st.starts[sel], st.ends[sel], win, wb)
    tier = (st.sketch if npad >= win else IVF._pad_rows(st.sketch, win))[None]
    args = [a.to(torch.int32).contiguous() for a in
            (torch.zeros_like(blk), blk.clamp(max=max(npad - win, 0)), blk, end)]
    before = K2.WINDOW_LAUNCHES
    got = K2.coarse_window_scores_kernel(tier, q, *args, live.contiguous(), win)
    assert K2.WINDOW_LAUNCHES == before + 1
    want = K2.coarse_window_scores_plain(tier, q, *args, live, win)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert fin.any()
    bound = 2 * 96 * U * K2.coarse_block_scores_plain(tier.abs(), q.abs(), args[0], args[1], win)
    assert ((got - want).abs()[fin] <= bound[fin] + 1e-30).all()


def test_kmeans_is_deterministic_on_card(dev):
    """Two builds from one seed lay out identically on the card: the k-means
    update sums clusters with integer adds, whose order does not matter."""
    x = torch.as_tensor(_ivf_corpus(200_000, 96, 5), device=dev)
    ids = np.arange(200_000, dtype=np.int32)
    a = IVF.build_ivf(x, ids, target_cluster=256, iters=4, seed=0)
    b = IVF.build_ivf(x, ids, target_cluster=256, iters=4, seed=0)
    for name in ("starts", "ends", "row_ids", "centroids", "sketch"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("point", ["single", "two_phase", "short_sketch"])
def test_ivf_on_card_matches_cpu(dev, point):
    """IVF's ids on the card (K2b) against the port's CPU path (K2b's plain
    version) on one index, built on the CPU and copied to the card."""
    kw = {"single": dict(nprobe=4, win=64), "two_phase": dict(nprobe=8, win=64, head_pool=16,
                                                               keep=8),
          "short_sketch": dict(nprobe=4, win=256)}[point]
    n = 24 if point == "short_sketch" else 6000
    x = _ivf_corpus(n, 96, 11)
    ids = np.arange(n, dtype=np.int32)
    cpu = IVFFlatIndex(target_cluster=32, iters=3, refine=128, device="cpu", **kw).fit(
        DenseBatch(ids, x))
    gpu = IVFFlatIndex(target_cluster=32, iters=3, refine=128, device=dev, **kw)
    gpu.state = IVF.IVFState(*(None if t is None else t.to(dev) for t in cpu.state))
    k2b = K2.WINDOW_LAUNCHES
    got, _ = gpu.query(x[:128], k=10, query_ids=ids[:128])
    assert K2.WINDOW_LAUNCHES > k2b
    want, _ = cpu.query(x[:128], k=10, query_ids=ids[:128])
    assert (got == want).all(axis=1).mean() >= 0.99


def _anisotropic(n, d, seed, n_clusters=80):
    """Clustered unit rows with well-separated leading eigenvalues, so the
    card's and the CPU's PCA bases agree."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    centers = (rng.normal(size=(n_clusters, d)) * 0.85 ** np.arange(d)) @ q.T
    x = centers[rng.integers(0, n_clusters, n)] + 0.02 * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("extra", [dict(), dict(m_cap=32768, window_keep=0),
                                   dict(m_cap=32768, window_keep=64)])
def test_forest_options_on_card_match_cpu(dev, extra):
    """The PCA basis, a bf16 coarse tier and the bf16 two-stage rerank on
    the card (K2 on the bf16 tier in block mode, K2b in window mode). The
    card's fit against the CPU's: both form the PCA moment in f32 in their
    own summation order, so the bases agree to 1e-4 and each tier value
    within one bf16 step plus twice what the bases' difference moves it
    (|x| . |basis difference|). The query paths on one index (the card's,
    copied to the host): every query's top 10 equal up to near-ties of the
    exact f32 scores (within 2*D*2^-24 for unit rows, the bound of two
    summation orders). This tight corpus (noise 0.02) has such ties: on the
    H100, query 12's rows 590 and 174 score 0.99940288 and 0.99940282 on
    the card and equal on the CPU, in the int8 f32 configuration too."""
    x = _anisotropic(3000, 32, 2)
    ids = np.arange(3000, dtype=np.int32)
    conf = RDFConfig(vector_dim=32, table_num=4, permutation_num=2, family_size=40,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=48),
                     query_batch_size=64, max_candidates=4096, coarse_dim=16,
                     coarse_refine=256, coarse_head_pool=16, coarse_dtype="bfloat16",
                     coarse_proj_mode="pca", rerank_dtype="bfloat16", seed=3)
    kw = dict(query_ids=ids[:128], probe_mode="margin", probe_budget=16, **extra)
    forest = RDFForest(conf, device=dev).fit(DenseBatch(ids, x))
    own_cpu = RDFForest(conf, device="cpu").fit(DenseBatch(ids, x)).state
    gs = forest.state.to("cpu")
    assert gs.coarse_tier.dtype == torch.bfloat16 and gs.corpus_lp is not None
    dproj = (gs.coarse_proj - own_cpu.coarse_proj).abs()
    assert float(dproj.max()) <= 1e-4
    si = own_cpu.tables.sorted_ids
    same = (gs.tables.sorted_ids == si)[..., None]
    assert float(same.float().mean()) > 0.999
    moved = (torch.from_numpy(np.abs(x)) @ dproj)[si.clamp(min=0).long()]
    want = own_cpu.coarse_tier.float()
    step = 2.0 ** (torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    diff = (gs.coarse_tier.float() - want).abs()
    assert bool(((diff <= step + 2 * moved) | ~same).all())
    k2, k2b = K2.LAUNCHES, K2.WINDOW_LAUNCHES
    gpu, gpu_sc = forest.query(x[:128], **kw)
    assert (K2.WINDOW_LAUNCHES > k2b) if extra else (K2.LAUNCHES > k2)
    cpu = RDFForest(conf, device="cpu")
    cpu.state = gs
    want_ids, want_sc = cpu.query(x[:128], **kw)
    tol = 2 * x.shape[1] * U
    assert all(equal_up_to_ties(gpu[i], gpu_sc[i], want_ids[i], want_sc[i], tol)
               for i in range(128))


def test_loaded_model_through_hash_kernel(dev, tmp_path):
    """A model loaded from its file holds T*P tables with one identity
    permutation each (P = 1). K1 takes that shape: bit-equal to its plain
    version away from near-zero dots, and to the saved model's K1 hashes
    everywhere (each function's dot is summed in the same column order
    whichever table holds it)."""
    conf = RDFConfig(vector_dim=100, table_num=10, permutation_num=3, family_size=100,
                     lsh_table=TableConfig(chain_length=32), seed=9)
    saved = generate_model(conf, device=dev)
    path = str(tmp_path / "model")
    save_model_file(saved, path)
    loaded = load_model_file(path, conf, device=dev)
    assert tuple(loaded.perm.shape) == (30, 1, 32)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(1024, 100)).astype(np.float32), device=dev)
    before = K1.LAUNCHES
    h, _ = K1.hash_dense_kernel(x, loaded.proj, loaded.perm)
    assert K1.LAUNCHES == before + 1
    assert torch.equal(h, K1.hash_dense_kernel(x, saved.proj, saved.perm)[0])
    _check_hash_of(dev, x, loaded.proj, loaded.perm)


def _check_hash_of(dev, x, proj, perm):
    """K1 against its plain version on given operands: no hash bit differs
    away from near-zero dots."""
    b, (t, c, _), p = x.shape[0], proj.shape, perm.shape[1]
    hk, _ = K1.hash_dense_kernel(x, proj, perm)
    hp, _ = K1.hash_dense_plain(x, proj, perm)
    dots = torch.einsum("bd,tcd->btc", x.double(), proj.double())
    near = (dots.abs() < 1e-4)[:, :, None, :].expand(-1, -1, p, -1)
    bits = torch.gather(near, 3, perm.long()[None].expand(b, -1, -1, -1)).long()
    near_word = (bits << torch.arange(31, 31 - c, -1, device=dev)).sum(-1).reshape(b, -1)
    assert not ((hk ^ hp) & ~near_word).any()


def _front_conf(**kw):
    return RDFConfig(vector_dim=32, table_num=4, permutation_num=2, family_size=40,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=48),
                     query_batch_size=64, max_candidates=4096, coarse_dim=16,
                     coarse_refine=256, top_k=10, seed=13, **kw)


def _ids_equal_up_to_ties(x, q, got, want, tol) -> bool:
    """Two id lists of one query (no scores returned): their rows' exact
    scores, position by position, within `tol`."""
    if len(got) != len(want):
        return False
    sg = x[np.asarray(got, dtype=np.int64)].astype(np.float64) @ q.astype(np.float64)
    sw = x[np.asarray(want, dtype=np.int64)].astype(np.float64) @ q.astype(np.float64)
    return bool((np.abs(sg - sw) <= tol).all())


@pytest.mark.parametrize("engine", ["forest", "flat"])
def test_dense_front_end_on_card_matches_cpu(dev, engine):
    """DenseRDFInit on the card against the CPU path on the same rows: the
    vector query up to exact-score ties (2*D*2^-24), the key query equal to
    the card's own vector query and [] for unknown keys, the dataTable
    distribution equal and each table's partition counts summing to N."""
    x = _flat_corpus(3000, 32, 21)
    ids = np.arange(3000, dtype=np.int32) + 100
    conf = _front_conf(engine=engine)
    fronts = {}
    for where in (dev, "cpu"):
        f = DenseRDFInit(device=where)
        f.initialize_rdf_hash_map(conf)
        f.fit_batch(DenseBatch(ids, x))
        fronts[str(where)] = f
    card, cpu = fronts[str(dev)], fronts["cpu"]
    k1, k2, k4 = K1.LAUNCHES, K2.LAUNCHES, K4.LAUNCHES
    g_ids, g_sc = card.new_multi_thread_query_batch(ids[:128], x[:128])
    if engine == "forest":
        assert K1.LAUNCHES > k1 and K2.LAUNCHES > k2
    else:
        assert K4.LAUNCHES > k4
    c_ids, c_sc = cpu.new_multi_thread_query_batch(ids[:128], x[:128])
    tol = 2 * 32 * U
    assert all(equal_up_to_ties(g_ids[i], g_sc[i], c_ids[i], c_sc[i], tol)
               for i in range(128))
    keys = [int(k) for k in ids[:128]] + [5, -1, 99999]
    got = card.query_batch(keys)
    assert got[:128] == [[i for i in row if i >= 0] for row in g_ids.tolist()]
    assert got[128:] == [[], [], []]
    if engine == "forest":
        dt, ht = card.get_dt_and_ht_num_distribution()
        assert np.array_equal(dt, cpu.get_dt_and_ht_num_distribution()[0])
        assert ht.sum() == 3000
        assert (card.forest.sub_index_distribution().sum(axis=1) == 3000).all()


def test_dynamic_forest_on_card_matches_cpu(dev):
    """The same inserts and removals on the card and on the CPU answer
    alike up to exact-score ties; the card's compaction equals a fresh fit
    on the card with the same model and chains, bit for bit."""
    x = _flat_corpus(4000, 32, 22)
    ids = np.arange(4000, dtype=np.int32)
    dyns = {}
    for where in (dev, "cpu"):
        d = DynamicForest(_front_conf(), merge_threshold=0.5, device=where)
        d.fit(DenseBatch(ids[:3000], x[:3000]))
        d.add(DenseBatch(ids[3000:3500], x[3000:3500]))
        for victim in (1, 3100, 2000):
            d.remove(victim)
        dyns[str(where)] = d
    card, cpu = dyns[str(dev)], dyns["cpu"]
    q = np.concatenate([x[:64], x[3000:3064]])
    qid = np.concatenate([ids[:64], ids[3000:3064]])
    k1, k2 = K1.LAUNCHES, K2.LAUNCHES
    g_ids, g_sc = card.query(q, query_ids=qid)
    assert K1.LAUNCHES > k1 and K2.LAUNCHES > k2 and card.delta is not None
    c_ids, c_sc = cpu.query(q, query_ids=qid)
    assert not np.isin(g_ids, [1, 3100, 2000]).any()
    tol = 2 * 32 * U
    assert all(equal_up_to_ties(g_ids[i], g_sc[i], c_ids[i], c_sc[i], tol)
               for i in range(128))
    card.compact()
    keep = ~np.isin(ids[:3500], [1, 3100, 2000])
    fresh = RDFForest(card.conf, model=card.main.model, device=dev)
    fresh.part_proj = card.main.part_proj
    fresh.fit(DenseBatch(ids[:3500][keep], x[:3500][keep]))
    got, want = card.query(q, query_ids=qid), fresh.query(q, query_ids=qid)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_rdfmap_on_card_matches_cpu(dev):
    x = _flat_corpus(2000, 32, 23)
    maps = {}
    for where in (dev, "cpu"):
        m = RDFMap(_front_conf(), device=where)
        for i in range(2000):
            m.put(i, x[i])
        m.remove(17)
        maps[str(where)] = m
    tol = 2 * 32 * U
    for key in range(0, 2000, 97):
        got, want = maps[str(dev)].get_similar(key), maps["cpu"].get_similar(key)
        assert 17 not in got and key not in got
        assert _ids_equal_up_to_ties(x, x[key], got, want, tol), key


_PERSIST_CONFS = {
    "int8_head": dict(coarse_dim=16, coarse_head_pool=8, coarse_window=64, coarse_keep=16,
                      max_candidates=2048),
    "bf16_pca_lp": dict(coarse_dim=16, coarse_dtype="bfloat16", coarse_proj_mode="pca",
                        rerank_dtype="bfloat16"),
    "folded": dict(coarse_dim=16, coarse_layout="folded", coarse_refine=2048,
                   coarse_window=64, max_candidates=4096),
}


def _persist_corpus(n=6000, d=32, seed=5):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(64, d))
    x = c[rng.integers(0, 64, n)] + 0.1 * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", list(_PERSIST_CONFS))
@pytest.mark.parametrize("compress", [True, False])
def test_forest_save_load_on_card(dev, tmp_path, name, compress):
    """A forest fitted on the card, saved and loaded on the card: the
    rebuilt coarse tier (and head tier) equal to the fitted ones, ids and
    scores bit-equal, and the loaded query through K1 and K2/K2b/K3."""
    from similaritysearchbyrdf_tpu_torch import load_forest, save_forest

    conf = _front_conf().replace(**_PERSIST_CONFS[name])
    x = _persist_corpus()
    ids = np.arange(len(x), dtype=np.int32)
    fitted = RDFForest(conf, device=dev).fit(DenseBatch(ids, torch.as_tensor(x, device=dev)))
    save_forest(fitted, str(tmp_path / "f"), compress=compress)
    loaded = load_forest(str(tmp_path / "f"))
    a, b = fitted.state, loaded.state
    assert b.corpus.is_cuda and b.coarse_tier.is_cuda
    assert torch.equal(a.coarse_proj, b.coarse_proj)
    assert torch.equal(a.coarse_tier, b.coarse_tier)
    assert (a.coarse_head is None) == (b.coarse_head is None)
    if a.coarse_head is not None:
        assert torch.equal(a.coarse_head, b.coarse_head)
    if a.corpus_lp is not None:
        assert torch.equal(a.corpus_lp, b.corpus_lp)
    kernel = {"int8_head": K2, "bf16_pca_lp": K2, "folded": K3}[name]
    attr = "WINDOW_LAUNCHES" if name == "int8_head" else "LAUNCHES"
    k1, kx = K1.LAUNCHES, getattr(kernel, attr)
    got = loaded.query(x[:128], steps=1, query_ids=ids[:128])
    assert K1.LAUNCHES > k1 and getattr(kernel, attr) > kx
    want = fitted.query(x[:128], steps=1, query_ids=ids[:128])
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_flat_save_load_on_card(dev, tmp_path, dtype):
    from similaritysearchbyrdf_tpu_torch import load_flat, save_flat

    x = _persist_corpus(n=20000, d=100)
    ids = np.arange(len(x), dtype=np.int32)
    flat = FlatIndex(sketch_dtype=dtype, device=dev).fit(DenseBatch(ids, x))
    save_flat(flat, str(tmp_path / "f"))
    loaded = load_flat(str(tmp_path / "f"))
    assert torch.equal(loaded.sketch, flat.sketch) and torch.equal(loaded.corpus, flat.corpus)
    before = K4.LAUNCHES
    got = loaded.query(x[:256], k=10, query_ids=ids[:256])
    assert K4.LAUNCHES > before
    want = flat.query(x[:256], k=10, query_ids=ids[:256])
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_ivf_save_load_on_card(dev, tmp_path):
    from similaritysearchbyrdf_tpu_torch import load_ivf, save_ivf

    x = _persist_corpus(n=20000, d=96)
    ids = np.arange(len(x), dtype=np.int32)
    ivf = IVFFlatIndex(target_cluster=64, nprobe=4, win=64, iters=3, head_pool=16, keep=8,
                       device=dev).fit(DenseBatch(ids, x))
    save_ivf(ivf, str(tmp_path / "i"))
    loaded = load_ivf(str(tmp_path / "i"))
    for a, b in zip(loaded.state, ivf.state):
        assert torch.equal(a, b)
    before = K2.WINDOW_LAUNCHES
    got = loaded.query(x[:256], k=10, query_ids=ids[:256])
    assert K2.WINDOW_LAUNCHES > before
    want = ivf.query(x[:256], k=10, query_ids=ids[:256])
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_tiered_store_on_card(dev, tmp_path):
    """Three generations spilled from the card: the device merge equals a
    host merge of each generation's own lists, the second query reads
    nothing from disk, and `get` returns the stored rows."""
    from similaritysearchbyrdf_tpu_torch import GenerationStore, TieredForest

    conf = _front_conf()
    x = _persist_corpus()
    ids = np.arange(len(x), dtype=np.int32)
    store = GenerationStore(str(tmp_path), "g", compress=False)
    tiered = TieredForest(conf, store)
    for c0 in range(0, len(x), 2000):
        tiered.fit(DenseBatch(ids[c0:c0 + 2000], x[c0:c0 + 2000]))
        tiered.spill()
    got_i, got_s = tiered.query(x[:128], steps=1, query_ids=ids[:128])
    loads = store.disk_loads
    assert loads == 3
    again = tiered.query(x[:128], steps=1, query_ids=ids[:128])
    assert store.disk_loads == loads
    assert np.array_equal(again[0], got_i)
    lists = [store.load_generation(s).query(x[:128], steps=1, query_ids=ids[:128], k=10)
             for s in store.generations()]
    cat_i = np.concatenate([a for a, _ in lists], axis=1)
    cat_s = np.concatenate([b for _, b in lists], axis=1)
    order = np.argsort(-cat_s, axis=1, kind="stable")[:, :10]
    want_s = np.take_along_axis(cat_s, order, 1)
    want_i = np.where(np.isfinite(want_s), np.take_along_axis(cat_i, order, 1), -1)
    assert np.array_equal(got_i, want_i) and np.array_equal(got_s, want_s)
    for key in (0, 2500, 5999):
        assert np.array_equal(tiered.get(key), x[key])


# ---------------------------------------------------------------------------
# the sparse path: its kernels at the sparse shapes, its engines on the card
# ---------------------------------------------------------------------------


def _sparse_rows(n, d, nnz, seed, n_clusters=150):
    """`scripts/bench_sparse_1m.py`'s recipe: support-clustered rows, values
    0.8 + 0.2·U normalised."""
    rng = np.random.default_rng(seed)
    supports = np.stack([rng.choice(d, size=nnz, replace=False) for _ in range(n_clusters)])
    idx = supports[rng.integers(0, n_clusters, n)].astype(np.int32)
    val = (0.8 + 0.2 * rng.random((n, nnz))).astype(np.float32)
    return idx, val / np.linalg.norm(val, axis=1, keepdims=True)


@pytest.mark.parametrize("b", [64, 8192])
def test_hash_kernel_densified_sparse_d4096(dev, b):
    """K1 at D 4096 (the wide form) on densified sparse rows, no margins:
    hash words equal away from near-zero dots."""
    from similaritysearchbyrdf_tpu_torch.ops.hashing import densify

    idx, val = _sparse_rows(b, 4096, 64, seed=b)
    x = densify(torch.as_tensor(idx, device=dev), torch.as_tensor(val, device=dev), 4096)
    rng = np.random.default_rng(7)
    proj = torch.as_tensor(rng.normal(size=(10, 32, 4096)).astype(np.float32), device=dev)
    perm = torch.as_tensor(np.stack([[rng.permutation(32) for _ in range(3)]
                                     for _ in range(10)]).astype(np.int32), device=dev)
    before = K1.LAUNCHES
    hk, mk = K1.hash_dense_kernel(x, proj, perm)
    assert K1.LAUNCHES == before + 1 and mk is None
    hp, _ = K1.hash_dense_plain(x, proj, perm)
    dots = torch.einsum("bd,tcd->btc", x.double(), proj.double())
    near = (dots.abs() < 1e-5)[:, :, None, :].expand(-1, -1, 3, -1)
    bits = torch.gather(near, 3, perm.long()[None].expand(b, -1, -1, -1)).long()
    near_word = (bits << torch.arange(31, -1, -1, device=dev)).sum(-1).reshape(b, -1)
    assert not ((hk ^ hp) & ~near_word).any()


def test_block_kernel_sparse_tier_cs64_bit_equal(dev):
    """K2 at the sparse tier's shape, int8 cs 64 (the b8 kernel), B 64 x MB
    2048 blocks of 8, L 30: integer queries make every sum exact, so kernel
    and plain version agree bit for bit."""
    rng = np.random.default_rng(64)
    l, caprows, b, mb = 30, 20_000, 64, 2048
    tier = torch.as_tensor(rng.integers(-127, 128, size=(l, caprows, 64)).astype(np.int8),
                           device=dev)
    q = torch.as_tensor(rng.integers(-64, 65, size=(b, 64)).astype(np.float32),
                        device=dev).to(torch.bfloat16)
    table = torch.as_tensor(rng.integers(0, l, size=(b, mb)).astype(np.int32), device=dev)
    start = torch.as_tensor(rng.integers(0, caprows - 8, size=(b, mb)).astype(np.int32),
                            device=dev)
    assert K2.block_kernel_form(64, 8, b, mb) == "b8"
    got = K2.coarse_block_scores_kernel(tier, q, table, start, 8)
    assert torch.equal(got, K2.coarse_block_scores_plain(tier, q, table, start, 8))


@pytest.mark.parametrize("queries", ["integer", "float"])
@pytest.mark.parametrize("b,mb", [(1, 1), (7, 33), (65, 2047), (3, 11), (64, 2048)])
def test_block_kernel_cs64_odd_shapes(dev, b, mb, queries):
    """K2's b8 kernel at cs 64 at block counts that end mid-step (B 1 x MB 1,
    7 x 33, 65 x 2047, 3 x 11) and the sparse query's 64 x 2048, table ids
    out of range and starts past both ends of the tier: bit for bit with
    integer queries (|q| <= 64), within the f32 bound with float ones, the
    same words on a second call."""
    assert K2.block_kernel_form(64, 8, b, mb) == "b8"
    rng = np.random.default_rng(b * 10_000 + mb)
    l, caprows, bs = 30, 20_000, 8
    tier = torch.as_tensor(rng.integers(-128, 128, size=(l, caprows, 64)).astype(np.int8),
                           device=dev)
    qv = rng.integers(-64, 65, size=(b, 64)) if queries == "integer" else rng.normal(size=(b, 64))
    q = torch.as_tensor(qv.astype(np.float32), device=dev).to(torch.bfloat16)
    table = torch.as_tensor(rng.integers(-2, l + 2, size=(b, mb)).astype(np.int32), device=dev)
    start = torch.as_tensor(rng.integers(-20, caprows + 20, size=(b, mb)).astype(np.int32),
                            device=dev)
    before = K2.LAUNCHES
    got = K2.coarse_block_scores_kernel(tier, q, table, start, bs)
    assert K2.LAUNCHES == before + 1
    want = K2.coarse_block_scores_plain(tier, q, table, start, bs)
    if queries == "integer":
        assert torch.equal(got, want)
    else:
        bound = 2 * 64 * U * K2.coarse_block_scores_plain(tier.abs(), q.abs(), table, start, bs)
        assert ((got - want).abs() <= bound + 1e-30).all()
    again = K2.coarse_block_scores_kernel(tier, q, table, start, bs)
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("cs,win,b,mb", [
    (4096, 64, 1024, 30), (4096, 64, 1, 1), (4096, 8, 3, 5), (2056, 64, 3, 5),
    (128, 256, 1024, 64), (64, 512, 7, 33), (128, 128, 7, 33), (96, 128, 1024, 14),
    (32, 64, 128, 1024), (128, 64, 1024, 30), (32, 64, 1 << 16, 1 << 15),
    (4096, 64, 1 << 14, 1 << 14), (96, 64, 1024, 30), (96, 64, 1024, 64), (96, 256, 7, 33),
    (96, 32, 7, 33), (96, 128, 1 << 16, 1 << 15)])
def test_window_kernel_form_mirror(dev, cs, win, b, mb):
    """The Python mirror of K2b's form and scratch names what the library
    chooses, for int8 and bf16 tiers."""
    lib = K2.build.library()
    for bf16 in (0, 1):
        form = ("generic", "w64", "window_major", "w96")[lib.rdf_coarse_window_form(
            cs, win, b, mb, bf16)]
        assert form == K2.window_kernel_form(cs, win, b, mb, bool(bf16))
        want = K2.window_scratch_bytes(b, mb) if form == "window_major" else 0
        assert lib.rdf_coarse_window_scratch(cs, win, b, mb, bf16) == want


def _window_major_operands(dev, cs, win, case, queries, seed):
    """K2b's operands for the window-major form's cases (L, B, MB by case):
    "shared", every pair on one window (a group of 120, past the 16 members
    of an item); "distinct", no window shared; "mixed", 3 tables with ids out
    of range, windows from a small pool of starts, among them negative ones
    and ones past caprows - win, so pairs of different blk_start share a
    clipped start (at 0 and at the table's end), ranges cutting a window at
    one or both ends or missing it, dead windows, and B x MB = 37 x 7 pairs;
    "two_tables", "shared" on 2 tables."""
    rng = np.random.default_rng(seed)
    caprows = 1024 if cs > 1024 else 4096
    l, b, mb = {"shared": (1, 40, 3), "distinct": (1, 9, 7), "mixed": (3, 37, 7),
                "two_tables": (2, 24, 5)}[case]
    tier = torch.as_tensor(rng.integers(-128, 128, size=(l, caprows, cs)).astype(np.int8),
                           device=dev)
    qv = (rng.integers(-16, 17, size=(b, cs)) if queries == "integer"
          else rng.normal(size=(b, cs)))
    q = torch.as_tensor(qv.astype(np.float32), device=dev).to(torch.bfloat16)
    table = rng.integers(0, l, size=(b, mb))
    live = np.ones((b, mb), bool)
    if case in ("shared", "two_tables"):
        blk = np.full((b, mb), 8 * rng.integers(0, (caprows - win) // 8))
    elif case == "distinct":
        blk = 8 * rng.choice((caprows - win) // 8, size=b * mb, replace=False).reshape(b, mb)
    else:
        table = rng.integers(-1, l + 1, size=(b, mb))
        pool = np.array([-16, -8, 0, 8, 64, caprows - win, caprows - win + 8,
                         caprows - win + 24, caprows])
        blk = pool[rng.integers(0, len(pool), size=(b, mb))]
        live = rng.random((b, mb)) < 0.8
    start, end = blk, blk + win
    if case == "mixed":
        cut_lo, cut_hi = rng.integers(1, win // 2, size=(2, b, mb))
        kind = rng.integers(0, 5, size=(b, mb))
        kind[-1, -1], live[-1, -1] = 1, True     # finite and -inf slots in every case
        # 0 whole, 1 cut at both ends, 2 at the start, 3 at the end, 4 missed
        start = np.choose(kind, [blk - 3, blk + cut_lo, blk + cut_lo, blk - 3, blk + win])
        end = np.choose(kind, [blk + win + 3, blk + win - cut_hi, blk + win + 3,
                               blk + win - cut_hi, blk + win + 16])
    args = [torch.as_tensor(np.asarray(a).astype(np.int32), device=dev)
            for a in (table, blk, start, end)]
    return (tier, q, *args, torch.as_tensor(live, device=dev), win)


@pytest.mark.parametrize("queries", ["integer", "float"])
@pytest.mark.parametrize("case", ["shared", "distinct", "mixed", "two_tables"])
@pytest.mark.parametrize("cs,win", [(4096, 64), (128, 256), (64, 512)])
def test_window_major_form_matches_plain(dev, cs, win, case, queries):
    """K2b's window-major form (int8 cs 4096 x 64-slot windows, IVF's cs 128
    x 256, the 32 KB threshold's cs 64 x 512) against its plain version in
    every grouping case (`_window_major_operands`): integer queries (|q| <=
    16) make every partial sum an integer below 2^24, so the two agree bit
    for bit; float queries stay within the f32 bound with the same -inf
    slots. A second call gives the same words."""
    args = _window_major_operands(dev, cs, win, case, queries, cs + win + len(case))
    tier, q, table, blk = args[:4]
    b, mb = table.shape
    assert K2.window_kernel_form(cs, win, b, mb) == "window_major"
    before = K2.WINDOW_LAUNCHES
    got = K2.coarse_window_scores_kernel(*args)
    assert K2.WINDOW_LAUNCHES == before + 1
    want = K2.coarse_window_scores_plain(*args)
    assert torch.isfinite(want).any()
    if queries == "integer":
        assert torch.equal(got, want)
    else:
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        fin = torch.isfinite(want)
        bound = 2 * cs * U * K2.coarse_block_scores_plain(tier.abs(), q.abs(), table, blk, win)
        assert ((got - want).abs()[fin] <= bound[fin] + 1e-30).all()
    again = K2.coarse_window_scores_kernel(*args)
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    if case == "mixed":
        assert torch.isneginf(want).any()


def test_window_major_form_at_the_re_score_shape(dev):
    """The window-major form at the sparse flat re-score's shape with its
    sharing: B 1024 x 30 windows of 64 rows over a 4096-wide int8 sketch of
    8,192 rows (128 windows, so about 240 queries a window and every group
    split into items of 16), integer queries: bit for bit, the same words on
    a second call."""
    rng = np.random.default_rng(15)
    caprows, b, mb, win = 8192, 1024, 30, 64
    sk = torch.as_tensor(rng.integers(-128, 128, size=(1, caprows, 4096), dtype=np.int8),
                         device=dev)
    q = torch.as_tensor(rng.integers(-16, 17, size=(b, 4096)).astype(np.float32),
                        device=dev).to(torch.bfloat16)
    blk = torch.as_tensor(np.argsort(rng.random((b, caprows // win)), axis=1)[:, :mb] * win,
                          dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(blk)
    args = (sk, q, zeros, blk, zeros, torch.full_like(blk, caprows - 100),
            torch.ones_like(blk, dtype=torch.bool), win)
    got = K2.coarse_window_scores_kernel(*args)
    assert torch.equal(got, K2.coarse_window_scores_plain(*args))
    assert torch.equal(K2.coarse_window_scores_kernel(*args).view(torch.int32),
                       got.view(torch.int32))


def test_window_kernel_one_table_cs4096(dev):
    """K2b as the sparse flat engine's exact2 re-score runs it: the 4096-wide
    int8 sketch as one table, B 1024 x 30 windows of 64 rows, every window
    live, bf16 float queries: within the f32 summation bound."""
    rng = np.random.default_rng(4096)
    caprows, b, mb, win = 65_536, 1024, 30, 64
    sk = torch.as_tensor(rng.integers(-127, 128, size=(1, caprows, 4096), dtype=np.int8),
                         device=dev)
    q = torch.as_tensor(rng.normal(size=(b, 4096)).astype(np.float32),
                        device=dev).to(torch.bfloat16)
    blk = torch.as_tensor(rng.integers(0, caprows // win, size=(b, mb)) * win,
                          dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(blk)
    args = (sk, q, zeros, blk, zeros, torch.full_like(blk, caprows - 100),
            torch.ones_like(blk, dtype=torch.bool), win)
    before = K2.WINDOW_LAUNCHES
    got = K2.coarse_window_scores_kernel(*args)
    assert K2.WINDOW_LAUNCHES == before + 1
    want = K2.coarse_window_scores_plain(*args)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    bound = 2 * 4096 * U * K2.coarse_block_scores_plain(sk.abs(), q.abs(), zeros, blk, win)
    assert ((got - want).abs()[fin] <= bound[fin]).all()


@pytest.mark.parametrize("b", [64, 1024])
def test_groupmax_kernel_int8_d4096_bit_equal(dev, b):
    """K4 at the sparse flat engine's width, int8 D 4096 (the K-looped
    wgmma form), on 65,536 rows: bit for bit."""
    rng = np.random.default_rng(b)
    sk = torch.as_tensor(rng.integers(-127, 128, (65_536, 4096), dtype=np.int8), device=dev)
    q = torch.as_tensor(rng.integers(-127, 128, (b, 4096), dtype=np.int8), device=dev)
    assert K4.kernel_form(torch.int8, 4096) == "wgmma_kloop"
    got = K4.flat_groupmax_kernel(sk, q, 64)
    assert torch.equal(got, K4.flat_groupmax_plain(sk, q, 64))


def _sparse_on_card_and_cpu(dev, run):
    """`run(device)` → (ids, scores) on the card and on the CPU: ids equal
    up to exact-score ties (1e-6)."""
    from similaritysearchbyrdf_tpu_torch.experiments.harness import equal_up_to_ties

    g_ids, g_sc = run(dev)
    c_ids, c_sc = run("cpu")
    assert g_ids.shape == c_ids.shape
    assert all(equal_up_to_ties(g_ids[i], g_sc[i], c_ids[i], c_sc[i], 1e-6)
               for i in range(len(g_ids)))
    assert (g_ids == c_ids).all(axis=1).mean() >= 0.98


def _sparse_conf(**kw):
    base = dict(vector_dim=512, table_num=4, permutation_num=2, family_size=40,
                partition_bits=3, lsh_table=TableConfig(chain_length=32, bucket_overflow=48),
                query_batch_size=32, max_candidates=4096, coarse_dim=64, coarse_refine=256,
                seed=31, feature_data_format="sparse")
    base.update(kw)
    return RDFConfig(**base)


@pytest.mark.parametrize("extra", [dict(), dict(max_candidates=32768), dict(coarse_dim=0)])
def test_sparse_forest_on_card_matches_cpu(dev, extra):
    from similaritysearchbyrdf_tpu_torch import SparseBatch, SparseRDFForest

    idx, val = _sparse_rows(3000, 512, 16, seed=3)
    batch = SparseBatch(np.arange(3000), 512, idx, val, np.full(3000, 16))
    conf = _sparse_conf(**extra)
    launches = {}

    def run(device):
        k1, k2, k2b = K1.LAUNCHES, K2.LAUNCHES, K2.WINDOW_LAUNCHES
        forest = SparseRDFForest(conf, device=device).fit(batch)
        out = forest.query(batch.slice(0, 128), steps=1, query_ids=np.arange(128))
        launches[str(device)] = (K1.LAUNCHES - k1, K2.LAUNCHES - k2, K2.WINDOW_LAUNCHES - k2b)
        return out

    _sparse_on_card_and_cpu(dev, run)
    k1, k2, k2b = launches[str(dev)]
    assert k1 > 0 and launches["cpu"] == (0, 0, 0)
    if conf.coarse_dim:
        assert (k2b if conf.max_candidates >= 32768 else k2) > 0


def test_sparse_flat_on_card_matches_cpu(dev):
    from similaritysearchbyrdf_tpu_torch import SparseBatch, SparseFlatIndex

    idx, val = _sparse_rows(3000, 4096, 64, seed=5)
    batch = SparseBatch(np.arange(3000), 4096, idx, val, np.full(3000, 64))
    k4, k2b = K4.LAUNCHES, K2.WINDOW_LAUNCHES
    _sparse_on_card_and_cpu(dev, lambda device: SparseFlatIndex(device=device).fit(batch).query(
        idx[:200], val[:200], k=10, query_ids=np.arange(200)))
    assert K4.LAUNCHES > k4 and K2.WINDOW_LAUNCHES > k2b


def test_sparse_front_end_on_card_matches_cpu(dev):
    from similaritysearchbyrdf_tpu_torch import SparseBatch, SparseRDFInit

    idx, val = _sparse_rows(2000, 512, 16, seed=8)
    batch = SparseBatch(np.arange(2000), 512, idx, val, np.full(2000, 16))
    out = {}
    for device in (dev, "cpu"):
        front = SparseRDFInit(device=device)
        front.initialize_rdf_hash_map(_sparse_conf())
        front.fit_batch(batch)
        out[str(device)] = (front.query_batch(list(range(0, 2000, 20)), steps=1),
                            front.get_dt_and_ht_num_distribution())
    (g_lists, (g_dt, g_ht)), (c_lists, (c_dt, c_ht)) = out[str(dev)], out["cpu"]
    assert np.array_equal(g_dt, c_dt) and np.array_equal(g_ht, c_ht)
    same = sum(g == c for g, c in zip(g_lists, c_lists)) / len(g_lists)
    assert same >= 0.98
    # with no device named, the sparse entry points take the first card
    from similaritysearchbyrdf_tpu_torch import SparseFlatIndex, SparseRDFForest

    card = torch.device("cuda", 0)
    assert SparseRDFInit().device == SparseRDFForest(_sparse_conf()).device == card
    assert SparseFlatIndex().fit(batch).sketch.device == card


# ---------------------------------------------------------------------------
# the sharded engines: 4 shards on the card against the CPU path
# ---------------------------------------------------------------------------


def _meshes(dev):
    from similaritysearchbyrdf_tpu_torch.parallel.mesh import make_forest_mesh

    return make_forest_mesh(devices=[dev] * 4), make_forest_mesh(devices=["cpu"] * 4)


def _to_cpu(obj):
    """A sharded state (dataclasses, named tuples, lists of them) with every
    tensor on the CPU."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, list):
        return [_to_cpu(o) for o in obj]
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _to_cpu(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_cpu(o) for o in obj))
    return obj


def _launches(kernels):
    return [(K2.LAUNCHES, K2.WINDOW_LAUNCHES) if m is K2 else m.LAUNCHES for m in kernels]


def _sharded_on_card_and_cpu(dev, fit, query, kernels, tol):
    """An engine fitted on 4 shards of the card (`fit(mesh)`), queried there
    (`query(engine)` → ids, scores) and again with its state moved to 4 CPU
    shards: the card launched every module in `kernels`, the CPU none; ids
    equal up to exact-score ties (-inf at the same places), on >= 98% of
    queries outright."""
    card, cpu = _meshes(dev)
    engine = fit(card)
    before = _launches(kernels)
    g_ids, g_sc = query(engine)
    after = _launches(kernels)
    assert all(a != b for a, b in zip(after, before)), (before, after)
    engine.state, engine.mesh = _to_cpu(engine.state), cpu
    if hasattr(engine, "_query_fns"):
        engine._query_fns = {}
    c_ids, c_sc = query(engine)
    assert _launches(kernels) == after
    assert g_ids.shape == c_ids.shape
    fin = np.isfinite(c_sc)
    assert (np.isfinite(g_sc) == fin).all()
    assert all(equal_up_to_ties(g_ids[i][fin[i]], g_sc[i][fin[i]], c_ids[i][fin[i]],
                                c_sc[i][fin[i]], tol) for i in range(len(g_ids)))
    assert (g_ids == c_ids).all(axis=1).mean() >= 0.98


@pytest.mark.parametrize("name,extra,kernels", [
    ("block", dict(), (K1, K2)),
    ("window", dict(max_candidates=32768, coarse_window=64, coarse_head_pool=8,
                    coarse_keep=64), (K1, K2)),
    ("folded", dict(coarse_layout="folded", coarse_window=256, coarse_refine=1024,
                    max_candidates=8192), (K1, K3)),
    ("classic", dict(coarse_dim=0), (K1,)),
])
def test_sharded_forest_on_card_matches_cpu(dev, name, extra, kernels):
    from similaritysearchbyrdf_tpu_torch import sharded_forest

    x = _flat_corpus(6000, 32, 41)
    ids = np.arange(6000, dtype=np.int32) * 7 - 20_000      # negative ids too
    conf = _front_conf().replace(**extra)
    _sharded_on_card_and_cpu(
        dev, lambda mesh: sharded_forest(conf, mesh=mesh).fit(DenseBatch(ids, x)),
        lambda f: f.query(x[:128], steps=1, query_ids=ids[:128]), kernels, tol=2 * 32 * U)


@pytest.mark.parametrize("mode,kernels", [("grouped", (K4, K2)), ("scan", ())])
def test_sharded_flat_on_card_matches_cpu(dev, mode, kernels):
    from similaritysearchbyrdf_tpu_torch.parallel.sharded_flat import ShardedFlatIndex

    x = _flat_corpus(20_000, 96, 43)
    ids = np.arange(20_000, dtype=np.int32)
    _sharded_on_card_and_cpu(
        dev, lambda mesh: ShardedFlatIndex(mesh=mesh, mode=mode).fit(DenseBatch(ids, x)),
        lambda f: f.query(x[:256], k=10, query_ids=ids[:256]), kernels, tol=2 * 96 * U)


def test_sharded_ivf_on_card_matches_cpu(dev):
    from similaritysearchbyrdf_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

    x = _flat_corpus(20_000, 96, 47)
    ids = np.arange(20_000, dtype=np.int32)
    _sharded_on_card_and_cpu(
        dev, lambda mesh: ShardedIVFIndex(mesh=mesh, target_cluster=128, nprobe=8, win=64,
                                          head_pool=16, keep=8).fit(DenseBatch(ids, x)),
        lambda f: f.query(x[:256], k=10, query_ids=ids[:256]), (K2,), tol=2 * 96 * U)


def test_sharded_ivf_fit_on_card_equals_across_meshes(dev):
    """The k-means sums are integers: 8 shards and 4 shards of the card
    reach the same centroids bit for bit (the assignment is row by row)."""
    from similaritysearchbyrdf_tpu_torch.parallel.mesh import make_forest_mesh
    from similaritysearchbyrdf_tpu_torch.parallel.sharded_ivf import fit_ivf_sharded

    x = _flat_corpus(16_384, 96, 49)
    ids = np.arange(16_384, dtype=np.int32)
    cents = [fit_ivf_sharded(x, ids, make_forest_mesh(devices=[dev] * s), target_cluster=128,
                             iters=4)[0].centroids for s in (8, 4)]
    assert torch.equal(cents[0], cents[1])


def test_sharded_sparse_engines_on_card_match_cpu(dev):
    import torch as T

    from similaritysearchbyrdf_tpu_torch import SparseBatch
    from similaritysearchbyrdf_tpu_torch.index.bucket_table import KeyLayout
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_forest as SF
    from similaritysearchbyrdf_tpu_torch.parallel.sharded_flat import ShardedSparseFlatIndex

    idx, val = _sparse_rows(4000, 4096, 64, seed=9)
    batch = SparseBatch(np.arange(4000), 4096, idx, val, np.full(4000, 64))
    conf = _sparse_conf(vector_dim=4096, coarse_dim=0, max_candidates=16384)
    layout = KeyLayout.from_config(conf, conf.lsh_table)

    class Forest:                     # the sparse query function as an engine
        def __init__(self, mesh):
            self.mesh = mesh
            self.state, _ = SF.fit_sparse_sharded(conf, batch, mesh)

        def query(self):
            fn = SF.make_sparse_query_fn(self.mesh, layout, 4096, steps=0, m_cap=16384, k=10)
            d = self.mesh.devices[0]
            ids, sc, _ = fn(self.state, T.as_tensor(idx[:128], device=d),
                            T.as_tensor(val[:128], device=d),
                            T.arange(128, dtype=T.int32, device=d), chunk=64)
            return ids.cpu().numpy(), sc.cpu().numpy()

    _sharded_on_card_and_cpu(dev, Forest, lambda f: f.query(), (K1,), tol=1e-6)
    _sharded_on_card_and_cpu(
        dev, lambda mesh: ShardedSparseFlatIndex(mesh=mesh).fit(batch),
        lambda f: f.query(idx[:128], val[:128], k=10, query_ids=np.arange(128)), (K4, K2),
        tol=1e-6)


def test_sharded_save_load_on_card(dev, tmp_path):
    """Each sharded engine saved from the card and loaded back on it
    answers alike; with no devices named, the mesh is one shard on the
    card."""
    from similaritysearchbyrdf_tpu_torch import (load_sharded_flat, load_sharded_ivf,
                                                 save_sharded_flat, save_sharded_ivf)
    from similaritysearchbyrdf_tpu_torch.parallel.mesh import make_forest_mesh
    from similaritysearchbyrdf_tpu_torch.parallel.sharded_flat import ShardedFlatIndex
    from similaritysearchbyrdf_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

    mesh = _meshes(dev)[0]
    x = _flat_corpus(10_000, 64, 53)
    batch = DenseBatch(np.arange(10_000, dtype=np.int32), x)
    for engine, save, load in ((ShardedFlatIndex(mesh=mesh), save_sharded_flat,
                                load_sharded_flat),
                               (ShardedIVFIndex(mesh=mesh, target_cluster=64), save_sharded_ivf,
                                load_sharded_ivf)):
        engine.fit(batch)
        want = engine.query(x[:64], k=10, query_ids=np.arange(64))
        save(engine, str(tmp_path / "idx"))
        got = load(str(tmp_path / "idx"), mesh).query(x[:64], k=10, query_ids=np.arange(64))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    one = make_forest_mesh()
    assert one.devices == tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
