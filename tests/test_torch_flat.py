"""The port's flat engine against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages: K4's plain version
against the Pallas kernels in interpret mode (bit for bit), the sketch, the
scan and grouped engines through `from_jax_flat` (ids equal on every query,
scores within the f32 summation bound), the argpack path in its two-level
and direct branches, and the packed selects. Also the entry points' default
device: the first CUDA card, never a quiet fall back to the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu import FlatIndex as JFlatIndex
from similaritysearchbyrdf_tpu.ops import flat as jflat
from similaritysearchbyrdf_tpu.ops.pallas import flat_groupmax as jgm
from similaritysearchbyrdf_tpu.vectors import DenseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import FlatIndex, RDFForest, fit_dense, from_jax_flat
from similaritysearchbyrdf_tpu_torch import from_jax_state
from similaritysearchbyrdf_tpu_torch.index import partitioner as tpart
from similaritysearchbyrdf_tpu_torch.models import families as tfam
from similaritysearchbyrdf_tpu_torch.ops import flat as tflat
from similaritysearchbyrdf_tpu_torch.ops.exact import exact_search
from similaritysearchbyrdf_tpu_torch.ops.kernels import flat_groupmax as K4
from similaritysearchbyrdf_tpu_torch.vectors import DenseBatch as TBatch

U = 2.0 ** -24     # f32 unit roundoff


def _corpus(n, d, seed, clusters=64, noise=0.08):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, clusters, n)] + noise * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def test_groupmax_plain_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    sk = rng.integers(-100, 100, size=(8192, 32)).astype(np.int8)
    q = rng.integers(-100, 100, size=(16, 32)).astype(np.int8)
    want = np.asarray(jgm.pallas_flat_groupmax(jnp.asarray(sk), jnp.asarray(q), group=64,
                                               block_b=16, block_n=4096, interpret=True)).T
    got = K4.flat_groupmax_plain(_t(sk), _t(q), 64).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_groupmax_plain_packed_matches_pallas_qmajor_and_qlane():
    rng = np.random.default_rng(0)
    npad, d, b, g = 16384, 128, 128, 64
    sk = rng.integers(-127, 128, size=(npad, d)).astype(np.int8)
    q = rng.integers(-127, 128, size=(b, d)).astype(np.int8)
    want = np.asarray(jgm.pallas_flat_groupmax_qmajor(
        jnp.asarray(sk), jnp.asarray(q), group=g, block_b=128, block_n=8192, interpret=True,
        pack_arg=True))
    got = K4.flat_groupmax_plain(_t(sk), _t(q), g, pack_arg=True)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # the fused supergroup tier: the qlane kernel on its strided sketch copy
    pk, sgt = jgm.pallas_flat_groupmax_qlane(
        jflat.stride_for_halved_gmax(jnp.asarray(sk)), jnp.asarray(q), group=g, block_b=128,
        block_n=8192, interpret=True, pack_arg=True, emit_sg=16)
    got2, sg = K4.flat_groupmax_plain(_t(sk), _t(q), g, pack_arg=True, emit_sg=16)
    assert np.array_equal(got2.numpy(), np.asarray(pk))
    assert np.array_equal(sg.numpy(), np.asarray(sgt).T)


def test_packed_groupmax_qmajor_matches_jax():
    rng = np.random.default_rng(8)
    sk = rng.integers(-127, 128, size=(8192, 64)).astype(np.int8)
    q = rng.integers(-127, 128, size=(9, 64)).astype(np.int8)
    sk[100:164:7] = sk[99]                          # ties inside a group
    want = np.asarray(jflat.packed_groupmax_qmajor(jnp.asarray(sk), jnp.asarray(q), 64,
                                                   use_pallas=False))
    got = tflat.packed_groupmax_qmajor(_t(sk), _t(q), 64)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_groupmax_plain_refuses_bad_input():
    sk = torch.zeros((128, 32), dtype=torch.int8)
    with pytest.raises(TypeError):
        K4.flat_groupmax_plain(sk, torch.zeros((2, 32)), 64)             # mixed types
    with pytest.raises(ValueError):
        K4.flat_groupmax_plain(sk, sk[:2], 48)                           # not a power of two
    with pytest.raises(TypeError):
        K4.flat_groupmax_plain(sk.to(torch.bfloat16), sk[:2].to(torch.bfloat16), 64,
                               pack_arg=True)                            # bf16 cannot pack
    with pytest.raises(ValueError):
        K4.flat_groupmax_plain(torch.zeros((8192, 2112), dtype=torch.int8),
                               torch.zeros((2, 2112), dtype=torch.int8), 64, pack_arg=True)
    with pytest.raises(ValueError):
        K4.flat_groupmax_plain(sk, sk[:2], 64, emit_sg=2)                # emit needs pack


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("d", [96, 100])
def test_build_flat_sketch_matches_jax(dtype, d, monkeypatch):
    x = _corpus(3000, d, seed=2)
    x[5, 3] = -1.5                                 # the largest magnitude is negative
    monkeypatch.setattr(tflat, "_QUANT_CHUNK", 1000)   # three quantization chunks
    js, jscale = jflat.build_flat_sketch(jnp.asarray(x), dtype)
    ts, tscale = tflat.build_flat_sketch(torch.as_tensor(x), dtype)
    assert ts.shape == (3000, -(-d // 32) * 32) and tscale == jscale
    want = np.asarray(js.astype(jnp.float32))[:, :ts.shape[1]]
    assert np.array_equal(ts.to(torch.float32).numpy(), want)
    assert not np.asarray(js.astype(jnp.float32))[:, ts.shape[1]:].any()


def _jax_flat(x, **kw):
    return JFlatIndex(**kw).fit(JBatch(np.arange(len(x), dtype=np.int32), x))


def _flat_arrays(jf):
    return {"sketch": np.asarray(jf.sketch.astype(jnp.float32) if jf.sketch.dtype != jnp.int8
                                 else jf.sketch),
            "scale": jf.scale, "corpus": np.asarray(jf.corpus.astype(jnp.float32)),
            "row_ids": np.asarray(jf.row_ids)}


def _assert_same_results(x, q, j_ids, j_sc, t_ids, t_sc):
    assert np.array_equal(t_ids, j_ids)
    fin = np.isfinite(j_sc)
    assert np.array_equal(fin, np.isfinite(t_sc))
    # each package's f32 dot is within D*u*sum|x*q| of the exact one
    s_abs = np.abs(x[np.where(j_ids >= 0, j_ids, 0)] * q[:, None, :]).sum(-1)
    assert (np.abs(t_sc - j_sc)[fin] <= 2 * x.shape[1] * U * s_abs[fin] + 1e-30).all()


@pytest.mark.parametrize("mode,dtype,d", [("scan", "int8", 100), ("scan", "bfloat16", 100),
                                          ("grouped", "int8", 100), ("grouped", "int8", 96),
                                          ("grouped", "bfloat16", 100), ("grouped", "int8", 200),
                                          ("grouped", "int8", 784)])
def test_flat_index_matches_jax(mode, dtype, d):
    """flat_topk (scan) and grouped exact2 (K4 unpacked, two-level group
    select, K2b window re-score) at ~6k x 100, B 64, through from_jax_flat;
    also at D 200 and 784, which the JAX package sends to its high-D group-max
    route (sketch width 224 and 800 here)."""
    x = _corpus(6000, d, seed=3)
    q, qids = x[:64], np.arange(64)
    kw = dict(sketch_dtype=dtype, refine=64, block=1024, mode=mode)
    jf = _jax_flat(x, **kw)
    j_ids, j_sc = jf.query(q, k=10, query_ids=qids)
    tf = from_jax_flat(_flat_arrays(jf), d, device="cpu", refine=64, block=1024, mode=mode)
    assert tf.sketch.shape == (8192, -(-d // 32) * 32) and tf.corpus.shape == (6000, d)
    t_ids, t_sc = tf.query(q, k=10, query_ids=qids)
    _assert_same_results(x, q, j_ids, j_sc, t_ids, t_sc)
    # the port's own fit builds the same index
    own = FlatIndex(device="cpu", **kw).fit(TBatch(np.arange(6000, dtype=np.int32), x))
    o_ids, _ = own.query(q, k=10, query_ids=qids)
    assert np.array_equal(o_ids, t_ids)


@pytest.mark.parametrize("n,l2,emit", [(131_072, "sort", 0), (131_072, "approx", 0),
                                       (131_072, "sort", 16), (3000, "sort", 0)])
def test_argpack_matches_jax(n, l2, emit):
    """argpack at N 131,072 (NG 2,048: the two-level select) and at N 3,000
    (NG 128: the direct select); K4's emitted supergroup tier changes
    nothing."""
    d, b, k = 32, 32, 10
    x = _corpus(n, d, seed=4, clusters=512, noise=0.2)
    q = x[:b] + 0.05 * np.random.default_rng(5).normal(size=(b, d)).astype(np.float32)
    js, _ = jflat.build_flat_sketch(jnp.asarray(x))
    j_ids, j_sc = jflat.flat_topk_grouped(
        js, jnp.asarray(x), jnp.arange(n, dtype=jnp.int32), jnp.asarray(q),
        jnp.arange(b, dtype=jnp.int32), k, refine=16, select_mode="argpack", argpack_l2=l2,
        use_pallas=False)
    sk = _t(np.asarray(js)[:, :d])
    t_ids, t_sc = tflat.flat_topk_grouped(
        sk, torch.as_tensor(x), torch.arange(n, dtype=torch.int32), torch.as_tensor(q),
        torch.arange(b, dtype=torch.int32), k, refine=16, select_mode="argpack",
        argpack_l2=l2, gmax_emit_sg=emit)
    _assert_same_results(x, q, np.asarray(j_ids), np.asarray(j_sc), t_ids.numpy(),
                         t_sc.numpy())


@pytest.mark.parametrize("mode,sg", [("exact2", 8), ("exact2", 64), ("topk", 64),
                                     ("approx", 64)])
def test_grouped_candidates_match_jax(mode, sg):
    """The exact2 two-level group select (NG 1,024 >= 4 rg supergroups) and
    the one-level selects pick the JAX package's candidates."""
    rng = np.random.default_rng(17)
    n, d, b, rg = 65_000, 16, 4, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:b] + 0.01 * rng.normal(size=(b, d)).astype(np.float32)
    sk = np.clip(np.round(x * (127.0 / np.abs(x).max())), -127, 127).astype(np.int8)
    jc, js = jflat._grouped_candidates(jnp.asarray(sk), jnp.asarray(q), refine=rg * 64,
                                       r_groups=rg, group=64, use_pallas=False,
                                       recall_target=0.998, select_mode=mode, select_sg=sg)
    tc, ts = tflat._grouped_candidates(_t(sk), torch.as_tensor(q), refine=rg * 64,
                                       r_groups=rg, group=64, select_mode=mode, select_sg=sg)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    fin = np.isfinite(np.asarray(js))
    assert np.array_equal(np.isfinite(ts.numpy()), fin)
    assert np.allclose(ts.numpy()[fin], np.asarray(js)[fin], rtol=1e-6)


def _tied_packed(rng, b, ng, n_dead):
    """Packed keys with many exact ties (few scores, few members) and a dead
    tail of groups."""
    score = rng.integers(-6, 6, size=(b, ng)).astype(np.int32)
    member = rng.integers(60, 64, size=(b, ng)).astype(np.int32)
    pk = (score << 6) | member
    pk[:, ng - n_dead:] = jflat._I32_DEAD
    return pk


@pytest.mark.parametrize("l2", ["sort", "approx"])
@pytest.mark.parametrize("ng,sg", [(2048, 32), (2048, 4), (128, 32)])
def test_select_packed_rows_matches_jax_with_ties(l2, ng, sg):
    rng = np.random.default_rng(ng + sg)
    pk = _tied_packed(rng, 8, ng, n_dead=40)
    n = (ng - 40) * 64 - 7
    jc, js = jflat.select_packed_rows(jnp.asarray(pk), group=64, refine=16, n=n, select_sg=sg,
                                      l2=l2)
    tc, ts = tflat.select_packed_rows(_t(pk), group=64, refine=16, n=n, select_sg=sg, l2=l2)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("n", [131_072, 100_000])
def test_fold_emitted_sgmax_matches_unemitted(n):
    rng = np.random.default_rng(n)
    npad, d, b, g, esg, sg = 131_072, 32, 4, 64, 16, 32
    sk = torch.as_tensor(rng.integers(-127, 128, size=(npad, d)).astype(np.int8))
    sk[n:] = 0
    q = torch.as_tensor(rng.integers(-127, 128, size=(b, d)).astype(np.int8))
    packed, sgmax_pre = K4.flat_groupmax_plain(sk, q, g, pack_arg=True, emit_sg=esg)
    packed[:, -(-n // g):] = tflat._I32_DEAD
    p3 = packed.view(b, -1, sg)
    folded = tflat._fold_emitted_sgmax(sgmax_pre, p3, n, g, sg, esg)
    assert torch.equal(folded, p3.amax(dim=2))
    want = np.asarray(jflat._fold_emitted_sgmax(jnp.asarray(sgmax_pre.numpy()),
                                                jnp.asarray(p3.numpy()), n, g, sg, esg))
    assert np.array_equal(folded.numpy(), want)
    for l2 in ("sort", "approx"):
        a = tflat.select_packed_rows(packed, g, 16, n, sg, l2)
        e = tflat.select_packed_rows(packed, g, 16, n, sg, l2, sgmax_pre=sgmax_pre, emit_sg=esg)
        assert all(torch.equal(u, v) for u, v in zip(a, e))


@pytest.mark.parametrize("n,select_sg,refine,want_emit", [
    (100_032, None, 16, 32),    # the live groups end inside a supergroup
    (102_400, None, 16, 32),    # ... on a supergroup boundary, dead supergroups after it
    (131_072, None, 16, 32),    # every supergroup live: full_sg == nsg
    (100_001, None, 16, 32),    # the last live group partly live
    (98_303, None, 16, 32),     # ... and full_sg == nsg
    (20_000, None, 16, 0),      # NG 384: 12 supergroups < 2 rg, the one-level select
    (100_032, 256, 3, 0),       # NG 1,664 % 256 != 0, the one-level select
    (100_032, 52, 16, 0),       # two levels of 52 groups, a width K4 cannot emit
])
def test_argpack_emits_the_select_tier_by_shape(n, select_sg, refine, want_emit, monkeypatch):
    """`_argpack_candidates` asks K4 for the supergroup tier at the select's
    own width exactly where the two-level select reads it, and for none
    elsewhere; the candidates and answers equal those with no tier bit for
    bit. The rows lean one way, and half the queries are negated rows, so
    their every key is negative: the dead groups' unmasked keys in the
    emitted tier would beat them where the tail were not recomputed."""
    d, b = 32, 8
    x = _corpus(n, d, seed=6, clusters=256, noise=0.2)
    x[:, 0] += 2.0
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    rng = np.random.default_rng(n)
    rows = np.r_[n - 1, n - 70, rng.integers(0, n, b - 2)]
    q = x[rows] * np.where(np.arange(b) % 2, -1.0, 1.0)[:, None].astype(np.float32)
    sk, _ = tflat.build_flat_sketch(torch.as_tensor(x))
    asked = []

    def recording(*args, **kw):
        asked.append(kw.get("emit_sg", 0))
        return K4.flat_groupmax_kernel(*args, **kw)

    monkeypatch.setattr(tflat, "flat_groupmax_kernel", recording)
    qt = torch.as_tensor(q)
    got = tflat._argpack_candidates(sk, qt, refine, 64, select_sg=select_sg)
    want = tflat._argpack_candidates(sk, qt, refine, 64, select_sg=select_sg, emit_sg=0)
    assert asked == [want_emit, 0]
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    k = min(10, refine)
    args = (sk, torch.as_tensor(x), torch.arange(n, dtype=torch.int32), qt, None, k)
    kw = dict(refine=refine, select_mode="argpack", select_sg=select_sg)
    ids, sc = tflat.flat_topk_grouped(*args, **kw)
    ids0, sc0 = tflat.flat_topk_grouped(*args, gmax_emit_sg=0, **kw)
    assert asked[2:] == [want_emit, 0]
    assert torch.equal(ids, ids0) and torch.equal(sc.view(torch.int32), sc0.view(torch.int32))


@pytest.mark.parametrize("mode,dtype,nrows,d", [
    ("auto", torch.int8, 1 << 20, 96), ("auto", torch.int8, (1 << 20) - 1, 96),
    ("auto", torch.bfloat16, 1 << 21, 96), ("argpack", torch.int8, 100, 4096),
    ("argpack", torch.bfloat16, 100, 96), ("topk", torch.int8, 100, 96)])
def test_select_mode_resolution_matches_jax(mode, dtype, nrows, d):
    jdt = jnp.int8 if dtype == torch.int8 else jnp.bfloat16
    assert tflat._resolve_select_mode(mode, dtype, nrows, d) == jflat._resolve_select_mode(
        mode, jdt, nrows, d)


@pytest.mark.parametrize("mode", ["auto", "argpack"])
@pytest.mark.parametrize("nrows", [1 << 20, 1 << 21])
def test_select_mode_past_2048_columns_matches_jax(mode, nrows):
    """Each package is given its own padded width, as its FlatIndex stores
    the sketch: the port's multiple of 32, the reference's multiple of 128.
    At D 2049-2080 the port's 32-padded key would still fit int32, but the
    reference's 2176 lanes do not: both must pick exact2 there."""
    for d in range(2040, 2101):
        port = tflat._resolve_select_mode(mode, torch.int8, nrows, -(-d // 32) * 32)
        ref = jflat._resolve_select_mode(mode, jnp.int8, nrows, -(-d // 128) * 128)
        assert port == ref, d


@pytest.mark.parametrize("nq", [1, 31, 33, 500, 1024, 5000])
def test_effective_query_batch_matches_jax(nq):
    assert tflat.effective_query_batch(nq, 1024) == jflat.effective_query_batch(nq, 1024)


def test_flat_unfitted_contract():
    ids, scores = FlatIndex(device="cpu").query(np.zeros((3, 8), np.float32), k=4)
    assert ids.shape == (3, 4) and (ids == -1).all() and np.isneginf(scores).all()


def _small_conf():
    return tcfg.RDFConfig(vector_dim=16, table_num=2, permutation_num=1, family_size=20,
                          lsh_table=tcfg.TableConfig(chain_length=8, bucket_overflow=16),
                          seed=5)


def test_entry_points_refuse_without_cuda(monkeypatch):
    """With no device named and no CUDA, every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = _small_conf()
    x = _corpus(64, 16, seed=6)
    batch = TBatch(np.arange(64, dtype=np.int32), x)
    for make in (lambda: RDFForest(conf), lambda: FlatIndex(),
                 lambda: fit_dense(conf, batch), lambda: exact_search(x, x[:4], 3),
                 lambda: from_jax_state({}, conf), lambda: tfam.generate_model(conf),
                 lambda: tpart.generate_partition_projections(conf),
                 lambda: from_jax_flat({}, 16), lambda: tfam.resolve_device(None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_entry_points_run_on_the_cpu_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = _small_conf()
    x = _corpus(300, 16, seed=7)
    ids = np.arange(300, dtype=np.int32)
    forest = RDFForest(conf, device="cpu").fit(TBatch(ids, x))
    assert forest.state.corpus.device.type == "cpu"
    f_ids, _ = forest.query(x[:4], query_ids=ids[:4], k=3)
    assert f_ids.shape == (4, 3)
    flat = FlatIndex(refine=32, device="cpu").fit(TBatch(ids, x))
    assert flat.sketch.device.type == "cpu"
    flat_ids, _ = flat.query(x[:4], k=3, exclude_self=False)
    gt, _ = exact_search(x, x[:4], 3, device="cpu")
    assert np.array_equal(flat_ids, gt)
    assert fit_dense(conf, TBatch(ids, torch.as_tensor(x))).corpus.device.type == "cpu"
    # a named device wins; with CUDA present, none named means the first card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tfam.resolve_device(None) == torch.device("cuda", 0)
    assert tfam.resolve_device("cpu") == torch.device("cpu")
