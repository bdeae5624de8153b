"""Port vs JAX package: hash models, hashing (K1's plain version), margins,
partitions, typeOfIndex transforms and bit utilities, from one numpy seed.

Hash bits are decided by the sign of an f32 dot, and the two packages sum
in different orders, so a bit may differ where |dot| < 1e-5; such bits are
counted and excluded, every other bit must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.index import partitioner as jpart
from similaritysearchbyrdf_tpu.models import families as jfam
from similaritysearchbyrdf_tpu.models import transforms as jtr
from similaritysearchbyrdf_tpu.ops import bitops as jbit
from similaritysearchbyrdf_tpu.ops import hashing as jhash
from similaritysearchbyrdf_tpu.ops.pallas.hash_kernel import pallas_hash_dense
from similaritysearchbyrdf_tpu_torch.index import partitioner as tpart
from similaritysearchbyrdf_tpu_torch.models import families as tfam
from similaritysearchbyrdf_tpu_torch.models import transforms as ttr
from similaritysearchbyrdf_tpu_torch.ops import bitops as tbit
from similaritysearchbyrdf_tpu_torch.ops import hashing as thash
from similaritysearchbyrdf_tpu_torch.ops.kernels import hash_kernel as K1

NEAR = 1e-5


def confs(**kw):
    """The same configuration in both packages."""
    chain = kw.pop("chain", 16)
    base = dict(vector_dim=24, table_num=3, permutation_num=2, family_size=40,
                partition_bits=3, seed=5)
    base.update(kw)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=chain)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=chain)))


def data(b=64, d=24, seed=0):
    return np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)


def near_bit_mask(x, proj, perm):
    """Per packed hash word, the bits whose function's |dot| < NEAR."""
    dots = np.einsum("bd,tcd->btc", x.astype(np.float64), proj.astype(np.float64))
    near = np.abs(dots) < NEAR                                    # [B, T, C]
    t, p, c = perm.shape
    bits = np.take_along_axis(near[:, :, None, :], perm[None].astype(np.int64), axis=-1)
    weights = np.left_shift(np.int64(1), np.arange(31, 31 - c, -1))
    return (bits * weights).sum(-1).reshape(x.shape[0], t * p)


def assert_hashes_equal(got, want, mask):
    got = np.asarray(got, np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    far = (got ^ want) & ~mask
    assert not far.any(), f"{np.count_nonzero(far)} words differ away from near-zero dots"
    return int(sum(bin(int(v)).count("1") for v in ((got ^ want) & mask).ravel()))


@pytest.mark.parametrize("family,pallas", [("angle", False), ("angle", True),
                                           ("pStable", False)])
def test_generate_model_bit_equal(family, pallas):
    jc, tc = confs(family_name=family, use_pallas_hash=pallas)
    jm, tm = jfam.generate_model(jc), tfam.generate_model(tc, device="cpu")
    for name in ("proj", "perm", "b", "sampling_perm"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
    assert (tm.family, tm.w, tm.type_of_index) == (jm.family, jm.w, jm.type_of_index)
    assert tm.perm.dtype == torch.int32 and tm.proj.dtype == torch.float32


def test_partition_projections_bit_equal():
    jc, tc = confs()
    np.testing.assert_array_equal(tpart.generate_partition_projections(tc, device="cpu").numpy(),
                                  np.asarray(jpart.generate_partition_projections(jc)))


@pytest.mark.parametrize("chain", [8, 16, 32])
def test_hash_dense_matches_xla_and_pallas(chain):
    jc, tc = confs(chain=chain)
    jm, tm = jfam.generate_angle_model(jc), tfam.generate_angle_model(tc, device="cpu")
    x = data()
    got = thash.hash_dense(tm, torch.from_numpy(x))
    assert got.dtype == tbit.HASH_DTYPE
    mask = near_bit_mask(x, np.asarray(jm.proj), np.asarray(jm.perm))
    n_xla = assert_hashes_equal(got, jhash.hash_dense(jm, jnp.asarray(x)), mask)
    n_pal = assert_hashes_equal(
        got, pallas_hash_dense(jm, jnp.asarray(x), block_b=16, interpret=True), mask)
    assert n_xla <= np.count_nonzero(mask) and n_pal <= np.count_nonzero(mask)


@pytest.mark.parametrize("chain", [16, 32])
def test_margins_match(chain):
    jc, tc = confs(chain=chain)
    jm, tm = jfam.generate_angle_model(jc), tfam.generate_angle_model(tc, device="cpu")
    x = data(seed=3)
    h, m = thash.hash_dense_with_margins(tm, torch.from_numpy(x))
    jh, jmg = jhash.hash_dense_with_margins(jm, jnp.asarray(x))
    assert_hashes_equal(h, jh, near_bit_mask(x, np.asarray(jm.proj), np.asarray(jm.perm)))
    jmg = np.asarray(jmg)
    assert m.shape == jmg.shape == (x.shape[0], 6, 32)
    np.testing.assert_array_equal(np.isinf(m.numpy()), np.isinf(jmg))
    np.testing.assert_allclose(m.numpy(), jmg, rtol=1e-6, atol=1e-6)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    _, tc = confs(chain=32)
    tm = tfam.generate_angle_model(tc, device="cpu")
    x = torch.from_numpy(data(seed=4))
    before = K1.LAUNCHES
    h, m = K1.hash_dense_kernel(x, tm.proj, tm.perm, emit_margins=True)
    hp, mp = K1.hash_dense_plain(x, tm.proj, tm.perm, emit_margins=True)
    assert torch.equal(h, hp) and torch.equal(m, mp)
    assert K1.hash_dense_kernel(x, tm.proj, tm.perm)[1] is None
    assert K1.LAUNCHES == before
    with pytest.raises(ValueError):
        K1.hash_dense_kernel(x.to("meta"), tm.proj.to("meta"), tm.perm.to("meta"))


def test_pstable_hash_matches():
    jc, tc = confs(family_name="pStable")
    jm, tm = jfam.generate_pstable_model(jc), tfam.generate_pstable_model(tc, device="cpu")
    x = data(seed=5)
    got = thash.hash_dense(tm, torch.from_numpy(x)).numpy()
    want = np.asarray(jhash.hash_dense(jm, jnp.asarray(x))).astype(np.int64)
    # a truncation boundary of (a.x + b)/w within float noise may differ
    vals = (np.einsum("bd,tcd->btc", x.astype(np.float64), np.asarray(jm.proj, np.float64))
            + np.asarray(jm.b)[None]) / jm.w
    near = (np.abs(vals - np.round(vals)) < NEAR).any(-1)         # [B, T]
    assert ((got == want) | near).all()
    assert (got == want).mean() > 0.95


@pytest.mark.parametrize("pbits", [2, 3])
def test_partition_of_hash_matches(pbits):
    jc, tc = confs(partition_bits=pbits)
    q = np.asarray(jpart.generate_partition_projections(jc))
    rng = np.random.default_rng(pbits)
    h = rng.integers(0, 2**32, size=(128, 6), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jpart.partition_of_hash(jnp.asarray(h), jnp.asarray(q)))
    got = tpart.partition_of_hash(torch.from_numpy(h.astype(np.int64)), torch.tensor(q))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["original", "sampling", "continueBitsCount",
                                  "angleNewMethod", "variableBits"])
def test_type_of_index_transforms_match(kind):
    rng = np.random.default_rng(11)
    h = rng.integers(0, 2**32, size=(257,), dtype=np.uint64).astype(np.uint32)
    h[:3] = [0, 0xFFFFFFFF, 0x0FFFFFFF]
    perm = jtr.sampling_permutation(88387)
    want = np.asarray(jtr.apply_type_of_index(jnp.asarray(h), kind, jnp.asarray(perm)))
    got = ttr.apply_type_of_index(torch.from_numpy(h.astype(np.int64)), kind,
                                  torch.from_numpy(ttr.sampling_permutation(88387)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_bitops_match():
    rng = np.random.default_rng(2)
    h = rng.integers(0, 2**32, size=(500,), dtype=np.uint64).astype(np.uint32)
    h[:4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    th = torch.from_numpy(h.astype(np.int64))
    for jf, tf in ((jbit.clz, tbit.clz), (jbit.popcount, tbit.popcount)):
        np.testing.assert_array_equal(tf(th).numpy(), np.asarray(jf(jnp.asarray(h))))
    np.testing.assert_array_equal(tbit.as_i32(th).numpy(), h.view(np.int32))
    keys = tbit.to_key(th)
    assert keys.dtype == torch.int32
    np.testing.assert_array_equal(tbit.from_key(keys).numpy(), h.astype(np.int64))
    assert torch.equal(torch.argsort(keys, stable=True), torch.argsort(th, stable=True))
    ints = rng.integers(-2**31, 2**31, size=(40, 5), dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(
        tbit.java_bytes_hash_of_ints(torch.from_numpy(ints)).numpy(),
        np.asarray(jbit.java_bytes_hash_of_ints(jnp.asarray(ints))).view(np.uint32))
    srt = np.sort(h)
    np.testing.assert_array_equal(
        tbit.searchsorted_u32(torch.from_numpy(srt.astype(np.int64)), th).numpy(),
        np.asarray(jbit.searchsorted_u32(jnp.asarray(srt), jnp.asarray(h))))
