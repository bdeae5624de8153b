"""Port vs JAX package: hash-model and partition checkpoint files.

A file written by either package loads bit-equal in the other, and the
port writes the JAX package's bytes (angle and p-stable families, one
partition chain broadcast or one chain per table). A loaded model holds T*P
tables with one identity permutation each (P = 1): its hashes equal the
saved model's bit for bit, and a fit through `generate_method="fromfile"`
or a partition file gives the JAX package's ids."""

import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.index import partitioner as jpart
from similaritysearchbyrdf_tpu.index.forest import RDFForest as JForest
from similaritysearchbyrdf_tpu.models import families as jfam
from similaritysearchbyrdf_tpu.ops.hashing import hash_dense as j_hash
from similaritysearchbyrdf_tpu.vectors import DenseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import DenseBatch as TBatch
from similaritysearchbyrdf_tpu_torch import RDFForest
from similaritysearchbyrdf_tpu_torch.index import partitioner as tpart
from similaritysearchbyrdf_tpu_torch.models import families as tfam
from similaritysearchbyrdf_tpu_torch.ops.hashing import hash_dense as t_hash

D = 16
TOL = 2 * D * 2.0 ** -24


def confs(family="angle", **kw):
    base = dict(vector_dim=D, table_num=3, permutation_num=2, family_size=20,
                partition_bits=3, query_batch_size=8, max_candidates=512, top_k=5,
                family_name=family, seed=17)
    base.update(kw)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=12,
                                                              bucket_overflow=16)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=12,
                                                              bucket_overflow=16)))


def data(seed=0, n=300):
    x = np.random.default_rng(seed).normal(size=(n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def model_arrays(m):
    return [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
            for a in (m.proj, m.perm, m.b)]


@pytest.mark.parametrize("family", ["angle", "pStable"])
def test_model_file_bytes_equal_jax(tmp_path, family):
    jc, tc = confs(family)
    jfam.save_model_file(jfam.generate_model(jc), str(tmp_path / "jax"))
    tfam.save_model_file(tfam.generate_model(tc, device="cpu"), str(tmp_path / "port"))
    got = (tmp_path / "port").read_bytes()
    assert got == (tmp_path / "jax").read_bytes()
    assert got.endswith(b"\r\n") and b"\r\n(" in got


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("family", ["angle", "pStable"])
def test_model_files_cross_load_bit_equal(tmp_path, family, writer):
    jc, tc = confs(family)
    path = str(tmp_path / "model")
    if writer == "jax":
        jfam.save_model_file(jfam.generate_model(jc), path)
    else:
        tfam.save_model_file(tfam.generate_model(tc, device="cpu"), path)
    jm = jfam.load_model_file(path, jc)
    tm = tfam.load_model_file(path, tc, device="cpu")
    for g, w in zip(model_arrays(tm), model_arrays(jm)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert (tm.family, tm.w, tm.type_of_index) == (jm.family, jm.w, jm.type_of_index)
    t = jc.table_num * (jc.permutation_num if family == "angle" else 1)
    assert tuple(tm.perm.shape) == (t, 1, 12)          # T*P tables, P = 1
    assert torch.equal(tm.perm[:, 0], torch.arange(12, dtype=torch.int32).expand(t, 12))


@pytest.mark.parametrize("family", ["angle", "pStable"])
def test_loaded_model_hashes_equal_the_saved_ones(tmp_path, family):
    """The loaded P = 1 model through the hash (K1's plain version for the
    angle family) gives the saved model's hashes and the JAX package's."""
    jc, tc = confs(family)
    path = str(tmp_path / "model")
    saved = tfam.generate_model(tc, device="cpu")
    tfam.save_model_file(saved, path)
    loaded = tfam.load_model_file(path, tc, device="cpu")
    x = data(1, 64)
    h = t_hash(loaded, torch.from_numpy(x))
    assert torch.equal(h, t_hash(saved, torch.from_numpy(x)))
    want = np.asarray(j_hash(jfam.load_model_file(path, jc), x))
    np.testing.assert_array_equal(h.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("conf_type", ["lsh", "partition"])
def test_generate_model_from_file(tmp_path, conf_type):
    """generate_method="fromfile" reads family_file_path, or with
    confType "partition" partition_family_file_path; without one it
    raises, as in the JAX package."""
    jc, tc = confs()
    path = str(tmp_path / "model")
    tfam.save_model_file(tfam.generate_model(tc, device="cpu"), path)
    key = "partition_family_file_path" if conf_type == "partition" else "family_file_path"
    kw = dict(generate_method="fromfile", conf_type=conf_type)
    got = tfam.generate_model(tc.replace(**kw, **{key: path}), device="cpu")
    want = jfam.generate_model(jc.replace(**kw, **{key: path}))
    for g, w in zip(model_arrays(got), model_arrays(want)):
        assert np.array_equal(g, w)
    for mod, c in ((tfam, tc), (jfam, jc)):
        with pytest.raises(ValueError, match="requires"):
            mod.generate_model(c.replace(**kw))


@pytest.mark.parametrize("family", ["angle", "pStable"])
def test_fromfile_fit_gives_jax_ids(tmp_path, family):
    jc, tc = confs(family)
    path = str(tmp_path / "model")
    jfam.save_model_file(jfam.generate_model(jc, seed=99), path)
    kw = dict(generate_method="fromfile", family_file_path=path)
    x = data(2)
    ids = np.arange(300, dtype=np.int32)
    jf = JForest(jc.replace(**kw)).fit(JBatch(ids, x))
    tf = RDFForest(tc.replace(**kw), device="cpu").fit(TBatch(ids, x))
    assert tf.model.permutation_num == 1
    np.testing.assert_array_equal(tf.state.tables.sorted_ids.numpy(),
                                  np.asarray(jf.state.tables.sorted_ids))
    got, want = (f.query(x[:24], steps=1, query_ids=ids[:24]) for f in (tf, jf))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)


@pytest.mark.parametrize("chains", ["one", "per_table"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_partition_files_cross_load(tmp_path, writer, chains):
    """One chain is broadcast to every table, L chains give one per table;
    both packages write the same bytes and load the same chains."""
    jc, tc = confs()
    l = tc.hash_tables
    pp = tpart.generate_partition_projections(tc, seed=123, device="cpu")
    if chains == "one":
        pp = pp[:1]
    path = str(tmp_path / "partition-bestHashFamily-angle")
    (jpart.save_partition_file if writer == "jax" else tpart.save_partition_file)(
        pp.numpy() if writer == "jax" else pp, path)
    other = str(tmp_path / "other")
    (tpart.save_partition_file if writer == "jax" else jpart.save_partition_file)(pp.numpy(),
                                                                                  other)
    assert (tmp_path / "other").read_bytes() == (tmp_path / "partition-bestHashFamily-angle"
                                                 ).read_bytes()
    got = tpart.load_partition_file(path, tc, device="cpu")
    want = np.asarray(jpart.load_partition_file(path, jc))
    assert got.shape == (l, 3, 32) and np.array_equal(got.numpy(), want)
    assert torch.equal(got, pp.expand(l, -1, -1))


def test_partition_file_with_a_wrong_chain_count_raises(tmp_path):
    jc, tc = confs()
    pp = tpart.generate_partition_projections(tc, seed=5, device="cpu")[:2]
    path = str(tmp_path / "p")
    tpart.save_partition_file(pp, path)
    with pytest.raises(ValueError, match="partition chains"):
        tpart.load_partition_file(path, tc, device="cpu")
    with pytest.raises(ValueError, match="partition chains"):
        jpart.load_partition_file(path, jc)
    path2 = str(tmp_path / "q")
    tpart.save_partition_file(pp[:1, :2], path2)              # 2 functions, pbits 3
    with pytest.raises(ValueError, match="not divisible"):
        tpart.load_partition_file(path2, tc, device="cpu")


def test_partition_file_fit_gives_jax_ids(tmp_path):
    jc, tc = confs()
    path = str(tmp_path / "partition")
    jpart.save_partition_file(jpart.generate_partition_projections(jc, seed=123), path)
    x = data(3)
    ids = np.arange(300, dtype=np.int32)
    jf = JForest(jc.replace(partition_family_file_path=path)).fit(JBatch(ids, x))
    tf = RDFForest(tc.replace(partition_family_file_path=path), device="cpu").fit(
        TBatch(ids, x))
    assert np.array_equal(tf.part_proj.numpy(), np.asarray(jf.part_proj))
    np.testing.assert_array_equal(tf.sub_index_distribution(), jf.sub_index_distribution())
    got, want = (f.query(x[:24], steps=1, query_ids=ids[:24]) for f in (tf, jf))
    np.testing.assert_array_equal(got[0], want[0])


def test_hash_partition_matches_jax():
    vals = np.array([0, 1, -1, 7, -8, 2**31 - 1, -2**31, 123456789], dtype=np.int32)
    for n in (1, 2, 3, 7):
        np.testing.assert_array_equal(tpart.hash_partition(torch.from_numpy(vals), n).numpy(),
                                      np.asarray(jpart.hash_partition(vals, n)))
