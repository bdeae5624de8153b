"""The port's XTEA + CRC32 record wrap (`similaritysearchbyrdf_tpu_torch/storage/crypto.py`)
against the JAX package's, and encrypted forest checkpoints that load in
either package."""

import struct
import zlib

import numpy as np
import pytest

from similaritysearchbyrdf_tpu.storage import crypto as J
from similaritysearchbyrdf_tpu_torch.storage.crypto import (ALIGN, XTEA, DataCorruptionError,
                                                           WrongConfigError, unwrap_record,
                                                           wrap_record)


@pytest.mark.parametrize("password", [b"", b"pw", b"hunter2", bytes(range(64))])
def test_xtea_bytes_equal_jax(password):
    rng = np.random.default_rng(len(password))
    data = rng.integers(0, 256, 8 * 37, dtype=np.uint8).tobytes()
    enc = XTEA(password).encrypt(data)
    assert enc == J.XTEA(password).encrypt(data)
    assert XTEA(password).decrypt(enc) == data
    assert J.XTEA(password).decrypt(enc) == data


def test_xtea_rejects_partial_blocks():
    with pytest.raises(DataCorruptionError):
        XTEA(b"pw").encrypt(b"123")


@pytest.mark.parametrize("password", [None, b"secret"])
@pytest.mark.parametrize("checksum", [False, True])
def test_wrap_unwrap_all_flag_combinations(password, checksum):
    """Every length around the 16-byte alignment, each flag combination:
    the port's wrap equals the JAX package's and unwraps in both."""
    rng = np.random.default_rng(2)
    for n in (0, 1, 15, 16, 17, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        w = wrap_record(data, password=password, checksum=checksum)
        assert w == J.wrap_record(data, password=password, checksum=checksum)
        if password is not None:
            assert (len(w) - 1 - (4 if checksum else 0)) % ALIGN == 0
        assert unwrap_record(w, password=password, checksum=checksum) == data
        assert J.unwrap_record(w, password=password, checksum=checksum) == data


def test_crc_detects_corruption():
    data = b"attack at dawn, bucket 7"
    w = wrap_record(data, checksum=True)
    assert struct.unpack(">I", w[-4:])[0] == zlib.crc32(data) & 0xFFFFFFFF
    for i in range(len(w)):
        bad = bytearray(w)
        bad[i] ^= 0x40
        with pytest.raises(DataCorruptionError):
            unwrap_record(bytes(bad), checksum=True)
    with pytest.raises(DataCorruptionError):
        unwrap_record(b"abc", checksum=True)


def _forests(tmp_path):
    from similaritysearchbyrdf_tpu.config import RDFConfig as JConfig
    from similaritysearchbyrdf_tpu.config import TableConfig as JTable
    from similaritysearchbyrdf_tpu.index.forest import RDFForest as JForest
    from similaritysearchbyrdf_tpu.vectors import DenseBatch as JBatch
    from similaritysearchbyrdf_tpu_torch import DenseBatch, RDFConfig, RDFForest, TableConfig

    rng = np.random.default_rng(3)
    x = rng.normal(size=(512, 16)).astype(np.float32)
    kw = dict(vector_dim=16, table_num=2, permutation_num=1, top_k=5, max_candidates=256,
              query_batch_size=64)
    ids = np.arange(512, dtype=np.int32)
    port = RDFForest(RDFConfig(lsh_table=TableConfig(chain_length=8, bucket_overflow=32), **kw),
                     device="cpu").fit(DenseBatch(ids, x))
    jax = JForest(JConfig(lsh_table=JTable(chain_length=8, bucket_overflow=32), **kw)).fit(
        JBatch(ids, x))
    return x, port, jax


def test_forest_checkpoint_encrypted_roundtrip(tmp_path):
    """An encrypted, checksummed save of the port's forest loads in the
    port and in the JAX package with the same ids; the JAX package's loads
    in the port; mismatched options raise WrongConfigError."""
    from similaritysearchbyrdf_tpu.storage import persist as JP
    from similaritysearchbyrdf_tpu_torch import load_forest, save_forest

    x, port, jax = _forests(tmp_path)
    want, _ = port.query(x[:16])
    base = str(tmp_path / "enc")
    save_forest(port, base, password=b"pw", checksum=True)
    raw = open(base + ".npz", "rb").read()
    assert raw[:5] == b"RDFX\x03" and not raw[5:].startswith(b"PK")
    got, _ = load_forest(base, password=b"pw", checksum=True, device="cpu").query(x[:16])
    np.testing.assert_array_equal(got, want)
    got_j, _ = JP.load_forest(base, password=b"pw", checksum=True).query(x[:16])
    np.testing.assert_array_equal(got_j, want)

    jbase = str(tmp_path / "jenc")
    JP.save_forest(jax, jbase, password=b"pw")
    got_p, _ = load_forest(jbase, password=b"pw", device="cpu").query(x[:16])
    np.testing.assert_array_equal(got_p, jax.query(x[:16])[0])

    with pytest.raises(WrongConfigError):
        load_forest(base, password=b"pw", device="cpu")              # checksum missing
    with pytest.raises(WrongConfigError):
        load_forest(base, checksum=True, device="cpu")               # password missing
    with pytest.raises(Exception):
        load_forest(base, password=b"wrong", checksum=True, device="cpu")
    plain = str(tmp_path / "plain")
    save_forest(port, plain)
    with pytest.raises(WrongConfigError):
        load_forest(plain, password=b"pw", device="cpu")
    with pytest.raises(WrongConfigError):
        load_forest(plain, checksum=True, device="cpu")


def test_crc_catches_a_corrupted_checkpoint(tmp_path):
    from similaritysearchbyrdf_tpu_torch import load_forest, save_forest

    _, port, _ = _forests(tmp_path)
    base = str(tmp_path / "ck")
    save_forest(port, base, checksum=True)
    raw = bytearray(open(base + ".npz", "rb").read())
    raw[len(raw) // 2] ^= 0x01
    open(base + ".npz", "wb").write(bytes(raw))
    with pytest.raises(DataCorruptionError):
        load_forest(base, checksum=True, device="cpu")
