"""`ops/precision.full_f32`: TF32 off inside the block, the caller's setting
back afterwards, also when the block raises.

The flags are process-wide; the fixture puts every one back as it found it.
On the CPU only the flags can be checked; the card test
`tests/test_torch_cuda.py::test_exact_tiers_ignore_global_tf32` checks the
ids.
"""

import contextlib

import pytest
import torch

from similaritysearchbyrdf_tpu_torch.ops.precision import full_f32

MATMUL = torch.backends.cuda.matmul


def _new_api():
    """The per-backend settings, where this torch has them."""
    out = {}
    for name, obj in (("generic", torch.backends), ("cuda", MATMUL),
                      ("mkldnn", getattr(torch.backends.mkldnn, "matmul", None))):
        if obj is not None and hasattr(obj, "fp32_precision"):
            out[name] = obj
    return out


@pytest.fixture
def flags():
    saved = {name: obj.fp32_precision for name, obj in _new_api().items()}
    yield
    torch.set_float32_matmul_precision("highest")
    for name, obj in _new_api().items():
        obj.fp32_precision = saved[name]
    assert MATMUL.allow_tf32 is False


class Boom(Exception):
    pass


@pytest.mark.parametrize("raises", [False, True])
def test_restores_tf32_set_by_matmul_precision(flags, raises):
    torch.set_float32_matmul_precision("high")
    assert MATMUL.allow_tf32 is True
    with pytest.raises(Boom) if raises else contextlib.nullcontext():
        with full_f32():
            assert MATMUL.allow_tf32 is False
            if raises:
                raise Boom()
    assert MATMUL.allow_tf32 is True
    assert torch.get_float32_matmul_precision() == "high"


@pytest.mark.parametrize("raises", [False, True])
def test_restores_tf32_set_by_allow_tf32(flags, raises):
    MATMUL.allow_tf32 = True
    with pytest.raises(Boom) if raises else contextlib.nullcontext():
        with full_f32():
            assert MATMUL.allow_tf32 is False
            if raises:
                raise Boom()
    assert MATMUL.allow_tf32 is True


@pytest.mark.parametrize("raises", [False, True])
def test_restores_tf32_set_by_the_per_backend_setting(flags, raises):
    MATMUL.fp32_precision = "tf32"
    with pytest.raises(Boom) if raises else contextlib.nullcontext():
        with full_f32():
            assert MATMUL.fp32_precision == "ieee"
            if raises:
                raise Boom()
    assert MATMUL.fp32_precision == "tf32"


def test_changes_nothing_when_tf32_is_off(flags):
    before = {name: obj.fp32_precision for name, obj in _new_api().items()}
    with full_f32():
        assert MATMUL.allow_tf32 is False
    assert {name: obj.fp32_precision for name, obj in _new_api().items()} == before
    assert torch.get_float32_matmul_precision() == "highest"
