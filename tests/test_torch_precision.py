"""`ops/precision.full_f32`: TF32 off inside the block, the caller's setting
back afterwards, also when the block raises; `matmul_f32`: products with
f32 output of operands rounded to f32 or bf16.

The flags are process-wide; the fixture puts every one back as it found it.
On the CPU only the flags can be checked; the card test
`tests/test_torch_cuda.py::test_exact_tiers_ignore_global_tf32` checks the
ids.
"""

import contextlib

import pytest
import torch

import numpy as np

from similaritysearchbyrdf_tpu_torch.ops.precision import full_f32, matmul_f32

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes", [((5, 40), (40, 7)), ((3, 6, 40), (3, 40, 1)),
                                    ((3, 4, 2, 40), (3, 1, 40, 1))])
def test_matmul_f32_rounds_operands_and_keeps_f32_output(dtype, shapes):
    """The result is f32 and within the f32 summation bound of the float64
    product of the operands rounded to `dtype` (every product of two bf16
    values is exact in f32): |err| <= D * 2^-24 * sum|a*b|."""
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.normal(size=shapes[0]).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=shapes[1]).astype(np.float32))
    got = matmul_f32(a, b, dtype)
    assert got.dtype == torch.float32
    ar, br = a.to(dtype).double(), b.to(dtype).double()
    want = torch.matmul(ar, br)
    lim = a.shape[-1] * 2.0 ** -24 * torch.matmul(ar.abs(), br.abs())
    assert bool(((got.double() - want).abs() <= lim).all())
    if dtype == torch.bfloat16:
        # rounding the operands is the point: bf16 inputs give the same result
        assert torch.equal(got, matmul_f32(a.to(dtype), b.to(dtype), dtype))
