"""Full-f32 matrix products, whatever TF32 setting the caller chose.

The JAX package pins `precision=HIGHEST` at its exact f32 products (the
rerank, the ground truth, the flat engine's refine). On the card a float32
`matmul`, `bmm` or `einsum` follows `torch.backends.cuda.matmul`, which a
caller may have switched to TF32 (`torch.set_float32_matmul_precision
("high")`); TF32 keeps about three decimal digits and would change ids.
`full_f32()` turns TF32 off for the block and restores the caller's setting
afterwards, also when the block raises.

PyTorch has two interfaces to the one setting: the older `allow_tf32` flag
(which `set_float32_matmul_precision` also sets) and, where the installed
torch has it, the per-backend `fp32_precision` string. Mixing them makes
torch refuse to read either, so the block uses the one the caller's state
can be read through, and changes nothing when TF32 is already off.

`matmul_f32` is the one place that decides how a product with f32 output
runs, also the JAX package's bf16 x bf16 products with
`preferred_element_type=float32`: a bf16 `matmul` on the card returns bf16
and would round every score.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Within the block, float32 matrix products on the card run in full
    f32; the caller's TF32 setting is restored on the way out."""
    matmul = torch.backends.cuda.matmul
    try:
        tf32 = matmul.allow_tf32
    except RuntimeError:   # set through the per-backend interface only
        tf32 = None
    if tf32 is None:
        saved = matmul.fp32_precision
        if saved == "ieee":
            yield
            return
        matmul.fp32_precision = "ieee"
        try:
            yield
        finally:
            matmul.fp32_precision = saved
    elif not tf32:
        yield
    else:
        matmul.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32 = True


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """f32 `torch.matmul(a, b)` with both operands first rounded to `dtype`
    (float32 or bfloat16), then multiplied widened to f32 in full f32. A
    product of two bf16 values is exact in f32, so a bf16 product differs
    from the reference's only in its summation order."""
    with full_f32():
        return torch.matmul(a.to(dtype).to(torch.float32), b.to(dtype).to(torch.float32))
