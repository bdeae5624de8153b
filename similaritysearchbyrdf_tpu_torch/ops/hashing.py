"""Batched LSH compound hashing of dense vectors.

Counterpart of `similaritysearchbyrdf_tpu/ops/hashing.py`. The angle family
goes through K1 (`ops/kernels/hash_kernel.py`): the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor — for fit and query alike, and
whatever `use_pallas_hash` says (in the JAX package that flag picks between
two bit-identical routes). The p-stable family, which no TPU kernel served,
stays plain PyTorch. Sparse hashing is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.families import HashModel
from ..models.transforms import apply_type_of_index
from .bitops import java_bytes_hash_of_ints
from .kernels.hash_kernel import hash_dense_kernel
from .precision import full_f32


def _hash_pstable(model: HashModel, x: torch.Tensor) -> torch.Tensor:
    """H(v) = ((a.v + b) / w).toInt per function, truncated toward zero like
    scala's Double.toInt, then byte-packed and Arrays.hashCode'd per chain
    (`PStableHashFamily.scala:122-177`). → int64[B, T*P]."""
    with full_f32():
        dots = torch.einsum("bd,tcd->btc", x, model.proj)
    vals = ((dots + model.b[None]) / float(model.w)).to(torch.int32)
    idx = model.perm.to(torch.int64)[None].expand(x.shape[0], -1, -1, -1)
    permuted = torch.gather(vals[:, :, None, :].expand(-1, -1, idx.shape[2], -1), 3, idx)
    return java_bytes_hash_of_ints(permuted).reshape(x.shape[0], -1)


def hash_dense(model: HashModel, x: torch.Tensor) -> torch.Tensor:
    """Hash a dense batch f32[B, D] into int64[B, L] table indexes (unsigned
    32-bit values), typeOfIndex transform included (`LSH.calculateIndex`,
    `LSH.scala:135-166`)."""
    x = x.to(torch.float32).contiguous()
    if model.family == "angle":
        h, _ = hash_dense_kernel(x, model.proj, model.perm)
    elif model.family == "pStable":
        h = _hash_pstable(model, x)
    else:
        raise ValueError(f"unknown family {model.family!r}")
    return apply_type_of_index(h, model.type_of_index, model.sampling_perm)


def hash_dense_with_margins(model: HashModel, x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`hash_dense` plus per-packed-bit flip margins f32[B, L, 32]: margin
    of bit i = |<x, proj of the function packed at bit i>|, +inf for the
    structural bits of chains shorter than 32. Angle family with
    typeOfIndex=original only."""
    if model.family != "angle" or model.type_of_index != "original":
        raise ValueError("bit margins require the angle family with typeOfIndex=original")
    h, margins = hash_dense_kernel(x.to(torch.float32).contiguous(), model.proj,
                                   model.perm, emit_margins=True)
    return h, margins
