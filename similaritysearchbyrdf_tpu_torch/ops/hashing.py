"""Batched LSH compound hashing of dense vectors.

Counterpart of `similaritysearchbyrdf_tpu/ops/hashing.py`. The angle family
goes through K1 (`ops/kernels/hash_kernel.py`): the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor — for fit and query alike, and
whatever `use_pallas_hash` says (in the JAX package that flag picks between
two bit-identical routes). The p-stable family, which no TPU kernel served,
stays plain PyTorch.

A padded-COO sparse batch (`vectors.SparseBatch` rows, padding index 0
with value 0.0) hashes either densified (`hash_sparse_densify`: scattered
to f32[B, D], then `hash_dense`, so K1 on the card) or by gathering the
projection columns of its non-zeros (`hash_sparse`, plain PyTorch, for
widths where the dense batch would be too large; no TPU kernel served it).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.families import HashModel
from ..models.transforms import apply_type_of_index
from .bitops import java_bytes_hash_of_ints, pack_bits_msb_first
from .kernels.hash_kernel import hash_dense_kernel
from .precision import full_f32


def _pack_chains(model: HashModel, dots: torch.Tensor) -> torch.Tensor:
    """Per-function values f32[B, T, C] → packed per-(table, permutation)
    hashes int64[B, T*P], table order P*t + p (`AngleHashFamily.scala:144`).
    angle: the permuted signs packed MSB-first (`AngleHashFamily.scala:
    184-219`); pStable: H(v) = ((a.v + b) / w).toInt per function, truncated
    toward zero like scala's Double.toInt, then byte-packed and
    Arrays.hashCode'd per chain (`PStableHashFamily.scala:122-177`)."""
    b = dots.shape[0]
    if model.family == "angle":
        vals = dots > 0
    elif model.family == "pStable":
        vals = ((dots + model.b[None]) / float(model.w)).to(torch.int32)
    else:
        raise ValueError(f"unknown family {model.family!r}")
    idx = model.perm.to(torch.int64)[None].expand(b, -1, -1, -1)          # [B, T, P, C]
    permuted = torch.gather(vals[:, :, None, :].expand(-1, -1, idx.shape[2], -1), 3, idx)
    if model.family == "angle":
        return pack_bits_msb_first(permuted).reshape(b, -1)
    return java_bytes_hash_of_ints(permuted).reshape(b, -1)


def _hash_pstable(model: HashModel, x: torch.Tensor) -> torch.Tensor:
    """The p-stable family's hashes of a dense batch → int64[B, T*P]."""
    with full_f32():
        dots = torch.einsum("bd,tcd->btc", x, model.proj)
    return _pack_chains(model, dots)


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


def densify(indices: torch.Tensor, values: torch.Tensor, d: int) -> torch.Tensor:
    """A padded-COO batch i32[B, NNZ] / f32[B, NNZ] scattered into f32[B, d]
    by accumulation: padding adds 0.0 at column 0, exact in any order."""
    b = indices.shape[0]
    dense = torch.zeros((b, d), dtype=torch.float32, device=values.device)
    rows = torch.arange(b, device=values.device)[:, None].expand_as(indices)
    dense.index_put_((rows, indices.to(torch.int64)), values.to(torch.float32),
                     accumulate=True)
    return dense


def hash_sparse(model: HashModel, indices: torch.Tensor, values: torch.Tensor
                ) -> torch.Tensor:
    """Hash a padded-COO batch into int64[B, L] table indexes by gathering
    the projection columns of its non-zeros and summing them weighted by
    the values in full f32 (the reference's BitSet-intersect sparse dot,
    `SimilarityCalculator.scala:9-27`); typeOfIndex transform included."""
    t, c, d = model.proj.shape
    proj_cols = model.proj.reshape(t * c, d).T                       # [D, T*C]
    gathered = proj_cols[indices.to(torch.int64)]                    # [B, NNZ, T*C]
    with full_f32():
        dots = torch.einsum("bn,bnk->bk", values.to(torch.float32), gathered)
    h = _pack_chains(model, dots.reshape(values.shape[0], t, c))
    return apply_type_of_index(h, model.type_of_index, model.sampling_perm)


def hash_sparse_densify(model: HashModel, indices: torch.Tensor, values: torch.Tensor
                        ) -> torch.Tensor:
    """Hash a padded-COO batch by densifying it to f32[B, D] and hashing
    that (`hash_dense`: K1 on the card for the angle family)."""
    return hash_dense(model, densify(indices, values, model.proj.shape[2]))
