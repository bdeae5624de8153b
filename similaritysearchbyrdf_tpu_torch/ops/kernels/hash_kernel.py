"""K1, the fused angle hash: CUDA kernel wrapper and its plain PyTorch version.

Replaces `similaritysearchbyrdf_tpu/ops/pallas/hash_kernel.py` (`_hash_kernel`
behind `pallas_hash_dense`, `make_pallas_hash_fn` and `_call`). The kernel
(`csrc/hash_kernel.cu`) fuses projection, sign and the permuted MSB-first
bit-pack, and also emits the bit margins that margin probing needs
(`hash_dense_with_margins`), so one kernel serves fit and query. The dot
stays in full f32 FMA, summed in column order, so that no hash bit moves
with TF32 or tensor-core rounding. Two forms, chosen by D (`kernel_form`):
at the dense paths' D 96-100 the work is small (B x 100 x 320 FMAs at the
bench config) and its bytes smaller than its latency, and the narrow form
stages a tile of 64 rows and one table's projection in shared memory by
asynchronous copies, each warp keeping 8 rows' dots in registers, so one
shared load of the projection feeds 8 independent FMA chains. From
`WIDE_MIN_D` on (the sparse path's densified rows, D 4096) operations bound
it, and the wide form runs a register-tiled f32 GEMM over 320 rows x 2
tables a CTA, split over D when the rows do not fill the card (partial
dots in scratch this wrapper allocates, added in ascending split order by
a second kernel that packs the hashes).

`hash_dense_kernel` launches the kernel for CUDA tensors and runs
`hash_dense_plain` for CPU tensors; a CUDA tensor never takes the plain
version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..bitops import HASH_DTYPE, pack_bits_msb_first
from . import build

LAUNCHES = 0   # kernel launches since the last reset (plain runs never count; the wide
               # form's GEMM and its epilogue kernel count as one launch)
WIDE_MIN_D = 384   # the narrowest D the wide form takes (`kWideMinD` in the source)
_SPLITS: dict = {}   # (device, B, D, T) -> the wide form's splits of D


def kernel_form(d: int) -> str:
    """Which form of the kernel a call takes, as `rdf_hash_dense` chooses
    by shape: the narrow form below `WIDE_MIN_D`, the wide form from it."""
    return "wide" if d >= WIDE_MIN_D else "narrow"


def hash_dense_plain(x: torch.Tensor, proj: torch.Tensor, perm: torch.Tensor,
                     emit_margins: bool = False
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x f32[B, D], proj f32[T, C, D], perm i32[T, P, C] → (hashes
    int64[B, T*P] holding unsigned 32-bit values, margins f32[B, T*P, 32]
    or None). Table order is P*t + p (`AngleHashFamily.scala:144`)."""
    b = x.shape[0]
    t, c, _ = proj.shape
    dots = torch.einsum("bd,tcd->btc", x, proj)                  # [B, T, C]
    idx = perm.to(torch.int64)[None].expand(b, -1, -1, -1)       # [B, T, P, C]
    permuted = torch.gather((dots > 0)[:, :, None, :].expand(-1, -1, idx.shape[2], -1),
                            3, idx)
    hashes = pack_bits_msb_first(permuted).reshape(b, -1)
    if not emit_margins:
        return hashes, None
    absdots = torch.gather(dots.abs()[:, :, None, :].expand(-1, -1, idx.shape[2], -1),
                           3, idx)                               # [B, T, P, C]
    # chain position j packs at bit 31-j: ascending bit index holds 32-c
    # structural +inf bits, then the reversed |dots|
    margins = torch.cat(
        [torch.full(absdots.shape[:-1] + (32 - c,), float("inf"),
                    dtype=torch.float32, device=x.device),
         torch.flip(absdots, dims=(-1,))], dim=-1)
    return hashes, margins.reshape(b, -1, 32)


def hash_dense_kernel(x: torch.Tensor, proj: torch.Tensor, perm: torch.Tensor,
                      emit_margins: bool = False
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1 on CUDA tensors, its plain version on CPU tensors. Same contract
    as `hash_dense_plain`."""
    global LAUNCHES
    if not x.is_cuda:
        if x.device.type == "cpu":
            return hash_dense_plain(x, proj, perm, emit_margins)
        raise ValueError(f"hash_dense_kernel: unsupported device {x.device}")
    if x.dtype != torch.float32 or proj.dtype != torch.float32 or perm.dtype != torch.int32:
        raise TypeError("hash_dense_kernel: needs x, proj f32 and perm i32")
    if x.dim() != 2 or proj.dim() != 3 or perm.dim() != 3:
        raise ValueError("hash_dense_kernel: needs x [B, D], proj [T, C, D], perm [T, P, C]")
    b, d = x.shape
    t, c, d2 = proj.shape
    p = perm.shape[1]
    if d2 != d or perm.shape[0] != t or perm.shape[2] != c or not 0 < c <= 32:
        raise ValueError(f"hash_dense_kernel: shapes x {tuple(x.shape)}, proj "
                         f"{tuple(proj.shape)}, perm {tuple(perm.shape)}")
    # shared memory: perm [P][32] beside the staged tiles (at most 48 KB, any D)
    if p * 32 * 4 > (227 - 48) * 1024:
        raise ValueError(f"hash_dense_kernel: P={p} exceeds shared memory")
    dev = x.device
    build.check_operands("hash_dense_kernel", dev, x=x, proj=proj, perm=perm)
    hashes = torch.empty((b, t * p), dtype=HASH_DTYPE, device=dev)
    margins = (torch.empty((b, t * p, 32), dtype=torch.float32, device=dev)
               if emit_margins else None)
    if b == 0:
        return hashes, margins
    lib = build.library()
    key = (dev.index, b, d, t)
    splits = _SPLITS.get(key)
    if splits is None:
        splits = lib.rdf_hash_dense_splits(b, d, t)
        if splits < 0:
            raise RuntimeError("hash_dense_kernel: the wide form found no CUDA device")
        _SPLITS[key] = splits
    # the wide form's partial dots, [splits, B, T*32] (the narrow form needs none)
    scratch = (torch.empty((splits, b, t * 32), dtype=torch.float32, device=dev)
               if splits else None)
    err = lib.rdf_hash_dense(
        x.data_ptr(), proj.data_ptr(), perm.data_ptr(), hashes.data_ptr(),
        margins.data_ptr() if emit_margins else None,
        scratch.data_ptr() if splits else None, b, d, t, c, p, build.stream(dev))
    build.check(err, "rdf_hash_dense")
    LAUNCHES += 1
    return hashes, margins
