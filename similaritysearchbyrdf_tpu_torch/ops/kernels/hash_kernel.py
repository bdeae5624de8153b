"""K1, the fused angle hash: CUDA kernel wrapper and its plain PyTorch version.

Replaces `similaritysearchbyrdf_tpu/ops/pallas/hash_kernel.py` (`_hash_kernel`
behind `pallas_hash_dense`, `make_pallas_hash_fn` and `_call`). The kernel
(`csrc/hash_kernel.cu`) fuses projection, sign and the permuted MSB-first
bit-pack, and also emits the bit margins that margin probing needs
(`hash_dense_with_margins`), so one kernel serves fit and query. The dot
stays in full f32 FMA, summed in column order, so that no hash bit moves
with TF32 or tensor-core rounding. Its work is small (B x 100 x 320 FMAs at
the bench config) and its bytes smaller than its latency: the kernel stages
a tile of 64 rows and one table's projection in shared memory by
asynchronous copies, and each warp keeps 8 rows' dots in registers, so one
shared load of the projection feeds 8 independent FMA chains.

`hash_dense_kernel` launches the kernel for CUDA tensors and runs
`hash_dense_plain` for CPU tensors; a CUDA tensor never takes the plain
version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..bitops import HASH_DTYPE, pack_bits_msb_first
from . import build

LAUNCHES = 0   # kernel launches since the last reset (plain runs never count)


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
    err = build.library().rdf_hash_dense(
        x.data_ptr(), proj.data_ptr(), perm.data_ptr(), hashes.data_ptr(),
        margins.data_ptr() if emit_margins else None, b, d, t, c, p, build.stream(dev))
    build.check(err, "rdf_hash_dense")
    LAUNCHES += 1
    return hashes, margins
