"""K4, the flat group-max kernel: CUDA wrapper and its plain PyTorch version.

Replaces `similaritysearchbyrdf_tpu/ops/pallas/flat_groupmax.py`, all three
entries: `pallas_flat_groupmax` and `pallas_flat_groupmax_qmajor`
(`_gmax_kernel`) and `pallas_flat_groupmax_qlane` (`_gmax_qlane_kernel`,
with its fused supergroup tier `emit_sg`). For a sketch [Npad, D] and queries
[B, D], both int8 or both bf16, it returns the query-major maxima of every
`group` consecutive rows' scores, [B, Npad/group], without writing the
[B, Npad] scores: f32, or with `pack_arg` (int8 only) the int32 key
`(score << log2 group) | member` of each group's best row. On the H100 it is
bound by operations (int8 tensor-core products, `csrc/flat_groupmax.cu`):
int8 up to D 192 runs a TMA-fed, warp-specialised wgmma kernel with the
query chunk resident, wider int8 a K-looped wgmma GEMM of 128-query x
256-row tiles with the same epilogue, bf16 the mma.sync form
(`kernel_form`). int8 dots are exact, so kernel and plain version agree bit
for bit; bf16 dots accumulate in f32 and agree within the f32 summation
bound.

`flat_groupmax_kernel` launches the kernel for CUDA tensors and runs
`flat_groupmax_plain` for CPU tensors; a CUDA tensor never takes the plain
version.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from . import build

LAUNCHES = 0     # kernel launches since the last reset (plain runs never count)
MAX_GROUP = 512  # the kernel's CTA holds at most 512 rows, so a group at most that
WGMMA_MAX_D = 192   # int8 widths the wgmma form takes (`kWgMaxD` in the source)
_PLAIN_CHUNK = 1 << 26   # score elements the plain version makes at once
GroupMax = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _check_args(sketch: torch.Tensor, q: torch.Tensor, group: int, pack_arg: bool,
                emit_sg: int) -> None:
    if sketch.dtype not in (torch.int8, torch.bfloat16) or q.dtype != sketch.dtype:
        raise TypeError("flat_groupmax: needs sketch and q both int8 or both bf16")
    if sketch.dim() != 2 or q.dim() != 2 or q.shape[1] != sketch.shape[1]:
        raise ValueError(f"flat_groupmax: shapes sketch {tuple(sketch.shape)}, q {tuple(q.shape)}")
    npad, d = sketch.shape
    if group < 1 or group & (group - 1) or npad % group:
        raise ValueError(f"flat_groupmax: group {group} must be a power of two dividing {npad}")
    if pack_arg:
        if sketch.dtype != torch.int8:
            raise TypeError("flat_groupmax: pack_arg needs the int8 sketch (exact int32 scores)")
        # `score << log2 group | member` must fit int32: |score| <= d*127^2
        if d * 127 * 127 * group >= 2**31:
            raise ValueError(f"flat_groupmax: pack_arg overflows int32 at D {d}, group {group}")
    if emit_sg:
        if not pack_arg:
            raise ValueError("flat_groupmax: emit_sg needs pack_arg")
        if emit_sg & (emit_sg - 1) or (npad // group) % emit_sg:
            raise ValueError(f"flat_groupmax: emit_sg {emit_sg} must be a power of two "
                             f"dividing {npad // group} groups")


def kernel_form(dtype: torch.dtype, d: int) -> str:
    """Which form of the kernel a call takes, as `rdf_flat_groupmax`
    chooses by shape: for int8 the wgmma form up to `WGMMA_MAX_D` and the
    K-looped wgmma form past it; for bf16 the mma.sync form (which stages
    D in slices where whole rows do not fit: past D 192)."""
    if dtype != torch.int8:
        return "mma.sync"
    return "wgmma" if d <= WGMMA_MAX_D else "wgmma_kloop"


def flat_groupmax_plain(sketch: torch.Tensor, q: torch.Tensor, group: int = 64,
                        pack_arg: bool = False, emit_sg: int = 0) -> GroupMax:
    """sketch and q int8 (or bf16) [Npad, D] and [B, D] → [B, Npad/group]:
    f32 group maxima of q·sketchᵀ, or with `pack_arg` the int32 key
    `(score << log2 group) | (row % group)` of each group's best row (ties
    to the highest member); with `emit_sg`, also the unmasked maxima of
    every `emit_sg` adjacent groups' keys, [B, Npad/group/emit_sg]. int8
    scores are exact: an f32 matmul of f32 copies while every partial sum is
    an integer below 2^24 (D < 1024), else of f64 copies, then rounded once
    to f32 as the kernel rounds its int32 sums; bf16 scores are an f32
    matmul. The sketch is scored `_PLAIN_CHUNK // B` rows at a time, so no
    [B, Npad] slab is made. The XLA reference is
    `similaritysearchbyrdf_tpu/ops/flat.py:597-602,788-792`."""
    _check_args(sketch, q, group, pack_arg, emit_sg)
    npad, d = sketch.shape
    b = q.shape[0]
    dev = sketch.device
    ng = npad // group
    out = torch.empty((b, ng), dtype=torch.int32 if pack_arg else torch.float32, device=dev)
    wide = sketch.dtype == torch.int8 and d * 128 * 128 >= 2**24
    exact = torch.float64 if wide else torch.float32
    qf = q.to(exact)
    rows = max(group, _PLAIN_CHUNK // max(b, 1) // group * group)
    member = torch.arange(rows, device=dev, dtype=torch.int32) % group
    for r0 in range(0, npad, rows):
        blk = sketch[r0:r0 + rows]
        scores = qf @ blk.to(exact).T                              # [B, rows]
        if pack_arg:
            # |score| * group < 2^31 (_check_args): the product cannot wrap
            scores = scores.to(torch.int32) * group | member[:blk.shape[0]]
        out[:, r0 // group:(r0 + blk.shape[0]) // group] = (
            scores.view(b, -1, group).amax(dim=2))
    if not emit_sg:
        return out
    return out, out.view(b, ng // emit_sg, emit_sg).amax(dim=2)


def flat_groupmax_kernel(sketch: torch.Tensor, q: torch.Tensor, group: int = 64,
                         pack_arg: bool = False, emit_sg: int = 0) -> GroupMax:
    """K4 on CUDA tensors, its plain version on CPU tensors. Same contract
    as `flat_groupmax_plain`; on the card D must be a multiple of 32 (any
    width) and group at most `MAX_GROUP`."""
    global LAUNCHES
    if sketch.device.type == "cpu":
        return flat_groupmax_plain(sketch, q, group, pack_arg, emit_sg)
    if sketch.device.type != "cuda":
        raise ValueError(f"flat_groupmax_kernel: unsupported device {sketch.device}")
    _check_args(sketch, q, group, pack_arg, emit_sg)
    npad, d = sketch.shape
    b = q.shape[0]
    if d % 32 or not 8 <= group <= MAX_GROUP:
        raise ValueError(f"flat_groupmax_kernel: D {d} must be a multiple of 32 and group "
                         f"{group} in [8, {MAX_GROUP}]")
    build.check_operands("flat_groupmax_kernel", sketch.device, ("sketch", "q"),
                         sketch=sketch, q=q)
    ng = npad // group
    out = torch.empty((b, ng), dtype=torch.int32 if pack_arg else torch.float32,
                      device=sketch.device)
    sgout = (torch.full((b, ng // emit_sg), -2**31, dtype=torch.int32, device=sketch.device)
             if emit_sg else None)
    if out.numel() == 0:
        return (out, sgout) if emit_sg else out
    err = build.library().rdf_flat_groupmax(
        sketch.data_ptr(), q.data_ptr(), out.data_ptr(),
        sgout.data_ptr() if emit_sg else None, npad, b, d,
        int(sketch.dtype == torch.bfloat16), group, int(pack_arg), emit_sg,
        build.stream(sketch.device),
    )
    build.check(err, "rdf_flat_groupmax")
    LAUNCHES += 1
    return (out, sgout) if emit_sg else out
