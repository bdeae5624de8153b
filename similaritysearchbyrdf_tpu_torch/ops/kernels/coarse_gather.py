"""K2, the coarse gather-score kernel: CUDA wrapper and its plain PyTorch version.

Replaces `similaritysearchbyrdf_tpu/ops/pallas/coarse_gather.py`: by code,
`pallas_coarse_scores` (`_kernel`, blocks at arbitrary starts); by function
also `pallas_coarse_scores_aligned` (8-aligned windows are blocks whose
starts happen to be aligned). The kernel (`csrc/coarse_gather.cu`) scores
`bs` contiguous rows of the per-table int8 coarse tier against each query's
bf16 coarse vector with f32 accumulation. On the H100 it is bound by bytes
read (2 flops per tier byte); the design reads each 256-byte block with one
coalesced 8-byte load per lane and keeps the query in registers, so the
dependent table/start-then-rows loads of many warps overlap.

`coarse_block_scores_kernel` launches the kernel for CUDA tensors and runs
`coarse_block_scores_plain` for CPU tensors; a CUDA tensor never takes the
plain version.
"""

from __future__ import annotations

import torch

from . import build

LAUNCHES = 0   # kernel launches since the last reset (plain runs never count)
_CS_SUPPORTED = (8, 16, 32, 64, 128, 256)


def coarse_block_scores_plain(tier: torch.Tensor, q_low: torch.Tensor,
                              table: torch.Tensor, blk_start: torch.Tensor,
                              bs: int) -> torch.Tensor:
    """tier i8[L, caprows, cs], q_low bf16[B, cs], table and blk_start
    i32[B, MB] → f32[B, MB, bs] with out[b, m, j] = sum_c tier[t, s+j, c] *
    q_low[b, c], t = clip(table, 0, L-1), s = clip(blk_start, 0, caprows-bs)
    — the CLIP gather of `index/forest.py:1150-1182`."""
    l, caprows, _ = tier.shape
    t = table.to(torch.int64).clamp(0, l - 1)
    s = blk_start.to(torch.int64).clamp(0, caprows - bs)
    rows = tier[t[..., None], s[..., None] + torch.arange(bs, device=tier.device)]
    return torch.einsum("bmjc,bc->bmj", rows.to(torch.float32), q_low.to(torch.float32))


def coarse_block_scores_kernel(tier: torch.Tensor, q_low: torch.Tensor,
                               table: torch.Tensor, blk_start: torch.Tensor,
                               bs: int) -> torch.Tensor:
    """K2 on CUDA tensors, its plain version on CPU tensors. Same contract
    as `coarse_block_scores_plain`."""
    global LAUNCHES
    if tier.device.type == "cpu":
        return coarse_block_scores_plain(tier, q_low, table, blk_start, bs)
    if tier.device.type != "cuda":
        raise ValueError(f"coarse_block_scores_kernel: unsupported device {tier.device}")
    if (tier.dtype != torch.int8 or q_low.dtype != torch.bfloat16
            or table.dtype != torch.int32 or blk_start.dtype != torch.int32):
        raise TypeError("coarse_block_scores_kernel: needs tier i8, q_low bf16, "
                        "table and blk_start i32")
    l, caprows, cs = tier.shape
    b, mb = table.shape
    if (q_low.shape != (b, cs) or blk_start.shape != (b, mb) or cs not in _CS_SUPPORTED
            or not 0 < bs <= caprows):
        raise ValueError(f"coarse_block_scores_kernel: shapes tier {tuple(tier.shape)}, "
                         f"q_low {tuple(q_low.shape)}, table {tuple(table.shape)}, "
                         f"blk_start {tuple(blk_start.shape)}, bs {bs}")
    for name, a in (("tier", tier), ("q_low", q_low), ("table", table),
                    ("blk_start", blk_start)):
        if a.device != tier.device or not a.is_contiguous():
            raise ValueError(f"coarse_block_scores_kernel: {name} must be contiguous "
                             f"on {tier.device}")
    if tier.data_ptr() % 16 or q_low.data_ptr() % 16:
        raise ValueError("coarse_block_scores_kernel: tier and q_low must be 16-byte aligned")
    out = torch.empty((b, mb, bs), dtype=torch.float32, device=tier.device)
    if out.numel() == 0:
        return out
    err = build.library().rdf_coarse_block_scores(
        tier.data_ptr(), q_low.data_ptr(), table.data_ptr(), blk_start.data_ptr(),
        out.data_ptr(), l, caprows, cs, b, mb, bs,
        torch.cuda.current_stream(tier.device).cuda_stream,
    )
    build.check(err, "rdf_coarse_block_scores")
    LAUNCHES += 1
    return out
