"""K2 and K2b, the coarse gather-score kernels: CUDA wrappers and their plain
PyTorch versions.

Replace `similaritysearchbyrdf_tpu/ops/pallas/coarse_gather.py`:
K2 `pallas_coarse_scores` (`_kernel`, blocks at arbitrary starts, block
mode) and K2b `pallas_coarse_scores_aligned` (`_kernel_aligned*`, aligned
windows, window mode). Both kernels (`csrc/coarse_gather.cu`) score
contiguous rows of the per-table int8 or bf16 coarse tier against each
query's bf16 coarse vector with f32 accumulation. On the H100 they are bound by bytes
read (2 flops per tier byte). The generic design reads each row chunk with
one coalesced 8-byte load per lane and keeps the query in registers, so the
dependent table/start-then-rows loads of many warps overlap. K2b also takes
the window mode's validity: a dead window loads nothing, and a slot outside
its range's [start, end) scores -inf, so the caller needs no masking pass.
K2b also takes a bf16 tier: the flat engine's bf16 sketch, re-scored as a
one-table tier (`ops/flat.py`), and a forest's bf16 coarse tier in window
mode; K2 takes a forest's bf16 coarse tier in block mode, on its generic
kernel (a chunk of 8 columns is one 16-byte load per lane).

K2's main-path shape, 8-slot blocks of 32 int8 columns (block mode), takes a
kernel of its own, chosen by shape inside `rdf_coarse_block_scores`
(`block_kernel_form`): K2b's design below, with steps of 32 blocks, 16
consecutive blocks to a warp and each 16-byte load covering two blocks;
every other shape keeps the generic kernel.

K2b's main-path shapes, an int8 tier with 64-slot windows of 32 columns
(window mode) or 128 (the flat engine's exact2 re-score), take a kernel of
their own, chosen by shape inside `rdf_coarse_window_scores`: a persistent
grid in which each CTA takes steps of 32 consecutive windows (every
grid-th step, so the queries' live windows, which come first among each
query's, spread over all CTAs), the small inputs of its next step loaded
ahead (one coalesced load per lane) and broadcast by shuffle; a warp issues
every 16-byte load of a window's valid slots before its first FMA, converts
int8 to f32 exactly by byte permute and one FADD (no `I2F`), and writes the
window's scores as two coalesced 128-byte stores, a dead window's as
16-byte stores. Other shapes (bf16 tiers, other widths and window sizes)
keep the generic kernel.

`coarse_block_scores_kernel` and `coarse_window_scores_kernel` launch their
kernels for CUDA tensors and run the plain versions for CPU tensors; a CUDA
tensor never takes a plain version.
"""

from __future__ import annotations

import torch

from . import build

LAUNCHES = 0          # K2 launches since the last reset (plain runs never count)
WINDOW_LAUNCHES = 0   # K2b launches since the last reset
_PLAIN_CHUNK = 1 << 28   # gathered tier elements the plain version makes at once


def _cs_ok(cs: int) -> bool:
    """The kernels take a tier row of any width that is a multiple of 8."""
    return cs > 0 and cs % 8 == 0


def block_kernel_form(cs: int, bs: int, b: int, mb: int, tier_bf16: bool = False) -> str:
    """Which kernel K2 takes for a shape on the card, as
    `rdf_coarse_block_scores` chooses it (`rdf_coarse_block_form`): "b8",
    the block-mode main shape's kernel (int8 tiers only), or "generic"."""
    form = build.library().rdf_coarse_block_form(cs, bs, b, mb, int(tier_bf16))
    return "b8" if form else "generic"


def coarse_block_scores_plain(tier: torch.Tensor, q_low: torch.Tensor,
                              table: torch.Tensor, blk_start: torch.Tensor,
                              bs: int) -> torch.Tensor:
    """tier i8 (or bf16) [L, caprows, cs], q_low bf16[B, cs], table and blk_start
    i32[B, MB] → f32[B, MB, bs] with out[b, m, j] = sum_c tier[t, s+j, c] *
    q_low[b, c], t = clip(table, 0, L-1), s = clip(blk_start, 0, caprows-bs)
    — the CLIP gather of `index/forest.py:1150-1182`. The rows are gathered
    for `_PLAIN_CHUNK // (MB·bs·cs)` queries at a time, so a wide tier (the
    4096-column sketch) makes no [B, MB, bs, cs] f32 slab."""
    l, caprows, cs = tier.shape
    b, mb = table.shape
    t = table.to(torch.int64).clamp(0, l - 1)
    s = blk_start.to(torch.int64).clamp(0, caprows - bs)[..., None] + torch.arange(
        bs, device=tier.device)
    qf = q_low.to(torch.float32)
    step = max(1, _PLAIN_CHUNK // max(1, mb * bs * cs))
    out = torch.empty((b, mb, bs), dtype=torch.float32, device=tier.device)
    for b0 in range(0, b, step):
        rows = tier[t[b0:b0 + step, :, None], s[b0:b0 + step]]
        out[b0:b0 + step] = torch.einsum("bmjc,bc->bmj", rows.to(torch.float32),
                                         qf[b0:b0 + step])
    return out


def coarse_block_scores_kernel(tier: torch.Tensor, q_low: torch.Tensor,
                               table: torch.Tensor, blk_start: torch.Tensor,
                               bs: int) -> torch.Tensor:
    """K2 on CUDA tensors, its plain version on CPU tensors. Same contract
    as `coarse_block_scores_plain`."""
    global LAUNCHES
    if not tier.is_cuda:
        if tier.device.type == "cpu":
            return coarse_block_scores_plain(tier, q_low, table, blk_start, bs)
        raise ValueError(f"coarse_block_scores_kernel: unsupported device {tier.device}")
    if (tier.dtype not in (torch.int8, torch.bfloat16) or q_low.dtype != torch.bfloat16
            or table.dtype != torch.int32 or blk_start.dtype != torch.int32):
        raise TypeError("coarse_block_scores_kernel: needs tier i8 or bf16, q_low bf16, "
                        "table and blk_start i32")
    l, caprows, cs = tier.shape
    b, mb = table.shape
    if (q_low.shape != (b, cs) or blk_start.shape != (b, mb) or not _cs_ok(cs)
            or not 0 < bs <= caprows):
        raise ValueError(f"coarse_block_scores_kernel: shapes tier {tuple(tier.shape)}, "
                         f"q_low {tuple(q_low.shape)}, table {tuple(table.shape)}, "
                         f"blk_start {tuple(blk_start.shape)}, bs {bs}; cs a multiple of 8")
    dev = tier.device
    build.check_operands("coarse_block_scores_kernel", dev, ("tier", "q_low"),
                         tier=tier, q_low=q_low, table=table, blk_start=blk_start)
    out = torch.empty((b, mb, bs), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    err = build.library().rdf_coarse_block_scores(
        tier.data_ptr(), q_low.data_ptr(), table.data_ptr(), blk_start.data_ptr(),
        out.data_ptr(), l, caprows, cs, b, mb, bs, int(tier.dtype == torch.bfloat16),
        build.stream(dev))
    build.check(err, "rdf_coarse_block_scores")
    LAUNCHES += 1
    return out


def coarse_window_scores_plain(tier: torch.Tensor, q_low: torch.Tensor,
                               table: torch.Tensor, blk_start: torch.Tensor,
                               start: torch.Tensor, end: torch.Tensor,
                               live: torch.Tensor, win: int) -> torch.Tensor:
    """tier i8 (or bf16) [L, caprows, cs], q_low bf16[B, cs], table,
    blk_start, start and end i32[B, MB], live bool[B, MB] → f32[B, MB, win]:
    the K2 score of row
    clip(blk_start, 0, caprows-win) + j where live and start <= blk_start + j
    < end, else -inf (the masks of `index/forest.py:1183-1189`)."""
    scores = coarse_block_scores_plain(tier, q_low, table, blk_start, win)
    pos = blk_start.to(torch.int64)[..., None] + torch.arange(win, device=tier.device)
    valid = live.to(torch.bool)[..., None] & (pos >= start[..., None]) & (pos < end[..., None])
    return torch.where(valid, scores, float("-inf"))


def coarse_window_scores_kernel(tier: torch.Tensor, q_low: torch.Tensor,
                                table: torch.Tensor, blk_start: torch.Tensor,
                                start: torch.Tensor, end: torch.Tensor,
                                live: torch.Tensor, win: int) -> torch.Tensor:
    """K2b on CUDA tensors, its plain version on CPU tensors. Same contract
    as `coarse_window_scores_plain`; `live` is bool or uint8."""
    global WINDOW_LAUNCHES
    if tier.device.type == "cpu":
        return coarse_window_scores_plain(tier, q_low, table, blk_start, start, end, live, win)
    if tier.device.type != "cuda":
        raise ValueError(f"coarse_window_scores_kernel: unsupported device {tier.device}")
    if (tier.dtype not in (torch.int8, torch.bfloat16) or q_low.dtype != torch.bfloat16
            or any(a.dtype != torch.int32 for a in (table, blk_start, start, end))
            or live.dtype not in (torch.bool, torch.uint8)):
        raise TypeError("coarse_window_scores_kernel: needs tier i8 or bf16, q_low bf16, "
                        "table, blk_start, start and end i32, live bool or u8")
    l, caprows, cs = tier.shape
    b, mb = table.shape
    if (q_low.shape != (b, cs) or not _cs_ok(cs) or not 0 < win <= caprows
            or win % 8 or any(a.shape != (b, mb) for a in (blk_start, start, end, live))):
        raise ValueError(f"coarse_window_scores_kernel: shapes tier {tuple(tier.shape)}, "
                         f"q_low {tuple(q_low.shape)}, table {tuple(table.shape)}, "
                         f"win {win} (a multiple of 8); cs a multiple of 8")
    build.check_operands("coarse_window_scores_kernel", tier.device, ("tier", "q_low"),
                         tier=tier, q_low=q_low, table=table, blk_start=blk_start,
                         start=start, end=end, live=live)
    out = torch.empty((b, mb, win), dtype=torch.float32, device=tier.device)
    if out.numel() == 0:
        return out
    err = build.library().rdf_coarse_window_scores(
        tier.data_ptr(), q_low.data_ptr(), table.data_ptr(), blk_start.data_ptr(),
        start.data_ptr(), end.data_ptr(), live.data_ptr(), out.data_ptr(),
        l, caprows, cs, b, mb, win, int(tier.dtype == torch.bfloat16),
        build.stream(tier.device),
    )
    build.check(err, "rdf_coarse_window_scores")
    WINDOW_LAUNCHES += 1
    return out
