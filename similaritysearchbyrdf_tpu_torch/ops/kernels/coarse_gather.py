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

K2's main-path shapes, 8-slot blocks of 32 int8 columns (block mode) or 64
(the sparse tier), take a kernel of their own, chosen by shape inside
`rdf_coarse_block_scores` (`block_kernel_form`): K2b's w64 design below,
with steps of 32 blocks and each warp-wide 16-byte load covering 512 bytes
(two blocks at cs 32, one at 64); every other shape keeps the generic
kernel.

K2b's main-path shapes, an int8 tier with 64-slot windows of 32 columns
(window mode) or 128 (the flat engine's exact2 re-score), take a kernel of
their own, chosen by shape inside `rdf_coarse_window_scores`
(`window_kernel_form` "w64"): a persistent grid in which each CTA takes
steps of 32 consecutive windows (every grid-th step, so the queries' live
windows, which come first among each query's, spread over all CTAs), the
small inputs of its next step loaded ahead (one coalesced load per lane) and
broadcast by shuffle; a warp issues every 16-byte load of a window's valid
slots before its first FMA, converts int8 to f32 exactly by byte permute and
one FADD (no `I2F`), and writes the window's scores as two coalesced
128-byte stores, a dead window's as 16-byte stores.

Wide int8 windows (at least `WINDOW_MAJOR_MIN_BYTES` = win * cs, cs a
multiple of 64: the sparse flat engine's cs 4096 re-score, IVF's default
256-slot windows at cs 128) take the window-major form ("window_major"),
for the many queries that ask for one window: three small passes group the
(query, window) pairs by the rows they read in a hash table in scratch that
this wrapper allocates (`window_scratch_bytes`), and one warp a 16-row
m-tile of a group's window scores up to 16 of its queries from one read,
on `mma.sync` in bf16 with f32 accumulators. Other shapes (bf16 tiers,
other widths and window sizes) keep the generic kernel.

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


# K2's specialised widths and K2b's window-major thresholds, as
# `rdf_coarse_block_form` and `rdf_coarse_window_form` (csrc/coarse_gather.cu)
# choose them: `WinMajor::kMinBytes`, `kChunk`, `kMaxWin`
BLOCK_B8_WIDTHS = (32, 64)
WINDOW_MAJOR_MIN_BYTES = 32768
WINDOW_MAJOR_CHUNK = 64
WINDOW_MAJOR_MAX_WIN = 32768


def block_kernel_form(cs: int, bs: int, b: int, mb: int, tier_bf16: bool = False) -> str:
    """Which kernel K2 takes for a shape on the card, as
    `rdf_coarse_block_form` chooses it: "b8", the block-mode main shapes'
    kernel (int8 tiers of 32 or 64 columns, 8-slot blocks), or "generic"."""
    b8 = (not tier_bf16 and cs in BLOCK_B8_WIDTHS and bs == 8
          and b * mb < (1 << 31) - 32)
    return "b8" if b8 else "generic"


def window_kernel_form(cs: int, win: int, b: int, mb: int, tier_bf16: bool = False) -> str:
    """Which kernel K2b takes for a shape on the card, as
    `rdf_coarse_window_form` chooses it: "w64" (int8, 64-slot windows of 32
    or 128 columns), "window_major" (int8 windows of at least
    `WINDOW_MAJOR_MIN_BYTES`, cs a multiple of 64, win of 16) or
    "generic"."""
    n = b * mb
    if tier_bf16:
        return "generic"
    if win == 64 and cs in (32, 128) and n < (1 << 31) - 64:
        return "w64"
    if (cs > 0 and cs % WINDOW_MAJOR_CHUNK == 0 and win % 16 == 0
            and win <= WINDOW_MAJOR_MAX_WIN and win * cs >= WINDOW_MAJOR_MIN_BYTES
            and n < (1 << 28)):
        return "window_major"
    return "generic"


def window_scratch_bytes(b: int, mb: int) -> int:
    """Device scratch the window-major form needs for B x MB pairs, as
    `rdf_coarse_window_scratch` counts it: a hash table of the next power of
    two of slots past 2n (at least 1024) at 16 bytes each, 32 bytes a pair,
    16 for two counters."""
    n = b * mb
    slots = max(1024, 1 << (2 * n - 1).bit_length())
    return 16 * slots + 32 * n + 16


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
    bf16 = tier.dtype == torch.bfloat16
    nbytes = (window_scratch_bytes(b, mb)
              if window_kernel_form(cs, win, b, mb, bf16) == "window_major" else 0)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=tier.device) if nbytes else None
    err = build.library().rdf_coarse_window_scores(
        tier.data_ptr(), q_low.data_ptr(), table.data_ptr(), blk_start.data_ptr(),
        start.data_ptr(), end.data_ptr(), live.data_ptr(), out.data_ptr(),
        l, caprows, cs, b, mb, win, int(bf16), scratch.data_ptr() if nbytes else None, nbytes,
        build.stream(tier.device),
    )
    build.check(err, "rdf_coarse_window_scores")
    WINDOW_LAUNCHES += 1
    return out
