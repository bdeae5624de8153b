"""Numerics shared by the plain references.

Every product runs in full f32 (TF32 off). A reference states the
precision of each operand as the configuration does: `f32` for the exact
parts, `bf16` for operands the configuration rounds to bfloat16, `int8`
for its quantized tiers. `Precision(control=True)` is the control: the
same reference one step of precision lower at every such operand, f32 to
TF32 (10 mantissa bits, operands rounded, products summed in f32), bf16 to
fp8 (e4m3), int8 to int4 (levels -7..7).
"""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero on the magnitude)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    def __init__(self, control: bool = False):
        self.control = control
        self.int_levels = 7 if control else 127
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def f32(self, x: torch.Tensor) -> torch.Tensor:
        """An operand the configuration keeps in f32."""
        return tf32_round(x) if self.control else x.to(torch.float32)

    def bf16(self, x: torch.Tensor) -> torch.Tensor:
        """An operand the configuration rounds to bf16, as f32 values."""
        low = torch.float8_e4m3fn if self.control else torch.bfloat16
        return x.to(low).to(torch.float32)

    def quantize(self, x: torch.Tensor, scale) -> torch.Tensor:
        """An int8 tier (int4 in the control): round half to even of x times
        `scale`, clipped to the levels; `scale` is given for 127 levels."""
        if self.control:
            scale = scale * (7.0 / 127.0)
        return torch.clamp(torch.round(x * scale), -self.int_levels,
                           self.int_levels).to(torch.int8)


def top_sorted(scores: torch.Tensor, m: int):
    """(top-m scores descending, their indices), ties in index order."""
    s, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :m], idx[:, :m]


def window_scores(tier: torch.Tensor, q: torch.Tensor, table: torch.Tensor,
                  blk_start: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                  live: torch.Tensor, win: int, chunk_elems: int = 1 << 28) -> torch.Tensor:
    """Scores f32[B, MB, win] of aligned windows: slot j of window (b, m)
    is row clip(blk_start, 0, caprows - win) + j of table clip(table, 0,
    L - 1) of `tier` [L, caprows, cs], dotted with q f32[B, cs]; -inf
    unless live and start <= blk_start + j < end."""
    l, caprows, cs = tier.shape
    b, mb = table.shape
    j = torch.arange(win, device=tier.device)
    t = table.to(torch.int64).clamp(0, l - 1)
    rows = blk_start.to(torch.int64).clamp(0, caprows - win)[..., None] + j
    out = torch.empty((b, mb, win), dtype=torch.float32, device=tier.device)
    step = max(1, chunk_elems // max(1, mb * win * cs))
    for b0 in range(0, b, step):
        g = tier[t[b0:b0 + step, :, None], rows[b0:b0 + step]].to(torch.float32)
        out[b0:b0 + step] = torch.einsum("bmjc,bc->bmj", g, q[b0:b0 + step])
    pos = blk_start.to(torch.int64)[..., None] + j
    valid = live.to(torch.bool)[..., None] & (pos >= start[..., None]) & (pos < end[..., None])
    return torch.where(valid, out, float("-inf"))
