"""Peaks of one NVIDIA H100 and the least time a kernel's work could take.

`PEAK` and `bound` are the port's `chip_smoke.py` arithmetic: NVIDIA's
published dense peaks of the H100 SXM part at its 700 W limit, and the
larger of a kernel's bytes over the memory rate and its operations over
the peak rate of their type. Bytes count each input byte read once (the
distinct tier rows of the valid slots, not the rows gathered again for
other queries) and each output byte written once.
"""

from __future__ import annotations

PEAK = {"bytes": 3.35e12, "f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time in seconds: bytes over the memory rate, or operations
    over the peak rate of `kind`, whichever is larger."""
    t_bytes = nbytes / PEAK["bytes"]
    t_ops = ops / PEAK[kind]
    return {"bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": float(nbytes), "ops": float(ops)}


def window_scores_work(tier, q_low, table, blk_start, start, end, live, win) -> dict:
    """The work of one call of the coarse window-score kernel (K2b), counted
    from its operands as its contract defines the result: slot j of window
    (b, m) reads tier row clip(blk_start, 0, caprows - win) + j of table
    clip(table, 0, L - 1) and is valid where live and start <= blk_start
    + j < end. Bytes: the distinct rows of the valid slots, the small
    inputs, the f32 scores; operations: a multiply and an add per column of
    every valid slot. → `bound` of that work."""
    import torch

    l, caprows, cs = tier.shape
    j = torch.arange(win, device=tier.device)
    pos = blk_start.to(torch.int64)[..., None] + j
    valid = (live.to(torch.bool)[..., None] & (pos >= start.to(torch.int64)[..., None])
             & (pos < end.to(torch.int64)[..., None]))
    row = (blk_start.to(torch.int64).clamp(0, caprows - win)[..., None] + j
           + table.to(torch.int64).clamp(0, l - 1)[..., None] * caprows)
    distinct = int(torch.unique(row[valid]).numel())
    small = sum(t.numel() * t.element_size() for t in (q_low, table, blk_start, start, end, live))
    out_bytes = blk_start.numel() * win * 4
    nbytes = distinct * cs * tier.element_size() + small + out_bytes
    return bound(nbytes, 2.0 * int(valid.sum()) * cs, "bf16")
