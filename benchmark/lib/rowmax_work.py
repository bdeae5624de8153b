"""The least time of one call of the folded row-max kernel K3.

`rowmax_work` counts the work the operands of `coarse_rowmax_kernel`
(`ops/kernels/coarse_fold.py` of the port) define, with the arithmetic of
the port's `chip_smoke.py` `folded_phase`: the kernel streams each live
window's `wpr` folded rows of `lanes` int8 values and scores every slot of
them against the query's int8 vector. Bytes: the distinct folded rows of
live windows (rows a window shares with another are read once), the small
inputs (the int8 query, the tables and row starts), the int32 outputs
(two with `emit2`); operations: a multiply and an add per int8 value of
every live window's rows. → `roofline.bound` of that work, on the int8
peak.
"""

from __future__ import annotations

from .roofline import bound


def rowmax_work(folded, qi8, table, row_start, wpr: int, rpg: int, mshift: int,
                emit2: bool = False) -> dict:
    """folded i8[L, capf, lanes], qi8 i8[B, cs], table and row_start
    i32[B, MB] (-1 a dead window) as the kernel takes them."""
    import torch

    l, capf, lanes = folded.shape
    live = row_start >= 0
    rows = (table.to(torch.int64).clamp(0, l - 1)[..., None] * capf
            + row_start.to(torch.int64).clamp(0, capf - wpr)[..., None]
            + torch.arange(wpr, device=row_start.device))
    distinct = int(torch.unique(rows[live]).numel())
    small = sum(t.numel() * t.element_size() for t in (qi8, table, row_start))
    out = table.numel() * wpr * 4 * (2 if emit2 else 1)
    gathered = int(live.sum()) * wpr * lanes
    return bound(distinct * lanes + small + out, 2.0 * gathered, "int8")
