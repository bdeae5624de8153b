"""K3, the folded rowmax kernel: CUDA wrapper and its plain PyTorch version.

Replaces `similaritysearchbyrdf_tpu/ops/pallas/coarse_fold.py`
(`pallas_coarse_rowmax` → `_kernel`). The folded coarse tier
i8[L, capf, fold*cs] holds `fold` consecutive slots of one table per
physical row (a view of the per-table tier, `index/forest.py`). For every
(query, window) the kernel (`csrc/coarse_fold.cu`) scores every slot of the
window's `wpr` physical rows with an exact int32 dot of int8 tier values
against the query's int8 coarse vector, packs `(score << mshift) | member`
and keeps the maximum (and, with `emit2`, the second maximum) per physical
row. On the H100 it is bound by bytes read: a persistent grid streams each
window's contiguous run of rows into a ring of shared-memory stages by TMA
bulk copy, and each consumer thread scores one row with `__dp4a`, keeping
its top two in registers. Every value is an integer, so kernel and plain
version agree bit for bit.

Unlike the TPU kernel, whose dead windows hold stale scratch, both versions
write `I32_DEAD` on every row of a dead window (`row_start < 0`), as the
JAX package's `rowmax_fallback` does.

`coarse_rowmax_kernel` launches the kernel for CUDA tensors and runs
`coarse_rowmax_plain` for CPU tensors; a CUDA tensor never takes the plain
version.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from . import build

LAUNCHES = 0   # kernel launches since the last reset (plain runs never count)
I32_DEAD = -(2**31 - 1)   # dead-row sentinel: not int32 min, so -pk never overflows
_WIDTHS = {(8, 128), (16, 128), (32, 128), (64, 128), (128, 128), (256, 256)}

RowMax = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def coarse_rowmax_plain(folded: torch.Tensor, qi8: torch.Tensor, table: torch.Tensor,
                        row_start: torch.Tensor, wpr: int, rpg: int, mshift: int,
                        emit2: bool = False) -> RowMax:
    """folded i8[L, capf, fold*cs], qi8 i8[B, cs], table and row_start
    i32[B, MB] (-1 = dead window) → i32[B, MB*wpr] (a pair with `emit2`).
    Row r of window m covers folded row clip(row_start, 0, capf-wpr) + r of
    table clip(table, 0, L-1); slot s of it packs
    (dot << mshift) | ((r % rpg) * fold | s). A transcription of the JAX
    package's `rowmax_fallback` (`ops/pallas/coarse_fold.py:284-327`)."""
    l, capf, lanes = folded.shape
    b, mb = table.shape
    cs = qi8.shape[1]
    fold = lanes // cs
    dev = folded.device
    t = table.to(torch.int64).clamp(0, l - 1)
    rs = row_start.to(torch.int64).clamp(0, capf - wpr)
    rows = folded[t[..., None], rs[..., None] + torch.arange(wpr, device=dev)]
    scores = (rows.view(b, mb, wpr, fold, cs).to(torch.int32)
              * qi8.to(torch.int32)[:, None, None, None, :]).sum(-1, dtype=torch.int32)
    member = (((torch.arange(wpr, device=dev) % rpg) * fold)[:, None]
              | torch.arange(fold, device=dev)[None, :]).to(torch.int32)
    # the caller guarantees score_bits + mshift <= 32: the product cannot wrap
    pk = scores * (1 << mshift) | member                       # [B, MB, wpr, fold]
    rowpk = pk.amax(dim=3)
    live = (row_start >= 0)[..., None]
    rowpk = torch.where(live, rowpk, I32_DEAD).reshape(b, mb * wpr)
    if not emit2:
        return rowpk
    pk2 = torch.where(pk == pk.amax(dim=3, keepdim=True), I32_DEAD, pk)
    rowpk2 = torch.where(live, pk2.amax(dim=3), I32_DEAD).reshape(b, mb * wpr)
    return rowpk, rowpk2


def coarse_rowmax_kernel(folded: torch.Tensor, qi8: torch.Tensor, table: torch.Tensor,
                         row_start: torch.Tensor, wpr: int, rpg: int, mshift: int,
                         emit2: bool = False) -> RowMax:
    """K3 on CUDA tensors, its plain version on CPU tensors. Same contract
    as `coarse_rowmax_plain`; the kernel takes `rpg` a power of two (the
    folded query's `coarse_group // fold` always is)."""
    global LAUNCHES
    if folded.device.type == "cpu":
        return coarse_rowmax_plain(folded, qi8, table, row_start, wpr, rpg, mshift, emit2)
    if folded.device.type != "cuda":
        raise ValueError(f"coarse_rowmax_kernel: unsupported device {folded.device}")
    if (folded.dtype != torch.int8 or qi8.dtype != torch.int8
            or table.dtype != torch.int32 or row_start.dtype != torch.int32):
        raise TypeError("coarse_rowmax_kernel: needs folded and qi8 i8, table and "
                        "row_start i32")
    l, capf, lanes = folded.shape
    b, mb = table.shape
    cs = qi8.shape[1] if qi8.dim() == 2 else -1
    if (qi8.shape != (b, cs) or (cs, lanes) not in _WIDTHS or row_start.shape != (b, mb)
            or not 0 < wpr <= capf or rpg < 1 or rpg & (rpg - 1) or not 0 <= mshift < 32):
        raise ValueError(f"coarse_rowmax_kernel: shapes folded {tuple(folded.shape)}, "
                         f"qi8 {tuple(qi8.shape)}, table {tuple(table.shape)}, "
                         f"row_start {tuple(row_start.shape)}, wpr {wpr}, rpg {rpg}, "
                         f"mshift {mshift}")
    build.check_operands("coarse_rowmax_kernel", folded.device, ("folded", "qi8"),
                         folded=folded, qi8=qi8, table=table, row_start=row_start)
    out = torch.empty((b, mb * wpr), dtype=torch.int32, device=folded.device)
    out2 = torch.empty_like(out) if emit2 else None
    if out.numel() == 0:
        return (out, out2) if emit2 else out
    err = build.library().rdf_coarse_rowmax(
        folded.data_ptr(), qi8.data_ptr(), table.data_ptr(), row_start.data_ptr(),
        out.data_ptr(), out2.data_ptr() if emit2 else None, l, capf, lanes, cs, b, mb,
        wpr, rpg, mshift, build.stream(folded.device),
    )
    build.check(err, "rdf_coarse_rowmax")
    LAUNCHES += 1
    return (out, out2) if emit2 else out
