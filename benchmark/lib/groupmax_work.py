"""The least time of the flat engine's scoring stage: K4's group maxima.

`groupmax_work` counts the work that one `FlatIndex` call of `queries`
queries on an index of `rows` rows of `dim` columns defines, with the
arithmetic of the port's `chip_smoke.py` (K4's bound): every query scored
against every row of the sketch as the engine lays it out (int8, rows
padded to a multiple of 8,192, columns to a multiple of 32), and one int32
key written for every 64-row group. Bytes: the sketch read once, the int8
queries, the keys; operations: a multiply and an add per int8 value of
every query-row pair. → `roofline.bound` of that work, on the int8 peak.
It reads the configuration's sizes alone, so any kernel behind the stage
reads the same work.
"""

from __future__ import annotations

from .roofline import bound

GROUP = 64              # rows a group: one int32 key each
ROW_MULTIPLE = 8192     # the sketch's row padding (`ops/flat.py` `_NPAD_MULTIPLE`)
COL_MULTIPLE = 32       # the sketch's column padding (`_SKETCH_COLS`)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def groupmax_work(queries: int, rows: int, dim: int) -> dict:
    npad = _round_up(rows, ROW_MULTIPLE)
    d = _round_up(dim, COL_MULTIPLE)
    nbytes = npad * d + queries * d + queries * (npad // GROUP) * 4
    return bound(nbytes, 2.0 * queries * npad * d, "int8")
