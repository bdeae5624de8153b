"""Top-k select over rows of packed keys: CUDA wrapper and its plain version.

Replaces no TPU kernel. The JAX package's folded query selects with full
`lax.sort`s of packed keys, and the port mirrored them as `torch.sort`s
whose results were then cut to their first `k` columns (`index/forest.py`:
the one-operand group select of `_query_groupmax` and the second sort of
`_stage2`). The kernel (`csrc/topk_select.cu`) returns that prefix alone:
for each row of int32 or int64 keys, its `k` largest keys in descending
order, or its `k` smallest ascending, equal bit for bit to
`torch.sort(keys, dim=1, descending=...)[0][:, :k]`. Equal keys are equal
bits, so ties need no rule; a caller that wants a stable sort's order packs
the position into the key, which makes the keys unique.

Its bound on the H100 is bytes, one read of each row: one block a row
reads the row once into shared memory, finds the k-th key by an 8-bit
radix select on chip, and sorts only the `k` winners there before writing
them, so its time is that work on chip (the source's note has the
numbers). Rows or winner sets wider than shared memory stay in device
memory (slower, the same bits; the wrapper allocates the scratch).

`topk_packed_select` takes int32 values instead of keys and builds each
column's key as the forest's one-operand group select packs it, inside the
kernel: `(clamp(v >> sh, lo, hi) << bits_w) | column`, with
`lo = -2^(31 - bits_w)` and `hi = 2^(31 - bits_w) - 1`, so that every key
fits int32; it returns those keys, largest first.

`topk_select` and `topk_packed_select` launch the kernel for CUDA tensors
and run the plain versions (`torch.sort`) for CPU tensors; a CUDA tensor
never takes the plain version.
"""

from __future__ import annotations

import functools

import torch

from . import build

LAUNCHES = 0   # kernel launches since the last reset (plain runs never count)
_KEY_BYTES = {torch.int32: 4, torch.int64: 8}


def topk_select_plain(keys: torch.Tensor, k: int, descending: bool) -> torch.Tensor:
    """keys int[B, n] → the sorted prefix int[B, min(k, n)] of each row."""
    return torch.sort(keys, dim=1, descending=descending)[0][:, :k].contiguous()


def pack_keys_plain(values: torch.Tensor, sh: int, bits_w: int) -> torch.Tensor:
    """values i32[B, n] → the packed keys i32[B, n] (module docstring)."""
    lo, hi = -(1 << (31 - bits_w)), (1 << (31 - bits_w)) - 1
    col = torch.arange(values.shape[1], device=values.device)
    return ((torch.clamp(values.to(torch.int64) >> sh, lo, hi) << bits_w) | col).to(torch.int32)


def _check(name: str, keys: torch.Tensor, k: int) -> None:
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {keys.device}")
    if keys.dim() != 2:
        raise ValueError(f"{name}: needs a 2-D tensor, got shape {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError(f"{name}: the keys must be contiguous")
    if k < 0:
        raise ValueError(f"{name}: k must be >= 0, got {k}")
    if max(keys.shape) >= 2**31:
        raise ValueError(f"{name}: shape {tuple(keys.shape)} past the kernel's int32 sizes")


@functools.lru_cache(maxsize=64)
def _form(device_index: int, n: int, kout: int, key_bytes: int) -> int:
    """The kernel's form for this shape (0 and 1 need no scratch, 2 does:
    `rdf_topk_select_form`, which also lets the form take this shape's
    shared memory on the device), cached per device and shape."""
    with torch.cuda.device(device_index):
        form = build.library().rdf_topk_select_form(n, kout, key_bytes)
    if form < 0:
        raise RuntimeError(f"rdf_topk_select_form: cudaError_t {-form}")
    return form


def _launch(keys: torch.Tensor, k: int, descending: bool, pack: bool, sh: int,
            bits_w: int) -> torch.Tensor:
    global LAUNCHES
    b, n = keys.shape
    kout = min(k, n)
    out = torch.empty((b, kout), dtype=keys.dtype, device=keys.device)
    if out.numel() == 0:
        return out
    key_bytes = _KEY_BYTES[keys.dtype]
    scratch = None
    form = _form(keys.device.index, n, kout, key_bytes)
    if form == 2:
        scratch = torch.empty((b, 1 << (kout - 1).bit_length()), dtype=keys.dtype,
                              device=keys.device)
    err = build.library().rdf_topk_select(
        keys.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        b, n, kout, key_bytes, form, int(descending), int(pack), sh, bits_w,
        build.stream(keys.device))
    build.check(err, "rdf_topk_select")
    LAUNCHES += 1
    return out


def topk_select(keys: torch.Tensor, k: int, descending: bool) -> torch.Tensor:
    """keys int32 or int64 [B, n], contiguous → int[B, min(k, n)]: each row's
    `k` largest keys in descending order, or `k` smallest ascending; the
    kernel on CUDA tensors, `topk_select_plain` on CPU tensors."""
    _check("topk_select", keys, k)
    if keys.dtype not in _KEY_BYTES:
        raise TypeError(f"topk_select: needs int32 or int64 keys, got {keys.dtype}")
    if keys.device.type == "cpu":
        return topk_select_plain(keys, k, descending)
    return _launch(keys, k, descending, False, 0, 0)


def topk_packed_select(values: torch.Tensor, k: int, sh: int, bits_w: int) -> torch.Tensor:
    """values i32[B, n], contiguous → i32[B, min(k, n)]: the `k` largest of
    each row's packed keys `(clamp(v >> sh, lo, hi) << bits_w) | column`,
    largest first (module docstring); the kernel builds the keys on CUDA
    tensors, `pack_keys_plain` and `topk_select_plain` run on CPU tensors.
    Needs 0 <= sh < 32, 1 <= bits_w < 32 and n <= 2^bits_w."""
    _check("topk_packed_select", values, k)
    if values.dtype != torch.int32:
        raise TypeError(f"topk_packed_select: needs int32 values, got {values.dtype}")
    if not (0 <= sh < 32 and 1 <= bits_w < 32 and values.shape[1] <= 1 << bits_w):
        raise ValueError(f"topk_packed_select: sh {sh}, bits_w {bits_w} for "
                         f"{values.shape[1]} columns")
    if values.device.type == "cpu":
        return topk_select_plain(pack_keys_plain(values, sh, bits_w), k, True)
    return _launch(values, k, True, True, sh, bits_w)
