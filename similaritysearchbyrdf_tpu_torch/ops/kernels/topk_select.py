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

`topk_select_f32` takes f32 scores and returns each row's first `k`
entries of a stable descending sort, values and int64 indices, equal bit
for bit to `torch.sort(scores, dim=1, descending=True, stable=True)` cut
to `k` columns: ties in index order (-0.0 and +0.0 tie), -inf last, each
value with its input bits, and a NaN where the card's sort puts it, at
every width: without the sign bit first, with it last, each by its bits
(the CPU's sort puts every NaN first, tied). The kernel's key for column c is the unique 64-bit
`(ord(v) << 32) | (2^32 - 1 - c)`; on the card it is never built in
memory. `ops/rerank.top_sorted` is this form.

`topk_select`, `topk_packed_select` and `topk_select_f32` launch the
kernel for CUDA tensors and run the plain versions (`torch.sort`) for CPU
tensors; a CUDA tensor never takes the plain version. `FORM_LAUNCHES`
counts the launches by key kind and form (`"<kind>.<form>"`: a kind of
`KINDS`, a form of `FORMS`: shared, row read from device memory, or
device, as the kernel chose it by shape); `launches` sums kinds of them.
"""

from __future__ import annotations

import collections
import functools
from typing import Tuple

import torch

from . import build

# kernel launches by kind and form since the last clear (plain runs never count)
FORM_LAUNCHES: "collections.Counter[str]" = collections.Counter()
FORMS = ("shared", "row_device", "device")   # the kernel's forms 0, 1, 2
KEY_KINDS = ("int32", "int64", "packed")     # the key forms
KINDS = KEY_KINDS + ("f32",)
_KEY_BYTES = {torch.int32: 4, torch.int64: 8}
_KEY_KIND = {torch.int32: "int32", torch.int64: "int64"}


def topk_select_plain(keys: torch.Tensor, k: int, descending: bool) -> torch.Tensor:
    """keys int[B, n] → the sorted prefix int[B, min(k, n)] of each row."""
    return torch.sort(keys, dim=1, descending=descending)[0][:, :k].contiguous()


def pack_keys_plain(values: torch.Tensor, sh: int, bits_w: int) -> torch.Tensor:
    """values i32[B, n] → the packed keys i32[B, n] (module docstring)."""
    lo, hi = -(1 << (31 - bits_w)), (1 << (31 - bits_w)) - 1
    col = torch.arange(values.shape[1], device=values.device)
    return ((torch.clamp(values.to(torch.int64) >> sh, lo, hi) << bits_w) | col).to(torch.int32)


def topk_select_f32_plain(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores f32[B, n] → the first min(k, n) columns of the stable
    descending sort: (values f32, indices int64)."""
    s, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], idx[:, :k]


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


def _checked_form(form: int, name: str) -> int:
    if form < 0:
        raise RuntimeError(f"{name}: cudaError_t {-form}")
    return form


@functools.lru_cache(maxsize=64)
def _form(device_index: int, n: int, kout: int, key_bytes: int) -> int:
    """The kernel's form for this shape (0 and 1 need no scratch, 2 does:
    `rdf_topk_select_form`, which also lets the form take this shape's
    shared memory on the device), cached per device and shape."""
    with torch.cuda.device(device_index):
        form = build.library().rdf_topk_select_form(n, kout, key_bytes)
    return _checked_form(form, "rdf_topk_select_form")


@functools.lru_cache(maxsize=64)
def _f32_form(device_index: int, n: int, kout: int) -> int:
    """`_form` for the f32 form (`rdf_topk_select_f32_form`)."""
    with torch.cuda.device(device_index):
        form = build.library().rdf_topk_select_f32_form(n, kout)
    return _checked_form(form, "rdf_topk_select_f32_form")


def _scratch(form: int, b: int, kout: int, dtype: torch.dtype, device) -> "torch.Tensor | None":
    """Form 2's sort buffers in device memory: pow2(kout) keys a row."""
    if form != 2:
        return None
    return torch.empty((b, 1 << (kout - 1).bit_length()), dtype=dtype, device=device)


def _count(kind: str, form: int) -> None:
    FORM_LAUNCHES[f"{kind}.{FORMS[form]}"] += 1


def launches(kinds=KINDS) -> int:
    """Launches of these kinds counted in `FORM_LAUNCHES`."""
    return sum(v for key, v in FORM_LAUNCHES.items() if key.split(".")[0] in kinds)


def _launch(keys: torch.Tensor, k: int, descending: bool, pack: bool, sh: int,
            bits_w: int) -> torch.Tensor:
    b, n = keys.shape
    kout = min(k, n)
    out = torch.empty((b, kout), dtype=keys.dtype, device=keys.device)
    if out.numel() == 0:
        return out
    key_bytes = _KEY_BYTES[keys.dtype]
    form = _form(keys.device.index, n, kout, key_bytes)
    scratch = _scratch(form, b, kout, keys.dtype, keys.device)
    err = build.library().rdf_topk_select(
        keys.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        b, n, kout, key_bytes, form, int(descending), int(pack), sh, bits_w,
        build.stream(keys.device))
    build.check(err, "rdf_topk_select")
    _count("packed" if pack else _KEY_KIND[keys.dtype], form)
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


def topk_select_f32(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores f32[B, n] → (values f32[B, min(k, n)], indices int64[B, min(k,
    n)]): each row's first `k` entries of a stable descending sort (module
    docstring); the kernel on CUDA tensors, `topk_select_f32_plain` on CPU
    tensors. A non-contiguous tensor is copied first."""
    if scores.dtype != torch.float32:
        raise TypeError(f"topk_select_f32: needs f32 scores, got {scores.dtype}")
    scores = scores.contiguous()
    _check("topk_select_f32", scores, k)
    if scores.device.type == "cpu":
        return topk_select_f32_plain(scores, k)
    b, n = scores.shape
    kout = min(k, n)
    out_s = torch.empty((b, kout), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((b, kout), dtype=torch.int64, device=scores.device)
    if out_s.numel() == 0:
        return out_s, out_i
    form = _f32_form(scores.device.index, n, kout)
    scratch = _scratch(form, b, kout, torch.int64, scores.device)
    err = build.library().rdf_topk_select_f32(
        scores.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, n, kout, form,
        build.stream(scores.device))
    build.check(err, "rdf_topk_select_f32")
    _count("f32", form)
    return out_s, out_i
