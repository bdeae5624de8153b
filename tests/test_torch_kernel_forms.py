"""Which form of K1, K2, K2b and K4 a shape takes (CPU: the Python mirrors
of the choices `csrc/hash_kernel.cu`, `csrc/coarse_gather.cu` and
`csrc/flat_groupmax.cu` make by shape), and that each mirror's threshold
equals its source's constant."""

import re
from pathlib import Path

import pytest
import torch

from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_gather as K2
from similaritysearchbyrdf_tpu_torch.ops.kernels import flat_groupmax as K4
from similaritysearchbyrdf_tpu_torch.ops.kernels import hash_kernel as K1

CSRC = Path(K1.__file__).resolve().parents[2] / "csrc"


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("d,form", [(32, "wgmma"), (96, "wgmma"), (192, "wgmma"),
                                    (224, "wgmma_kloop"), (800, "wgmma_kloop"),
                                    (4096, "wgmma_kloop")])
def test_groupmax_form_by_width(d, form):
    assert K4.kernel_form(torch.int8, d) == form
    # a bf16 row of D values is 2D bytes: the wgmma form to D 96
    assert K4.kernel_form(torch.bfloat16, d) == ("wgmma" if d <= 96 else "wgmma_kloop")


@pytest.mark.parametrize("d,form", [(32, "wgmma"), (64, "wgmma"), (96, "wgmma"),
                                    (128, "wgmma_kloop"), (800, "wgmma_kloop")])
def test_groupmax_bf16_form_by_width(d, form):
    """bf16 takes the int8 forms by the bytes of a row: the wgmma form to
    `WGMMA_MAX_D` bytes (D 96), the K-looped form past it."""
    assert K4.kernel_form(torch.bfloat16, d) == form


@pytest.mark.parametrize("d,form", [(7, "narrow"), (100, "narrow"), (300, "narrow"),
                                    (383, "narrow"), (384, "wide"), (4096, "wide"),
                                    (5000, "wide")])
def test_hash_form_by_width(d, form):
    assert K1.kernel_form(d) == form


@pytest.mark.parametrize("cs,win,b,mb,form", [
    (4096, 64, 1024, 30, "window_major"),     # sparse_1m's flat exact2 re-score
    (4096, 64, 1, 1, "window_major"),
    (128, 256, 1024, 64, "window_major"),     # IVF's default: nprobe 32, 256-slot windows
    (64, 512, 7, 33, "window_major"),         # 32 KB windows: the threshold
    (128, 128, 1024, 14, "generic"),          # 16 KB windows: below it
    (96, 128, 1024, 14, "w96"),               # ivf_8m's headline: cs 96, 128-slot windows
    (96, 64, 1024, 64, "w96"),                # ivf_8m pruned
    (96, 64, 1024, 30, "w96"),                # sharded_8m's flat re-score on a D-96 shard
    (96, 128, 1, 1, "w96"),
    (96, 32, 1024, 14, "generic"),            # cs 96 past the w96 windows
    (96, 256, 1024, 14, "generic"),           # ... and not a multiple of 64 columns
    (96, 128, 1 << 16, 1 << 15, "generic"),   # window counts past an int
    (2056, 64, 5, 12, "generic"),             # past 2048 columns, not a multiple of 64
    (4096, 8, 5, 12, "generic"),              # a window of 8 slots: not a multiple of 16
    (32, 64, 128, 1024, "w64"),               # window mode
    (128, 64, 1024, 30, "w64"),               # the dense flat engine's re-score
    (32, 64, 1 << 16, 1 << 15, "generic"),    # window counts past an int
    (4096, 64, 1 << 14, 1 << 14, "generic"),  # past the window-major form's pair count
])
def test_window_form_by_shape(cs, win, b, mb, form):
    """K2b's form at every shape the card paths give it; a bf16 tier always
    takes the generic kernel."""
    assert K2.window_kernel_form(cs, win, b, mb) == form
    assert K2.window_kernel_form(cs, win, b, mb, tier_bf16=True) == "generic"


@pytest.mark.parametrize("cs,bs,b,mb,form", [
    (32, 8, 1024, 512, "b8"), (32, 8, 1, 1, "b8"), (64, 8, 64, 2048, "b8"),
    (64, 8, 7, 33, "b8"), (96, 8, 1024, 512, "generic"), (64, 4, 64, 2048, "generic"),
    (128, 8, 1024, 512, "generic"), (64, 8, 1 << 16, 1 << 15, "generic")])
def test_block_form_by_shape(cs, bs, b, mb, form):
    """K2's form: 8-slot blocks of 32 or 64 int8 columns take the b8 kernel;
    other widths and block sizes, block counts past an int and every bf16
    tier the generic one."""
    assert K2.block_kernel_form(cs, bs, b, mb) == form
    assert K2.block_kernel_form(cs, bs, b, mb, tier_bf16=True) == "generic"


@pytest.mark.parametrize("b,mb,slots", [(1, 1, 1024), (1024, 30, 65536), (1024, 64, 131072),
                                        (512, 1, 1024), (513, 1, 2048)])
def test_window_scratch_bytes(b, mb, slots):
    """The window-major form's scratch: 16 bytes a hash slot (the next power
    of two of at least 2n slots, 1024 at least), 32 a pair, 16 for the
    counters."""
    assert K2.window_scratch_bytes(b, mb) == 16 * slots + 32 * b * mb + 16


@pytest.mark.parametrize("mirror,source,name", [
    (K4.WGMMA_MAX_D, "flat_groupmax.cu", "kWgMaxD"),
    (K1.WIDE_MIN_D, "hash_kernel.cu", "kWideMinD"),
    (K2.WINDOW_MAJOR_MIN_BYTES, "coarse_gather.cu", "kMinBytes"),
    (K2.WINDOW_MAJOR_CHUNK, "coarse_gather.cu", "kChunk"),
    (K2.WINDOW_MAJOR_MAX_WIN, "coarse_gather.cu", "kMaxWin"),
])
def test_form_widths_match_the_sources(mirror, source, name):
    assert mirror == _constant(source, name)


def test_w96_windows_match_the_source():
    """K2b's w96 window sizes and width are the ones `rdf_coarse_window_form`
    tests for."""
    text = (CSRC / "coarse_gather.cu").read_text()
    form = text[text.index("int rdf_coarse_window_form"):]
    line = next(ln for ln in form.splitlines() if "return 3;" in ln)
    assert tuple(int(w) for w in re.findall(r"win == (\d+)", line)) == K2.W96_WINDOWS
    assert re.findall(r"cs == (\d+)", line) == ["96"]


def test_block_widths_match_the_source():
    """K2's b8 widths are the ones `rdf_coarse_block_form` tests for."""
    text = (CSRC / "coarse_gather.cu").read_text()
    form = text[text.index("int rdf_coarse_block_form"):]
    form = form[:form.index("}")]
    assert tuple(int(w) for w in re.findall(r"cs == (\d+)", form)) == K2.BLOCK_B8_WIDTHS
