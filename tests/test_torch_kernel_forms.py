"""Which form of K1 and K4 a shape takes (CPU: the Python mirrors of the
choices `csrc/hash_kernel.cu` and `csrc/flat_groupmax.cu` make by shape),
and that each mirror's width equals its source's constant."""

import re
from pathlib import Path

import pytest
import torch

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
    assert K4.kernel_form(torch.bfloat16, d) == "mma.sync"


@pytest.mark.parametrize("d,form", [(7, "narrow"), (100, "narrow"), (300, "narrow"),
                                    (383, "narrow"), (384, "wide"), (4096, "wide"),
                                    (5000, "wide")])
def test_hash_form_by_width(d, form):
    assert K1.kernel_form(d) == form


@pytest.mark.parametrize("mirror,source,name", [
    (K4.WGMMA_MAX_D, "flat_groupmax.cu", "kWgMaxD"),
    (K1.WIDE_MIN_D, "hash_kernel.cu", "kWideMinD"),
])
def test_form_widths_match_the_sources(mirror, source, name):
    assert mirror == _constant(source, name)
