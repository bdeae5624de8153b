"""The port's quantized-flat engine against the benchmark's plain reference.

`FlatIndex` at the `flat_deep96` configuration (its defaults: int8 sketch,
grouped mode, refine 128), on the configuration's own `hard_clustered`
data cut to a few rows, answers every query with the ids of
`benchmark/reference/flat.py` (torch and numpy, nothing of the port) and
scores within f32 rounding: on the exact2 route the small sizes take, and
on the argpack route the full size takes (forced in both by lowering
their shared 1M-row threshold), at 40,000 rows (one-level select) and at
520,000 (two-level, as at full size). The reference one step of precision
lower (the control) answers otherwise."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.engines import flat as engine
from benchmark.lib import data
from benchmark.lib.runner import _deep_update
from benchmark.reference import flat as reference
from similaritysearchbyrdf_tpu_torch.ops import flat as port_flat

ROOT = Path(__file__).resolve().parents[1]
BASE = json.loads((ROOT / "benchmark/configs/flat_deep96.json").read_text())
SEED = 2**35 + 25
# both sides re-score the same rows with f32 products; the sums may run in
# another order, a few ulps of a score below 1
SCORE_ATOL = 2e-5


def answers(rows, control=False):
    torch.set_num_threads(4)
    cfg = _deep_update(BASE, {"rows": rows, "queries": 64})
    x, q = data.make(cfg, SEED, "cpu")
    index = engine.build(cfg, "cpu")
    engine.fit(index, x)
    ids, scores = engine.query(index, cfg, q.numpy())
    ref_ids, ref_scores = reference.answers(cfg, x, q, cfg["k"], control=control)
    return ids, scores, ref_ids.numpy(), ref_scores.numpy()


@pytest.fixture
def argpack(monkeypatch):
    monkeypatch.setattr(port_flat, "_ARGPACK_MIN_ROWS", 1 << 15)
    monkeypatch.setattr(reference, "ARGPACK_MIN_ROWS", 1 << 15)


def check_equal(rows):
    ids, scores, ref_ids, ref_scores = answers(rows)
    assert np.array_equal(ids, ref_ids)
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=SCORE_ATOL)
    assert (ids >= 0).all()


def test_port_equals_reference_exact2():
    assert port_flat._resolve_select_mode("auto", torch.int8, 40_000, 96) == "exact2"
    check_equal(40_000)


@pytest.mark.parametrize("rows", [40_000, 520_000])
def test_port_equals_reference_argpack(argpack, rows):
    assert port_flat._resolve_select_mode("auto", torch.int8, rows, 96) == "argpack"
    check_equal(rows)


def test_the_control_answers_otherwise(argpack):
    ids, _, ref_ids, _ = answers(40_000, control=True)
    assert not np.array_equal(ids, ref_ids)


def test_reference_loads_neither_package_nor_jax():
    import subprocess
    import sys

    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import benchmark.reference.flat\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(out.stdout.split())
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "similaritysearchbyrdf_tpu",
                        "similaritysearchbyrdf_tpu_torch"}
