"""The plain references against the port's CPU path at a tiny size of both
configurations: the same ids, scores within f32 rounding."""

import numpy as np
import pytest
import torch

from benchmark.lib import cell, data
from conftest import TINY


def _run_deep_update(base, over):
    from benchmark.lib.runner import _deep_update

    return _deep_update(base, over)


@pytest.mark.parametrize("name", ["dpf_glove100", "ivf_deep96"])
def test_reference_equals_port_cpu_path(bench, name):
    torch.set_num_threads(4)
    cfg = _run_deep_update(cell.config(bench, name), TINY[name])
    eng = cell.engine(cfg)
    x, q = data.make(cfg, 2**35 + 11, "cpu")
    port = eng.build(cfg, "cpu")
    eng.fit(port, x)
    ids, scores = eng.query(port, cfg, q.numpy())
    ref_ids, ref_scores = eng.reference.answers(cfg, x, q, cfg["k"], batch=eng.REF_BATCH)
    assert np.array_equal(ids, ref_ids.numpy())
    np.testing.assert_allclose(scores, ref_scores.numpy(), rtol=0, atol=1e-6)
    assert (ids >= 0).all()
