"""The port's dataset generators (`similaritysearchbyrdf_tpu_torch/utils/datasets.py`,
a numpy copy) draw the JAX package's arrays bit for bit."""

import numpy as np
import pytest

from similaritysearchbyrdf_tpu.utils import datasets as J
from similaritysearchbyrdf_tpu_torch.utils import datasets as T


@pytest.mark.parametrize("seed", [0, 3, 11, 2024])
def test_easy_clustered_equals_jax(seed):
    x = T.easy_clustered(3000, 24, seed=seed, n_centers=200)
    want = J.easy_clustered(3000, 24, seed=seed, n_centers=200)
    assert x.dtype == np.float32 and x.shape == (3000, 24)
    np.testing.assert_array_equal(x, want)


@pytest.mark.parametrize("seed", [1, 7, 42])
@pytest.mark.parametrize("d", [16, 48])
def test_hard_clustered_equals_jax(seed, d):
    x, q = T.hard_clustered(4000, d, n_queries=64, seed=seed, n_centers=100)
    jx, jq = J.hard_clustered(4000, d, n_queries=64, seed=seed, n_centers=100)
    assert x.dtype == q.dtype == np.float32 and x.shape == (4000, d) and q.shape == (64, d)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_allclose(np.linalg.norm(x, axis=1), 1.0, atol=1e-5)


def test_hard_clustered_chunks_past_a_million_rows_alike():
    """The corpus is drawn in chunks of 2**20 rows: a two-chunk draw equals
    the JAX package's (a small n draws one chunk)."""
    x, q = T.hard_clustered((1 << 20) + 500, 8, n_queries=8, seed=5, n_centers=50)
    jx, jq = J.hard_clustered((1 << 20) + 500, 8, n_queries=8, seed=5, n_centers=50)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(q, jq)


def test_hard_clustered_refuses_a_bad_spread():
    with pytest.raises(ValueError):
        T.hard_clustered(10, 4, center_spread=1.0)
