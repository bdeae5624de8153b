"""The generator repeats by seed, and draws unit rows of the stated shapes."""

import torch

from benchmark.lib import data


def test_same_seed_same_arrays():
    a = data.hard_clustered(2000, 24, 50, 2**40 + 17, "cpu", n_centers=100)
    b = data.hard_clustered(2000, 24, 50, 2**40 + 17, "cpu", n_centers=100)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_other_seed_other_arrays():
    a, _ = data.hard_clustered(500, 24, 10, 1, "cpu", n_centers=100)
    b, _ = data.hard_clustered(500, 24, 10, 2, "cpu", n_centers=100)
    assert not torch.equal(a, b)


def test_shapes_and_unit_rows():
    x, q = data.hard_clustered(1500, 96, 40, 5, "cpu")
    assert x.shape == (1500, 96) and q.shape == (40, 96)
    assert x.dtype == torch.float32
    norms = torch.linalg.vector_norm(torch.cat([x, q]), dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def test_config_sizes(bench):
    from benchmark.lib import cell

    for c in bench["configs"]:
        cfg = cell.config(bench, c["name"])
        x, q = data.make({**cfg, "rows": 100, "queries": 7}, 3, "cpu")
        x2, q2 = data.make({**cfg, "rows": 100, "queries": 7}, 4, "cpu")
        assert torch.equal(x, x2) and not torch.equal(q, q2)
        assert torch.equal(q.sort(0).values, q2.sort(0).values)
        assert x.shape == (100, cfg["dim"]) and q.shape == (7, cfg["dim"])
