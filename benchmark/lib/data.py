"""The benchmark's corpora and queries, drawn on the device from `--seed`.

`hard_clustered` is the geometry of the port's numpy generator
(`utils/datasets.hard_clustered`), rewritten in torch so that a
ten-million-row corpus is drawn on the card in a few large calls: points
sit at angle asin(alpha) from one of `n_centers` centres, the centres are
perturbations of `n_parents` parent directions, alpha has a base band and a
heavy tail, a small share of points is uniform on the sphere, and every
Gaussian is shaped by a power-law spectrum. Queries are fresh draws from
the same mixture, made after the corpus. The same seed on the same kind of
device gives the same arrays; the draws are not those of the numpy
generator.

A configuration fixes the seed of its data (`data.seed`), as a published
data set fixes its vectors; a run's `--seed` orders the pool of queries.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

DEFAULTS = dict(n_parents=64, n_centers=10_000, center_spread=0.45,
                alpha_base=(0.40, 0.60), alpha_tail=(0.60, 0.90), tail_frac=0.15,
                uniform_frac=0.03, spectrum_decay=0.35)
CHUNK = 1 << 20     # rows drawn at once


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded by `seed` (any whole number; reduced
    modulo 2^64, which torch's seed takes)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def _unit(a: torch.Tensor) -> torch.Tensor:
    return a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp(min=1e-20)


def hard_clustered(n: int, d: int, n_queries: int, seed: int, device,
                   **params) -> Tuple[torch.Tensor, torch.Tensor]:
    """(corpus f32[n, d], queries f32[n_queries, d]), unit rows on `device`."""
    p = {**DEFAULTS, **params}
    unknown = set(p) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"hard_clustered: unknown parameters {sorted(unknown)}")
    gen = generator(seed, device)
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    spectrum = (1.0 + torch.arange(d, dtype=torch.float32, device=device)) ** -p["spectrum_decay"]

    def gauss(m: int) -> torch.Tensor:
        return torch.randn((m, d), **f32) * spectrum

    def uniform(m: int, lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(m, **f32)

    s = p["center_spread"]
    parents = _unit(gauss(p["n_parents"]))
    pick = torch.randint(0, p["n_parents"], (p["n_centers"],), device=device, generator=gen)
    centers = _unit(math.sqrt(1.0 - s * s) * parents[pick] + s * _unit(gauss(p["n_centers"])))

    def draw(m: int) -> torch.Tensor:
        cid = torch.randint(0, p["n_centers"], (m,), device=device, generator=gen)
        alpha = torch.where(torch.rand(m, **f32) < p["tail_frac"],
                            uniform(m, *p["alpha_tail"]), uniform(m, *p["alpha_base"]))
        pts = (torch.sqrt(1.0 - alpha * alpha)[:, None] * centers[cid]
               + alpha[:, None] * _unit(gauss(m)))
        uni = torch.rand(m, **f32) < p["uniform_frac"]
        pts = torch.where(uni[:, None], _unit(torch.randn((m, d), **f32)), pts)
        return _unit(pts)

    corpus = torch.empty((n, d), dtype=torch.float32, device=device)
    for c0 in range(0, n, CHUNK):
        corpus[c0:c0 + CHUNK] = draw(min(CHUNK, n - c0))
    return corpus, draw(n_queries)


GENERATORS = {"hard_clustered": hard_clustered}


def make(cfg: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The configuration's corpus and its held-out queries, drawn from the
    configuration's own data seed (the deployment's data set, one per
    configuration), the queries in the order `seed` gives them: runs of
    other seeds send the same queries to the same index in another order,
    so the seed does not change the work."""
    data = dict(cfg["data"])
    gen = GENERATORS[data.pop("generator")]
    x, q = gen(cfg["rows"], cfg["dim"], cfg["queries"], data.pop("seed"), device, **data)
    order = np.random.default_rng([int(seed) % (1 << 63), 0x0DE5]).permutation(q.shape[0])
    return x, q[torch.as_tensor(order, device=q.device)]
