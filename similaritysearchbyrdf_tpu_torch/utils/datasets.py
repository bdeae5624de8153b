"""Synthetic ANN corpora, including a HARD one whose recall knobs bind.

A numpy copy of `similaritysearchbyrdf_tpu/utils/datasets.py`: the same
generators draw the same arrays, bit for bit, from the same seed.

The round-2 benches used well-separated clusters (orthogonal unit centers +
0.05 gaussian noise, e.g. scripts/bench_flat.make_corpus). At D ≥ 96 random
centers are near-orthogonal and the noise is tiny, so every query's true
top-10 lives inside its own cluster: IVF recall was bit-identical across
nprobe 2→64 (results/ivf_deep8m.json, VERDICT r2 "missing #2") — the
recall-governing knob never bound and the headline number could not
distinguish a good pruner from a lucky one.

`hard_clustered` fixes that with three ingredients, calibrated so exact-GT
neighbors straddle cluster boundaries (the property the reference's own
evaluation relies on — its recall-vs-time curves visibly trade off,
the reference's results.png and README.md:7):

  1. **Hierarchical, overlapping centers.** Centers are perturbations of a
     few parent directions, so neighboring centers are a few degrees apart
     (not orthogonal) and k-means cells tile a continuum instead of
     isolated islands.
  2. **Large, heavy-tailed within-cluster spread.** Each point sits at
     angle asin(alpha) from its center with alpha drawn from a base band
     plus a heavy tail. In high-D the residual directions are mutually
     near-orthogonal, so cos(x1, x2) ≈ sqrt((1-a1²)(1-a2²))·cos(c1, c2):
     a query's true neighbors are the *lowest-alpha* points of the nearest
     centers, spread uniformly over the k-means subdivision of those
     centers — coverage (nprobe / steps / probe budget) directly governs
     recall.
  3. **A uniform noise floor.** A small fraction of points is uniform on
     the sphere (the unclusterable tail real Deep/GloVe distance
     histograms show).

  4. **A low-rank spectrum.** Gaussians are shaped by a power-law decay
     per dimension (real embeddings are effectively low-rank), which
     de-concentrates pairwise distances.

Queries are drawn from the same mixture (fresh points, never corpus rows),
so exclude-self is irrelevant and every query has genuine in-distribution
neighbors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["hard_clustered", "easy_clustered"]


def easy_clustered(
    n: int, d: int, seed: int = 11, n_centers: int = 50_000,
    noise: float = 0.05,
) -> np.ndarray:
    """The round-2 recipe (kept for regression comparisons): orthogonal-ish
    unit centers + small gaussian noise. Recall saturates on this corpus —
    use `hard_clustered` for any experiment about recall knobs."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, n_centers, n)] + noise * rng.normal(
        size=(n, d)
    )
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def _unit_rows(a: np.ndarray) -> np.ndarray:
    return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-20)


def _shaped_gauss(
    rng: np.random.Generator, shape: Tuple[int, ...], spectrum: np.ndarray
) -> np.ndarray:
    """Gaussian rows scaled per-dimension by `spectrum` (low-rank-ish)."""
    return rng.standard_normal(shape, dtype=np.float32) * spectrum


def hard_clustered(
    n: int,
    d: int,
    n_queries: int = 1024,
    seed: int = 7,
    n_parents: int = 64,
    n_centers: int = 10_000,
    center_spread: float = 0.45,
    alpha_base: Tuple[float, float] = (0.40, 0.60),
    alpha_tail: Tuple[float, float] = (0.60, 0.90),
    tail_frac: float = 0.15,
    uniform_frac: float = 0.03,
    spectrum_decay: float = 0.35,
) -> Tuple[np.ndarray, np.ndarray]:
    """Hard clustered corpus + query set on the unit sphere.

    Returns (x f32[n, d], q f32[n_queries, d]), both unit-norm. Queries are
    fresh draws from the same mixture (never corpus rows).

    Geometry: point = sqrt(1-a²)·center + a·residual with a ∈ alpha_base
    (prob 1-tail_frac) or alpha_tail (prob tail_frac); centers =
    sqrt(1-s²)·parent + s·residual with s = center_spread; `uniform_frac`
    of points (and queries) are uniform on the sphere. All gaussians are
    spectrum-shaped: dim i scaled by (1+i)^(-spectrum_decay).
    """
    if not 0.0 < center_spread < 1.0:
        raise ValueError("center_spread must be in (0, 1)")
    rng = np.random.default_rng(seed)
    spectrum = (1.0 + np.arange(d, dtype=np.float32)) ** (-spectrum_decay)

    parents = _unit_rows(_shaped_gauss(rng, (n_parents, d), spectrum))
    c_res = _unit_rows(_shaped_gauss(rng, (n_centers, d), spectrum))
    centers = _unit_rows(
        np.sqrt(1.0 - center_spread**2)
        * parents[rng.integers(0, n_parents, n_centers)]
        + center_spread * c_res
    )

    def draw(m: int) -> np.ndarray:
        cid = rng.integers(0, n_centers, m)
        alpha = rng.uniform(alpha_base[0], alpha_base[1], m).astype(
            np.float32
        )
        tail = rng.random(m) < tail_frac
        alpha[tail] = rng.uniform(
            alpha_tail[0], alpha_tail[1], int(tail.sum())
        )
        res = _unit_rows(_shaped_gauss(rng, (m, d), spectrum))
        pts = (
            np.sqrt(1.0 - alpha**2)[:, None] * centers[cid]
            + alpha[:, None] * res
        )
        uni = rng.random(m) < uniform_frac
        if uni.any():
            pts[uni] = _unit_rows(
                rng.standard_normal((int(uni.sum()), d), dtype=np.float32)
            )
        return _unit_rows(pts).astype(np.float32)

    # chunk the corpus draw: 8M×96 temporaries would otherwise peak at
    # several redundant f32[N, D] copies
    chunks = []
    step = 1 << 20
    for s0 in range(0, n, step):
        chunks.append(draw(min(step, n - s0)))
    x = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
    q = draw(n_queries)
    return x, q
