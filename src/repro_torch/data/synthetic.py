"""Synthetic data per paper Sec. 5.2 (a numpy copy of the JAX package's
`data/synthetic.py`): Gaussian blobs, some partially overlapped, with
random diagonal covariances in [0, 10], plus uniform background noise, in
the three a* regimes of Table 1:

  regime "omega": a* = omega * n / 20  (clean source: clusters grow with n)
  regime "eta":   a* = n^eta / 20      (noisy source: sub-linear growth)
  regime "P":     a* = P / 20          (size-limited clusters, Dunbar bound)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.lsh.pstable import LSHParams


class SyntheticSpec(NamedTuple):
    points: np.ndarray        # (n, d) float32
    labels: np.ndarray        # (n,) int32, -1 = noise
    n_clusters: int


def make_blobs_with_noise(
    n_clusters: int,
    cluster_size: int,
    n_noise: int,
    d: int = 16,
    seed: int = 0,
    mean_range: float = 50.0,
    cov_max: float = 10.0,
    overlap_pairs: int = 2,
    noise_range: float = 60.0,
) -> SyntheticSpec:
    rng = np.random.default_rng(seed)
    means = rng.uniform(-mean_range, mean_range, size=(n_clusters, d))
    # partially overlap a few cluster pairs (paper: means set close together)
    for j in range(min(overlap_pairs, n_clusters // 2)):
        means[2 * j + 1] = means[2 * j] + rng.normal(0, 3.0, size=d)
    covs = rng.uniform(0.0, cov_max, size=(n_clusters, d))

    pts, labels = [], []
    for c in range(n_clusters):
        x = means[c] + rng.normal(size=(cluster_size, d)) * np.sqrt(covs[c])
        pts.append(x)
        labels.append(np.full(cluster_size, c))
    if n_noise > 0:
        pts.append(rng.uniform(-noise_range, noise_range, size=(n_noise, d)))
        labels.append(np.full(n_noise, -1))
    points = np.concatenate(pts).astype(np.float32)
    labels = np.concatenate(labels).astype(np.int32)
    perm = rng.permutation(points.shape[0])
    return SyntheticSpec(points[perm], labels[perm], n_clusters)


def make_regime_dataset(
    n: int,
    regime: str,
    d: int = 16,
    n_clusters: int = 20,
    omega: float = 1.0,
    eta: float = 0.9,
    P: int = 1000,
    seed: int = 0,
) -> SyntheticSpec:
    if regime == "omega":
        a_star = max(2, int(omega * n / n_clusters))
    elif regime == "eta":
        a_star = max(2, int(n**eta / n_clusters))
    elif regime == "P":
        a_star = max(2, int(P / n_clusters))
    else:
        raise ValueError(f"unknown regime {regime!r}")
    a_star = min(a_star, n // n_clusters)
    n_noise = max(0, n - n_clusters * a_star)
    return make_blobs_with_noise(n_clusters, a_star, n_noise, d=d, seed=seed)


def auto_lsh_params(
    points: np.ndarray,
    n_tables: int = 4,
    n_projections: int = 8,
    probe: int = 16,
    seg_scale: float = 8.0,
    sample: int = 512,
    seed: int = 0,
) -> LSHParams:
    """Pick the p-stable segment length r from the data scale: r = seg_scale
    * median nearest-neighbour distance of a random subsample."""
    rng = np.random.default_rng(seed)
    m = min(sample, points.shape[0])
    idx = rng.choice(points.shape[0], size=m, replace=False)
    s = points[idx].astype(np.float64)
    d2 = ((s[:, None, :] - s[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nn = np.sqrt(d2.min(axis=1))
    r = float(np.median(nn)) * seg_scale
    return LSHParams(n_tables=n_tables, n_projections=n_projections,
                     seg_len=max(r, 1e-6), probe=probe)
