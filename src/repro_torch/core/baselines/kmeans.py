"""k-means (Lloyd) with k-means++ init: partitioning baseline (Fig. 11)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.alid import resolve_device
from repro_torch.kernels import ops


def _lloyd(points: torch.Tensor, init: torch.Tensor, n_clusters: int,
           max_iters: int = 100):
    """max_iters Lloyd steps from init; (centers, the assignment made from
    the centers before the last update), as the JAX package's scan."""
    centers = init
    assign = torch.zeros(points.shape[0], dtype=torch.int64,
                         device=points.device)
    for _ in range(max_iters):
        dist = ops.pairwise_distance(points, centers)
        assign = torch.argmin(dist, dim=1)
        onehot = torch.nn.functional.one_hot(assign, n_clusters).to(
            points.dtype)
        counts = torch.clamp_min(onehot.sum(0), 1.0)
        centers = (onehot.T @ points) / counts[:, None]
    return centers, assign


def kmeans(points: np.ndarray, n_clusters: int, seed: int = 0,
           max_iters: int = 100, device="cuda"):
    """(labels (n,) int32, centers (n_clusters, d)). The k-means++ draws
    come from numpy's default_rng(seed), as in the JAX package."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    rng = np.random.default_rng(seed)
    centers = [pts[rng.integers(len(points))]]
    for _ in range(n_clusters - 1):
        dist = ops.pairwise_distance(pts, torch.stack(centers))
        d2 = np.min(dist.cpu().numpy(), 1) ** 2
        prob = d2 / max(d2.sum(), 1e-12)
        centers.append(pts[rng.choice(len(points), p=prob)])
    centers, assign = _lloyd(pts, torch.stack(centers), n_clusters,
                             max_iters)
    return (assign.cpu().numpy().astype(np.int32),
            centers.cpu().numpy())
