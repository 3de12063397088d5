"""Spectral clustering (Ng-Jordan-Weiss): partitioning baseline (Fig. 11).
Full-matrix eigendecomposition: small n only (as in the paper's
comparison). The affinity matrix comes from the `affinity` kernel on the
card."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.affinity import affinity_matrix
from repro_torch.core.alid import resolve_device
from repro_torch.core.baselines.kmeans import kmeans


def spectral_clustering(points: np.ndarray, n_clusters: int, k_aff: float,
                        seed: int = 0, device="cuda") -> np.ndarray:
    """Labels (n,) int32. The eigenvectors of a repeated eigenvalue, and
    their signs, are not unique: compare partitions, not embeddings."""
    dev = resolve_device(device)
    a = affinity_matrix(
        torch.as_tensor(np.asarray(points, np.float32), device=dev), k_aff)
    d = a.sum(1)
    dm = 1.0 / torch.sqrt(torch.clamp_min(d, 1e-12))
    lap = dm[:, None] * a * dm[None, :]
    _, v = torch.linalg.eigh(lap)
    emb = v[:, -n_clusters:]
    # analysis: allow(private-distance): row-unit normalization of the spectral embedding, not a pairwise distance; the twin of the pragma at repro/core/baselines/spectral.py:21
    emb = emb / torch.clamp_min(torch.linalg.norm(emb, dim=1, keepdim=True),
                                1e-12)
    labels, _ = kmeans(emb.cpu().numpy(), n_clusters, seed=seed, device=dev)
    return labels
