"""Mean shift (Comaniciu & Meer, TPAMI'02) with a Gaussian kernel: the
feature-space baseline discussed in Sec. 2 / Appendix C."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.alid import resolve_device
from repro_torch.kernels import ops


def _shift(points: torch.Tensor, bandwidth: float, max_iters: int = 50):
    modes = points
    for _ in range(max_iters):
        dist = ops.pairwise_distance(modes, points)
        w = torch.exp(-(dist * dist) / (2.0 * bandwidth ** 2))
        num = w @ points
        den = torch.clamp_min(w.sum(1, keepdim=True), 1e-12)
        modes = num / den
    return modes


def mean_shift(points: np.ndarray, bandwidth: float,
               merge_radius: float | None = None, max_iters: int = 50,
               min_members: int = 2, device="cuda"):
    """(labels (n,) int32 with -1 for clusters under min_members,
    centers)."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    modes_t = _shift(pts, bandwidth, max_iters)
    modes = modes_t.cpu().numpy()
    merge_radius = bandwidth if merge_radius is None else merge_radius
    labels = np.full(len(points), -1, np.int32)
    # one mode-to-mode distance pass, then a host merge over the matrix
    mm = ops.pairwise_distance(modes_t, modes_t).cpu().numpy()
    center_idx: list[int] = []
    centers: list[np.ndarray] = []
    for i, m in enumerate(modes):
        for ci, c_i in enumerate(center_idx):
            if mm[i, c_i] < merge_radius:
                labels[i] = ci
                break
        else:
            center_idx.append(i)
            centers.append(m)
            labels[i] = len(centers) - 1
    # drop tiny clusters to noise
    for ci in range(len(centers)):
        if (labels == ci).sum() < min_members:
            labels[labels == ci] = -1
    return labels, (np.asarray(centers) if centers
                    else np.zeros((0, points.shape[1])))
