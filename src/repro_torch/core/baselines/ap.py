"""Affinity Propagation (Frey & Dueck, Science'07): baseline.

Responsibility/availability message passing on the full similarity matrix;
O(n^2) memory and time per sweep (the paper's Fig. 6/7 show AP as the least
scalable baseline).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.alid import resolve_device
from repro_torch.kernels import ops


def _ap_iterate(s: torch.Tensor, max_iters: int = 200,
                damping: float = 0.7):
    n = s.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=s.device)
    r = torch.zeros_like(s)
    a = torch.zeros_like(s)
    for _ in range(max_iters):
        # responsibilities
        as_ = a + s
        first = as_.max(dim=1, keepdim=True).values
        arg = torch.argmax(as_, dim=1, keepdim=True)
        is_arg = torch.zeros_like(eye).scatter_(1, arg, True)
        second = torch.where(is_arg, float("-inf"), as_).max(
            dim=1, keepdim=True).values
        r_new = s - torch.where(is_arg, second, first)
        r = damping * r + (1 - damping) * r_new
        # availabilities
        rp = torch.where(eye, r, torch.clamp_min(r, 0.0))
        col = rp.sum(dim=0, keepdim=True) - rp
        a_new = torch.where(eye, col, torch.clamp_max(col, 0.0))
        a = damping * a + (1 - damping) * a_new
    return r, a


def median(v: torch.Tensor) -> torch.Tensor:
    """jnp.median of a flat tensor: the mean of the two middle order
    statistics for an even count ((lo + hi) * 0.5, its 'midpoint' rule;
    torch.median would take the lower one), NaN if any entry is NaN."""
    s = torch.sort(v).values
    n = s.numel()
    if bool(torch.isnan(s[-1])):
        return s[-1]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def affinity_propagation(points: np.ndarray, preference: float | None = None,
                         max_iters: int = 200, damping: float = 0.7,
                         device="cuda"):
    """Returns (labels (n,) int32, exemplars). Similarity = -||vi - vj||^2;
    the default preference is the median of the off-diagonal
    similarities."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    dist = ops.pairwise_distance(pts, pts)
    s = -(dist * dist)
    eye = torch.eye(s.shape[0], dtype=torch.bool, device=dev)
    pref = median(s[~eye]) if preference is None else preference
    s = torch.where(eye, pref, s)
    r, a = _ap_iterate(s, max_iters=max_iters, damping=damping)
    crit = torch.diagonal(r + a).cpu().numpy()
    exemplars = np.where(crit > 0)[0]
    if exemplars.size == 0:
        exemplars = np.asarray([int(np.argmax(crit))])
    sim_to_ex = s.cpu().numpy()[:, exemplars]
    labels = exemplars[np.argmax(sim_to_ex, axis=1)]
    labels[exemplars] = exemplars
    # relabel to 0..K-1
    uniq = {e: i for i, e in enumerate(sorted(set(labels.tolist())))}
    return np.asarray([uniq[int(l)] for l in labels], np.int32), exemplars
