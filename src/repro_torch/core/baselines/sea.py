"""Shrinking-Expansion Algorithm (Liu, Latecki & Yan, TPAMI'13): baseline.

SEA restricts replicator dynamics to a small evolving subgraph of a SPARSE
affinity graph: run RD on the current local set (shrink: RD zeroes weak
vertices), then expand by the graph neighbours of the surviving support.
Complexity is linear in the number of sparse edges; detection quality
depends on the enforced sparsity, exactly the trade-off the paper studies in
Fig. 6.

The sparse graph is a kNN graph (fixed degree). The transpose half of the
sparse product is a scatter-add; it goes through `ops.segment_matmul`,
which adds each target's terms in input order (on the card too, where an
`index_add_` would add them with atomics in no fixed order), so SEA gives
the same bits from run to run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.alid import resolve_device
from repro_torch.core.peeling import PeelResult
from repro_torch.kernels import ops


class SparseGraph(NamedTuple):
    nbr_idx: torch.Tensor   # (n, deg) int64 neighbour indices
    nbr_aff: torch.Tensor   # (n, deg) affinities (0 where invalid/self)


def build_knn_graph(points: torch.Tensor, k_aff: float, deg: int,
                    block: int = 512, p: float = 2.0) -> SparseGraph:
    """Exact kNN graph by blocked scan (O(n^2 d) time, O(n deg) memory).
    Equal distances go to the lower index, as `jax.lax.top_k` breaks its
    ties (torch.topk promises no order): a stable ascending sort."""
    n = points.shape[0]
    cols = torch.arange(n, device=points.device)
    idxs, affs = [], []
    for start in range(0, n, block):
        q = points[start:start + block]
        dist = ops.pairwise_distance(q, points, p)
        rows = start + torch.arange(q.shape[0], device=points.device)
        dist = torch.where(rows[:, None] == cols[None, :], float("inf"),
                           dist)
        near, idx = torch.sort(dist, dim=1, stable=True)
        idxs.append(idx[:, :deg])
        affs.append(torch.exp(-k_aff * near[:, :deg]))
    return SparseGraph(torch.cat(idxs), torch.cat(affs))


def _spmv(g: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    """(A x)_i = sum_j aff_ij x_j over the kNN edges, symmetrized by max
    with the transpose part (x_i aff_ij scattered into j)."""
    contrib = (g.nbr_aff * x[g.nbr_idx]).sum(1)
    back = ops.segment_matmul((g.nbr_aff * x[:, None]).reshape(-1, 1),
                              g.nbr_idx.reshape(-1), x.shape[0])[:, 0]
    return torch.maximum(contrib, back)


def _rd_steps(g: SparseGraph, x: torch.Tensor, steps: int) -> torch.Tensor:
    for _ in range(steps):
        ax = _spmv(g, x)
        # analysis: allow(private-matmul): pi = x'Ax of SEA's replicator step, the twin of `x @ ax` at repro/core/baselines/sea.py:77
        pi = torch.dot(x, ax)
        x = torch.where(pi > 0, x * ax / torch.clamp_min(pi, 1e-30), x)
    return x


def _sea_from_seed(g: SparseGraph, seed: int, active: torch.Tensor,
                   rd_iters: int = 50, expand_iters: int = 8,
                   support_eps: float = 1e-6):
    """One SEA run: local RD + neighbour expansion, dense x over n (the
    reference form: the sparse bookkeeping of the original is irrelevant
    to the quality comparison). Returns (x, density)."""
    n = g.nbr_idx.shape[0]
    x = torch.zeros((n,), dtype=torch.float32, device=active.device)
    x[seed] = 1.0
    # initial support = seed + its neighbours; the kNN ids of one row are
    # distinct (one sort of the row), so no two terms meet in one entry
    # and the sum has no order to fix
    x = x.index_add(0, g.nbr_idx[seed], (g.nbr_aff[seed] > 0).float())
    x = torch.where(active, x, 0.0)
    x = x / torch.clamp_min(x.sum(), 1e-12)
    flat = g.nbr_idx.reshape(-1)
    for _ in range(expand_iters):
        x = _rd_steps(g, x, rd_iters)
        # expansion: add neighbours of the support
        sup = x > support_eps
        grow = torch.zeros((n,), dtype=torch.bool, device=x.device)
        grow[flat[sup.repeat_interleave(g.nbr_idx.shape[1])]] = True
        newx = torch.where(sup, x, torch.where(grow & active,
                                               support_eps * 10, 0.0))
        x = newx / torch.clamp_min(newx.sum(), 1e-12)
    x = _rd_steps(g, x, rd_iters * 2)
    # analysis: allow(private-matmul): the density x'Ax, the twin of `x @ ax` at repro/core/baselines/sea.py:98
    return x, torch.dot(x, _spmv(g, x))


def sea_detect(points: np.ndarray, k_aff: float, deg: int = 16,
               max_clusters: int = 64, density_min: float = 0.75,
               support_eps: float = 1e-6, device="cuda") -> PeelResult:
    """SEA with peeling over seeds (highest-degree-affinity first)."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    g = build_knn_graph(pts, k_aff, deg)
    n = pts.shape[0]
    strength = g.nbr_aff.sum(1).cpu().numpy()
    active = np.ones((n,), bool)
    labels = np.full((n,), -1, np.int32)
    densities: list[float] = []
    lab = 0
    for rounds in range(1, max_clusters + 1):
        if not active.any():
            break
        cand = np.where(active)[0]
        seed = int(cand[np.argmax(strength[cand])])
        x, dens = _sea_from_seed(g, seed, torch.as_tensor(active, device=dev))
        sup = (x > support_eps).cpu().numpy() & active
        if sup.sum() == 0:
            active[seed] = False
            continue
        if float(dens) >= density_min and sup.sum() > 1:
            labels[sup] = lab
            densities.append(float(dens))
            lab += 1
        active &= ~sup
        active[seed] = False
        if float(dens) < 0.2:
            break
    return PeelResult(labels, np.asarray(densities, np.float32), rounds)
