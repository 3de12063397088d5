"""Shared full-affinity-matrix peeling driver for the paper's baselines
(DS/RD, IID). Peels one dense subgraph per round (Sec. 4.4): solve the StQP
on the active subgraph, extract the support, deactivate it, repeat.

O(n^2) time and space by construction: these exist to reproduce the
paper's baseline comparisons (Figs. 6, 7, 9, 11), not to scale. The JAX
package hands its solver a * outer(active, active) every round, an n x n
mask and an n x n product on top of the matrix (8 GB at n = 40,000); here
the solver takes the active set and restricts the game itself, with the
same bits (`core.iid.iid_solve`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.iid import StQPResult, iid_solve, uniform_on
from repro_torch.core.rd import replicator_solve


class PeelResult(NamedTuple):
    labels: np.ndarray
    densities: np.ndarray
    n_rounds: int


def peel_full_matrix(
    a: torch.Tensor,
    solver: Callable[..., StQPResult],
    max_clusters: int = 64,
    density_min: float = 0.75,
    support_eps: float = 1e-6,
    stop_density: float = 0.3,
    max_iters: int = 3000,
) -> PeelResult:
    """Peeling on a precomputed affinity matrix (zero diagonal), on the
    matrix's device. `solver(a, x0, max_iters=..., active=...)` is
    `iid_solve`, `replicator_solve` or one with their signature."""
    n = a.shape[0]
    active = np.ones((n,), bool)
    labels = np.full((n,), -1, np.int32)
    densities: list[float] = []
    lab = 0
    rounds = 0
    while active.any() and rounds < max_clusters:
        rounds += 1
        act = torch.as_tensor(active, device=a.device)
        res = solver(a, uniform_on(act), max_iters=max_iters, active=act)
        sup = (res.x > support_eps).cpu().numpy() & active
        if sup.sum() == 0:
            break
        dens = float(res.density)
        if dens >= density_min and sup.sum() > 1:
            labels[sup] = lab
            densities.append(dens)
            lab += 1
        active &= ~sup
        if dens < stop_density:
            # remaining graph has no cohesive structure; the rest is noise
            break
    return PeelResult(labels, np.asarray(densities, np.float32), rounds)


def ds_detect(a: torch.Tensor, **kw) -> PeelResult:
    """Dominant Sets = replicator dynamics peeling (Pavan & Pelillo)."""
    return peel_full_matrix(a, replicator_solve, **kw)


def iid_detect(a: torch.Tensor, **kw) -> PeelResult:
    """Full-matrix IID peeling (Rota Bulò et al.)."""
    return peel_full_matrix(a, iid_solve, **kw)
