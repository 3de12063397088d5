"""Laplacian-kernel affinity: a_ij = exp(-k * ||v_i - v_j||_p), zero
diagonal (paper Eq. 1). The distance itself exists once, in
`kernels.ref.pairwise_distance_ref`, and the affinity once, in the
`affinity` kernel and its plain version, both reached through
`kernels.ops`."""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ops


def pairwise_distance(q: torch.Tensor, c: torch.Tensor, p: float = 2.0,
                      backend: str = "auto") -> torch.Tensor:
    """||q_i - c_j||_p for q:(m, d), c:(n, d) -> (m, n) f32."""
    return ops.pairwise_distance(q, c, p, backend=backend)


def affinity_block(q: torch.Tensor, c: torch.Tensor, k: float,
                   p: float = 2.0, backend: str = "auto") -> torch.Tensor:
    """exp(-k * ||q_i - c_j||_p) for blocks q:(..., m, d), c:(..., n, d),
    WITHOUT diagonal zeroing."""
    return ops.affinity(q, c, k, p, backend=backend)


def affinity_matrix(v: torch.Tensor, k: float, p: float = 2.0,
                    backend: str = "auto") -> torch.Tensor:
    """Full (n, n) affinity matrix with zero diagonal (the full-matrix
    baselines only: O(n^2)).

    The diagonal is zeroed in place, where the JAX package multiplies by
    1 - eye: no second n x n tensor is built (6.4 GB at n = 40,000). For
    finite affinities the two are bitwise the same (a * 1 = a, a * 0 = +0
    for a >= 0); a NaN on the diagonal becomes 0 here and stays NaN there.
    """
    a = affinity_block(v, v, k, p, backend)
    a.diagonal(dim1=-2, dim2=-1).zero_()
    return a


def affinity_column(v_beta: torch.Tensor, beta_idx: torch.Tensor,
                    v_i: torch.Tensor, i, k: float, p: float = 2.0,
                    backend: str = "auto") -> torch.Tensor:
    """A[beta, i]: the affinity of one vertex v_i:(..., d) against the local
    range v_beta:(..., cap, d) -> (..., cap), one column per leading index.

    Zeroes the self entry (a_ii = 0) by comparing global indices
    beta_idx:(..., cap) with i:(...), which also handles duplicate
    occurrences defensively."""
    col = affinity_block(v_beta, v_i.unsqueeze(-2), k, p, backend)[..., 0]
    i = torch.as_tensor(i, device=beta_idx.device)
    return torch.where(beta_idx == i.unsqueeze(-1), 0.0, col)


def estimate_k(v: torch.Tensor, sample: int = 512, target: float = 0.95,
               percentile: float = 10.0, backend: str = "auto") -> float:
    """The Laplacian scale k for which a CLUSTER-SCALE nearest-neighbour
    pair has affinity ~= target: k = log(1/target) / (the `percentile`-th
    percentile of NN distances over a strided subsample). Returned as the
    f32 value (a Python float) that every op of the fit then uses."""
    n = v.shape[0]
    m = min(sample, n)
    rows = torch.as_tensor((np.arange(m, dtype=np.int64) * n) // m,
                           device=v.device)
    s = v[rows]
    d = pairwise_distance(s, s, 2.0, backend)
    d = d + torch.where(torch.eye(m, dtype=torch.bool, device=v.device),
                        float("inf"), 0.0)
    nn = d.min(dim=1).values
    # jnp.percentile's default is linear interpolation, as torch.quantile's
    ref = torch.quantile(nn, percentile / 100.0, interpolation="linear")
    num = torch.tensor(math.log(1.0 / target), dtype=torch.float32)
    return float(num / torch.clamp_min(ref.cpu(), 1e-12))
