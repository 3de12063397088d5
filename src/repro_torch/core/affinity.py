"""Laplacian-kernel affinity: a_ij = exp(-k * ||v_i - v_j||_p), zero
diagonal (paper Eq. 1). The distance itself exists once, in
`kernels.ref.pairwise_distance_ref`, reached through `kernels.ops`."""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ops


def pairwise_distance(q: torch.Tensor, c: torch.Tensor, p: float = 2.0,
                      backend: str = "auto") -> torch.Tensor:
    """||q_i - c_j||_p for q:(m, d), c:(n, d) -> (m, n) f32."""
    return ops.pairwise_distance(q, c, p, backend=backend)


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
