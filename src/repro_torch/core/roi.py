"""Region of Interest, paper Sec. 4.2, Eq. 15/16 and Prop. 1.

Double-deck hyperball H(D, R_in, R_out) around the support centroid: every
point strictly inside R_in is guaranteed infective, every point outside R_out
is guaranteed non-infective. The ROI radius grows from R_in to R_out with
the shifted logistic theta(c) = 1 / (1 + e^{4 - c/2}). Batched over seeds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops


class ROI(NamedTuple):
    center: torch.Tensor   # (B, d)
    radius: torch.Tensor   # (B,)
    r_in: torch.Tensor     # (B,)
    r_out: torch.Tensor    # (B,)
    pi: torch.Tensor       # (B,) density pi(x_hat), recomputed exactly


_EXP_CLAMP = 60.0


def theta(c: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(4.0 - 0.5 * c.float()))


def estimate_roi(v_beta, beta_idx, beta_mask, x, k: float, c: torch.Tensor,
                 r0: float = 0.4, p: float = 2.0, support_eps: float = 1e-6,
                 backend: str = "auto") -> ROI:
    """v_beta:(B, cap, d), beta_idx/beta_mask/x:(B, cap), c:(B,) outer
    iteration counts -> the ROI of every lane."""
    w = torch.where(beta_mask & (x > support_eps), x, 0.0)
    wsum = torch.clamp_min(w.sum(-1), 1e-12)
    w = w / wsum[:, None]

    center = torch.einsum("bc,bcd->bd", w, v_beta.float())  # D = sum x_i v_i

    # pi(x_hat) = w^T A w over the support block: the inner A w is the fused
    # masked matvec, off-support columns contribute nothing (w is 0 there)
    aw = ops.affinity_matvec(v_beta, beta_idx, v_beta, beta_idx, w, k, p,
                             backend=backend)
    pi = torch.clamp_min((w * aw).sum(-1), 1e-12)

    dist = ops.pairwise_distance(v_beta, center[:, None, :], p,
                                 backend=backend)[..., 0]

    kd = k * dist
    lam_in = (w * torch.exp(-torch.clamp_max(kd, _EXP_CLAMP))).sum(-1)
    lam_out = (w * torch.exp(torch.clamp_max(kd, _EXP_CLAMP))).sum(-1)
    r_in = torch.log(torch.clamp_min(lam_in / pi, 1e-12)) / k
    r_out = torch.log(torch.clamp_min(lam_out / pi, 1e-12)) / k
    r_in = torch.clamp_min(r_in, 0.0)
    r_out = torch.maximum(r_out, r_in)

    radius = r_in + theta(c) * (r_out - r_in)
    # Alg. 2: the very first iteration has Ax = 0, so the radii are
    # undefined; the paper fixes R = r0 (0.4) for c == 1
    radius = torch.where(c <= 1, torch.tensor(r0, dtype=radius.dtype,
                                              device=radius.device), radius)
    return ROI(center=center, radius=radius, r_in=r_in, r_out=r_out, pi=pi)
