"""Candidate Infective Vertex Search, paper Sec. 4.3, replicated engine.

Queries LSH from EVERY support point of x_hat (several locality-sensitive
regions jointly cover the ROI, Fig. 4b), filters the candidates to the ROI
ball, keeps the <= delta nearest to the center D, and rebuilds the
fixed-capacity LID buffers as beta' = alpha u psi with an EXACT refresh of
(A_beta,alpha x_alpha) (Eq. 17).

Fixed-shape realization, batched over seeds: the support is compacted into
the first `a_cap` slots (heaviest first; an overflow beyond a_cap drops the
lightest members and raises `overflow`), psi occupies the trailing `delta`
slots. Dedup is sort-based. `jax.lax.top_k` ranks ties toward the lower
index and `jnp.argsort` is stable, so both become stable sorts here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.lid import LIDState
from repro_torch.core.roi import ROI
from repro_torch.kernels import ops
from repro_torch.lsh.pstable import LSHParams, LSHTables, query_batch


# Conservative slack on a ball-intersection routing test (the online
# router's, `core.online`): centres and radii are f32, so a point exactly on
# a ball's boundary must not be lost to rounding. Applied RELATIVE to the
# ball's scale (f32 rounding is relative): over-admitting costs one extra
# re-convergence, under-admitting breaks exactness.
_ROUTE_EPS = 1e-4


class CIVSResult(NamedTuple):
    state: LIDState
    infective_found: torch.Tensor  # (B,) bool: some psi vertex is infective
    n_candidates: torch.Tensor     # (B,) post-filter candidate count
    overflow: torch.Tensor         # (B,) bool: support exceeded a_cap


def top_k(scores: torch.Tensor, k: int):
    """`jax.lax.top_k` along the last dim: descending, ties -> lower index."""
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def compact_support(state: LIDState, a_cap: int, support_eps: float):
    """Step 1: compact the support into the first a_cap slots (weight desc)."""
    w = torch.where(state.beta_mask, state.x, 0.0)
    n_sup_total = (w > support_eps).sum(-1)
    order = torch.argsort(-w, dim=-1, stable=True)[:, :a_cap]
    sup_idx = torch.gather(state.beta_idx, 1, order)
    sup_v = torch.gather(state.v_beta, 1, order[..., None].expand(
        -1, -1, state.v_beta.shape[-1]))
    sup_x = torch.gather(w, 1, order)
    n_sup = torch.clamp_max(n_sup_total, a_cap)
    slot = torch.arange(a_cap, device=w.device)
    sup_slot_mask = (slot[None, :] < n_sup[:, None]) & (sup_x > support_eps)
    sup_x = torch.where(sup_slot_mask, sup_x, 0.0)
    sup_x = sup_x / torch.clamp_min(sup_x.sum(-1), 1e-12)[:, None]
    overflow = n_sup_total > a_cap
    return sup_idx, sup_v, sup_x, sup_slot_mask, overflow


def rebuild_support(state: LIDState, sup_idx, sup_v, sup_x, sup_slot_mask,
                    psi_idx, psi_valid, psi_v, k: float, a_cap: int,
                    tol: float, p: float, n_candidates, overflow,
                    backend: str = "auto") -> CIVSResult:
    """Step 5: beta' = alpha u psi with the exact Ax refresh (Eq. 17), ONE
    fused masked affinity x weights matvec against the support."""
    beta_idx = torch.cat([sup_idx, psi_idx], dim=1).to(torch.int32)
    beta_mask = torch.cat([sup_slot_mask, psi_valid], dim=1)
    v_beta = torch.cat([sup_v, psi_v], dim=1)
    x = torch.cat([sup_x, torch.zeros_like(psi_v[..., 0])], dim=1)

    ax = ops.affinity_matvec(v_beta, beta_idx, sup_v, sup_idx, sup_x, k, p,
                             backend=backend)
    ax = torch.where(beta_mask, ax, 0.0)

    pi = (x * ax).sum(-1)
    infective = (psi_valid & (ax[:, a_cap:] - pi[:, None] > tol)).any(-1)

    new_state = LIDState(beta_idx=beta_idx, beta_mask=beta_mask,
                         v_beta=v_beta, x=x, ax=ax, n_iters=state.n_iters,
                         converged=torch.zeros_like(state.converged))
    return CIVSResult(state=new_state, infective_found=infective,
                      n_candidates=n_candidates, overflow=overflow)


def _retrieve_replicated(roi: ROI, points, active, tables: LSHTables,
                         lsh_params: LSHParams, sup_idx, sup_v,
                         sup_slot_mask, delta: int, p: float,
                         backend: str = "auto"):
    """Steps 2-4 against the full dataset + monolithic LSH tables."""
    n = points.shape[0]
    bsz, a_cap, d = sup_v.shape
    cands = query_batch(tables, sup_v.reshape(bsz * a_cap, d), lsh_params,
                        backend=backend).reshape(bsz, a_cap, -1)
    cands = torch.where(sup_slot_mask[..., None], cands, -1)
    flat = cands.reshape(bsz, -1)                     # (B, a_cap*L*probe)

    safe = torch.clamp(flat, 0, n - 1)
    valid = (flat >= 0) & active[safe]
    # not already a support member
    member = ((safe[:, :, None] == sup_idx[:, None, :].long())
              & sup_slot_mask[:, None, :]).any(-1)
    valid &= ~member

    # sort-based dedup: invalid entries become the sentinel n (sorts last)
    skeys = torch.sort(torch.where(valid, safe, n), dim=-1).values
    uniq = torch.ones_like(valid)
    uniq[:, 1:] = skeys[:, 1:] != skeys[:, :-1]
    cvalid = uniq & (skeys < n)
    cidx = torch.clamp(skeys, 0, n - 1)

    # ROI filter + the delta nearest to D: distance, radius/validity mask and
    # the -dist scores come out of ONE fused pass
    vc = points[cidx]
    _, cvalid, neg = ops.roi_filter(vc, roi.center, roi.radius, cvalid, p,
                                    backend=backend)
    n_candidates = cvalid.sum(-1)

    top_vals, top_pos = top_k(neg, delta)
    psi_valid = top_vals > float("-inf")
    psi_idx = torch.where(psi_valid, torch.gather(cidx, 1, top_pos), -1)
    psi_v = points[torch.clamp(psi_idx, 0, n - 1)]
    psi_v = torch.where(psi_valid[..., None], psi_v, 0.0)
    return psi_idx.to(torch.int32), psi_valid, psi_v, n_candidates


def civs_update(state: LIDState, roi: ROI, points: torch.Tensor,
                active: torch.Tensor, tables: LSHTables,
                lsh_params: LSHParams, k: float, a_cap: int, delta: int,
                tol: float = 1e-5, support_eps: float = 1e-6, p: float = 2.0,
                backend: str = "auto") -> CIVSResult:
    cap = a_cap + delta
    if state.x.shape[-1] != cap:
        raise ValueError(f"state capacity {state.x.shape[-1]} != a_cap + "
                         f"delta = {cap}")
    sup_idx, sup_v, sup_x, sup_slot_mask, overflow = compact_support(
        state, a_cap, support_eps)
    psi_idx, psi_valid, psi_v, n_candidates = _retrieve_replicated(
        roi, points, active, tables, lsh_params, sup_idx, sup_v,
        sup_slot_mask, delta, p, backend)
    return rebuild_support(state, sup_idx, sup_v, sup_x, sup_slot_mask,
                           psi_idx, psi_valid, psi_v, k, a_cap, tol, p,
                           n_candidates, overflow, backend)
