"""Candidate Infective Vertex Search, paper Sec. 4.3.

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

Two retrieval substrates sit behind the one `civs_update` signature:

  * replicated: `points`/`tables` are the full dataset + monolithic LSH;
  * sharded: `points` is a `core.store.ShardedStore` (`tables=None`),
    a `core.store.MeshStore` (the shards split over ranks, each routed
    shard broadcast from its owner), or the streamed engine
    (`engine.StreamedEngine`), which uploads one routed shard at a time.
    All go through `retrieve_shards`: the shards
    whose bounding ball can meet a lane's ROI ball are probed one after
    another, and each chunk is folded into a running top-delta buffer
    (`top_k` over [buffer ++ chunk]) by `retrieve_chunk`, with an explicit
    carry (`init_retrieval_carry` / `finalize_retrieval`): one function,
    so the streamed engine is exact by construction. One global probe
    budget (`pstable.shard_bucket_windows`) keeps the sample of an
    oversized bucket at min(bucket, probe), the replicated engine's.

The lanes run eagerly: a chunk step runs only on the lanes whose ROI
ball meets the shard, and a lane that does not meet it keeps its carry
(the JAX package's lax.cond under vmap, a select).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.lid import LIDState, put_lanes, take_lanes
from repro_torch.core.roi import ROI
from repro_torch.kernels import ops
from repro_torch.lsh.pstable import (LSHParams, LSHTables, hash_queries,
                                     probe_tables_window, query_batch)


# Conservative slack on a ball-intersection routing test (the shard
# routing here and in the streamed engine, and the online router's,
# `core.online`): centres and radii are rounded, so a point exactly on a
# ball's boundary must not be lost to rounding. Applied RELATIVE to the
# ball's scale (rounding is relative): over-admitting costs one extra
# probe or re-convergence, under-admitting breaks exactness.
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
    x = torch.cat([sup_x, torch.zeros_like(psi_valid, dtype=sup_x.dtype)],
                  dim=1)

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


# --------------------------------------------------- the shared chunk step --
def init_retrieval_carry(bsz: int, delta: int, d: int, device="cpu",
                         dtype=torch.float32):
    """Empty running top-delta candidate state of `bsz` lanes: (best_neg
    (B, delta), best_idx (B, delta), best_v (B, delta, d) in the point
    storage `dtype`, n_candidates (B,)). Fold shards in with
    `retrieve_chunk`; read the result off with `finalize_retrieval`."""
    return (torch.full((bsz, delta), float("-inf"), device=device),
            torch.full((bsz, delta), -1, dtype=torch.int64, device=device),
            torch.zeros((bsz, delta, d), dtype=dtype, device=device),
            torch.zeros((bsz,), dtype=torch.int64, device=device))


def retrieve_chunk(carry, pts_s, sk, pm, gmap, keys, starts, lo, hi,
                   roi_center, roi_radius, active, sup_idx, sup_slot_mask,
                   probe: int, p: float, backend: str = "auto"):
    """CIVS steps 2-4 for ONE shard, folded into the lanes' running
    top-delta carry: THE chunk step of the sharded and streamed engines
    (`retrieve_shards`), run on each shard they route.

    pts_s (cap_s, d) / sk, pm (L, cap_s) / gmap (cap_s,): one shard's
    points, sorted-key tables and slot -> global map. keys/starts/lo/hi
    (B, L, a_cap): the lanes' hashed support queries and this shard's
    slice of the global probe windows. roi_center (B, d), roi_radius (B,),
    sup_idx / sup_slot_mask (B, a_cap). Carry as in `init_retrieval_carry`.
    """
    best_neg, best_idx, best_v, n_cand = carry
    n = active.shape[0]
    shard_cap = pts_s.shape[0]
    bsz, n_tables, a_cap = keys.shape
    delta = best_neg.shape[1]

    def flat(t):                           # (B, L, a_cap) -> (L, B*a_cap)
        return t.permute(1, 0, 2).reshape(n_tables, bsz * a_cap)

    local = probe_tables_window(sk, pm, flat(keys), flat(starts), flat(lo),
                                flat(hi), probe).reshape(bsz, a_cap, -1)
    local = torch.where(sup_slot_mask[..., None], local, -1)
    flat_slots = local.reshape(bsz, -1)          # (B, a_cap * L * probe)
    # keep the hits only, in their order (a stable partition), padded with
    # -1 to the lanes' most: a miss can neither win the top-delta merge
    # nor count, and the dedup sort below orders the hits by global index
    # whatever their positions, so the merge is the full list's
    hit = flat_slots >= 0
    width = int(hit.sum(1).max())
    if width == 0:
        return carry
    order = torch.sort((~hit).to(torch.uint8), dim=1, stable=True).indices
    flat_slots = torch.gather(flat_slots, 1, order[:, :width])
    safe_slot = torch.clamp(flat_slots, 0, shard_cap - 1)
    gidx = torch.where(flat_slots >= 0, gmap[safe_slot], -1)
    vc = pts_s[safe_slot]

    safe_g = torch.clamp(gidx, 0, n - 1)
    valid = (gidx >= 0) & active[safe_g]
    member = ((safe_g[:, :, None] == sup_idx[:, None, :].long())
              & sup_slot_mask[:, None, :]).any(-1)
    valid &= ~member
    # fused ROI filter: distance to D, the radius + validity mask and the
    # -dist top-delta scores in one pass (neg is -inf exactly on ~valid)
    _, valid, neg0 = ops.roi_filter(vc, roi_center, roi_radius, valid, p,
                                    backend=backend)

    # within-chunk dedup (a point can surface from several tables); the
    # stable sort also fixes the order of exact-tie distances
    dkeys = torch.where(valid, safe_g, n)
    sg, order = torch.sort(dkeys, dim=-1, stable=True)
    uniq = torch.ones_like(valid)
    uniq[:, 1:] = sg[:, 1:] != sg[:, :-1]
    cvalid = uniq & (sg < n)
    n_cand = n_cand + cvalid.sum(-1)

    neg = torch.where(uniq, torch.gather(neg0, 1, order), float("-inf"))
    cand_idx = torch.where(cvalid, sg, -1)
    # streaming top-delta merge: buffer ++ chunk -> top_k. The candidate
    # rows ride along in the carry, so psi needs no gather at the end; only
    # the delta winning rows are gathered (from the carry or this chunk)
    best_neg, pos = top_k(torch.cat([best_neg, neg], dim=1), delta)
    best_idx = torch.gather(torch.cat([best_idx, cand_idx], dim=1), 1, pos)
    from_chunk = pos >= delta
    row = torch.gather(order, 1, torch.clamp_min(pos - delta, 0))
    d = vc.shape[-1]
    chunk_v = torch.gather(vc, 1, row[..., None].expand(-1, -1, d))
    carry_v = torch.gather(best_v, 1, torch.clamp_max(pos, delta - 1)
                           [..., None].expand(-1, -1, d))
    best_v = torch.where(from_chunk[..., None], chunk_v, carry_v)
    return best_neg, best_idx, best_v, n_cand


def finalize_retrieval(carry):
    """(psi_idx, psi_valid, psi_v, n_candidates) off a finished carry."""
    best_neg, best_idx, best_v, n_candidates = carry
    psi_valid = best_neg > float("-inf")
    psi_idx = torch.where(psi_valid, best_idx, -1)
    psi_v = torch.where(psi_valid[..., None], best_v, 0.0)
    return psi_idx.to(torch.int32), psi_valid, psi_v, n_candidates


def retrieve_lanes(carry, lanes: torch.Tensor, pts_s, sk, pm, gmap, keys,
                   starts, lo, hi, roi: ROI, active, sup_idx, sup_slot_mask,
                   probe: int, p: float, backend: str = "auto"):
    """`retrieve_chunk` on the lanes `lanes` only (those whose ROI ball
    meets the shard); every other lane keeps its carry. keys, starts, lo,
    hi and the support arguments are the full batch's."""
    new = retrieve_chunk(
        take_lanes(carry, lanes), pts_s, sk, pm, gmap, keys[lanes],
        starts[lanes], lo[lanes], hi[lanes], roi.center[lanes],
        roi.radius[lanes], active, sup_idx[lanes], sup_slot_mask[lanes],
        probe=probe, p=p, backend=backend)
    return put_lanes(carry, lanes, new)


def route_shards(roi: ROI, centers: np.ndarray, radii: np.ndarray,
                 p: float) -> np.ndarray:
    """(B, S) host bool: lane b's ROI ball can meet shard s's bounding ball,
    in f64 with `_ROUTE_EPS` of slack. Exact by the triangle inequality: a
    shard whose ball the ROI ball misses holds no point inside the ROI.
    Every shard for p != 2 (the radii are Euclidean)."""
    b = roi.radius.shape[0]
    if p != 2.0:
        return np.ones((b, centers.shape[0]), bool)
    cen = roi.center.double().cpu().numpy()                  # (B, d)
    rad = roi.radius.double().cpu().numpy()                  # (B,)
    dist = np.sqrt(((cen[:, None, :] - centers[None]) ** 2).sum(-1))
    reach = rad[:, None] + radii[None]
    return dist <= reach + _ROUTE_EPS * (1.0 + reach)


def retrieve_shards(roi: ROI, substrate, active, lsh_params: LSHParams,
                    sup_idx, sup_v, sup_slot_mask, delta: int, p: float,
                    backend: str = "auto"):
    """Steps 2-4 out of core: fold the routed shards into a running
    top-delta carry. `substrate` is a `core.store.ShardedStore`, a
    `core.store.MeshStore` or the streamed engine; each gives its LSH
    projections (`proj`, `bias`), its shard balls in f64 (`balls()`), the
    shards to route (`routed`: those some lane's ROI ball meets; on the
    mesh store the union over the ranks), the global probe windows of the
    routed shards (`windows`: carved over ALL shards on the sharded and
    mesh stores, over the routed ones on the streamed engine, as the JAX
    package carves them) and the routed shards' tensors in routed order
    (`stream`). A shard is probed only for the lanes whose ROI ball can
    meet its ball; the other lanes keep their carry."""
    bsz, a_cap, d = sup_v.shape
    dev = sup_v.device
    n_tables = lsh_params.n_tables
    keys, salts = hash_queries(sup_v.reshape(bsz * a_cap, d), substrate.proj,
                               substrate.bias, lsh_params.seg_len,
                               backend)                  # (L, B*a_cap)
    touch = route_shards(roi, *substrate.balls(), p)
    routed = substrate.routed(touch)
    carry = init_retrieval_carry(bsz, delta, d, dev, sup_v.dtype)
    if routed.size == 0:
        return finalize_retrieval(carry)
    starts, lo, hi = substrate.windows(keys, salts, routed, lsh_params.probe)

    def lanes_of(t):                   # (..., L, B*a_cap) -> (..., B, L, a_cap)
        t = t.reshape(*t.shape[:-2], n_tables, bsz, a_cap)
        return t.transpose(-3, -2)

    keys, starts, lo, hi = (lanes_of(t) for t in (keys, starts, lo, hi))
    for pos, s, (pts_s, sk, pm, gmap) in substrate.stream(routed):
        lanes = torch.as_tensor(np.flatnonzero(touch[:, s]), device=dev)
        if lanes.numel() == 0:        # routed for another rank's lanes
            continue
        carry = retrieve_lanes(
            carry, lanes, pts_s, sk, pm, gmap, keys, starts[pos], lo[pos],
            hi[pos], roi, active, sup_idx, sup_slot_mask,
            probe=lsh_params.probe, p=p, backend=backend)
    return finalize_retrieval(carry)


def civs_update(state: LIDState, roi: ROI, points,
                active: torch.Tensor, tables: LSHTables | None,
                lsh_params: LSHParams, k: float, a_cap: int, delta: int,
                tol: float = 1e-5, support_eps: float = 1e-6, p: float = 2.0,
                backend: str = "auto") -> CIVSResult:
    cap = a_cap + delta
    if state.x.shape[-1] != cap:
        raise ValueError(f"state capacity {state.x.shape[-1]} != a_cap + "
                         f"delta = {cap}")
    sup_idx, sup_v, sup_x, sup_slot_mask, overflow = compact_support(
        state, a_cap, support_eps)
    if isinstance(points, torch.Tensor):
        psi_idx, psi_valid, psi_v, n_candidates = _retrieve_replicated(
            roi, points, active, tables, lsh_params, sup_idx, sup_v,
            sup_slot_mask, delta, p, backend)
    else:                    # a ShardedStore or the streamed engine
        psi_idx, psi_valid, psi_v, n_candidates = retrieve_shards(
            roi, points, active, lsh_params, sup_idx, sup_v, sup_slot_mask,
            delta, p, backend)
    return rebuild_support(state, sup_idx, sup_v, sup_x, sup_slot_mask,
                           psi_idx, psi_valid, psi_v, k, a_cap, tol, p,
                           n_candidates, overflow, backend)
