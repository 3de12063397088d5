"""Localized Infection-Immunization Dynamics (LID), paper Sec. 4.1, Alg. 1.

The dynamic local range beta is a FIXED-CAPACITY buffer (cap = a_cap +
delta) with a validity mask, and every tensor carries the seed batch as its
leading dimension: the JAX package vmaps one seed's state, the port holds B
seeds as lanes. Every iteration:

  1. r_i = (A_beta,alpha x_alpha)_i - pi(x)            (Eq. 10)
  2. pick i* = argmax |r| over C1 u C2                 (Eq. 6)
  3. invasion share eps via Eq. 9/11/12
  4. x, Ax updated with ONE on-demand affinity column  (Eq. 13/14)

all of it fused into the `lid_sweep` kernel, several iterations a launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.affinity import affinity_column
from repro_torch.kernels import ops
from repro_torch.kernels.ref import pinned_sum


class LIDState(NamedTuple):
    beta_idx: torch.Tensor   # (B, cap) int32 global indices (-1 where ~mask)
    beta_mask: torch.Tensor  # (B, cap) bool
    v_beta: torch.Tensor     # (B, cap, d) gathered data items
    x: torch.Tensor          # (B, cap) simplex weights restricted to beta
    ax: torch.Tensor         # (B, cap) (A_beta,alpha x_alpha)
    n_iters: torch.Tensor    # (B,) int32 cumulative LID iterations
    converged: torch.Tensor  # (B,) bool


def _rebuild(tup, items):
    return type(tup)(*items) if hasattr(tup, "_fields") else tuple(items)


def take_lanes(tup, lanes: torch.Tensor):
    """The lanes `lanes` of a (Named)tuple of batched tensors."""
    return _rebuild(tup, (t[lanes] for t in tup))


def put_lanes(tup, lanes: torch.Tensor, sub):
    """A copy of `tup` with lanes `lanes` replaced by `sub`'s."""
    out = []
    for full, part in zip(tup, sub):
        full = full.clone()
        full[lanes] = part
        out.append(full)
    return _rebuild(tup, out)


def init_state_from(v_seed: torch.Tensor, seed_idx: torch.Tensor,
                    cap: int) -> LIDState:
    """Alg. 2 line 1 from gathered seed rows v_seed:(B, d): beta = {seed},
    x = s_seed, Ax = a_ii = 0."""
    bsz, d = v_seed.shape
    dev = v_seed.device
    beta_idx = torch.full((bsz, cap), -1, dtype=torch.int32, device=dev)
    beta_idx[:, 0] = seed_idx.to(torch.int32)
    beta_mask = torch.zeros((bsz, cap), dtype=torch.bool, device=dev)
    beta_mask[:, 0] = True
    v_beta = torch.zeros((bsz, cap, d), dtype=v_seed.dtype, device=dev)
    v_beta[:, 0] = v_seed
    x = torch.zeros((bsz, cap), dtype=torch.float32, device=dev)
    x[:, 0] = 1.0
    ax = torch.zeros((bsz, cap), dtype=torch.float32, device=dev)
    return LIDState(beta_idx, beta_mask, v_beta, x, ax,
                    torch.zeros(bsz, dtype=torch.int32, device=dev),
                    torch.zeros(bsz, dtype=torch.bool, device=dev))


def init_state(points: torch.Tensor, seed_idx: torch.Tensor,
               cap: int) -> LIDState:
    return init_state_from(points[seed_idx.long()], seed_idx, cap)


def lid_solve(state: LIDState, k: float, max_iters: int = 200,
              tol: float = 1e-5, p: float = 2.0, backend: str = "auto",
              sweep_steps: int = 8, refresh_every: int = 0,
              support_eps: float = 1e-6) -> LIDState:
    """Run LID to convergence within the (masked) local range of every lane.

    A loop over `ops.lid_sweep` chunks of up to `sweep_steps` fused
    iterations (one kernel launch each), which goes on while any lane has
    ~converged & n_iters < max_iters. The sweep's per-step guard is the same
    predicate, so a finished lane is left unchanged by later chunks and the
    chunk size changes nothing. `sweep_steps <= 0` means one sweep of
    `max_iters` steps."""
    n_steps = min(sweep_steps, max_iters) if sweep_steps > 0 else max_iters
    x, ax, it = state.x, state.ax, state.n_iters
    cv = torch.zeros_like(state.converged)
    while bool(((~cv) & (it < max_iters)).any()):
        x, ax, it, cv = ops.lid_sweep(
            state.v_beta, state.beta_idx, state.beta_mask, x, ax, it, cv, k,
            n_steps=n_steps, max_iters=max_iters, tol=tol, p=p,
            refresh_every=refresh_every, support_eps=support_eps,
            backend=backend)
    return state._replace(x=x, ax=ax, n_iters=it, converged=cv)


def lid_solve_unfused(state: LIDState, k: float, max_iters: int = 200,
                      tol: float = 1e-5, p: float = 2.0,
                      backend: str = "auto") -> LIDState:
    """The reference loop: one LID iteration per step, every lane checked
    on the host after each, the affinity column computed apart by
    `affinity_column` (the `affinity` kernel on the card). It is the
    bit-parity oracle of `lid_solve`'s fused sweeps: the same operations in
    the same order as `kernels.ref.lid_sweep_ref` (pi in the pinned order),
    so on equal inputs it gives `lid_solve`'s bits whatever its
    `sweep_steps`. Not called on any hot path.

    A lane whose step finds convergence, or whose guard ~converged &
    n_iters < max_iters is false, computes no column: its iteration stays
    O(cap), as the JAX package's `lax.cond` keeps it."""
    v_beta, idx, mask = state.v_beta, state.beta_idx, state.beta_mask
    x, ax = state.x.float().clone(), state.ax.float().clone()
    it = state.n_iters.to(torch.int32).clone()
    cv = torch.zeros_like(state.converged)
    lanes = torch.arange(x.shape[0], device=x.device)
    slot = torch.arange(x.shape[1], device=x.device)
    while True:
        live = (~cv) & (it < max_iters)
        if not bool(live.any()):
            break
        pi = pinned_sum(x * ax)
        r = torch.where(mask, ax - pi[:, None], 0.0)
        c1 = mask & (r > tol)
        c2 = mask & (r < -tol) & (x > 0.0)
        score = torch.where(c1 | c2, r.abs(), float("-inf"))
        i = torch.argmax(score, dim=-1)
        done = score[lanes, i] <= tol
        go = torch.nonzero(live & ~done)[:, 0]
        if go.numel():
            g = i[go]
            ri, xi, axi = r[go, g], x[go, g], ax[go, g]
            mu = torch.where(ri > 0.0, 1.0,
                             xi / torch.clamp_max(xi - 1.0, -1e-12))
            num = mu * ri
            den = mu * mu * (-2.0 * axi + pi[go])
            eps = torch.where(den < 0.0, torch.clamp_max(-num / den, 1.0),
                              1.0)
            scale = (eps * mu)[:, None]
            col = affinity_column(v_beta[go], idx[go], v_beta[go, g],
                                  idx[go, g], k, p, backend)
            col = torch.where(mask[go], col, 0.0)
            onehot = (slot[None, :] == g[:, None]).float()
            xg, axg = x[go], ax[go]
            x[go] = torch.clamp_min(xg + scale * (onehot - xg), 0.0)
            ax[go] = axg + scale * (col - axg)
        it = torch.where(live, it + 1, it)
        cv = torch.where(live, done, cv)
    return state._replace(x=x, ax=ax, n_iters=it, converged=cv)


def refresh_ax(state: LIDState, k: float, p: float = 2.0,
               support_eps: float = 1e-6,
               backend: str = "auto") -> LIDState:
    """Exactly recompute (A_beta,alpha x_alpha) from the support (kills the
    f32 drift of the incremental Eq. 14 updates): ONE fused masked matvec,
    the slot mask folded into the weights and a row select on the output."""
    w = torch.where(state.beta_mask & (state.x > support_eps), state.x, 0.0)
    ax = ops.affinity_matvec(state.v_beta, state.beta_idx, state.v_beta,
                             state.beta_idx, w, k, p, backend=backend)
    return state._replace(ax=torch.where(state.beta_mask, ax, 0.0))


def support_size(state: LIDState, support_eps: float = 1e-6) -> torch.Tensor:
    return (state.beta_mask & (state.x > support_eps)).sum(-1)


def density(state: LIDState) -> torch.Tensor:
    return (state.x * state.ax).sum(-1)
