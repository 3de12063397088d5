"""Replicator Dynamics: the Dominant Sets solver (Pavan & Pelillo,
TPAMI'07).

x_{t+1} = x_t * (A x_t) / (x_t^T A x_t). Each iteration is O(n^2); kept as
the paper's DS baseline. Converges to a local maximizer of pi(x) on the
simplex. The iterations run in chunks with one host check a chunk, as in
`core.iid`; `A x` is a plain matrix-vector product, as in the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.core.iid import StQPResult, _restrict, run_chunks


def replicator_solve(a: torch.Tensor, x0: torch.Tensor, max_iters: int = 2000,
                     tol: float = 1e-7, *, active: torch.Tensor | None = None,
                     chunk: int = 64, graphs: bool = True) -> StQPResult:
    """RD from x0 until sum |x' - x| <= tol or max_iters. `active` restricts
    the game as in `core.iid.iid_solve`: x0 must vanish off it, and A x is
    zeroed off it, which gives a * outer(active, active)'s bits. The
    iterations run in chunks (`core.iid.run_chunks`)."""
    x = x0.float().clone()
    t = torch.zeros((), dtype=torch.int32, device=x.device)
    delta = torch.ones((), dtype=torch.float32, device=x.device)

    def step():
        live = (delta > tol) & (t < max_iters)
        ax = _restrict(torch.mv(a, x), active)
        # analysis: allow(private-matmul): pi = x'Ax of the replicator step, the twin of `x @ ax` at repro/core/rd.py:27
        pi = torch.dot(x, ax)
        x_new = torch.where(pi > 0.0, x * ax / torch.clamp_min(pi, 1e-30), x)
        torch.where(live, (x_new - x).abs().sum(), delta, out=delta)
        torch.where(live, x_new, x, out=x)
        torch.add(t, live.to(torch.int32), out=t)

    run_chunks(step, x.device, max_iters, chunk, lambda: not bool(delta > tol),
               graphs)
    ax = _restrict(torch.mv(a, x), active)
    # analysis: allow(private-matmul): the density x'Ax, the twin of `x @ ax` at repro/core/rd.py:34
    return StQPResult(x=x, density=torch.dot(x, ax), n_iters=t,
                      converged=delta <= tol)
