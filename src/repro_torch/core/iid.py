"""Infection-Immunization Dynamics (Rota Bulò et al., CVIU'11) on the FULL
affinity matrix: the paper's primary baseline (Sec. 3).

Solves  max_{x in simplex} pi(x) = x^T A x  by repeatedly invading x with
the vertex (or co-vertex) maximizing |pi(s_i - x, x)| (Eq. 6-9). Each
iteration is O(n) given A, but materializing A is O(n^2): exactly the
bottleneck ALID removes.

The JAX package runs the iterations in a `lax.while_loop`. Here they run in
chunks of `chunk` iterations with no host synchronisation inside a chunk
(on the card, one CUDA graph replay a chunk): once an iteration finds
convergence (or the budget is spent) the state is frozen, so the later
iterations of the chunk change nothing, and the host checks the flag once
a chunk. The chunk size changes no bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StQPResult(NamedTuple):
    x: torch.Tensor          # (n,) final simplex point
    density: torch.Tensor    # () pi(x)
    n_iters: torch.Tensor    # () int32
    converged: torch.Tensor  # () bool


def _select(x: torch.Tensor, r: torch.Tensor, tol: float):
    """M(x) of Eq. 6: strongest infective vertex or weakest support vertex;
    (index, its score) as (1,) tensors. A (1,) index gathers without the
    host synchronisation that indexing with a 0-d tensor costs. (The JAX
    package's `_select` also takes a mask, which `iid_solve` passes all
    True.)"""
    c1 = r > tol
    c2 = (r < -tol) & (x > 0.0)
    score = torch.where(c1 | c2, r.abs(), float("-inf"))
    i = torch.argmax(score, dim=0, keepdim=True)
    return i, score.index_select(0, i)


def _invade(x, ax, r, i, col, pi):
    """One invasion step shared by infection and immunization.

    mu = 1 for infection (y = s_i); mu = x_i/(x_i - 1) for immunization
    (y = co-vertex of s_i, Eq. 7/12). With a_ii = 0:
        pi(s_i - x)    = -2 (Ax)_i + pi(x)                         (Eq. 11)
        pi(y - x, x)   = mu * r_i
        pi(y - x)      = mu^2 * pi(s_i - x)                        (Eq. 12)
        eps            = min(-num/den, 1) if den < 0 else 1        (Eq. 9)
        x'             = x + eps*mu*(s_i - x)                      (Eq. 13)
        (Ax)'          = Ax + eps*mu*(A[:,i] - Ax)                 (Eq. 14)
    As in the JAX package, mu has no clamp (LID's has one).
    """
    ri, xi, axi = (v.index_select(0, i) for v in (r, x, ax))
    mu = torch.where(ri > 0.0, 1.0, xi / (xi - 1.0))
    num = mu * ri
    den = mu * mu * (-2.0 * axi + pi)
    eps = torch.where(den < 0.0, torch.clamp_max(-num / den, 1.0), 1.0)
    scale = eps * mu
    onehot = (torch.arange(x.shape[0], device=x.device) == i).float()
    x_new = x + scale * (onehot - x)
    ax_new = ax + scale * (col - ax)
    return torch.clamp_min(x_new, 0.0), ax_new


def _restrict(v: torch.Tensor, active) -> torch.Tensor:
    return v if active is None else torch.where(active, v, 0.0)


def run_chunks(step, device: torch.device, max_iters: int, chunk: int,
               finished, graphs: bool = True) -> None:
    """Call `step()` at most max_iters times, `chunk` calls between host
    checks `finished()`. A step rewrites the solver's state tensors in place
    and must change nothing once the solver has finished or spent its
    budget (a guard on the device), so that a chunk may run past the end.

    On the card with `graphs`, the first step runs eagerly on a side stream
    (warming up the libraries it calls) and the next `chunk` steps are
    captured once in a CUDA graph that each later chunk replays: the same
    kernels on the same tensors as the eager loop, so the same bits,
    without the host's per-operation cost, which would otherwise set the
    time of an iteration of small vector operations."""
    if device.type != "cuda" or not graphs:
        issued = 0
        while issued < max_iters:
            steps = min(chunk, max_iters - issued)
            for _ in range(steps):
                step()
            issued += steps
            if finished():
                return
        return
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        step()
    main.wait_stream(side)
    issued = 1
    if issued >= max_iters or finished():
        return
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(chunk):
            step()
    while issued < max_iters:
        graph.replay()
        issued += chunk
        if finished():
            return


def iid_solve(a: torch.Tensor, x0: torch.Tensor, max_iters: int = 1000,
              tol: float = 1e-5, *, active: torch.Tensor | None = None,
              chunk: int = 64, graphs: bool = True) -> StQPResult:
    """IID from x0 on the full matrix a (zero diagonal).

    `active` (n,) bool restricts the game to the active vertices, as if it
    ran on a * outer(active, active), without building that product: x0
    must vanish off `active`, Ax is zeroed off it, and the invading column
    a[:, i] is masked by it. For finite a this gives the masked matrix's
    bits (the products that meet x are the same, and a * 0 = +0).
    The iterations run in chunks of `chunk` (`run_chunks`).
    """
    x = x0.float().clone()
    ax = _restrict(torch.mv(a, x), active)
    t = torch.zeros((), dtype=torch.int32, device=x.device)
    done = torch.zeros((), dtype=torch.bool, device=x.device)

    def step():
        live = (~done) & (t < max_iters)
        # analysis: allow(private-matmul): pi = x'Ax of the StQP iterate, the twin of `x @ ax` at repro/core/iid.py:74
        pi = torch.dot(x, ax)
        r = ax - pi
        i, best = _select(x, r, tol)
        stop = (best <= tol)[0]
        col = _restrict(a.index_select(1, i)[:, 0], active)
        x_new, ax_new = _invade(x, ax, r, i, col, pi)
        upd = live & ~stop
        torch.where(upd, x_new, x, out=x)
        torch.where(upd, ax_new, ax, out=ax)
        torch.add(t, live.to(torch.int32), out=t)
        torch.where(live, stop, done, out=done)

    run_chunks(step, x.device, max_iters, chunk, lambda: bool(done), graphs)
    # analysis: allow(private-matmul): the density x'Ax, the twin of `x @ ax` at repro/core/iid.py:85
    return StQPResult(x=x, density=torch.dot(x, ax), n_iters=t,
                      converged=done)


def uniform_on(mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    return m / torch.clamp_min(m.sum(), 1.0)
