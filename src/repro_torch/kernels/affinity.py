"""CUDA wrapper of the blocked affinity kernels (`csrc/affinity.cu`), which
replace the TPU kernel `affinity_pallas` of the JAX package, and their
plan."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import f32, require_cuda

# dynamic shared memory one Hopper block may opt into: 227 KB less a
# margin for the kernel's static shared variables
SMEM_MAX = 232448 - 256
TILES = (64, 32, 16)  # rows and columns of a tile, largest first


class Plan(NamedTuple):
    route: str   # "symmetric" (q is c: tiles I <= J, mirrored) or "general"
    tile: int    # rows and columns of a tile
    stages: int  # 2: the next tile is copied while this one is computed
    ng: int      # float4 groups of a leaf: ceil(d / 128)
    ld: int      # floats of a packed (leaf-major) row: 128 ng + 4
    smem: int    # dynamic shared bytes of the tile kernel
    tiles: int   # tiles of one batch entry the kernel computes


def plan(m: int, n: int, d: int, same: bool) -> Plan:
    """The tile kernel's plan for (m, d) x (n, d): the largest tile (and two
    stages before one) whose stages and result fit in shared memory. The
    bytes are the layout carved in `tiles_kernel`: per stage the tile's
    packed rows and columns (ld floats each) and their norms, then the
    (tile, tile + 1) results. `same` (q and c one tensor) takes the
    symmetric route, which computes the tiles I <= J only."""
    if min(m, n, d) < 1:
        raise ValueError(f"affinity: no plan for m={m} n={n} d={d}")
    ng = -(-d // 128)
    ld = 128 * ng + 4
    sym = same and m == n
    for tile in TILES:
        for stages in (2, 1):
            smem = 4 * (stages * (2 * tile * ld + 2 * tile)
                        + tile * (tile + 1))
            if smem <= SMEM_MAX:
                ti, tj = -(-m // tile), -(-n // tile)
                return Plan("symmetric" if sym else "general", tile, stages,
                            ng, ld, smem,
                            ti * (ti + 1) // 2 if sym else ti * tj)
    raise ValueError(f"affinity: d={d} does not fit a {TILES[-1]}-row tile "
                     f"in {SMEM_MAX} bytes of shared memory")


def _same(q: torch.Tensor, c: torch.Tensor) -> bool:
    return (q.data_ptr() == c.data_ptr() and q.shape == c.shape
            and q.stride() == c.stride())


def affinity_cuda(q: torch.Tensor, c: torch.Tensor,
                  k_scale: float) -> torch.Tensor:
    """q:(..., m, d), c:(..., n, d) f32 on the card, with the same leading
    dims -> (..., m, n) f32 exp(-k ||q_i - c_j||), no diagonal logic. Where
    q and c are the same tensor (same storage, shape and strides) the
    symmetric route computes each pair once. One launch of the pack kernel
    and one of the tile kernel for the whole batch; an empty result
    launches nothing."""
    dev = require_cuda("affinity", q, c)
    *lead, m, d = q.shape
    n = c.shape[-2]
    if tuple(c.shape) != (*lead, n, d):
        raise ValueError(f"affinity: shapes q{tuple(q.shape)} "
                         f"c{tuple(c.shape)}; expected the same leading "
                         "dims and d")
    same = _same(q, c)
    q = f32("affinity q", q)
    c = q if same else f32("affinity c", c)
    out = torch.empty((*lead, m, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    batch = out.numel() // (m * n)
    pl = plan(m, n, d, same)
    rows_q = batch * -(-m // pl.tile) * pl.tile
    qp = torch.empty((rows_q, pl.ld), dtype=torch.float32, device=dev)
    q2 = torch.empty(rows_q, dtype=torch.float32, device=dev)
    if pl.route == "symmetric":
        cp, c2 = qp, q2
    else:
        rows_c = batch * -(-n // pl.tile) * pl.tile
        cp = torch.empty((rows_c, pl.ld), dtype=torch.float32, device=dev)
        c2 = torch.empty(rows_c, dtype=torch.float32, device=dev)
    err = _build.library().affinity_launch(
        q.data_ptr(), c.data_ptr(), out.data_ptr(), qp.data_ptr(),
        q2.data_ptr(), cp.data_ptr(), c2.data_ptr(), batch, m, n, d, pl.ng,
        pl.tile, pl.stages, int(pl.route == "symmetric"), pl.smem,
        float(k_scale), _build.stream_ptr(dev))
    _build.check("affinity", err)
    affinity_cuda.launches += 1
    affinity_cuda.by_path[pl.route] += 1
    return out


affinity_cuda.launches = 0
affinity_cuda.by_path = {"symmetric": 0, "general": 0}
