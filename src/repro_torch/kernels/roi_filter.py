"""CUDA wrapper of the ROI filter kernels (`csrc/roi_filter.cu`), which
replace the TPU kernel `roi_filter_pallas` of the JAX package, and their
plan: the "ring" route (a persistent grid streaming chunks of rows through
shared-memory stages) or the "rows" route (a warp a row, read in place)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import f32, require_cuda, storage, u8

ROUTES = ("ring", "rows")
# The ring: a stage holds a chunk of rows, a multiple of 8 that is at least
# STAGE_BYTES (at most STAGE_MAX_ROWS; rows wider than STAGE_MAX_BYTES / 8
# take the rows route); each warp has STAGES of them and a block
# RING_WARPS warps, as `csrc/roi_filter.cu`'s kStages and kRingWarps, whose
# note says why; the C side launches a block for every RING_WARPS chunks,
# no more than the card's SMs hold at once.
STAGE_BYTES = 2048
STAGE_MAX_BYTES = 8192
STAGE_MAX_ROWS = 32
STAGES = 2
RING_WARPS = 4
# below this many rows a launch takes the "rows" route: on the card the two
# routes' summed time over every call of the sharded fits at 3b's data and
# at full width (`time_kernel_routes.py --fits`) was flat from ~8,000 to
# ~32,000 rows and lower than at either end
RING_MIN_ROWS = 16384


class Plan(NamedTuple):
    route: str         # "ring" or "rows"
    stage_rows: int    # rows a stage (ring)
    smem: int          # dynamic shared bytes a block (ring: every stage)


ROWS_PLAN = Plan("rows", 0, 0)


def plan(rows: int, d: int, dtype=torch.float32, *, aligned: bool = True,
         min_rows: int | None = None) -> Plan:
    """The route of a launch over `rows` candidate rows of width d stored
    as `dtype`: "ring" from `min_rows` (RING_MIN_ROWS) rows where the rows
    start on 16 bytes and 8 of them take at most STAGE_MAX_BYTES, a stage
    holding the fewest rows, a multiple of 8, that reach STAGE_BYTES (at
    least 8, at most STAGE_MAX_ROWS); else "rows"."""
    esize = torch.empty((), dtype=dtype).element_size()
    row_bytes = max(d, 1) * esize
    min_rows = RING_MIN_ROWS if min_rows is None else min_rows
    if rows < min_rows or not aligned or 8 * row_bytes > STAGE_MAX_BYTES:
        return ROWS_PLAN
    stage_rows = min(STAGE_MAX_ROWS, max(8, -(-STAGE_BYTES // row_bytes)))
    stage_rows = -(-stage_rows // 8) * 8
    return Plan("ring", stage_rows,
                RING_WARPS * STAGES * stage_rows * d * esize)


def roi_filter_cuda(vc: torch.Tensor, center: torch.Tensor,
                    radius: torch.Tensor, valid: torch.Tensor, *,
                    route: str | None = None):
    """vc:(B, C, d) f32 or bf16, center:(B, d) f32, radius:(B,),
    valid:(B, C) bool on the card -> (dist (B, C) f32, ok (B, C) bool,
    neg (B, C) f32). `route` forces "ring" or "rows" where the plan would
    take the other (timing; a ring the rows cannot take raises); both give
    the same bits. `roi_filter_cuda.by_path` counts each route's
    launches."""
    dev = require_cuda("roi_filter", vc, center, radius, valid)
    bsz, per_seed, d = vc.shape
    if (tuple(center.shape) != (bsz, d) or tuple(radius.shape) != (bsz,)
            or tuple(valid.shape) != (bsz, per_seed)):
        raise ValueError(
            f"roi_filter: shapes vc{tuple(vc.shape)} center"
            f"{tuple(center.shape)} radius{tuple(radius.shape)} "
            f"valid{tuple(valid.shape)}")
    vc = storage("roi_filter vc", vc)
    if center.dtype != torch.float32:
        raise TypeError(f"roi_filter: vc is {vc.dtype} and center is "
                        f"{center.dtype}; the centre is float32")
    center = center.contiguous()
    radius = f32("roi_filter radius", radius)
    # bools are bytes of 0 / 1: the kernel reads and writes them in place
    valid8 = valid.contiguous() if valid.dtype == torch.bool else u8(valid)
    dist = torch.empty((bsz, per_seed), dtype=torch.float32, device=dev)
    neg = torch.empty_like(dist)
    ok = torch.empty((bsz, per_seed), dtype=torch.bool, device=dev)
    rows = bsz * per_seed
    if rows == 0:
        return dist, ok, neg
    kw = dict(aligned=vc.data_ptr() % 16 == 0)
    pl = plan(rows, d, vc.dtype, **kw)
    if route is not None and route != pl.route:
        if route not in ROUTES:
            raise ValueError(f"roi_filter: route {route!r} not in {ROUTES}")
        pl = ROWS_PLAN if route == "rows" else \
            plan(rows, d, vc.dtype, min_rows=0, **kw)
        if pl.route != route:
            raise ValueError(f"roi_filter: the ring route cannot take "
                             f"{rows} rows of width {d} ({vc.dtype}, "
                             f"aligned {kw['aligned']})")
    lib = _build.library()
    launch = (lib.roi_filter_launch if vc.dtype == torch.float32
              else lib.roi_filter_bf16_launch)
    err = launch(
        vc.data_ptr(), center.data_ptr(), radius.data_ptr(),
        valid8.data_ptr(), dist.data_ptr(), ok.data_ptr(), neg.data_ptr(),
        rows, per_seed, d, ROUTES.index(pl.route), pl.stage_rows,
        _build.stream_ptr(dev))
    _build.check("roi_filter", err)
    roi_filter_cuda.launches += 1
    roi_filter_cuda.by_path[pl.route] += 1
    return dist, ok, neg


roi_filter_cuda.launches = 0
roi_filter_cuda.by_path = dict.fromkeys(ROUTES, 0)
