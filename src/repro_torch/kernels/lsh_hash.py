"""CUDA wrapper of the LSH hashing kernels (`csrc/lsh_hash.cu`), which
replace the TPU kernel `lsh_hash_pallas` of the JAX package, their plan,
and the rule that holds their keys to the plain version's.

The kernels sum each projection in another order than the plain version,
so a key may flip where z / seg_len lies within rounding of an integer.
`key_flips` counts the (point, table) pairs whose keys differ and checks
that each such pair has a projection within `FLIP_NEAR` of a bucket edge,
recomputed in float64."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import f32, require_cuda, storage

# dynamic shared memory one Hopper block may opt into: 227 KB less a
# margin for the kernel's static shared variables
SMEM_MAX = 232448 - 256
# the most points the "probe" route takes: past it the "stream" route's
# larger tiles, 4 points a thread, read the projections less often
PROBE_MAX_N = 16_384
_Q = 4   # projections of a thread
PER_THREAD = {"stream": 4, "probe": 1}   # points of a thread, by route


class Plan(NamedTuple):
    route: str    # "stream" (4 points a thread) or "probe" (1)
    pts: int      # points a block
    threads: int  # threads a block
    smem: int     # dynamic shared bytes


def _smem(lm: int, d: int, pts: int) -> int:
    """Bytes of the layout carved in `lsh_tile_kernel`: the projections
    (4 G rows, G = ceil(L m / 4)) and the block's points, rows of
    ceil(d / 4) * 4 floats padded to 32 k + 4, then the (points, L m + 1)
    words."""
    ldx = -(-(-(-d // 4) * 4) // 32) * 32 + 4
    return 4 * ((-(-lm // _Q) * _Q + pts) * ldx + pts * (lm + 1))


def plan(n: int, d: int, n_tables: int, n_proj: int) -> Plan:
    """The kernel's plan for n points of width d against L x m
    projections: past PROBE_MAX_N points the stream route (128 points a
    block, a thread 4 points x 4 projections), up to it the probe route
    (32 points a block, a thread one point x 4 projections); fewer points
    a block where d is too wide for shared memory, the probe route's where
    no stream tile fits."""
    lm = n_tables * n_proj
    groups = -(-lm // _Q)
    routes = ((("stream", (128, 64, 32, 16, 8, 4)),) if n > PROBE_MAX_N
              else ()) + (("probe", (32, 16, 8, 4, 2, 1)),)
    for route, sizes in routes:
        per_thread = PER_THREAD[route]
        for pts in sizes:
            smem = _smem(lm, d, pts)
            if smem <= SMEM_MAX:
                threads = min(256,
                              -(-(pts // per_thread) * groups // 32) * 32)
                return Plan(route, pts, threads, smem)
    raise ValueError(f"lsh_hash: {lm} projections of width {d} do not fit "
                     "one block's shared memory")


def lsh_hash_cuda(x: torch.Tensor, proj: torch.Tensor, bias: torch.Tensor,
                  seg_len: float) -> torch.Tensor:
    """x:(n, d) f32 or bf16, proj:(L, m, d), bias:(L, m) f32 on the card
    -> (n, L) int32 key bits. No points launch nothing."""
    dev = require_cuda("lsh_hash", x, proj, bias)
    x = storage("lsh_hash x", x)
    if proj.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"lsh_hash: x is {x.dtype} and proj {proj.dtype}, "
                        f"bias {bias.dtype}; the projections are float32")
    n, d = x.shape
    n_tables, n_proj, dp = proj.shape
    if dp != d or tuple(bias.shape) != (n_tables, n_proj):
        raise ValueError(f"lsh_hash: shapes x{tuple(x.shape)} "
                         f"proj{tuple(proj.shape)} bias{tuple(bias.shape)}")
    proj = f32("lsh_hash proj", proj)
    bias = f32("lsh_hash bias", bias)
    out = torch.empty((n, n_tables), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    seg = float(torch.tensor(seg_len, dtype=torch.float32))
    pl = plan(n, d, n_tables, n_proj)
    lib = _build.library()
    launch = (lib.lsh_hash_launch if x.dtype == torch.float32
              else lib.lsh_hash_bf16_launch)
    err = launch(
        x.data_ptr(), proj.data_ptr(), bias.data_ptr(), out.data_ptr(), n, d,
        n_tables, n_proj, PER_THREAD[pl.route], pl.pts, pl.threads,
        pl.smem, seg, _build.stream_ptr(dev))
    _build.check("lsh_hash", err)
    lsh_hash_cuda.launches += 1
    lsh_hash_cuda.by_path[pl.route] += 1
    return out


lsh_hash_cuda.launches = 0
lsh_hash_cuda.by_path = {"stream": 0, "probe": 0}

# how close to an integer z / seg_len must lie for a key flip to be rounding
FLIP_NEAR = 1e-4


def key_flips(x, proj, bias, seg_len: float, got: torch.Tensor,
              want: torch.Tensor) -> tuple[int, bool]:
    """(number of (point, table) pairs whose keys differ, whether every one
    of them has some z / seg_len within FLIP_NEAR of an integer)."""
    flips = (got != want).nonzero()
    if flips.shape[0] == 0:
        return 0, True
    pts, tab = flips[:, 0], flips[:, 1]
    z = (x[pts].double()[:, None, :] * proj[tab].double()).sum(-1) \
        + bias[tab].double()
    q = z / float(torch.tensor(seg_len, dtype=torch.float32))
    near = (q - torch.round(q)).abs().min(dim=1).values <= FLIP_NEAR
    return int(flips.shape[0]), bool(near.all())
