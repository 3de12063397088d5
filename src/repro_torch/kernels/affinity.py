"""CUDA wrapper of the blocked affinity kernel (`csrc/affinity.cu`), which
replaces the TPU kernel `affinity_pallas` of the JAX package."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import f32, require_cuda

# dynamic shared memory one Hopper block may opt into: 227 KB less a
# margin for the kernel's static shared variables
SMEM_MAX = 232448 - 256
_CHUNK = 32        # columns staged at a time
_QUERY_GROUPS = 16  # query rows of a tile = 16 x the rows per thread
_MAX_BATCH = 65535  # the grid's y dimension


def smem_plan(d: int) -> tuple[int, int]:
    """(query rows per thread, dynamic shared bytes) of the kernel for
    dimension d: 4 rows per thread (64-row tiles) where they fit, 1 (16-row
    tiles) where d is too wide. The bytes are the layout carved at the top
    of `affinity_kernel`: the query tile and the column chunk as
    zero-padded rows of stride ceil(d / 32) * 32 + 1, then |q|^2 and
    |c|^2."""
    ld = -(-d // 32) * 32 + 1
    for tq in (4, 1):
        rows = _QUERY_GROUPS * tq
        nbytes = 4 * ((rows + _CHUNK) * ld + rows + _CHUNK)
        if nbytes <= SMEM_MAX:
            return tq, nbytes
    raise ValueError(f"affinity: d={d} does not fit a 16-row tile in "
                     f"{SMEM_MAX} bytes of shared memory")


def affinity_cuda(q: torch.Tensor, c: torch.Tensor,
                  k_scale: float) -> torch.Tensor:
    """q:(..., m, d), c:(..., n, d) f32 on the card, with the same leading
    dims -> (..., m, n) f32 exp(-k ||q_i - c_j||), no diagonal logic. One
    launch for the whole batch; an empty result launches nothing."""
    dev = require_cuda("affinity", q, c)
    *lead, m, d = q.shape
    n = c.shape[-2]
    if tuple(c.shape) != (*lead, n, d):
        raise ValueError(f"affinity: shapes q{tuple(q.shape)} "
                         f"c{tuple(c.shape)}; expected the same leading "
                         "dims and d")
    q = f32("affinity q", q)
    c = f32("affinity c", c)
    out = torch.empty((*lead, m, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    batch = out.numel() // (m * n)
    if batch > _MAX_BATCH:
        raise ValueError(f"affinity: a batch of {batch} exceeds "
                         f"{_MAX_BATCH}")
    tq, smem = smem_plan(d)
    err = _build.library().affinity_launch(
        q.data_ptr(), c.data_ptr(), out.data_ptr(), batch, m, n, d, tq,
        smem, float(k_scale), _build.stream_ptr(dev))
    _build.check("affinity", err)
    affinity_cuda.launches += 1
    return out


affinity_cuda.launches = 0
