"""CUDA wrapper of the LSH hashing kernel (`csrc/lsh_hash.cu`), which
replaces the TPU kernel `lsh_hash_pallas` of the JAX package, and the rule
that holds its keys to the plain version's.

The kernel sums each projection in another order than the plain version,
so a key may flip where z / seg_len lies within rounding of an integer.
`key_flips` counts the (point, table) pairs whose keys differ and checks
that each such pair has a projection within `FLIP_NEAR` of a bucket edge,
recomputed in float64."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import f32, require_cuda

# dynamic shared memory one Hopper block may opt into: 227 KB less a
# margin for the kernel's static shared variables
_SMEM_MAX = 232448 - 256


def _tile(lm: int, d: int) -> int:
    """Points per tile: the largest of 64/32/16/8 whose staging fits."""
    for pts in (64, 32, 16, 8):
        if 4 * ((lm + pts) * (d + 1) + pts * lm) <= _SMEM_MAX:
            return pts
    raise ValueError(f"lsh_hash: {lm} projections of width {d} do not fit "
                     "one block's shared memory")


def lsh_hash_cuda(x: torch.Tensor, proj: torch.Tensor, bias: torch.Tensor,
                  seg_len: float) -> torch.Tensor:
    """x:(n, d), proj:(L, m, d), bias:(L, m) f32 on the card -> (n, L)
    int32 key bits."""
    dev = require_cuda("lsh_hash", x, proj, bias)
    x = f32("lsh_hash x", x)
    n, d = x.shape
    n_tables, n_proj, dp = proj.shape
    if dp != d or tuple(bias.shape) != (n_tables, n_proj):
        raise ValueError(f"lsh_hash: shapes x{tuple(x.shape)} "
                         f"proj{tuple(proj.shape)} bias{tuple(bias.shape)}")
    proj = f32("lsh_hash proj", proj)
    bias = f32("lsh_hash bias", bias)
    out = torch.empty((n, n_tables), dtype=torch.int32, device=dev)
    seg = float(torch.tensor(seg_len, dtype=torch.float32))
    err = _build.library().lsh_hash_launch(
        x.data_ptr(), proj.data_ptr(), bias.data_ptr(), out.data_ptr(), n, d,
        n_tables, n_proj, _tile(n_tables * n_proj, d), seg,
        _build.stream_ptr(dev))
    _build.check("lsh_hash", err)
    lsh_hash_cuda.launches += 1
    return out


lsh_hash_cuda.launches = 0

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
