"""CUDA wrapper of the fused cluster-assignment kernels (`csrc/assign.cu`),
which replace the TPU kernel `assign_pallas` of the JAX package, and the
plan that picks one of them from the host's ints (m, C, A, d)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import f32, require_cuda, u8

# dynamic shared memory one Hopper block may opt into: 227 KB less a
# margin for the kernel's static shared variables
SMEM_MAX = 232448 - 256
# the lanes kernel: queries a warp, at most (16 x 2 or 1 x 32 dots a lane)
LANE_ROWS = 16
# the tiles kernel: queries a tile, supports a chunk, and the blocks a
# launch aims at (three a SM of the H100's 132)
TILE_ROWS = 64
_CHUNK = 32
TILE_BLOCKS = 3 * 132
_PATHS = ("lanes", "tiles")


class Plan(NamedTuple):
    """Which kernel computes the scores: "lanes" with `rows` queries a warp
    (a power of two up to 16), or "tiles" over `slices` slices of the
    clusters with `smem` dynamic shared bytes a block."""
    kernel: str
    rows: int = 0
    slices: int = 0
    smem: int = 0


def tile_smem_bytes(d: int) -> int:
    """Bytes of the layout carved at the top of `assign_tiles_kernel`: the
    64-query tile and two 32-support chunks as zero-padded rows of stride
    ceil(d / 32) * 32 + 4, |q|^2, and two chunks' |s|^2 and weights."""
    ld = -(-d // 32) * 32 + 4
    return 4 * ((TILE_ROWS + 2 * _CHUNK) * ld + TILE_ROWS + 4 * _CHUNK)


def plan(m: int, n_clusters: int, a_cap: int, d: int) -> Plan:
    """The tiles kernel for more than 16 queries where its rows fit in
    shared memory (d up to 448); the lanes kernel otherwise, which streams
    d in chunks of 32 columns and so takes any d (m past 16 in groups of
    16). No d raises."""
    smem = tile_smem_bytes(d)
    if m > LANE_ROWS and smem <= SMEM_MAX:
        n_tiles = -(-m // TILE_ROWS)
        slices = min(n_clusters, 65535, max(1, -(-TILE_BLOCKS // n_tiles)))
        return Plan("tiles", slices=slices, smem=smem)
    rows = 1
    while rows < min(m, LANE_ROWS):
        rows *= 2
    return Plan("lanes", rows=rows)


def assign_cuda(q, sup_v, sup_w, dens, k_scale: float, threshold: float,
                valid=None):
    """q:(m, d), sup_v:(C, A, d), sup_w:(C, A), dens:(C,) f32 and valid:(m,)
    bool or None on the card, m >= 1 and C >= 1 -> (labels (m,) int32,
    best score (m,) f32). One launch computes the (m, C) scores (the
    kernel of `plan`), a second the argmax, threshold and mask.
    `assign_cuda.by_path` counts the launches of each scores kernel."""
    tensors = (q, sup_v, sup_w, dens) + (() if valid is None else (valid,))
    dev = require_cuda("assign", *tensors)
    m, d = q.shape
    n_clusters, a_cap = sup_w.shape
    if (tuple(sup_v.shape) != (n_clusters, a_cap, d)
            or tuple(dens.shape) != (n_clusters,)
            or (valid is not None and tuple(valid.shape) != (m,))):
        raise ValueError(
            f"assign: shapes q{tuple(q.shape)} sup_v{tuple(sup_v.shape)} "
            f"sup_w{tuple(sup_w.shape)} dens{tuple(dens.shape)} valid"
            f"{None if valid is None else tuple(valid.shape)}")
    if m == 0 or n_clusters == 0 or a_cap == 0 or d == 0:
        raise ValueError("assign: the kernel needs m, C, A, d >= 1")
    q = f32("assign q", q)
    sup_v = f32("assign sup_v", sup_v)
    sup_w = f32("assign sup_w", sup_w)
    dens = f32("assign dens", dens)
    valid8 = None if valid is None else u8(valid)
    pl = plan(m, n_clusters, a_cap, d)
    scores = torch.empty((m, n_clusters), dtype=torch.float32, device=dev)
    labels = torch.empty((m,), dtype=torch.int32, device=dev)
    bscore = torch.empty((m,), dtype=torch.float32, device=dev)
    err = _build.library().assign_launch(
        q.data_ptr(), sup_v.data_ptr(), sup_w.data_ptr(), dens.data_ptr(),
        None if valid8 is None else valid8.data_ptr(), scores.data_ptr(),
        labels.data_ptr(), bscore.data_ptr(), m, n_clusters, a_cap, d,
        _PATHS.index(pl.kernel), pl.rows, pl.slices, pl.smem,
        float(k_scale), float(threshold), _build.stream_ptr(dev))
    _build.check("assign", err)
    assign_cuda.launches += 1
    assign_cuda.by_path[pl.kernel] += 1
    return labels, bscore


assign_cuda.launches = 0
assign_cuda.by_path = dict.fromkeys(_PATHS, 0)
