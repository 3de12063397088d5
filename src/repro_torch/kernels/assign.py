"""CUDA wrapper of the fused cluster-assignment kernel (`csrc/assign.cu`),
which replaces the TPU kernel `assign_pallas` of the JAX package."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import f32, require_cuda, u8

# dynamic shared memory one Hopper block may opt into: 227 KB less a
# margin for the kernel's static shared variables
SMEM_MAX = 232448 - 256
_CHUNK = 32        # supports staged at a time
_QUERY_GROUPS = 16  # query rows of a tile = 16 x the rows per thread


def smem_plan(d: int) -> tuple[int, int]:
    """(query rows per thread, dynamic shared bytes) of the scores kernel
    for dimension d: 4 rows per thread (64-query tiles) where they fit, 1
    (16-query tiles) where d is too wide. The bytes are the layout carved
    at the top of `assign_scores_kernel`: the query tile and the support
    chunk as zero-padded rows of stride ceil(d / 32) * 32 + 1, the 33-wide
    lane sums, |q|^2, |s|^2 and the chunk's weights."""
    ld = -(-d // 32) * 32 + 1
    for tq in (4, 1):
        rows = _QUERY_GROUPS * tq
        nbytes = 4 * ((rows + _CHUNK) * ld + rows * 33 + rows + 2 * _CHUNK)
        if nbytes <= SMEM_MAX:
            return tq, nbytes
    raise ValueError(f"assign: d={d} does not fit a 16-query tile in "
                     f"{SMEM_MAX} bytes of shared memory")


def assign_cuda(q, sup_v, sup_w, dens, k_scale: float, threshold: float,
                valid=None):
    """q:(m, d), sup_v:(C, A, d), sup_w:(C, A), dens:(C,) f32 and valid:(m,)
    bool or None on the card, m >= 1 and C >= 1 -> (labels (m,) int32,
    best score (m,) f32). One launch computes the (m, C) scores, a second
    the argmax, threshold and mask."""
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
    if m == 0 or n_clusters == 0 or a_cap == 0:
        raise ValueError("assign: the kernel needs m >= 1, C >= 1, A >= 1")
    q = f32("assign q", q)
    sup_v = f32("assign sup_v", sup_v)
    sup_w = f32("assign sup_w", sup_w)
    dens = f32("assign dens", dens)
    valid8 = None if valid is None else u8(valid)
    tq, smem = smem_plan(d)
    scores = torch.empty((m, n_clusters), dtype=torch.float32, device=dev)
    labels = torch.empty((m,), dtype=torch.int32, device=dev)
    bscore = torch.empty((m,), dtype=torch.float32, device=dev)
    err = _build.library().assign_launch(
        q.data_ptr(), sup_v.data_ptr(), sup_w.data_ptr(), dens.data_ptr(),
        None if valid8 is None else valid8.data_ptr(), scores.data_ptr(),
        labels.data_ptr(), bscore.data_ptr(), m, n_clusters, a_cap, d, tq,
        smem, float(k_scale), float(threshold), _build.stream_ptr(dev))
    _build.check("assign", err)
    assign_cuda.launches += 1
    return labels, bscore


assign_cuda.launches = 0
