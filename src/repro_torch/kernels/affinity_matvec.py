"""CUDA wrapper of the masked affinity matvec kernel
(`csrc/affinity_matvec.cu`), which replaces the TPU kernel
`affinity_matvec_pallas` of the JAX package."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import f32, i32, require_cuda


def affinity_matvec_cuda(q, q_idx, c, c_idx, w, k_scale: float):
    """q:(B, m, d), q_idx:(B, m) i32, c:(B, n, d), c_idx:(B, n) i32,
    w:(B, n) f32 on the card -> (B, m) f32."""
    dev = require_cuda("affinity_matvec", q, q_idx, c, c_idx, w)
    bsz, m, d = q.shape
    n = c.shape[1]
    if (tuple(c.shape) != (bsz, n, d) or tuple(q_idx.shape) != (bsz, m)
            or tuple(c_idx.shape) != (bsz, n) or tuple(w.shape) != (bsz, n)):
        raise ValueError(
            f"affinity_matvec: shapes q{tuple(q.shape)} q_idx"
            f"{tuple(q_idx.shape)} c{tuple(c.shape)} c_idx"
            f"{tuple(c_idx.shape)} w{tuple(w.shape)}")
    q = f32("affinity_matvec q", q)
    c = f32("affinity_matvec c", c)
    w = f32("affinity_matvec w", w)
    q_idx = i32("affinity_matvec q_idx", q_idx)
    c_idx = i32("affinity_matvec c_idx", c_idx)
    out = torch.empty((bsz, m), dtype=torch.float32, device=dev)
    err = _build.library().affinity_matvec_launch(
        q.data_ptr(), q_idx.data_ptr(), c.data_ptr(), c_idx.data_ptr(),
        w.data_ptr(), out.data_ptr(), bsz, m, n, d, float(k_scale),
        _build.stream_ptr(dev))
    _build.check("affinity_matvec", err)
    affinity_matvec_cuda.launches += 1
    return out


affinity_matvec_cuda.launches = 0
