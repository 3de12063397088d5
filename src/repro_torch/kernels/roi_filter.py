"""CUDA wrapper of the ROI filter kernel (`csrc/roi_filter.cu`), which
replaces the TPU kernel `roi_filter_pallas` of the JAX package."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import f32, require_cuda, storage, u8


def roi_filter_cuda(vc: torch.Tensor, center: torch.Tensor,
                    radius: torch.Tensor, valid: torch.Tensor):
    """vc:(B, C, d) f32 or bf16, center:(B, d) f32, radius:(B,),
    valid:(B, C) bool on the card -> (dist (B, C) f32, ok (B, C) bool,
    neg (B, C) f32)."""
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
    valid8 = u8(valid)
    dist = torch.empty((bsz, per_seed), dtype=torch.float32, device=dev)
    neg = torch.empty_like(dist)
    ok = torch.empty((bsz, per_seed), dtype=torch.uint8, device=dev)
    lib = _build.library()
    launch = (lib.roi_filter_launch if vc.dtype == torch.float32
              else lib.roi_filter_bf16_launch)
    err = launch(
        vc.data_ptr(), center.data_ptr(), radius.data_ptr(),
        valid8.data_ptr(), dist.data_ptr(), ok.data_ptr(), neg.data_ptr(),
        bsz * per_seed, per_seed, d, _build.stream_ptr(dev))
    _build.check("roi_filter", err)
    roi_filter_cuda.launches += 1
    return dist, ok.bool(), neg


roi_filter_cuda.launches = 0
