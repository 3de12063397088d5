"""CUDA wrapper of the segment-sum kernel (`csrc/segment_matmul.cu`), which
replaces the TPU kernel `segment_matmul_pallas` of the JAX package, and the
layout that it shares with the `embedding_bag` kernel.

The Pallas kernel needs its edges sorted by segment and aligned to its
blocks (`align_segments`). Here the layout is a stable sort of the segment
ids, so the ids may come in any order and the pads anywhere: each segment's
rows are listed in their input order, which is the pinned order of the
plain version (`kernels.ref.segment_sum_ref`)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import require_cuda

_INT32_MAX = 2 ** 31 - 1


def segment_layout(keys: torch.Tensor, n: int):
    """keys (E,) int: each row's segment in [0, n], n for a row to skip
    (the overflow bin) -> (perm (E,) int64, bounds (n + 1,) int64):
    perm[bounds[s]:bounds[s + 1]] are segment s's rows in input order (a
    stable sort), the skipped rows last."""
    ordered, perm = torch.sort(keys, stable=True)
    bounds = torch.searchsorted(
        ordered, torch.arange(n + 1, dtype=ordered.dtype, device=keys.device))
    return perm, bounds


def segment_keys(seg: torch.Tensor, n: int) -> torch.Tensor:
    """Each row's segment, n (the overflow bin) where it is outside
    [0, n): the -1 pads wherever they sit. int32 where n allows (the
    sort is faster on 32-bit keys)."""
    if n < _INT32_MAX and seg.dtype == torch.int64:
        seg = seg.clamp(-1, n).to(torch.int32)
    return torch.where((seg >= 0) & (seg < n), seg, n)


def lane_plan(d: int, element_size: int, ptr: int) -> tuple[int, int]:
    """(elements a load, lanes a segment) for rows of d elements: the
    widest load of at most 16 bytes that divides a row and the base
    address, and the power of two of lanes (<= 32) that covers a row in
    one pass where it can."""
    vec = 16 // element_size
    while vec > 1 and (d % vec or ptr % (vec * element_size)):
        vec //= 2
    lanes = -(-d // vec)
    group = 1
    while group < min(lanes, 32):
        group *= 2
    return vec, group


def _check_rows(name: str, x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise TypeError(f"{name}: expected a 2-D float32 or bfloat16 tensor, "
                        f"got {x.dtype} of shape {tuple(x.shape)}")


def segment_matmul_cuda(msg: torch.Tensor, seg_ids: torch.Tensor,
                        n_segments: int) -> torch.Tensor:
    """msg (E, d) f32 or bf16 and seg_ids (E,) int on the card ->
    (n_segments, d) in msg's dtype: each segment's rows summed in f32 in
    their input order, rows never visited 0, ids outside [0, n_segments)
    skipped. The layout is a sort on the card; then one launch."""
    dev = require_cuda("segment_matmul", msg, seg_ids)
    _check_rows("segment_matmul msg", msg)
    e, d = msg.shape
    if tuple(seg_ids.shape) != (e,):
        raise ValueError(f"segment_matmul: seg_ids{tuple(seg_ids.shape)} "
                         f"for msg{tuple(msg.shape)}")
    n = int(n_segments)
    out = torch.empty((n, d), dtype=msg.dtype, device=dev)
    if n == 0 or d == 0:
        return out
    msg = msg.contiguous()
    perm, bounds = segment_layout(segment_keys(seg_ids, n), n)
    vec, group = lane_plan(d, msg.element_size(), msg.data_ptr())
    err = _build.library().segment_matmul_launch(
        msg.data_ptr(), perm.data_ptr(), bounds.data_ptr(), out.data_ptr(),
        n, d, int(msg.dtype == torch.bfloat16), vec, group,
        _build.stream_ptr(dev))
    _build.check("segment_matmul", err)
    segment_matmul_cuda.launches += 1
    return out


segment_matmul_cuda.launches = 0
