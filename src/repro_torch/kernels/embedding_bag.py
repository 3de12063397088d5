"""CUDA wrapper of the EmbeddingBag kernel (`csrc/embedding_bag.cu`), which
replaces the TPU kernel `embedding_bag_pallas` of the JAX package. Its
layout is segment_matmul's (`kernels.segment_matmul.segment_layout`), as
the Pallas kernel's is: a stable sort of the bag ids with every skipped
entry in an overflow bin, so pads may sit anywhere."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import require_cuda
from repro_torch.kernels.segment_matmul import _check_rows, lane_plan, \
    segment_keys, segment_layout


def embedding_bag_cuda(table: torch.Tensor, idx: torch.Tensor,
                       bag_ids: torch.Tensor, n_bags: int,
                       mode: str = "sum") -> torch.Tensor:
    """table (V, dim) f32 or bf16, idx and bag_ids (N,) int on the card ->
    (n_bags, dim) in the table's dtype: each bag's rows summed in f32 in
    their input order (`mode="mean"`: divided by their count), empty bags
    0; an entry is skipped where idx is outside [0, V) or its bag outside
    [0, n_bags). The layout is a sort on the card; then one launch."""
    dev = require_cuda("embedding_bag", table, idx, bag_ids)
    _check_rows("embedding_bag table", table)
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got "
                         f"{mode!r}")
    if idx.dim() != 1 or bag_ids.shape != idx.shape:
        raise ValueError(f"embedding_bag: idx{tuple(idx.shape)} and "
                         f"bag_ids{tuple(bag_ids.shape)} must be one (N,)")
    v, dim = table.shape
    n = int(n_bags)
    out = torch.empty((n, dim), dtype=table.dtype, device=dev)
    if n == 0 or dim == 0:
        return out
    table = table.contiguous()
    idx = idx.clamp(-1, v).to(torch.int32).contiguous()
    keys = torch.where((idx >= 0) & (idx < v), segment_keys(bag_ids, n), n)
    perm, bounds = segment_layout(keys, n)
    vec, group = lane_plan(dim, table.element_size(), table.data_ptr())
    err = _build.library().embedding_bag_launch(
        table.data_ptr(), idx.data_ptr(), perm.data_ptr(), bounds.data_ptr(),
        out.data_ptr(), n, dim, int(table.dtype == torch.bfloat16), vec,
        group, int(mode == "mean"), _build.stream_ptr(dev))
    _build.check("embedding_bag", err)
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
