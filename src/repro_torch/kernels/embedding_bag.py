"""CUDA wrapper of the EmbeddingBag kernels (`csrc/embedding_bag.cu`), which
replace the TPU kernel `embedding_bag_pallas` of the JAX package. The
layout is made on the card: where the valid bag ids come in order (BST's
bags, the Pallas kernel's contract) each bag is the range between its first
and last entry, with no sort; in any other order a one-block placement
lists each bag's entries in input order. Nothing is read back to the host,
so the op can be captured in a CUDA graph."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import require_cuda
from repro_torch.kernels.segment_matmul import (_check_rows, lane_plan,
                                              segment_layout)

# entries a block of the layout's pass takes (csrc/embedding_bag.cu kTile)
PASS_TILE = 4096
_INT32_MAX = 2 ** 31 - 1


def embedding_bag_scratch(n: int, n_bags: int) -> int:
    """int32s of the layout's scratch for n entries and n_bags bags: each
    bag's first and one-past-last entry, the pass blocks' done counter,
    the order flag, three per pass block, then the unsorted placement's
    cursor, bounds and permutation."""
    return 2 * n_bags + 2 + 3 * -(-n // PASS_TILE) + n_bags + n_bags + 1 + n


def embedding_bag_cuda(table: torch.Tensor, idx: torch.Tensor,
                       bag_ids: torch.Tensor, n_bags: int,
                       mode: str = "sum") -> torch.Tensor:
    """table (V, dim) f32 or bf16, idx and bag_ids (N,) int on the card ->
    (n_bags, dim) in the table's dtype: each bag's rows summed in f32 in
    their input order (`mode="mean"`: divided by their count), empty bags
    0. An entry is skipped where idx is negative or its bag is outside
    [0, n_bags); an id at or past V reads row V - 1, as the JAX
    reference's gather does. One call of the library: a memset and two
    kernels."""
    dev = require_cuda("embedding_bag", table, idx, bag_ids)
    _check_rows("embedding_bag table", table)
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got "
                         f"{mode!r}")
    if idx.dim() != 1 or bag_ids.shape != idx.shape:
        raise ValueError(f"embedding_bag: idx{tuple(idx.shape)} and "
                         f"bag_ids{tuple(bag_ids.shape)} must be one (N,)")
    v, dim = table.shape
    n, e = int(n_bags), idx.numel()
    if n > _INT32_MAX or e > _INT32_MAX:
        raise ValueError(f"embedding_bag: {e} ids into {n} bags exceed "
                         f"{_INT32_MAX}")
    out = torch.empty((n, dim), dtype=table.dtype, device=dev)
    if n == 0 or dim == 0:
        return out
    if v == 0:                      # every id clamps to -1, a pad
        return out.zero_()
    if idx.dtype != bag_ids.dtype or idx.dtype not in (torch.int32,
                                                       torch.int64):
        idx, bag_ids = idx.long(), bag_ids.long()
    table, idx, bag_ids = table.contiguous(), idx.contiguous(), \
        bag_ids.contiguous()
    scratch = torch.empty(embedding_bag_scratch(e, n), dtype=torch.int32,
                          device=dev)
    vec, group = lane_plan(dim, table.element_size(), table.data_ptr())
    err = _build.library().embedding_bag_launch(
        table.data_ptr(), v, idx.data_ptr(), bag_ids.data_ptr(),
        int(idx.dtype == torch.int64), scratch.data_ptr(), out.data_ptr(), e,
        n, dim, int(table.dtype == torch.bfloat16), vec, group,
        int(mode == "mean"), _build.stream_ptr(dev))
    _build.check("embedding_bag", err)
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0


def bag_counts(idx: torch.Tensor, bag_ids: torch.Tensor, n_bags: int,
               v_rows: int) -> torch.Tensor:
    """(n_bags,) f32: each bag's entries that the forward reads (id >= 0,
    bag in [0, n_bags)), the mean's divisor, at least 1."""
    keys = torch.where((idx >= 0) & (bag_ids >= 0) & (bag_ids < n_bags),
                       bag_ids.long(), n_bags)
    cnt = torch.bincount(keys, minlength=n_bags + 1)[:n_bags]
    return cnt.clamp(min=1).to(torch.float32)


def embedding_bag_bwd_cuda(d_out: torch.Tensor, idx: torch.Tensor,
                           bag_ids: torch.Tensor, v_rows: int,
                           mode: str = "sum") -> torch.Tensor:
    """The gradient of `embedding_bag_cuda`'s table (`csrc/segment_bwd.cu`,
    the port's own): d_out (n_bags, dim) f32 or bf16, idx and bag_ids (N,)
    int on the card -> d_table (v_rows, dim) in d_out's dtype. Row v sums,
    in f32 in input order, d_out[bag_ids[e]] (divided by the bag's count
    for `mode="mean"`) over the entries e the forward read whose id is v;
    an id at or past v_rows (read as row v_rows - 1 by the forward) adds
    nothing, as in the JAX package, whose transpose of the clamped gather
    skips out-of-bounds rows; rows no entry names are 0. The layout by
    table row is `segment_layout`'s stable sort; then one launch."""
    dev = require_cuda("embedding_bag backward", d_out, idx, bag_ids)
    _check_rows("embedding_bag backward d_out", d_out)
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got "
                         f"{mode!r}")
    if idx.dim() != 1 or bag_ids.shape != idx.shape:
        raise ValueError(f"embedding_bag backward: idx{tuple(idx.shape)} and "
                         f"bag_ids{tuple(bag_ids.shape)} must be one (N,)")
    n, dim = d_out.shape
    v = int(v_rows)
    d_table = torch.empty((v, dim), dtype=d_out.dtype, device=dev)
    if v == 0 or dim == 0:
        return d_table
    if bag_ids.dtype not in (torch.int32, torch.int64):
        bag_ids = bag_ids.long()
    d_out, bag_ids = d_out.contiguous(), bag_ids.contiguous()
    named = (idx >= 0) & (idx < v) & (bag_ids >= 0) & (bag_ids < n)
    keys = torch.where(named, idx.long(), v)
    perm, bounds = segment_layout(keys, v)
    counts = bag_counts(idx, bag_ids, n, v) if mode == "mean" else None
    vec, group = lane_plan(dim, d_out.element_size(),
                           d_out.data_ptr() | d_table.data_ptr())
    err = _build.library().embedding_bag_bwd_launch(
        d_out.data_ptr(), bag_ids.data_ptr(),
        0 if counts is None else counts.data_ptr(), perm.data_ptr(),
        bounds.data_ptr(), d_table.data_ptr(), v, dim, n,
        int(d_out.dtype == torch.bfloat16),
        int(bag_ids.dtype == torch.int64), vec, group,
        _build.stream_ptr(dev))
    _build.check("embedding_bag backward", err)
    embedding_bag_bwd_cuda.launches += 1
    return d_table


embedding_bag_bwd_cuda.launches = 0
