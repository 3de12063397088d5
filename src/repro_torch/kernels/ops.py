"""The kernel layer of the port: one wrapper per op of the hot paths.

Every hot-path module (`core.affinity`, `core.lid`, `core.roi`, `core.civs`,
`lsh.pstable`, `core.alid.assign_labels` behind predict and serving, the
full-matrix baselines through `core.affinity`, the LMs' and BST's
attention in `models.transformer` and `models.bst`, BST's multi-hot
lookups, and the GNNs' aggregations in `models.gnn`) computes distances,
affinities, LSH keys, assignments, attention, bag sums and segment sums
only through these wrappers. Each takes `backend`:

  "auto"    the CUDA kernel for tensors on the card, the plain PyTorch
            version (`kernels.ref`) for tensors on the CPU;
  "kernel"  the CUDA kernel; raises for a CPU tensor;
  "ref"     the plain PyTorch version on any device. Nothing on the main
            path chooses it: it exists so that tests and `chip_smoke.py`
            can compare a kernel with its plain version on the card.

A CUDA tensor never falls back to the plain version: a kernel that does not
build or launch raises, and so does a norm other than p = 2, which the
kernels do not compute. Each kernel wrapper counts its launches
(`launch_counts`), so a run can show that the fit went through the kernels.

Gradients. On the "ref" route every op is plain torch, which autograd
differentiates. On the kernel route the three ops that training runs,
`flash_attention`, `segment_matmul` and `embedding_bag`, are each an
`autograd.Function`: the forward kernel, then a backward kernel of the
port's own (`csrc/flash_attention_bwd.cu`, `csrc/segment_bwd.cu`; the JAX
package differentiates its plain versions), all free of atomics, so a
step's gradients are the same bits from run to run. The other six kernels
have no backward: called on the kernel route with an input that requires
grad, they raise rather than return a result silently cut from the graph.
`gather_rows` is `table[idx]` whose backward sums the rows' gradients by
index through `segment_matmul` in input order, in place of the atomic
scatter-add of torch's own indexing backward on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.affinity import affinity_cuda
from repro_torch.kernels.affinity_matvec import affinity_matvec_cuda
from repro_torch.kernels.assign import assign_cuda
from repro_torch.kernels.embedding_bag import (embedding_bag_bwd_cuda,
                                               embedding_bag_cuda)
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.lid_sweep import lid_sweep_cuda
from repro_torch.kernels.lsh_hash import lsh_hash_cuda
from repro_torch.kernels.roi_filter import roi_filter_cuda
from repro_torch.kernels.segment_matmul import (segment_matmul_bwd_cuda,
                                                segment_matmul_cuda)

BACKENDS = ("auto", "ref", "kernel")
DTYPES = ("float32", "bfloat16")


def storage_dtype(name: str) -> torch.dtype:
    """The `EngineSpec.dtype` knob as the torch STORAGE dtype (validated).

    The kernel layer's mixed-precision contract, the JAX package's: points,
    store shards and the v_beta support blocks are stored in this dtype,
    while every distance, affinity and LID accumulator (x, Ax, pi) stays
    f32, and each op upcasts its storage inputs once. Engines and stores
    round their points through `to_storage`, once, BEFORE hashing, so LSH
    keys of the rounded values are the same on every engine."""
    if name not in DTYPES:
        raise ValueError(
            f"unknown storage dtype {name!r}; expected one of {DTYPES}")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


# rows rounded per block by to_storage: bounds its int32 temporaries
_ROUND_ROWS = 1 << 16


def to_storage(t: torch.Tensor, name: str, device=None) -> torch.Tensor:
    """`t` in the storage dtype `name` on `device` (default: t's; a tensor
    already there in that dtype is returned as is). f32 -> bf16 rounds to
    nearest, ties to even, as XLA's convert: subnormals are kept, overflow
    goes to inf, and a NaN becomes the quiet NaN 0x7FC0 with its sign
    (torch's own conversion gives 0xFFFF or 0x7FFF), so the port's rounded
    points are the JAX package's bit for bit. Integer arithmetic on the
    bits, a block of rows at a time, each block moved to `device` first:
    host points go to the card as bf16 with no f32 copy there."""
    dtype = storage_dtype(name)
    device = t.device if device is None else torch.device(device)
    if dtype == torch.float32 or t.dtype == dtype:
        return t.to(device=device, dtype=dtype)
    src = t.float().contiguous()
    flat = src.reshape(-1, src.shape[-1]) if src.dim() > 1 \
        else src.reshape(1, -1)
    out = torch.empty(flat.shape, dtype=torch.int16, device=device)
    for lo in range(0, flat.shape[0], _ROUND_ROWS):
        b = flat[lo:lo + _ROUND_ROWS].to(device).view(torch.int32)
        mag = b & 0x7FFFFFFF
        sign = (b >> 16) & 0x8000
        rne = (mag + (0x7FFF + ((mag >> 16) & 1))) >> 16
        r = torch.where(mag > 0x7F800000, 0x7FC0, rne) | sign
        out[lo:lo + _ROUND_ROWS] = torch.where(r >= 0x8000, r - 0x10000, r)
    return out.view(torch.bfloat16).reshape(t.shape)

KERNELS = {
    "lsh_hash": lsh_hash_cuda,
    "roi_filter": roi_filter_cuda,
    "affinity_matvec": affinity_matvec_cuda,
    "lid_sweep": lid_sweep_cuda,
    "assign": assign_cuda,
    "affinity": affinity_cuda,
    "flash_attention": flash_attention_cuda,
    "embedding_bag": embedding_bag_cuda,
    "segment_matmul": segment_matmul_cuda,
    "flash_attention_bwd": flash_attention_bwd_cuda,
    "segment_matmul_bwd": segment_matmul_bwd_cuda,
    "embedding_bag_bwd": embedding_bag_bwd_cuda,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def path_counts() -> dict[str, dict[str, int]]:
    """Launches of each kernel behind a wrapper that picks one of several
    by a plan (`flash_attention`, its backward, `assign`, `affinity`,
    `lsh_hash`), by the plan's name."""
    return {name: dict(fn.by_path) for name, fn in KERNELS.items()
            if hasattr(fn, "by_path")}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "by_path"):
            fn.by_path = dict.fromkeys(fn.by_path, 0)


def resolve_backend(backend: str, t: torch.Tensor) -> str:
    """Collapse the knob to "ref" or "kernel" for a tensor on `t`'s device:
    the ONE dispatch decision, which every op routes through."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {backend!r}; expected one of {BACKENDS}")
    on_card = t.device.type == "cuda"
    if backend == "kernel" and not on_card:
        raise ValueError("backend='kernel' needs tensors on a CUDA device; "
                         f"got one on {t.device}")
    if backend == "auto":
        return "kernel" if on_card else "ref"
    return backend


def wants_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a graph through these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def no_backward(op: str, *tensors: torch.Tensor) -> None:
    """The kernel route of an op without a backward kernel refuses inputs
    that require grad: its raw-pointer launch would give a result with no
    grad_fn, silently cut from the graph."""
    if wants_grad(*tensors):
        raise NotImplementedError(
            f"{op}: the kernel has no backward; an input requires grad. Run "
            "it under torch.no_grad() or detach the inputs (backend='ref' "
            "differentiates the plain version)")


def check_norm(mode: str, p: float, op: str) -> None:
    """The kernels compute the p = 2 norm only; any other p on the kernel
    path raises rather than running the plain version on the card."""
    if mode == "kernel" and p != 2.0:
        raise NotImplementedError(
            f"{op}: the kernel computes p=2 only; p={p} is not ported yet "
            "(ROADMAP queue item 'p != 2 in the kernels'); pass "
            "device='cpu' to run the plain version")


def pairwise_distance(q, c, p: float = 2.0, *, backend: str = "auto"):
    """||q_i - c_j||_p in f32. No kernel, as in the JAX package: every
    hot-path distance is fused into affinity_matvec / roi_filter / the
    sweep, and what remains (estimate_k, the ROI radii) is per-call
    metadata. `backend` is validated for signature uniformity."""
    resolve_backend(backend, q)
    return _ref.pairwise_distance_ref(q, c, p)


def affinity(q, c, k_scale: float, p: float = 2.0, *, backend: str = "auto"):
    """exp(-k ||q_i - c_j||_p) for q:(..., m, d), c:(..., n, d) -> (..., m, n)
    f32, with no diagonal logic. The kernel takes f32 only: bf16 rows in
    this kernel wait for ROADMAP item P1b (no fit engine calls it on
    storage rows)."""
    mode = resolve_backend(backend, q)
    check_norm(mode, p, "affinity")
    if mode == "ref":
        return _ref.affinity_ref(q, c, k_scale, p)
    no_backward("affinity", q, c)
    if q.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"affinity: the kernel takes float32 only, got "
                        f"{q.dtype} and {c.dtype} (bf16 rows in this "
                        "kernel are ROADMAP item P1b)")
    lead = torch.broadcast_shapes(q.shape[:-2], c.shape[:-2])
    return affinity_cuda(q.expand(*lead, *q.shape[-2:]),
                         c.expand(*lead, *c.shape[-2:]), k_scale)


def affinity_matvec(q, q_idx, c, c_idx, w, k_scale: float, p: float = 2.0,
                    *, backend: str = "auto"):
    """out_i = sum_j [q_idx_i != c_idx_j] exp(-k||q_i - c_j||) w_j, (..., m)
    f32 for q:(..., m, d), c:(..., n, d) stored in one dtype (f32 or bf16,
    the affinity taken in f32); the leading dim is the seed batch."""
    mode = resolve_backend(backend, q)
    check_norm(mode, p, "affinity_matvec")
    if mode == "ref":
        return _ref.affinity_matvec_ref(q, q_idx, c, c_idx, w, k_scale, p)
    no_backward("affinity_matvec", q, c, w)
    if q.dim() == 2:
        return affinity_matvec_cuda(q[None], q_idx[None], c[None],
                                    c_idx[None], w[None], k_scale)[0]
    return affinity_matvec_cuda(q, q_idx, c, c_idx, w, k_scale)


def lid_sweep(v_beta, beta_idx, beta_mask, x, ax, n_iters, converged,
              k_scale: float, *, n_steps: int, max_iters: int, tol: float,
              p: float = 2.0, refresh_every: int = 0,
              support_eps: float = 1e-6, backend: str = "auto"):
    """Up to `n_steps` fused LID iterations per seed over a batch of
    (cap, d) support blocks; (x, ax, n_iters, converged) in, same out.
    `n_iters` is cumulative: the per-step guard is ~converged & n_iters <
    max_iters. See `kernels.ref.lid_sweep_ref` for the shapes."""
    mode = resolve_backend(backend, v_beta)
    check_norm(mode, p, "lid_sweep")
    if mode == "ref":
        return _ref.lid_sweep_ref(v_beta, beta_idx, beta_mask, x, ax,
                                  n_iters, converged, k_scale, n_steps,
                                  max_iters, tol, p, refresh_every,
                                  support_eps)
    no_backward("lid_sweep", v_beta, x, ax)
    return lid_sweep_cuda(v_beta, beta_idx, beta_mask, x, ax, n_iters,
                          converged, k_scale, n_steps=n_steps,
                          max_iters=max_iters, tol=tol,
                          refresh_every=refresh_every,
                          support_eps=support_eps)


def roi_filter(vc, center, radius, valid, p: float = 2.0, *,
               backend: str = "auto"):
    """(dist, ok, neg) for candidates vc:(..., C, d) against center:(..., d)
    with ok = valid & dist <= radius and neg = -dist where ok, else -inf."""
    mode = resolve_backend(backend, vc)
    check_norm(mode, p, "roi_filter")
    if p != 2.0:
        dist = _ref.pairwise_distance_ref(vc, center.unsqueeze(-2), p)[..., 0]
        r = torch.as_tensor(radius, dtype=torch.float32, device=dist.device)
        ok = valid & (dist <= (r.unsqueeze(-1) if r.dim() else r))
        return dist, ok, torch.where(ok, -dist, float("-inf"))
    if mode == "ref":
        return _ref.roi_filter_ref(vc, center, radius, valid)
    no_backward("roi_filter", vc, center,
                radius if torch.is_tensor(radius) else None)
    radius = torch.as_tensor(radius, dtype=torch.float32, device=vc.device)
    if vc.dim() == 2:
        dist, ok, neg = roi_filter_cuda(vc[None], center[None],
                                        radius.reshape(1), valid[None])
        return dist[0], ok[0], neg[0]
    return roi_filter_cuda(vc, center, radius, valid)


def lsh_hash(x, proj, bias, seg_len: float, *, backend: str = "auto"):
    """p-stable bucket keys x:(n, d) -> (n, L) int32 bits (callers read them
    as uint32); x is stored as f32 or bf16, the projection runs in f32."""
    mode = resolve_backend(backend, x)
    if mode == "ref":
        return _ref.lsh_hash_ref(x, proj, bias, seg_len)
    no_backward("lsh_hash", x, proj, bias)
    return lsh_hash_cuda(x, proj, bias, seg_len)


def assign_clusters(q, sup_v, sup_w, dens, k_scale, threshold, valid=None,
                    *, backend: str = "auto"):
    """Fused cluster assignment (predict / serving): weighted support
    affinity scores, argmax over clusters, density-threshold accept.

    q:(m, d), sup_v:(C, A, d), sup_w:(C, A), dens:(C,) -> (labels (m,)
    int32 with -1 = no cluster, best score (m,) f32). `valid` ((m,) bool or
    None) is the slot-validity mask of a padded serving batch, applied in
    the epilogue: invalid rows come out -1 with score 0.0 exactly, and the
    valid rows are bitwise what the unmasked call gives. With no cluster
    (C = 0) or no query every label is -1 and nothing launches."""
    mode = resolve_backend(backend, q)
    if q.shape[-1] != sup_v.shape[-1]:
        raise ValueError(f"assign_clusters: queries of dimension "
                         f"{q.shape[-1]}, supports of {sup_v.shape[-1]}")
    k = float(torch.tensor(k_scale, dtype=torch.float32))
    thr = float(torch.tensor(threshold, dtype=torch.float32))
    m, n_clusters = q.shape[0], sup_w.shape[0]
    if m == 0 or n_clusters == 0:
        return (torch.full((m,), -1, dtype=torch.int32, device=q.device),
                torch.zeros((m,), dtype=torch.float32, device=q.device))
    if mode == "ref":
        return _ref.assign_ref(q, sup_v, sup_w, dens, k, thr, valid)
    no_backward("assign_clusters", q, sup_v, sup_w, dens)
    return assign_cuda(q, sup_v, sup_w, dens, k, thr, valid)


def flash_attention(q, k, v, q_offset: int = 0, *, causal: bool = True,
                    window=None, chunk=None, softcap=None, scale=None,
                    flat_gqa: bool = True, kv_start=None,
                    backend: str = "auto"):
    """Attention of q (B, H, Sq, dh) over k, v (B, Hkv, Sk, dh) -> (B, H,
    Sq, dh) in q's dtype; f32 softmax and sums. `kv_start` ((B,) int32 or
    None) is the left-padded serving-batch contract: kv slots < kv_start[b]
    are pad, never attended, and the causal / window / chunk masks run in
    logical positions (slot - kv_start), so packed prompts match their solo
    runs. A query row that attends no key comes out 0 from the kernel and
    as the uniform average of V from the plain version, as in the JAX
    package; such rows are the pad slots of a packed batch, which no real
    row reads. `flat_gqa` only chooses the plain version's einsum form in
    the JAX package; both compute the same products.

    Differentiable on both routes; on the kernel route the backward is
    `flash_attention_bwd_cuda` (`csrc/flash_bwd_wgmma.cu` for bf16 at dh
    64 / 80 / 128, reading the lse the forward keeps; else
    `csrc/flash_attention_bwd.cu`), which takes no `q_offset` and no
    `kv_start` (training passes neither): a call with either whose inputs
    require grad raises NotImplementedError."""
    mode = resolve_backend(backend, q)
    if mode == "ref":
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  chunk=chunk, softcap=softcap,
                                  q_offset=int(q_offset), scale=scale,
                                  flat_gqa=flat_gqa, kv_start=kv_start)
    if wants_grad(q, k, v):
        if int(q_offset) != 0 or kv_start is not None:
            raise NotImplementedError(
                "flash_attention: the backward kernel takes no q_offset and "
                "no kv_start (training passes neither); got q_offset="
                f"{int(q_offset)}, kv_start "
                f"{'given' if kv_start is not None else 'None'}")
        return _FlashAttention.apply(q, k, v, dict(
            causal=causal, window=window, chunk=chunk, softcap=softcap,
            scale=scale))
    return flash_attention_cuda(q, k, v, int(q_offset), causal=causal,
                                window=window, chunk=chunk, softcap=softcap,
                                scale=scale, kv_start=kv_start)


def embedding_bag(table, idx, bag_ids, n_bags: int, mode: str = "sum", *,
                  backend: str = "auto"):
    """Rows of table (V, dim) gathered by idx (N,) and summed, or averaged
    with `mode="mean"`, into bag bag_ids[e]: (n_bags, dim) in the table's
    dtype, f32 sums. Negative ids (the -1 pads, anywhere) and bags outside
    [0, n_bags) are skipped, ids at or past V read row V - 1 (the JAX
    package's gather clamps them); empty bags are 0. The kernel computes
    both modes (the JAX package sends "mean" to its plain version); the
    TPU layout knobs `be` and `bw` have no counterpart."""
    kmode = resolve_backend(backend, table)
    if kmode == "ref":
        return _ref.embedding_bag_ref(table, idx, bag_ids, n_bags, mode)
    if wants_grad(table):
        return _EmbeddingBag.apply(table, idx, bag_ids, int(n_bags), mode)
    return embedding_bag_cuda(table, idx, bag_ids, n_bags, mode)


def segment_matmul(msg, seg_ids, n_segments: int, *, backend: str = "auto"):
    """sum_e msg[e] into row seg_ids[e]: (n_segments, d) in msg's dtype,
    f32 sums. Ids outside [0, n_segments) (the -1 pads, anywhere) are
    skipped, and rows never visited are 0, as the JAX wrapper's rule
    has it. The ids need not be sorted."""
    mode = resolve_backend(backend, msg)
    if mode == "ref":
        return _ref.segment_matmul_ref(msg, seg_ids, n_segments)
    if wants_grad(msg):
        return _SegmentMatmul.apply(msg, seg_ids, int(n_segments))
    return segment_matmul_cuda(msg, seg_ids, n_segments)


def gather_rows(table, idx, *, backend: str = "auto"):
    """table[idx]: rows of table (V, ...) by idx (any shape, ids in [0,
    V)). Its gradient with respect to the table sums the rows' gradients
    into their ids through `segment_matmul` (each id's rows in input
    order, from +0, in f32, rounded once), so it is the same bits from run
    to run on the card, where torch's own indexing backward adds by
    atomics. Without a graph to record it is plain indexing."""
    if not wants_grad(table):
        return table[idx]
    return _GatherRows.apply(table, idx, backend)


class _FlashAttention(torch.autograd.Function):
    """The attention kernel and its backward kernel (kernel route). The
    forward keeps the lse that the wgmma kernel writes, where it ran,
    for the backward's wgmma route (which otherwise recomputes it; remat
    re-runs this forward, and so the lse with it)."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = flash_attention_cuda(q, k, v, 0, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, lse=lse,
                                              **ctx.kw)
        return dq, dk, dv, None


class _SegmentMatmul(torch.autograd.Function):
    """The segment-sum kernel and its backward, the row gather."""

    @staticmethod
    def forward(ctx, msg, seg_ids, n_segments):
        ctx.save_for_backward(seg_ids)
        ctx.n_rows = msg.shape[0]
        return segment_matmul_cuda(msg, seg_ids, n_segments)

    @staticmethod
    def backward(ctx, d_out):
        seg_ids, = ctx.saved_tensors
        return segment_matmul_bwd_cuda(d_out, seg_ids, ctx.n_rows), None, \
            None


class _EmbeddingBag(torch.autograd.Function):
    """The EmbeddingBag kernel and its backward, the table's segment sum."""

    @staticmethod
    def forward(ctx, table, idx, bag_ids, n_bags, mode):
        ctx.save_for_backward(idx, bag_ids)
        ctx.v_rows, ctx.mode = table.shape[0], mode
        return embedding_bag_cuda(table, idx, bag_ids, n_bags, mode)

    @staticmethod
    def backward(ctx, d_out):
        idx, bag_ids = ctx.saved_tensors
        return (embedding_bag_bwd_cuda(d_out, idx, bag_ids, ctx.v_rows,
                                       ctx.mode), None, None, None, None)


class _GatherRows(torch.autograd.Function):
    """table[idx], its table gradient a segment sum keyed by idx."""

    @staticmethod
    def forward(ctx, table, idx, backend):
        ctx.save_for_backward(idx)
        ctx.v_rows, ctx.backend = table.shape[0], backend
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        width = grad.shape[idx.dim():]
        flat = grad.reshape(idx.numel(), -1)
        d_table = segment_matmul(flat, idx.reshape(-1), ctx.v_rows,
                                 backend=ctx.backend)
        return d_table.reshape(ctx.v_rows, *width), None, None
