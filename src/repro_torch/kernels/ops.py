"""The kernel layer of the port: one wrapper per op of the hot paths.

Every hot-path module (`core.affinity`, `core.lid`, `core.roi`, `core.civs`,
`lsh.pstable`, `core.alid.assign_labels` behind predict and serving, the
full-matrix baselines through `core.affinity`, the LMs' and BST's
attention in `models.transformer` and `models.bst`, and BST's multi-hot
lookups) computes distances, affinities, LSH keys, assignments,
attention, bag sums and segment sums only through these wrappers. Each takes
`backend`:

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
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.affinity import affinity_cuda
from repro_torch.kernels.affinity_matvec import affinity_matvec_cuda
from repro_torch.kernels.assign import assign_cuda
from repro_torch.kernels.embedding_bag import embedding_bag_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.lid_sweep import lid_sweep_cuda
from repro_torch.kernels.lsh_hash import lsh_hash_cuda
from repro_torch.kernels.roi_filter import roi_filter_cuda
from repro_torch.kernels.segment_matmul import segment_matmul_cuda

BACKENDS = ("auto", "ref", "kernel")

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
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


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
    f32, with no diagonal logic. The kernel takes f32 only: bf16 storage
    waits for ROADMAP queue item "bf16 storage"."""
    mode = resolve_backend(backend, q)
    check_norm(mode, p, "affinity")
    if mode == "ref":
        return _ref.affinity_ref(q, c, k_scale, p)
    if q.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"affinity: the kernel takes float32 only, got "
                        f"{q.dtype} and {c.dtype} (bf16 storage is ROADMAP "
                        "queue item 'bf16 storage')")
    lead = torch.broadcast_shapes(q.shape[:-2], c.shape[:-2])
    return affinity_cuda(q.expand(*lead, *q.shape[-2:]),
                         c.expand(*lead, *c.shape[-2:]), k_scale)


def affinity_matvec(q, q_idx, c, c_idx, w, k_scale: float, p: float = 2.0,
                    *, backend: str = "auto"):
    """out_i = sum_j [q_idx_i != c_idx_j] exp(-k||q_i - c_j||) w_j, (..., m)
    f32 for q:(..., m, d), c:(..., n, d); the leading dim is the seed batch.
    """
    mode = resolve_backend(backend, q)
    check_norm(mode, p, "affinity_matvec")
    if mode == "ref":
        return _ref.affinity_matvec_ref(q, q_idx, c, c_idx, w, k_scale, p)
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
    radius = torch.as_tensor(radius, dtype=torch.float32, device=vc.device)
    if vc.dim() == 2:
        dist, ok, neg = roi_filter_cuda(vc[None], center[None],
                                        radius.reshape(1), valid[None])
        return dist[0], ok[0], neg[0]
    return roi_filter_cuda(vc, center, radius, valid)


def lsh_hash(x, proj, bias, seg_len: float, *, backend: str = "auto"):
    """p-stable bucket keys x:(n, d) -> (n, L) int32 bits (callers read them
    as uint32); the projection runs in f32."""
    mode = resolve_backend(backend, x)
    if mode == "ref":
        return _ref.lsh_hash_ref(x, proj, bias, seg_len)
    return lsh_hash_cuda(x.float(), proj, bias, seg_len)


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
    the JAX package; both compute the same products."""
    mode = resolve_backend(backend, q)
    if mode == "ref":
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  chunk=chunk, softcap=softcap,
                                  q_offset=int(q_offset), scale=scale,
                                  flat_gqa=flat_gqa, kv_start=kv_start)
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
    return embedding_bag_cuda(table, idx, bag_ids, n_bags, mode)


def segment_matmul(msg, seg_ids, n_segments: int, *, backend: str = "auto"):
    """sum_e msg[e] into row seg_ids[e]: (n_segments, d) in msg's dtype,
    f32 sums. Ids outside [0, n_segments) (the -1 pads, anywhere) are
    skipped, and rows never visited are 0, as the JAX wrapper's rule
    has it. The ids need not be sorted."""
    mode = resolve_backend(backend, msg)
    if mode == "ref":
        return _ref.segment_matmul_ref(msg, seg_ids, n_segments)
    return segment_matmul_cuda(msg, seg_ids, n_segments)
