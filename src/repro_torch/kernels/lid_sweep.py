"""CUDA wrapper of the fused LID sweep kernel (`csrc/lid_sweep.cu`), which
replaces the TPU kernel `lid_sweep_pallas` of the JAX package."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import f32, i32, require_cuda, storage, u8
from repro_torch.kernels.affinity_matvec import leaf_groups

# dynamic shared memory one Hopper block may opt into (227 KB)
SMEM_MAX = 232448
SMS = 132            # an H100's SMs
MAX_CLUSTER = 8      # the portable thread-block cluster size
# the in-sweep refresh folds its columns on a 14-deep stack
MAX_REFRESH_CAP = 8192


class Plan(NamedTuple):
    route: str      # "smem": each block's rows staged; "global": read in place
    cluster: int    # blocks a seed (a thread-block cluster)
    rows_per: int   # rows of a block's slice, ceil(cap / cluster)
    threads: int    # threads a block: four a row, at most 256
    smem: int       # dynamic shared bytes


def plan(bsz: int, cap: int, d: int) -> Plan:
    """The sweep's launch plan for B seeds of (cap, d) rows: the largest
    cluster (8, 4, 2 or 1 blocks) with B x cluster <= 132 and at least 16
    rows a block, enlarged up to 8 where a block's slice of leaf-major rows
    would not fit in shared memory, and rows read from device memory where
    not even 8 blocks hold them. Raises where the cap-long lanes alone do
    not fit."""
    lanes = 4 * 7 * (-(-cap // 32) * 32)   # padded to 32 slots
    if lanes > SMEM_MAX:
        raise ValueError(f"lid_sweep: cap={cap} lanes need {lanes} bytes of "
                         "shared memory")
    row_bytes = 4 * (128 * leaf_groups(d) + 16)
    cs = 1
    for c in (8, 4, 2):
        if bsz * c <= SMS and c <= max(1, cap // 16):
            cs = c
            break
    route = "smem"
    while lanes + -(-cap // cs) * row_bytes > SMEM_MAX:
        if cs == MAX_CLUSTER:
            route = "global"
            break
        cs *= 2
    rows_per = -(-cap // cs)
    threads = min(256, max(32, -(-4 * rows_per // 32) * 32))
    smem = lanes + (rows_per * row_bytes if route == "smem" else 0)
    return Plan(route, cs, rows_per, threads, smem)


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A bool mask as the bytes the kernel reads: a view where it is bool
    (one byte, 0 or 1), so that a launch adds no conversion kernel."""
    if t.dtype == torch.bool:
        return t.contiguous().view(torch.uint8)
    return u8(t)


def lid_sweep_cuda(v_beta, beta_idx, beta_mask, x, ax, n_iters, converged,
                   k_scale: float, *, n_steps: int, max_iters: int,
                   tol: float, refresh_every: int = 0,
                   support_eps: float = 1e-6):
    """v_beta:(B, cap, d) f32 or bf16, beta_idx:(B, cap) i32,
    beta_mask:(B, cap) bool, x/ax:(B, cap) f32, n_iters:(B,) i32,
    converged:(B,) bool on the card -> (x, ax, n_iters, converged), new
    tensors."""
    dev = require_cuda("lid_sweep", v_beta, beta_idx, beta_mask, x, ax,
                       n_iters, converged)
    bsz, cap, d = v_beta.shape
    for name, t, shape in (("beta_idx", beta_idx, (bsz, cap)),
                           ("beta_mask", beta_mask, (bsz, cap)),
                           ("x", x, (bsz, cap)), ("ax", ax, (bsz, cap)),
                           ("n_iters", n_iters, (bsz,)),
                           ("converged", converged, (bsz,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"lid_sweep: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if refresh_every > 0 and cap > MAX_REFRESH_CAP:
        raise ValueError(f"lid_sweep: the in-sweep refresh takes cap <= "
                         f"{MAX_REFRESH_CAP}, got {cap}")
    v_beta = storage("lid_sweep v_beta", v_beta)
    x = f32("lid_sweep x", x)
    ax = f32("lid_sweep ax", ax)
    beta_idx = i32("lid_sweep beta_idx", beta_idx)
    n_iters = i32("lid_sweep n_iters", n_iters)
    mask8 = as_bytes(beta_mask)
    cv8 = as_bytes(converged)
    pl = plan(bsz, cap, d)
    x_out = torch.empty_like(x)
    ax_out = torch.empty_like(ax)
    it_out = torch.empty_like(n_iters)
    cv_out = torch.empty(bsz, dtype=torch.bool, device=dev)
    lib = _build.library()
    launch = (lib.lid_sweep_launch if v_beta.dtype == torch.float32
              else lib.lid_sweep_bf16_launch)
    err = launch(
        v_beta.data_ptr(), beta_idx.data_ptr(), mask8.data_ptr(),
        x.data_ptr(), ax.data_ptr(), n_iters.data_ptr(), cv8.data_ptr(),
        x_out.data_ptr(), ax_out.data_ptr(), it_out.data_ptr(),
        cv_out.data_ptr(), bsz, cap, d, float(k_scale), int(n_steps),
        int(max_iters), float(tol), int(refresh_every), float(support_eps),
        pl.cluster, pl.threads, pl.rows_per, int(pl.route == "smem"),
        pl.smem, _build.stream_ptr(dev))
    _build.check("lid_sweep", err)
    lid_sweep_cuda.launches += 1
    lid_sweep_cuda.by_path[pl.route] += 1
    return x_out, ax_out, it_out, cv_out


lid_sweep_cuda.launches = 0
lid_sweep_cuda.by_path = {"smem": 0, "global": 0}
