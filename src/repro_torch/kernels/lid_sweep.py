"""CUDA wrapper of the fused LID sweep kernel (`csrc/lid_sweep.cu`), which
replaces the TPU kernel `lid_sweep_pallas` of the JAX package."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import f32, i32, require_cuda, u8

# dynamic shared memory one Hopper block may opt into: 227 KB less a
# margin for the kernel's static shared variables
SMEM_MAX = 232448 - 256
_WARPS = 8


def smem_plan(cap: int, d: int, refresh_every: int) -> tuple[bool, int]:
    """(rows in shared memory?, dynamic shared bytes) for one seed's block:
    five (cap,) lanes, the per-warp refresh trees when the refresh is on,
    and the (cap, d+1) padded rows when they fit in what remains."""
    pow2 = 1 << max(cap - 1, 0).bit_length()
    lanes = 4 * (5 * cap + (_WARPS * pow2 if refresh_every > 0 else 0))
    rows = 4 * cap * (d + 1)
    if lanes + rows <= SMEM_MAX:
        return True, lanes + rows
    if lanes > SMEM_MAX:
        raise ValueError(f"lid_sweep: cap={cap} lanes need {lanes} bytes of "
                         "shared memory")
    return False, lanes


def lid_sweep_cuda(v_beta, beta_idx, beta_mask, x, ax, n_iters, converged,
                   k_scale: float, *, n_steps: int, max_iters: int,
                   tol: float, refresh_every: int = 0,
                   support_eps: float = 1e-6):
    """v_beta:(B, cap, d) f32, beta_idx:(B, cap) i32, beta_mask:(B, cap)
    bool, x/ax:(B, cap) f32, n_iters:(B,) i32, converged:(B,) bool on the
    card -> (x, ax, n_iters, converged), new tensors."""
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
    v_beta = f32("lid_sweep v_beta", v_beta)
    x = f32("lid_sweep x", x)
    ax = f32("lid_sweep ax", ax)
    beta_idx = i32("lid_sweep beta_idx", beta_idx)
    n_iters = i32("lid_sweep n_iters", n_iters)
    mask8 = u8(beta_mask)
    cv8 = u8(converged)
    use_smem, smem = smem_plan(cap, d, refresh_every)
    x_out = torch.empty_like(x)
    ax_out = torch.empty_like(ax)
    it_out = torch.empty_like(n_iters)
    cv_out = torch.empty_like(cv8)
    err = _build.library().lid_sweep_launch(
        v_beta.data_ptr(), beta_idx.data_ptr(), mask8.data_ptr(),
        x.data_ptr(), ax.data_ptr(), n_iters.data_ptr(), cv8.data_ptr(),
        x_out.data_ptr(), ax_out.data_ptr(), it_out.data_ptr(),
        cv_out.data_ptr(), bsz, cap, d, float(k_scale), int(n_steps),
        int(max_iters), float(tol), int(refresh_every), float(support_eps),
        int(use_smem), smem, _build.stream_ptr(dev))
    _build.check("lid_sweep", err)
    lid_sweep_cuda.launches += 1
    return x_out, ax_out, it_out, cv_out.bool()


lid_sweep_cuda.launches = 0
