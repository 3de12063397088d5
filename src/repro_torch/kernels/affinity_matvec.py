"""CUDA wrapper of the masked affinity matvec kernel
(`csrc/affinity_matvec.cu`), which replaces the TPU kernel
`affinity_matvec_pallas` of the JAX package."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import f32, i32, require_cuda, storage

# dynamic shared memory one Hopper block may opt into (227 KB)
SMEM_MAX = 232448
_SLOTS, _TC = 16, 4
_GROUP_SLOTS = _SLOTS * _TC
# the j stack holds 8 levels: at most 128 groups of 4 columns a class
MAX_N = 8192


class Plan(NamedTuple):
    route: str       # "smem": rows staged leaf-major; "global": read in place
    rows: int        # output rows a block: 4 a thread ("smem"), 1 ("global")
    classes: int     # G: column classes, j = r mod G (threads of a row group)
    ubits: int       # log2 U, U = P / G columns a class (P = pow2 >= n)
    tc: int          # columns a thread sums in registers (a subtree)
    groups: int      # U / tc groups a class
    gpp: int         # groups staged a pass
    smem: int        # dynamic shared bytes


def leaf_groups(d: int) -> int:
    """float4 groups a leaf of a leaf-major row: ceil(ceil(d / 32) / 4)."""
    return (-(-d // 32) + 3) // 4


def column_classes(n: int) -> tuple[int, int, int]:
    """(G, U, tc) of `tree_matvec`'s halving tree over P = pow2 >= n
    leaves: the leaves j = r mod G (r < G) form a complete subtree of U =
    P / G leaves, met in bit-reversed order of u = (j - r) / G, tc at a
    time (a complete subtree of tc leaves); G <= 16, tc <= 4."""
    p = 1 << max(n - 1, 0).bit_length()
    if p >= 64:
        return 16, p // 16, 4
    if p >= 4:
        return p // 4, 4, 4
    return 1, p, p


def plan(m: int, n: int, d: int) -> Plan:
    """The kernel's launch plan for (m, d) x (n, d) rows of a seed."""
    if n > MAX_N:
        raise ValueError(f"affinity_matvec: n = {n} columns exceed the "
                         f"kernel's {MAX_N}")
    g, u, tc = column_classes(n)
    groups = u // tc
    ld = 128 * leaf_groups(d) + 4
    rows = min(64, 8 * -(-max(m, 1) // 8))
    while True:
        meta = 4 * 2 * rows
        per_group = 4 * _GROUP_SLOTS * (ld + 4)
        gpp = min(groups, (SMEM_MAX - meta - 4 * rows * ld) // per_group)
        if gpp >= 1:
            return Plan("smem", rows, g, u.bit_length() - 1, tc, groups, gpp,
                        meta + 4 * rows * ld + gpp * per_group)
        if rows == 8:
            break
        rows //= 2
    rows = min(16, 2 * -(-max(m, 1) // 2))   # one row a thread
    gpp = min(groups, 32)
    return Plan("global", rows, g, u.bit_length() - 1, tc, groups, gpp,
                4 * 2 * rows + 4 * _GROUP_SLOTS * 4 * gpp)


def affinity_matvec_cuda(q, q_idx, c, c_idx, w, k_scale: float):
    """q:(B, m, d), q_idx:(B, m) i32, c:(B, n, d), c_idx:(B, n) i32,
    w:(B, n) f32 on the card -> (B, m) f32. q and c are stored in one
    dtype, f32 or bf16."""
    dev = require_cuda("affinity_matvec", q, q_idx, c, c_idx, w)
    bsz, m, d = q.shape
    n = c.shape[1]
    if (tuple(c.shape) != (bsz, n, d) or tuple(q_idx.shape) != (bsz, m)
            or tuple(c_idx.shape) != (bsz, n) or tuple(w.shape) != (bsz, n)):
        raise ValueError(
            f"affinity_matvec: shapes q{tuple(q.shape)} q_idx"
            f"{tuple(q_idx.shape)} c{tuple(c.shape)} c_idx"
            f"{tuple(c_idx.shape)} w{tuple(w.shape)}")
    if q.dtype != c.dtype:     # a mixed pair is no engine's: no upcast
        raise TypeError(f"affinity_matvec: q is {q.dtype} and c is "
                        f"{c.dtype}; both must be stored in one dtype")
    q = storage("affinity_matvec q", q)
    c = storage("affinity_matvec c", c)
    w = f32("affinity_matvec w", w)
    q_idx = i32("affinity_matvec q_idx", q_idx)
    c_idx = i32("affinity_matvec c_idx", c_idx)
    pl = plan(m, n, d)
    out = torch.empty((bsz, m), dtype=torch.float32, device=dev)
    lib = _build.library()
    launch = (lib.affinity_matvec_launch if q.dtype == torch.float32
              else lib.affinity_matvec_bf16_launch)
    err = launch(
        q.data_ptr(), q_idx.data_ptr(), c.data_ptr(), c_idx.data_ptr(),
        w.data_ptr(), out.data_ptr(), bsz, m, n, d, float(k_scale),
        int(pl.route == "smem"), pl.rows, pl.classes, pl.ubits, pl.tc,
        pl.groups, pl.gpp, pl.smem, _build.stream_ptr(dev))
    _build.check("affinity_matvec", err)
    affinity_matvec_cuda.launches += 1
    affinity_matvec_cuda.by_path[pl.route] += 1
    return out


affinity_matvec_cuda.launches = 0
affinity_matvec_cuda.by_path = {"smem": 0, "global": 0}
