"""CUDA wrapper of the attention kernels (`csrc/flash_attention.cu`,
`csrc/flash_wgmma.cu`), which replace the TPU kernel
`flash_attention_pallas` of the JAX package, and the plan that picks one
of them by shape and dtype (`kernel_plan`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import i32, require_cuda

# dynamic shared memory one Hopper block may opt into: 227 KB less a
# margin for the kernel's static shared variables
SMEM_MAX = 232448 - 256
MAX_HEAD_DIM = 256
_MAX_GRID_YZ = 65535
# the card's streaming multiprocessors (H100 SXM)
N_SM = 132
# split kernel: query rows (rep x Sq) a block holds, keys it scores at a
# time, the shortest attended range it takes, kv chunks a (row, kv head)
# may take, and the blocks a split grid aims at (four a SM)
SPLIT_ROWS = 8
SPLIT_TILE = 128
SPLIT_MIN = 512
MAX_SPLIT = 256
SPLIT_BLOCKS = 4 * N_SM
# small kernel: Sq, Sk and dh it takes, at most; warps a block
SMALL_S = 32
SMALL_DH = 16
_WARPS = 8
# wgmma kernel: query rows a warpgroup, dh it takes (a multiple of 16, at
# most)
WGMMA_ROWS = 64
WGMMA_DH = 128
_PATHS = ("tiles", "split", "small", "wgmma")


class Plan(NamedTuple):
    """Which kernel computes a call, and for "split" how the host's bound
    [split_lo, split_lo + n_split * split_len) of the attended kv slots is
    cut into n_split chunks of split_len slots, one block each."""
    kernel: str            # "tiles", "split", "small" or "wgmma"
    n_split: int = 1
    split_lo: int = 0
    split_len: int = 0


def _smem_bytes(dh: int, rp: int, bc: int) -> int:
    """Bytes of the layout carved at the top of `flash_kernel`: queries
    and keys transposed (rows padded by 4), values and accumulators with
    dh rounded up to 4, the score tile, and three floats per row."""
    dh4 = -(-dh // 4) * 4
    return 4 * (dh * (rp + 4) + dh * (bc + 4) + bc * dh4 + rp * (bc + 4)
                + rp * dh4 + 3 * rp)


def smem_plan(dh: int, rep: int, sq: int) -> tuple[int, int, int, int]:
    """(q heads per tile, query positions per tile, keys per kv tile,
    dynamic shared bytes). A tile holds up to 64 rows (32 past dh = 96):
    all `rep` heads of a kv head (at most 64 of them) times as many query
    positions as fit, no more than Sq. Tiles of 16 rows or fewer (decode)
    take up to 256 keys at a time, larger ones 64; the largest that fits
    in shared memory is taken."""
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {dh} > {MAX_HEAD_DIM}")
    rows = 64 if dh <= 96 else 32
    hb = min(rep, rows)
    ppt = min(max(1, rows // hb), sq)
    rp = -(-(hb * ppt) // 4) * 4
    for bc in ((256, 128, 64, 32) if rp <= 16 else (64, 32)):
        nbytes = _smem_bytes(dh, rp, bc)
        if nbytes <= SMEM_MAX:
            return hb, ppt, bc, nbytes
    raise ValueError(f"flash_attention: no tile of head_dim {dh} fits in "
                     f"{SMEM_MAX} bytes of shared memory")


def wgmma_plan(dh: int, rep: int, sq: int) -> tuple[int, int, int]:
    """(q heads per tile, query positions per tile, dynamic shared bytes)
    of `flash_wgmma_kernel`: tiles of all `rep` heads of a kv head (at most
    64) times as many positions as fit, no more than Sq, in 128 rows (two
    warpgroups sharing each K / V tile) where more than 64 rows fill, else
    in 64. The bytes: a 64-row Q tile a warpgroup and two stages of K and
    V tiles of 64 keys, in bf16 core matrices of 8 rows x 16 bytes, 144
    bytes apart along a row."""
    hb = min(rep, WGMMA_ROWS)
    ppt = min(max(1, 2 * WGMMA_ROWS // hb), sq)
    if hb * ppt <= WGMMA_ROWS:
        ppt = min(max(1, WGMMA_ROWS // hb), sq)
    warpgroups = -(-(hb * ppt) // WGMMA_ROWS)
    return hb, ppt, (warpgroups + 2 * 2) * (WGMMA_ROWS // 8) * (dh // 8) * 144


def attended_range(sq: int, sk: int, q_offset: int, causal: bool,
                   window, chunk) -> tuple[int, int]:
    """The host's bound [lo, hi] of the kv slots that some query at slots
    q_offset .. q_offset + sq - 1 can attend, whatever kv_start (a device
    tensor the host never reads) is: kv_start only masks slots below it,
    and a chunk holds no slot further than chunk - 1 from a query."""
    first, last = q_offset, q_offset + sq - 1
    lo, hi = 0, sk - 1
    if causal:
        hi = min(hi, last)
    if window:
        lo = max(lo, first - window + 1)
    if chunk:
        lo = max(lo, first - chunk + 1)
        hi = min(hi, last + chunk - 1)
    return lo, hi


def kernel_plan(b: int, h: int, hkv: int, sq: int, sk: int, dh: int,
                q_offset: int = 0, *, causal: bool = True, window=None,
                chunk=None, bf16: bool = False) -> Plan:
    """The kernel for a call of these shapes (and dtype: bf16 or f32).

    "small" where Sq and Sk are at most 32 and dh at most 16 (BST's 21 x
    21 x 4): a warp per (row, head). "split" where the rep x Sq query rows
    of a kv head fit one split block (at most 8), the tile kernel's grid
    would not fill the 132 SMs once, and the attended range is long (at
    least 512 slots): the range is cut into as many chunks as bring the
    grid (a block per chunk, kv head and batch row) to about four blocks
    a SM, no more than one a 128 keys. Otherwise (prefill) "wgmma", the
    tensor cores, for bf16 with dh a multiple of 16 up to 128, and the
    SIMT "tiles" for the rest (f32, other dh)."""
    if sq <= SMALL_S and sk <= SMALL_S and dh <= SMALL_DH and \
            b * h < 2 ** 31 - 2 ** 20:
        return Plan("small")
    rep = h // hkv
    lo, hi = attended_range(sq, sk, q_offset, causal, window, chunk)
    n = hi - lo + 1
    hb, ppt, _, _ = smem_plan(dh, rep, sq)
    tiles_blocks = b * hkv * -(-sq // ppt) * -(-rep // hb)
    if rep * sq <= SPLIT_ROWS and b <= _MAX_GRID_YZ and \
            tiles_blocks < N_SM and n >= SPLIT_MIN:
        n_split = min(-(-n // SPLIT_TILE), -(-SPLIT_BLOCKS // (b * hkv)),
                      MAX_SPLIT)
        return Plan("split", n_split, lo, -(-n // n_split))
    if bf16 and dh % 16 == 0 and dh <= WGMMA_DH:
        return Plan("wgmma")
    return Plan("tiles")


def split_smem_bytes(dh: int, rows: int, vec: int) -> int:
    """Bytes of the layout carved at the top of `flash_split_kernel`:
    queries, scores (a tile of 128 a row), the value parts of the key
    subsets (256 threads over dh / vec vectors), the accumulators and
    three floats a row."""
    ks = 256 // (dh // vec)
    return 4 * (rows * dh + rows * SPLIT_TILE + ks * rows * dh + rows * dh
                + 3 * rows)


def small_smem_bytes(dh: int) -> int:
    """K and V of up to 32 keys for each of a block's 8 warps, as f32,
    with dh rounded up to 4, 8 or 16."""
    return 4 * _WARPS * 2 * SMALL_S * next(w for w in (4, 8, 16) if dh <= w)


def split_vec(dh: int, tensors) -> int:
    """Elements of one K / V load in the split kernel: the widest of at
    most 16 bytes that divides dh, every stride and each base address."""
    es = tensors[0].element_size()
    vec = 16 // es
    while vec > 1 and (dh % vec or any(
            t.data_ptr() % (vec * es) or
            any(st % vec for st in t.stride()[:3]) for t in tensors)):
        vec //= 2
    return vec


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_offset: int = 0, *, causal: bool = True,
                         window=None, chunk=None, softcap=None, scale=None,
                         kv_start=None, batch_on_z=None,
                         force_tiles: bool = False) -> torch.Tensor:
    """q (B, H, Sq, dh), k and v (B, Hkv, Sk, dh) on the card, all f32 or
    all bf16, H a multiple of Hkv, dh <= 256 -> (B, H, Sq, dh) in q's
    dtype. q, k and v may be any views whose last dim is contiguous (the
    models pass transposed ones): they are read through their strides.
    kv_start: (B,) int32 pad slots per row, or None for none. The kernel
    is `kernel_plan`'s; the tile kernels put the batch on grid.z where
    B <= 65,535 and fold it into grid.x past that (`batch_on_z` forces
    one or the other, for timing the two; `force_tiles` runs the SIMT
    tiles kernel where the plan took wgmma). One launch, two for "split"
    (its partials, then their combine). `flash_attention_cuda.by_path`
    counts the launches of each kernel."""
    dev = require_cuda("flash_attention", q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, sk, dh) or v.shape != k.shape or \
            hkv == 0 or h % hkv != 0:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    for name, val in (("window", window), ("chunk", chunk)):
        if val is not None and not val > 0:
            raise ValueError(f"flash_attention: {name} must be > 0, got "
                             f"{val}")
    if hkv > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: Hkv={hkv} exceeds {_MAX_GRID_YZ}")
    plan = kernel_plan(b, h, hkv, max(sq, 1), max(sk, 1), dh, int(q_offset),
                       causal=causal, window=window, chunk=chunk,
                       bf16=q.dtype == torch.bfloat16)
    if force_tiles and plan.kernel == "wgmma":
        plan = Plan("tiles")
    out = torch.empty((b, h, sq, dh), dtype=q.dtype, device=dev)
    if out.numel() == 0 or sk == 0:
        return out.zero_()
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    if kv_start is None:
        kv_start = torch.zeros((b,), dtype=torch.int32, device=dev)
    else:
        require_cuda("flash_attention kv_start", q, kv_start)
        kv_start = i32("flash_attention kv_start", kv_start.reshape(b))
    scale = dh ** -0.5 if scale is None else scale
    hb = ppt = bc = vec = 0
    scratch = None
    if plan.kernel in ("tiles", "wgmma"):
        if plan.kernel == "tiles":
            hb, ppt, bc, smem = smem_plan(dh, h // hkv, sq)
        else:
            hb, ppt, smem = wgmma_plan(dh, h // hkv, sq)
            # its copies move 16 bytes: base and strides in whole 8 x bf16
            q, k, v = (t if t.data_ptr() % 16 == 0 and
                       all(st % 8 == 0 for st in t.stride()[:3])
                       else t.contiguous() for t in (q, k, v))
        if batch_on_z is None:
            batch_on_z = b <= _MAX_GRID_YZ
    elif plan.kernel == "split":
        rows = h // hkv * sq
        vec = split_vec(dh, (k, v))
        smem = split_smem_bytes(dh, rows, vec)
        scratch = torch.empty(b * hkv * plan.n_split * rows * (dh + 2),
                              dtype=torch.float32, device=dev)
    else:
        smem = small_smem_bytes(dh)
    err = _build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_start.data_ptr(),
        out.data_ptr(), b, h, hkv, sq, sk, dh, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], int(q_offset), int(bool(causal)),
        int(window or 0), int(chunk or 0), float(softcap or 0.0),
        float(scale), int(q.dtype == torch.bfloat16),
        _PATHS.index(plan.kernel), hb, ppt, bc, smem, int(bool(batch_on_z)),
        plan.n_split, plan.split_lo, plan.split_len, vec,
        0 if scratch is None else scratch.data_ptr(), _build.stream_ptr(dev))
    _build.check("flash_attention", err)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.by_path[plan.kernel] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.by_path = dict.fromkeys(_PATHS, 0)


def _bf16_ordinal(x: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in the order of their values (adjacent bf16
    numbers differ by 1)."""
    bits = x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(bits >= 0x8000, -(bits & 0x7FFF), bits)


def compare_with_plain(got: torch.Tensor, want: torch.Tensor,
                       attended: torch.Tensor) -> dict:
    """The kernel's output against its plain version's on the same inputs,
    by the stated rule. `attended` (B, Sq) says which query rows attend at
    least one key (`ref.attention_mask(...).any(-1)`); only those rows are
    compared, and every head of the other rows must be exactly 0 in the
    kernel's output (the plain version writes the mean of V there).

    f32: |got - want| <= 1e-5 + 2e-5 |want|. bf16: at most one bf16 ulp
    apart, or within the f32 atol 1e-5 where the weighted sum cancels to
    near 0 and the two f32 values straddle a rounding boundary close to
    zero. Both paths compute in f32 and round once to q's dtype.

    Returns the number of compared entries outside the rule, the largest
    absolute difference on compared rows, and the number of nonzero
    entries on rows that attend nothing."""
    rows = attended[:, None, :, None].expand_as(got)
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if got.dtype == torch.bfloat16:
        ok = ((_bf16_ordinal(got) - _bf16_ordinal(want)).abs() <= 1) | \
            (diff <= 1e-5)
    else:
        ok = diff <= 1e-5 + 2e-5 * w.abs()
    return dict(bad=int((~ok & rows).sum()),
                max_abs_err=float(diff[rows].max()) if bool(rows.any())
                else 0.0,
                masked_nonzero=int(((g != 0) & ~rows).sum()))
