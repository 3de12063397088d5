"""CUDA wrapper of the attention kernel (`csrc/flash_attention.cu`), which
replaces the TPU kernel `flash_attention_pallas` of the JAX package."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import i32, require_cuda

# dynamic shared memory one Hopper block may opt into: 227 KB less a
# margin for the kernel's static shared variables
SMEM_MAX = 232448 - 256
MAX_HEAD_DIM = 256
_MAX_GRID_Y = 65535


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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_offset: int = 0, *, causal: bool = True,
                         window=None, chunk=None, softcap=None, scale=None,
                         kv_start=None) -> torch.Tensor:
    """q (B, H, Sq, dh), k and v (B, Hkv, Sk, dh) on the card, all f32 or
    all bf16, H a multiple of Hkv, dh <= 256 -> (B, H, Sq, dh) in q's
    dtype. q may be any view whose last dim is contiguous (the model
    passes a transposed one); k and v are made contiguous. kv_start: (B,)
    int32 pad slots per row, or None for none. One launch (the batch
    is split only past 2**31 - 1 blocks)."""
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
    hb, ppt, bc, smem = smem_plan(dh, h // hkv, max(sq, 1))
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    for name, val in (("window", window), ("chunk", chunk)):
        if val is not None and not val > 0:
            raise ValueError(f"flash_attention: {name} must be > 0, got "
                             f"{val}")
    if hkv > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: Hkv={hkv} exceeds {_MAX_GRID_Y}")
    out = torch.empty((b, h, sq, dh), dtype=q.dtype, device=dev)
    if out.numel() == 0 or sk == 0:
        return out.zero_()
    if q.stride(3) != 1:
        q = q.contiguous()
    k, v = k.contiguous(), v.contiguous()
    if kv_start is None:
        kv_start = torch.zeros((b,), dtype=torch.int32, device=dev)
    else:
        require_cuda("flash_attention kv_start", q, kv_start)
        kv_start = i32("flash_attention kv_start", kv_start.reshape(b))
    scale = dh ** -0.5 if scale is None else scale
    err = _build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_start.data_ptr(),
        out.data_ptr(), b, h, hkv, sq, sk, dh, q.stride(0), q.stride(1),
        q.stride(2), int(q_offset), int(bool(causal)), int(window or 0),
        int(chunk or 0), float(softcap or 0.0), float(scale),
        int(q.dtype == torch.bfloat16), hb, ppt, bc, smem,
        _build.stream_ptr(dev))
    _build.check("flash_attention", err)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


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
