"""Building blocks of the LMs, as the JAX package's `models/layers.py`
computes them: activations in the model's dtype, products accumulated in
f32 and rounded once, norms in f32. `layer_norm`, `he_init` and the MLP
helpers wait for BST (ROADMAP A16)."""

from __future__ import annotations

import torch

from repro_torch import random as trandom


def normal_init(key: torch.Tensor, shape, dtype, stddev: float = 0.02,
                device="cpu") -> torch.Tensor:
    """`jax.random.normal(key, shape) * stddev` in f32, cast to dtype."""
    return (trandom.normal(key, tuple(shape), device) * stddev).to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w over x's last dim, the result in x's dtype. A plain product,
    outside any kernel, as the JAX package leaves it to XLA: f32 inputs
    multiply in f32 (callers keep TF32 off), bf16 ones accumulate in f32
    and round once."""
    return torch.matmul(x, w).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = True) -> torch.Tensor:
    """RMSNorm in f32 with gamma = 1 + scale (zero-centred), in x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    norm = x32 * torch.rsqrt(var + eps)
    gamma = (1.0 + scale.float()) if zero_centered else scale.float()
    return (norm * gamma).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, half-split. x: (..., S, H, dh), positions: (..., S)
    (logical positions; the pad slots of a packed batch go negative)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].float() * freqs            # (.., S, half)
    cos = torch.cos(ang)[..., :, None, :]                     # (.., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
