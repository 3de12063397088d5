"""Building blocks of the LMs, BST and the GNNs, as the JAX package's
`models/layers.py` computes them: activations in the model's dtype,
products accumulated in f32 and rounded once, norms in f32. The
activations are jax.nn's: `gelu` is its tanh form (jax's default;
torch's default is the exact erf form), `leaky_relu` its slope 0.01.

Where BST's serving batches make the FFN's hidden layer large (1,000,000
candidates x 21 positions x 128 in f32 is 10.8 GB), the bias add and the
activation work in place on the fresh product: the same operations in the
same order as out-of-place ones, the same bits, one buffer fewer.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as trandom


def he_init(key: torch.Tensor, shape, dtype, fan_in=None,
            device="cpu") -> torch.Tensor:
    """`jax.random.normal(key, shape) * sqrt(2 / fan_in)` in f32 (fan_in =
    shape[0] by default), cast to dtype."""
    fan_in = shape[0] if fan_in is None else fan_in
    return (trandom.normal(key, tuple(shape), device)
            * (2.0 / fan_in) ** 0.5).to(dtype)


# elements a weight draw makes at a time: its int64 counters and f32 draws
# stay a few GB however large the leaf (kimi-k2's expert leaf is 5.6e9)
DRAW_CHUNK = 1 << 26


def normal_init(key: torch.Tensor, shape, dtype, stddev: float = 0.02,
                device="cpu", out: torch.Tensor | None = None,
                start: int = 0) -> torch.Tensor:
    """`jax.random.normal(key, shape) * stddev` in f32, cast to dtype,
    drawn DRAW_CHUNK elements at a time into one tensor of dtype: `out`
    (a contiguous tensor of `shape`, e.g. one group's slice of a stacked
    leaf) or a new one on `device`. Each slice is the whole draw's
    (`random.normal`'s `start`), so the bits do not depend on the
    chunking. `start` places the leaf at that flat offset of a larger
    draw: experts [a, b) of an (E, ...) leaf start at a * its row size."""
    shape = tuple(shape)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    if tuple(out.shape) != shape or not out.is_contiguous():
        raise ValueError(f"normal_init: out {tuple(out.shape)} is not a "
                         f"contiguous {shape}")
    flat = out.view(-1)
    n = flat.numel()
    for lo in range(0, n, DRAW_CHUNK):
        m = min(DRAW_CHUNK, n - lo)
        flat[lo:lo + m] = (trandom.normal(key, (m,), out.device, start + lo)
                           * stddev).to(dtype)
    return out


def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w (+ b) over x's last dim, the result in x's dtype. A plain
    product, outside any kernel, as the JAX package leaves it to XLA: f32
    inputs multiply in f32 (callers keep TF32 off), bf16 ones accumulate
    in f32 and round once; a bias is added to the f32 product before that
    rounding.

    With a bias the product runs on f32 copies of x and w, as the JAX
    package's f32 product plus bias rounds: for a bf16 x that is a copy
    twice x's size beside it, plus the f32 product. At edge-level widths
    this dominates the GNNs' memory: MeshGraphNet's edge MLP at
    ogb_products takes a (61.9M, 3 x 128) bf16 input, 47.5 GB, whose f32
    copy alone is 95 GB: that cell does not fit one 80 GB card, and
    `chip_smoke.py` runs MeshGraphNet and GraphCast at full_graph_sm."""
    if b is None:
        return torch.matmul(x, w).to(x.dtype)
    out = torch.matmul(x.float(), w.float()).add_(b)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim in f32 with jax's eps 1e-6 (torch's
    default is 1e-5): (x - mean) * rsqrt(var + eps) * scale + bias, var
    the mean of squared deviations, in x's dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` with its default approximate=True (the tanh form),
    term for term: x * 0.5 * (1 + tanh(sqrt(2/pi) (x + 0.044715 x**3)))
    with jax's constants rounded to f32 first, in one buffer beside x
    (out of place, the same operations, where autograd records x)."""
    if torch.is_grad_enabled() and x.requires_grad:
        cdf = torch.tanh((x * x * x * 0.044715 + x) * _SQRT_2_OVER_PI)
        return (cdf + 1.0) * 0.5 * x
    cdf = x * x
    cdf.mul_(x).mul_(0.044715).add_(x).mul_(_SQRT_2_OVER_PI).tanh_()
    cdf.add_(1.0).mul_(0.5)
    return cdf.mul_(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """`jax.nn.leaky_relu`: x where x >= 0, else negative_slope * x."""
    return torch.where(x >= 0, x, negative_slope * x)


def mlp_init(key: torch.Tensor, sizes, dtype, bias: bool = True,
             device="cpu") -> dict:
    """The JAX package's `mlp_init`: per layer i, w{i} (he_init from the
    i-th of split(key, len(sizes) - 1)) and, with `bias`, b{i} zeros."""
    params = {}
    keys = trandom.split(key, len(sizes) - 1)
    for i, (din, dout) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = he_init(keys[i], (din, dout), dtype, device=device)
        if bias:
            params[f"b{i}"] = torch.zeros((dout,), dtype=dtype, device=device)
    return params


def mlp_apply(params: dict, x: torch.Tensor, act=torch.relu,
              final_act: bool = False) -> torch.Tensor:
    """dense layer after dense layer, `act` between them (and after the
    last with `final_act`)."""
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = dense(x, params[f"w{i}"], params.get(f"b{i}"))
        if i < n - 1 or final_act:
            x = act(x)
    return x


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
