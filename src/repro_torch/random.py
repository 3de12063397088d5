"""Counter-based random numbers that reproduce `jax.random` bit for bit.

The JAX package draws every random number of a fit from threefry2x32 in
partitionable mode (the jax 0.9 default): the LSH projections and biases
(`lsh.pstable.make_projections`), the round keys of the fit driver and the
Gumbel top-k seeding (`core.alid._sample_seeds`); the language models draw
their weights (`models.transformer.init_params`, per layer group through
`fold_in`) and `serve.engine.generate` its samples (`categorical`) from it
too, and BST's synthetic batches (`data.recsys.bst_batch`) their ids,
clicks and dense features (`randint`, `bernoulli`, `normal`). Labels and
weights can only match the reference if the port draws the same numbers,
so this module ports that generator instead of using `torch.Generator`.

A key is an int64 tensor of shape (2,) holding two uint32 words. The
cipher runs on int32 tensors holding the uint32 bits (torch has no uint32
arithmetic on the CPU): an int32 add wraps as a uint32 add does, and the
logical right shift is the arithmetic one masked to the bits shifted in.
Half the bytes of int64 words, which matters where a draw is billions of
elements (the MoE experts' weights).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def PRNGKey(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with 32-bit seeds: [0, seed mod 2**32]."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64)


def _words(key: torch.Tensor) -> tuple[int, int]:
    k = key.tolist()
    return int(k[0]), int(k[1])


def _i32(v: int) -> int:
    """The int32 holding the uint32 word v."""
    v &= _M32
    return v - (1 << 32) if v >= 1 << 31 else v


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _rounds(x0, x1, rot):
    for r in rot:
        x0 = x0 + x1
        x1 = x0 ^ _rotl(x1, r)
    return x0, x1


def _threefry32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds), as `jax._src.prng`
    computes it, on int32 tensors holding uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = x0 + _i32(ks[0])
    x1 = x1 + _i32(ks[1])
    for i in range(5):
        x0, x1 = _rounds(x0, x1, _ROT0 if i % 2 == 0 else _ROT1)
        x0 = x0 + _i32(ks[(i + 1) % 3])
        x1 = x1 + _i32(ks[(i + 2) % 3] + i + 1)
    return x0, x1


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words as int64 values in [0, 2**32)."""
    return x.to(torch.int64) & _M32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values (any) -> the int32 holding their low 32 bits."""
    return (((x & _M32) + (1 << 31)) & _M32).sub_(1 << 31).to(torch.int32)


def _counts(shape, device, start: int = 0) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """`iota_2x32_shape`: the row-major flat index as (hi, lo) int32
    words, from `start` on: the counters of elements [start, start +
    prod(shape)) of a larger draw. Past 2**32 elements the high word is
    nonzero."""
    n = math.prod(shape)
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return _to_i32(idx >> 32), _to_i32(idx)


def _bits_pair(key, shape, device, start: int = 0):
    """The cipher's two int32 words for each element."""
    k1, k2 = _words(key)
    hi, lo = _counts(shape, device, start)
    return _threefry32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split` (fold-like, partitionable): (num, 2) keys."""
    b1, b2 = _bits_pair(key, (num,), key.device)
    return torch.stack([_u32(b1), _u32(b2)], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in`: the cipher of `key` applied to the counter
    (0, data mod 2**32), as `jax._src.prng.threefry_fold_in` computes it."""
    k1, k2 = _words(key)
    x0 = torch.zeros(1, dtype=torch.int32)
    x1 = torch.tensor([_i32(int(data))], dtype=torch.int32)
    b1, b2 = _threefry32(k1, k2, x0, x1)
    return torch.cat([_u32(b1), _u32(b2)])


def _bits32(key, shape, device, start: int = 0) -> torch.Tensor:
    b1, b2 = _bits_pair(key, tuple(shape), device, start)
    return (b1 ^ b2).reshape(tuple(shape))


def random_bits(key: torch.Tensor, shape, device="cpu",
                start: int = 0) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2**32)), jax's
    `_threefry_random_bits_partitionable` with bit_width=32. With `start`,
    elements [start, start + prod(shape)) of the row-major flat draw: the
    partitionable threefry's counter is that index, so a slice of a draw
    is a draw from an offset, bit for bit."""
    return _u32(_bits32(key, shape, device, start))


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, device="cpu",
            start: int = 0) -> torch.Tensor:
    """`jax.random.uniform` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled into [minval, maxval). `start` as in
    `random_bits`."""
    bits = _bits32(key, shape, device, start)
    fbits = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# XLA's float32 erf_inv (Giles' approximation, as StableHLO's chlo
# legalization writes it out)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, term for term as XLA computes it."""
    w = -torch.log1p(x * (-x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=x.dtype,
                                            device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=x.dtype,
                                        device=x.device))

    p = coeff(0)
    for i in range(1, 9):
        p = coeff(i) + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


def normal(key: torch.Tensor, shape, device="cpu",
           start: int = 0) -> torch.Tensor:
    """`jax.random.normal` in float32: sqrt(2) * erf_inv(u) with u uniform
    on [nextafter(-1, 0), 1). `start` as in `random_bits`."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device, start)
    return torch.tensor(np.sqrt(2), dtype=torch.float32,
                        device=device) * erf_inv(u)


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """`jax.random.randint` with jax's default int32: two 32-bit draws per
    value (from the two halves of `split(key)`), each reduced modulo the
    span = maxval - minval and combined as ((hi mod span) * mult + lo mod
    span) mod span, every step in uint32 arithmetic (here int64 masked to
    32 bits), plus minval. mult is jax's ((2**16 mod span)**2 mod 2**32)
    mod span: the square wraps to 0 for spans above 2**16, which then
    draw from the low word alone. A span <= 0 gives minval. int32 values
    in int64."""
    lo32, hi32 = -(2 ** 31), 2 ** 31 - 1
    minval = min(max(int(minval), lo32), hi32)
    maxval = min(max(int(maxval), lo32), hi32)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    mult = (((2 ** 16 % span) ** 2) & _M32) % span
    offset = ((((higher % span) * mult) & _M32) + lower % span) & _M32
    return minval + offset % span


def bernoulli(key: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """`jax.random.bernoulli(key, p)` in its default "low" mode: uniform
    draws of p's shape, compared in f32: uniform < p (bool)."""
    p = p.float()
    return uniform(key, tuple(p.shape), device=p.device) < p


def gumbel(key: torch.Tensor, shape, device="cpu") -> torch.Tensor:
    """`jax.random.gumbel` in float32, its default "low" mode:
    -log(-log(u)) with u uniform on [tiny, 1)."""
    tiny = float(np.finfo(np.float32).tiny)
    u = uniform(key, shape, tiny, 1.0, device)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """`jax.random.categorical` with replacement: the argmax of the logits
    plus Gumbel noise of their shape, first index on ties (int64)."""
    g = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits.float(), dim=axis)
