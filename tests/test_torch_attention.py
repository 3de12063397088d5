"""The port's plain attention (`kernels.ref.attention_ref`, what
`ops.flash_attention` runs on the CPU) against the JAX package's
`attention_ref`, and the CPU-side plan of the attention kernel.

Tolerances: both compute in f32 from the same inputs (logits, softcap,
mask, one softmax, the value product) but sum the dh- and Sk-long products
in their own orders, so f32 outputs are held to rtol 1e-5, atol 2e-6
(measured: <= 7e-7 on outputs of magnitude ~3). bf16 outputs are those f32
values rounded once, so they may differ by at most one bf16 ulp, except
where the weighted sum cancels to near 0 and the two f32 values, 2e-6
apart at most, straddle zero: there the f32 atol holds instead. Rows that
attend no key are the uniform average of V in both (MASK_VALUE logits),
and are compared like any other row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import SMEM_MAX, \
    flash_attention_cuda, smem_plan

# the eight cases of tests/test_kernels.py::test_flash_attention_kernel
CASES = [
    dict(b=1, h=4, hkv=4, sq=128, sk=128, dh=32),                       # MHA
    dict(b=2, h=4, hkv=2, sq=64, sk=64, dh=16),                         # GQA
    dict(b=1, h=8, hkv=1, sq=100, sk=100, dh=32),                       # MQA+pad
    dict(b=1, h=2, hkv=2, sq=1, sk=256, dh=64, q_offset=255),           # decode
    dict(b=1, h=4, hkv=2, sq=128, sk=128, dh=32, window=32),            # SWA
    dict(b=1, h=4, hkv=2, sq=128, sk=128, dh=32, chunk=64),             # chunked
    dict(b=1, h=4, hkv=2, sq=128, sk=128, dh=32, softcap=20.0),         # softcap
    dict(b=1, h=4, hkv=4, sq=96, sk=192, dh=32, q_offset=96),           # chunked prefill
]
# the kv_start cases of tests/test_kernels.py::test_flash_attention_kv_start_parity
KV_START_CASES = [
    dict(b=3, h=2, hkv=2, sq=64, sk=64, dh=16),                   # causal
    dict(b=3, h=4, hkv=2, sq=64, sk=64, dh=16, window=16),        # SWA
    dict(b=2, h=2, hkv=2, sq=64, sk=64, dh=16, chunk=32),         # chunked
    dict(b=2, h=2, hkv=1, sq=1, sk=128, dh=16, q_offset=127),     # decode
]
# the widths of the ported models: danube's dh = 80 (GQA 4, window, left
# pads), BST's dh = 4 (not causal), gemma2's dh = 128 with softcap
WIDTH_CASES = [
    dict(b=3, h=8, hkv=2, sq=33, sk=40, dh=80, window=16, q_offset=7,
         pads=True),
    dict(b=3, h=8, hkv=8, sq=21, sk=21, dh=4, causal=False),
    dict(b=2, h=4, hkv=2, sq=17, sk=50, dh=128, softcap=50.0, q_offset=33,
         pads=True),
]


def _inputs(cfg, dtype, seed):
    rng = np.random.default_rng(seed)
    b, h, hkv, sq, sk, dh = (cfg["b"], cfg["h"], cfg["hkv"], cfg["sq"],
                             cfg["sk"], cfg["dh"])
    q = rng.normal(size=(b, h, sq, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, dh)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    js = [jnp.asarray(a, jdt) for a in (q, k, v)]
    ts = [torch.tensor(a).to(tdt) for a in (q, k, v)]
    return js, ts


def _kw(cfg):
    return dict(causal=cfg.get("causal", True), window=cfg.get("window"),
                chunk=cfg.get("chunk"), softcap=cfg.get("softcap"),
                q_offset=cfg.get("q_offset", 0))


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in bf16 ulps of two arrays of bf16 values (held as f32)."""
    def ordinal(x):
        bits = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return np.abs(ordinal(a) - ordinal(b))


def _compare(got: torch.Tensor, want, dtype: str):
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-6)
    else:
        ok = (_bf16_ulps(g, w) <= 1) | (np.abs(g - w) <= 2e-6)
        assert ok.all(), (g[~ok], w[~ok])


def _both(cfg, dtype, seed, kv_start=None):
    js, ts = _inputs(cfg, dtype, seed)
    kw = _kw(cfg)
    want = jref.attention_ref(*js, kv_start=None if kv_start is None
                              else jnp.asarray(kv_start, jnp.int32), **kw)
    got = tref.attention_ref(*ts, kv_start=None if kv_start is None
                             else torch.tensor(kv_start, dtype=torch.int32),
                             **kw)
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", CASES)
def test_attention_ref_matches_jax(cfg, dtype):
    got, want = _both(cfg, dtype, seed=1)
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    _compare(got, want, dtype)


@pytest.mark.parametrize("cfg", KV_START_CASES)
def test_attention_ref_kv_start_matches_jax(cfg):
    """Every row, the fully masked pad rows included (uniform averages in
    both packages)."""
    rng = np.random.default_rng(21)
    kv_start = rng.integers(0, cfg["sk"] // 2, size=cfg["b"])
    got, want = _both(cfg, "float32", seed=21, kv_start=kv_start)
    _compare(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", WIDTH_CASES, ids=["dh80", "dh4", "dh128"])
def test_attention_ref_model_widths_match_jax(cfg, dtype):
    kv_start = None
    if cfg.get("pads"):
        kv_start = np.array([0, 9, cfg["sk"] - 2][:cfg["b"]])
    got, want = _both(cfg, dtype, seed=5, kv_start=kv_start)
    _compare(got, want, dtype)


def test_attention_ref_block_scan_matches_jax():
    """Sq a multiple of block_q = 1,024: both scan q in blocks."""
    cfg = dict(b=2, h=4, hkv=1, sq=2048, sk=2060, dh=8, window=100,
               q_offset=12)
    got, want = _both(cfg, "float32", seed=8, kv_start=[0, 700])
    _compare(got, want, "float32")
    # and the blocks change nothing against one dense pass
    _, ts = _inputs(cfg, "float32", seed=8)
    dense = tref.attention_ref(*ts, block_q=4096, **_kw(cfg),
                               kv_start=torch.tensor([0, 700]))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_fully_masked_rows_are_the_uniform_average():
    """Pad query rows attend nothing: the plain version returns the mean
    of V over every kv slot, as the JAX package's attention_ref does."""
    cfg = dict(b=2, h=4, hkv=2, sq=12, sk=12, dh=80, window=4)
    kv_start = [0, 5]
    got, want = _both(cfg, "float32", seed=3, kv_start=kv_start)
    _compare(got, want, "float32")
    _, (q, k, v) = _inputs(cfg, "float32", seed=3)
    mean_v = v[1].mean(dim=1)                       # (Hkv, dh)
    for hh in range(4):
        np.testing.assert_allclose(got[1, hh, :5].numpy(),
                                   mean_v[hh // 2].expand(5, 80).numpy(),
                                   rtol=1e-5, atol=1e-6)
    mask = tref.attention_mask(12, 12, 0, torch.tensor(kv_start),
                               window=4)
    assert not bool(mask[1, :5].any()) and bool(mask[1, 5:].any(-1).all())


@pytest.mark.parametrize("window", [None, 16])
def test_kv_start_matches_unpadded(window):
    """A row with kv_start = s attends exactly as the same sequence run
    solo without padding, under a sliding window too (the JAX package's
    tests/test_kernels.py::test_flash_attention_kv_start_matches_unpadded
    on the port)."""
    rng = np.random.default_rng(22)
    h, dh, s_real, pad = 2, 16, 48, 16
    real = [torch.tensor(rng.normal(size=(1, h, s_real, dh)),
                         dtype=torch.float32) for _ in range(3)]
    z = torch.zeros((1, h, pad, dh))
    padded = [torch.cat([z, t], dim=2) for t in real]
    solo = tref.attention_ref(*real, causal=True, window=window)
    packed = tref.attention_ref(*padded, causal=True, window=window,
                                kv_start=torch.tensor([pad]))
    np.testing.assert_allclose(packed[:, :, pad:].numpy(), solo.numpy(),
                               rtol=2e-5, atol=2e-5)


def test_ops_dispatch_on_the_cpu():
    """ops.flash_attention on CPU tensors runs the plain version (auto and
    ref), and the kernel backend raises; flat_gqa changes nothing."""
    cfg = CASES[1]
    _, ts = _inputs(cfg, "float32", seed=4)
    before = ops.launch_counts()
    want = tref.attention_ref(*ts, window=8)
    for backend in ("auto", "ref"):
        for flat in (True, False):
            got = ops.flash_attention(*ts, 0, window=8, flat_gqa=flat,
                                      backend=backend)
            assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(*ts, backend="kernel")
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(*ts)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("dh", [4, 8, 16, 64, 80, 128, 200, 256])
@pytest.mark.parametrize("rep,sq", [(1, 1), (4, 1), (4, 5120), (2, 7),
                                    (8, 100), (80, 3)])
def test_kernel_plan_fits_shared_memory(dh, rep, sq):
    """The kernel's tile plan: every head of a group lands in some tile
    (at most 64 a tile), no more positions than Sq, and the layout fits in
    one block's shared memory."""
    hb, ppt, bc, nbytes = smem_plan(dh, rep, sq)
    assert 1 <= hb <= min(rep, 64) and 1 <= ppt <= sq
    assert hb * ppt <= 64 and bc % 4 == 0 and nbytes <= SMEM_MAX
    if sq == 1 and rep <= 16:
        assert ppt == 1 and bc >= 64          # decode: wide kv tiles


def test_kernel_plan_danube_and_limits():
    assert smem_plan(80, 4, 5120)[:3] == (4, 16, 64)    # danube prefill
    assert smem_plan(80, 4, 1)[:3] == (4, 1, 256)       # danube decode
    with pytest.raises(ValueError, match="head_dim 257"):
        smem_plan(257, 4, 1)
