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
from repro_torch.kernels.flash_attention import SMEM_MAX, SPLIT_BLOCKS, \
    Plan, attended_range, compare_with_plain, flash_attention_cuda, \
    kernel_plan, smem_plan, wgmma_plan

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


@pytest.mark.parametrize("dh", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("rep,sq", [(1, 1), (4, 1), (4, 5120), (2, 2048),
                                    (3, 70), (8, 100), (80, 3)])
def test_wgmma_plan_fits_shared_memory(dh, rep, sq):
    """The tensor-core kernel's tile plan: tiles of whole kv-head groups
    (at most 64 heads), no more positions than Sq, 128 rows (two
    warpgroups) where more than 64 fill and 64 otherwise, and the Q tiles
    plus two stages of K and V tiles within the 232,448 bytes a block may
    hold."""
    hb, ppt, nbytes = wgmma_plan(dh, rep, sq)
    assert 1 <= hb <= min(rep, 64) and 1 <= ppt <= sq and hb * ppt <= 128
    assert nbytes <= SMEM_MAX < 232448
    if hb * ppt <= 64:
        assert ppt == sq or hb * (ppt + 1) > 64
    else:
        assert hb * (ppt + 1) > 128 or ppt == sq
    if (dh, rep, sq) == (80, 4, 5120):
        assert (hb, ppt) == (4, 32)                  # danube prefill


def test_p_split_keeps_the_rule_where_sums_cancel(capsys):
    """The wgmma kernel multiplies V by P = hi + lo, hi = bf16(P) and lo =
    bf16(P - hi) (f32 products summed in f32, emulated here by f32
    matmuls): P enters exact to ~2^-17 of itself, and the result keeps
    `compare_with_plain`'s rule, whose 1e-5 leg holds where the weighted
    sum cancels near 0. One rounding of P to bf16 (~2^-9) breaks it there:
    the test prints that error beside the split's, the reason for the
    split."""
    rng = np.random.default_rng(17)
    b, h, sq, dh = 2, 4, 256, 64
    q, k, v = (torch.tensor(rng.standard_normal((b, h, sq, dh)),
                            dtype=torch.float32).to(torch.bfloat16)
               for _ in range(3))
    want = tref.attention_ref(q, k, v)
    mask = tref.attention_mask(sq, sq, 0, None)
    logits = (q.float() @ k.float().transpose(-1, -2)) * dh ** -0.5
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    l_sum = p.sum(-1, keepdim=True)
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    vf = v.float()
    rows = mask.any(-1).expand(b, -1)
    split = compare_with_plain(((hi @ vf + lo @ vf) / l_sum).to(
        torch.bfloat16), want, rows)
    single = compare_with_plain((hi @ vf / l_sum).to(torch.bfloat16), want,
                                rows)
    with capsys.disabled():
        print(f"\nP as hi + lo: {split}; P rounded once to bf16: {single}")
    assert split["bad"] == 0 and split["masked_nonzero"] == 0
    assert single["bad"] > 0


# kernel_plan's choice at the ported models' shapes: (B, H, Hkv, Sq, Sk, dh),
# keywords, the plan
PLAN_CASES = [
    # chip_smoke 7a's decode: danube's packed batch, one query at slot
    # 5,120 over 5,137 slots, window 4,096: 4 x 8 blocks would fill a
    # quarter of the SMs, so 17 chunks of 241 slots from slot 1,025
    ((4, 32, 8, 1, 5137, 80), dict(q_offset=5120, window=4096),
     Plan("split", 17, 1025, 241)),
    # the same step at 40 rows fills the SMs unsplit
    ((40, 32, 8, 1, 5137, 80), dict(q_offset=5120, window=4096),
     Plan("tiles")),
    # a short decode: 256 slots, under the split's 512
    ((1, 2, 2, 1, 256, 64), dict(q_offset=255), Plan("tiles")),
    ((2, 2, 1, 1, 128, 16), dict(q_offset=127), Plan("tiles")),
    # a long full-attention decode: as many chunks as make ~4 blocks a SM
    ((1, 32, 8, 1, 32768, 128), dict(q_offset=32767),
     Plan("split", 66, 0, 497)),
    # gemma2's local decode (rep 2), a chunked decode (rep 4)
    ((2, 32, 16, 1, 4200, 128), dict(q_offset=4199, window=1024),
     Plan("split", 8, 3176, 128)),
    ((1, 8, 2, 1, 3000, 64), dict(q_offset=2999, chunk=1024),
     Plan("split", 8, 1976, 128)),
    # 16 query rows of a kv head do not fit a split block
    ((1, 64, 4, 1, 5000, 128), dict(q_offset=4999), Plan("tiles")),
    # prefill
    ((4, 32, 8, 5120, 5137, 80), dict(window=4096), Plan("tiles")),
    # BST's attention at serve_bulk, and the LM tests' tiny shapes
    ((262144, 8, 8, 21, 21, 4), dict(causal=False), Plan("small")),
    ((3, 8, 8, 21, 21, 4), dict(causal=False), Plan("small")),
    ((3, 2, 2, 5, 30, 16), dict(), Plan("small")),
    ((3, 2, 2, 5, 33, 16), dict(), Plan("tiles")),
    # bf16 prefill on the tensor cores: danube (dh 80) and gemma2's local
    # layer (dh 128), and a short bf16 decode that the split does not take;
    # bf16 decode and BST keep their kernels; f32, dh 72 and dh 256 stay on
    # the SIMT tiles
    ((4, 32, 8, 5120, 5137, 80), dict(window=4096, bf16=True),
     Plan("wgmma")),
    ((2, 32, 16, 2048, 2065, 128), dict(window=1024, bf16=True),
     Plan("wgmma")),
    ((1, 2, 2, 1, 256, 64), dict(q_offset=255, bf16=True), Plan("wgmma")),
    ((4, 32, 8, 1, 5137, 80), dict(q_offset=5120, window=4096, bf16=True),
     Plan("split", 17, 1025, 241)),
    ((3, 8, 8, 21, 21, 4), dict(causal=False, bf16=True), Plan("small")),
    ((2, 8, 2, 2048, 2065, 72), dict(bf16=True), Plan("tiles")),
    ((2, 8, 2, 100, 100, 256), dict(bf16=True), Plan("tiles")),
]


@pytest.mark.parametrize("shape,kw,want", PLAN_CASES)
def test_kernel_plan_picks_the_kernel(shape, kw, want):
    """Which of the three kernels each shape takes, and the split's cut:
    split where few blocks would fill the SMs and the range is long."""
    b, h, hkv, sq, sk, dh = shape
    plan = kernel_plan(b, h, hkv, sq, sk, dh, **kw)
    assert plan == want
    if plan.kernel == "split":
        lo, hi = attended_range(sq, sk, kw.get("q_offset", 0),
                                kw.get("causal", True), kw.get("window"),
                                kw.get("chunk"))
        assert plan.split_lo == lo and \
            plan.n_split * plan.split_len >= hi - lo + 1 > \
            (plan.n_split - 1) * plan.split_len
        assert b * hkv * plan.n_split <= SPLIT_BLOCKS + b * hkv


def _split_emulated(q, k, v, q_offset, kv_start, plan, **kw):
    """The split kernel's arithmetic in f32 on the CPU: per (row, kv
    head, chunk) the partial max, sum and value sum over the chunk's
    attended slots, then the partials merged in chunk order."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    mask = tref.attention_mask(sq, sk, q_offset, kv_start,
                               causal=kw["causal"], window=kw["window"],
                               chunk=kw["chunk"])
    logits = torch.einsum("bgrsd,bgkd->bgrsk",
                          q.float().view(b, hkv, rep, sq, dh),
                          k.float()) * dh ** -0.5
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    m_all, l_all, o_all = [], [], []
    for s in range(plan.n_split):
        lo = plan.split_lo + s * plan.split_len
        part = logits[..., lo:lo + plan.split_len]
        m = part.amax(-1, keepdim=True)
        p = torch.where(m == float("-inf"), 0.0, torch.exp(part - m))
        m_all.append(m)
        l_all.append(p.sum(-1, keepdim=True))
        o_all.append(p @ v.float()[:, :, None, lo:lo + plan.split_len])
    m = torch.stack(m_all).amax(0)
    w = [torch.where(m == float("-inf"), 0.0, torch.exp(ms - m))
         for ms in m_all]
    l = sum(ls * ws for ls, ws in zip(l_all, w))
    o = sum(os * ws for os, ws in zip(o_all, w))
    out = torch.where(l > 0, o / l, 0.0)
    return out.reshape(b, h, sq, dh), mask.any(-1)


@pytest.mark.parametrize("shape,kw", [
    ((3, 8, 2, 1, 1500, 16), dict(q_offset=1499, window=700)),
    ((2, 4, 2, 2, 2100, 8), dict(q_offset=2098, chunk=512)),
    ((2, 4, 4, 1, 1100, 8), dict(q_offset=1099)),
    ((2, 2, 1, 1, 900, 8), dict(q_offset=600, causal=False, window=300)),
])
def test_split_plan_covers_and_merges(shape, kw):
    """The host's bound holds every slot that any kv_start lets a query
    attend (left pads that leave whole chunks empty included), and the
    partials merged in chunk order give the plain version within its
    rule; rows attending nothing come out 0."""
    from repro_torch.kernels.flash_attention import compare_with_plain
    b, h, hkv, sq, sk, dh = shape
    kw = dict(dict(causal=True, window=None, chunk=None), **kw)
    off = kw.pop("q_offset")
    plan = kernel_plan(b, h, hkv, sq, sk, dh, off, **kw)
    assert plan.kernel == "split"
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32))
               for s in ((b, h, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh)))
    kv_start = torch.tensor([0, sk - 3, sk + 5][:b], dtype=torch.int32)
    lo, hi = attended_range(sq, sk, off, kw["causal"], kw["window"],
                            kw["chunk"])
    mask = tref.attention_mask(sq, sk, off, kv_start, **kw)
    slots = torch.nonzero(mask.any(1).any(0)).flatten()
    assert slots.numel() and lo <= int(slots.min())
    assert int(slots.max()) <= hi
    got, rows = _split_emulated(q, k, v, off, kv_start, plan, **kw)
    want = tref.attention_ref(q, k, v, q_offset=off, kv_start=kv_start,
                              **kw)
    res = compare_with_plain(got, want, rows)
    assert res["bad"] == 0 and res["masked_nonzero"] == 0, res
