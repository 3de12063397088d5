"""The port's MoE (`repro_torch.models.moe`, the MoE layers of
`models.transformer`, both MoE configs, the sliced weight draw and the
expert-parallel mesh branch) against the JAX package, on the CPU.

Inputs are numpy-seeded; weights are the JAX package's own, converted by
`lm_params_from_numpy`, wherever outputs are compared.

Tolerances:
- routing integers (eidx, rank, keep, dst) and the capacity: equal.
  Gates: rtol 1e-6 (f32 router products summed in other orders).
- aux: within 1e-6 absolute (measured <= 4e-9).
- `_dispatch_combine` / `moe_apply` in f32: atol 1e-7 at outputs of
  ~1e-2 (measured <= 2.8e-9; the expert products sum in torch's order).
- in bf16: given equal expert outputs and gates, the combine is bitwise
  (the k terms summed in f32 in k order, rounded once:
  `test_combine_sums_k_terms_in_order`); the shared expert is bitwise
  (XLA's per-op bf16 sigmoid); the batched expert products may differ by
  one bf16 ulp (measured: 3 of 24,576), so outputs are held to 2 bf16
  ulps at the largest |output|'s scale.
- init: normal draws within 4 f32 ulps of jax's (as
  tests/test_torch_transformer.py allows); the sliced draw and the
  threefry counters past 2**32: bitwise.
- LM logits in f32: rtol 1e-5, atol 1e-6 (measured <= 2.7e-7); served
  tokens: equal.
- mesh branch: the gathered output of W = 2 over ("model",) and W = 4
  over ("data", "model") = (2, 2), the same on every rank, against the
  port's one-process dispatch of each rank's token shard and JAX's
  `_dispatch_combine(params, cfg, shard, None)`: atol 1e-6 at outputs of
  ~1e-2. Alone the first is bitwise; in a full xdist run one case came
  out 1.3e-7 apart (the ranks are other processes, whose CPU BLAS may
  take other paths), so equality is not asserted. A wrong expert, token
  or drop moves an output by ~1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import torch_mesh_ranks as ranks
from repro.configs import get_arch as jax_arch
from repro.models import moe as jmoe
from repro.models import transformer as jm
from repro.serve import BatchServer as JaxBatchServer
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.spawn import run_ranks
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tm

ARCHS = ["llama4-scout-17b-16e", "kimi-k2-1t-a32b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
T_TOKENS = 96


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs(arch, drops=False):
    """The smoke config's MoE widths, (JAX MoEConfig, port MoEConfig,
    d_model); with `drops` a capacity factor of 0.25."""
    jc = jax_arch(arch).SMOKE_CONFIG
    fields = dataclasses.asdict(jc.moe)
    if drops:
        fields["capacity_factor"] = 0.25
    return (jmoe.MoEConfig(**fields), tmoe.MoEConfig(**fields), jc.d_model)


def _params(jcfg, d, dtype, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, d, DTYPES[dtype][0])
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_routing(jp, cfg, x):
    """`repro.models.moe._dispatch_combine`'s routing (moe.py:80-107) in
    jnp, step for step: (cap, gates, eidx, rank, keep, dst)."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = int((t * k / e) * cfg.capacity_factor) + 1
    cap = max(8, -(-cap // 8) * 8)
    logits = (x.astype(jnp.float32) @ jp["router"]).astype(jnp.float32)
    probs = (jax.nn.sigmoid(logits) if cfg.router == "sigmoid"
             else jax.nn.softmax(logits, axis=-1))
    gates, eidx = jax.lax.top_k(probs, k)
    if cfg.norm_topk and cfg.router == "softmax":
        gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    seg_start = jnp.searchsorted(sorted_e, jnp.arange(e))
    rank_sorted = jnp.arange(t * k) - seg_start[sorted_e]
    rank = jnp.zeros((t * k,), jnp.int32).at[order].set(
        rank_sorted.astype(jnp.int32))
    keep = rank < cap
    dst = jnp.where(keep, flat_e * cap + rank, e * cap)
    return cap, *(np.asarray(a) for a in (gates, eidx, rank, keep, dst))


def _bf16_ulp(a) -> float:
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


def _close(got, want, dtype):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
    else:
        assert np.abs(g - w).max() <= 2 * _bf16_ulp(w)


CASES = [(a, dt, drops) for a in ARCHS for dt in DTYPES
         for drops in (False, True)]


# ---------------------------------------------------------------- routing --
@pytest.mark.parametrize("arch,dtype,drops", CASES)
def test_routing_integers_match_jax(arch, dtype, drops):
    jcfg, tcfg, d = _cfgs(arch, drops)
    jp, tp = _params(jcfg, d, dtype)
    x = _x((T_TOKENS, d))
    jd, td = DTYPES[dtype]
    cap, gates, eidx, rank, keep, dst = _jax_routing(
        jp, jcfg, jnp.asarray(x, jd))
    assert tmoe.capacity(T_TOKENS, tcfg) == cap
    _, tg, te = tmoe.route(tp["router"], tcfg, torch.tensor(x).to(td))
    np.testing.assert_array_equal(te.numpy(), eidx)
    np.testing.assert_allclose(tg.numpy(), gates, rtol=1e-6)
    trank, tkeep, tdst = tmoe.dispatch_plan(te, tcfg.n_experts, cap)
    np.testing.assert_array_equal(trank.numpy(), rank)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    np.testing.assert_array_equal(tdst.numpy(), dst)
    assert bool((~keep).any()) == drops


def test_top_k_keeps_jax_tie_order():
    """Equal probabilities: the lower expert first, as jax.lax.top_k."""
    cfg = tmoe.MoEConfig(n_experts=6, top_k=3, d_ff=4, norm_topk=False)
    router = torch.zeros((2, 6))
    router[0, 4] = 1.0
    x = torch.tensor([[0.0, 0.0], [1.0, 0.0]])
    _, _, eidx = tmoe.route(router, cfg, x)
    jcfg = jmoe.MoEConfig(**dataclasses.asdict(cfg))
    _, _, want, *_ = _jax_routing({"router": jnp.asarray(router.numpy())},
                                  jcfg, jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(eidx.numpy(), want)
    assert eidx.tolist() == [[0, 1, 2], [4, 0, 1]]


@pytest.mark.parametrize("arch,dtype,drops", CASES)
def test_dispatch_combine_matches_jax(arch, dtype, drops):
    jcfg, tcfg, d = _cfgs(arch, drops)
    jp, tp = _params(jcfg, d, dtype)
    x = _x((T_TOKENS, d))
    jd, td = DTYPES[dtype]
    want, waux = jmoe._dispatch_combine(jp, jcfg, jnp.asarray(x, jd), None)
    got, gaux = tmoe._dispatch_combine(tp, tcfg, torch.tensor(x).to(td))
    assert got.dtype == td
    _close(got, want, dtype)
    assert abs(float(gaux) - float(waux)) <= 1e-6
    if drops:       # a dropped entry reads the zero row
        dropped = (~tmoe.dispatch_plan(
            tmoe.route(tp["router"], tcfg, torch.tensor(x).to(td))[2],
            tcfg.n_experts, tmoe.capacity(T_TOKENS, tcfg))[1]).view(
                T_TOKENS, tcfg.top_k).all(1)
        assert bool(dropped.any())
        assert float(got[dropped].abs().max()) == 0.0


@pytest.mark.parametrize("arch,dtype,drops", CASES)
def test_moe_apply_matches_jax(arch, dtype, drops):
    jcfg, tcfg, d = _cfgs(arch, drops)
    jp, tp = _params(jcfg, d, dtype)
    x = _x((3, 32, d))
    jd, td = DTYPES[dtype]
    want, waux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x, jd))
    got, gaux = tmoe.moe_apply(tp, tcfg, torch.tensor(x).to(td))
    assert got.shape == x.shape and got.dtype == td
    _close(got, want, dtype)
    assert abs(float(gaux) - float(waux)) <= 1e-6


def test_combine_sums_k_terms_in_order(monkeypatch):
    """bf16, equal expert outputs: the combine is bitwise JAX's (the
    gates cast to bf16, each product rounded to bf16, the k = 8 terms
    summed in f32 in k order and rounded once)."""
    monkeypatch.setattr(jmoe, "_swiglu_experts", lambda p, h: h * 3)
    monkeypatch.setattr(tmoe, "_swiglu_experts",
                        lambda p, h, out=None: torch.mul(h, 3, out=out))
    fields = dict(n_experts=24, top_k=8, d_ff=8, capacity_factor=0.7)
    jcfg, tcfg = jmoe.MoEConfig(**fields), tmoe.MoEConfig(**fields)
    jp, tp = _params(jcfg, 64, "bfloat16")
    x = _x((300, 64))
    want, _ = jmoe._dispatch_combine(jp, jcfg, jnp.asarray(x, jnp.bfloat16),
                                     None)
    got, _ = tmoe._dispatch_combine(tp, tcfg,
                                    torch.tensor(x).to(torch.bfloat16))
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_shared_expert_and_sigmoid_match_jax(dtype):
    """The shared expert's SiLU in x's dtype: XLA's CPU expansion of the
    sigmoid, each op rounded to bf16, bitwise in bf16."""
    jcfg, tcfg, d = _cfgs("kimi-k2-1t-a32b")
    jp, tp = _params(jcfg, d, dtype)
    jd, td = DTYPES[dtype]
    x = _x((40, d))
    want = jmoe._shared_ffn(jp, jnp.asarray(x, jd))
    got = tmoe._shared_ffn(tp, torch.tensor(x).to(td))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    else:
        _close(got, want, dtype)
    z = _x((4000,), seed=3)
    np.testing.assert_array_equal(
        tmoe.sigmoid(torch.tensor(z).to(torch.bfloat16)).float().numpy(),
        np.asarray(jax.nn.sigmoid(jnp.asarray(z, jnp.bfloat16))
                   .astype(jnp.float32)))


# ------------------------------------------- twins of tests/test_moe.py --
def _setup(t=64, d=16, e=8, k=2, cf=4.0, router="softmax", seed=0):
    cfg = tmoe.MoEConfig(n_experts=e, top_k=k, d_ff=32, capacity_factor=cf,
                         router=router, norm_topk=(router == "softmax"))
    params = tmoe.moe_init(trandom.PRNGKey(seed), cfg, d, torch.float32,
                           device="cpu")
    x = trandom.normal(trandom.PRNGKey(seed + 1), (t, d))
    return cfg, params, x


def test_no_drops_at_high_capacity_matches_dense_equivalent():
    """With capacity >> tokens*k/E, sort-based dispatch must equal the
    naive 'every token through its top-k experts' computation."""
    cfg, params, x = _setup(cf=8.0)
    out, _ = tmoe._dispatch_combine(params, cfg, x)
    probs = torch.softmax(x @ params["router"], -1)
    gates, eidx = torch.sort(probs, dim=-1, descending=True,
                             stable=True)
    gates, eidx = gates[:, :cfg.top_k], eidx[:, :cfg.top_k]
    gates = gates / gates.sum(-1, keepdim=True)

    def expert(i, xi):
        g = torch.nn.functional.silu(xi @ params["w_gate"][i])
        u = xi @ params["w_up"][i]
        return (g * u) @ params["w_down"][i]

    ref = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(cfg.top_k):
            ref[t] += gates[t, j] * expert(int(eidx[t, j]), x[t])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_dropped_tokens_get_zero_not_garbage():
    cfg, params, x = _setup(t=64, e=4, k=1, cf=0.1)  # tiny capacity
    out, _ = tmoe._dispatch_combine(params, cfg, x)
    assert bool(torch.isfinite(out).all())
    # cap rounds up to 8/expert -> exactly half the 64 tokens fit; the
    # other half must be EXACT zeros (not stale memory)
    zero_rows = int((out.abs().amax(dim=1) == 0.0).sum())
    assert zero_rows >= x.shape[0] // 2


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_moe_apply_finite_and_shaped(seed):
    cfg = tmoe.MoEConfig(n_experts=4, top_k=2, d_ff=16, n_shared=1,
                         capacity_factor=2.0)
    params = tmoe.moe_init(trandom.PRNGKey(seed % 100), cfg, 8,
                           torch.float32, device="cpu")
    x = trandom.normal(trandom.PRNGKey(seed), (2, 6, 8))
    out, aux = tmoe.moe_apply(params, cfg, x)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    assert float(aux) >= 0.0


def test_sigmoid_top1_router_llama4_style():
    cfg, params, x = _setup(k=1, router="sigmoid")
    out, _ = tmoe._dispatch_combine(params, cfg, x)
    assert bool(torch.isfinite(out).all())
    # sigmoid gates are NOT normalized: output scale tracks the gate
    g = tmoe.sigmoid(x @ params["router"]).amax(-1)
    assert float(g.min()) >= 0.0 and float(g.max()) <= 1.0


def test_aux_loss_detects_imbalance():
    cfg = tmoe.MoEConfig(n_experts=4, top_k=1, d_ff=16, capacity_factor=4.0,
                         aux_loss_coef=1.0)
    params = tmoe.moe_init(trandom.PRNGKey(0), cfg, 8, torch.float32,
                           device="cpu")
    biased = dict(params, router=torch.zeros_like(params["router"]))
    biased["router"][:, 0] = 10.0
    x = trandom.normal(trandom.PRNGKey(1), (64, 8))
    _, aux_uniform = tmoe._dispatch_combine(params, cfg, x)
    _, aux_biased = tmoe._dispatch_combine(biased, cfg, x)
    assert float(aux_biased) > float(aux_uniform)


# ------------------------------------------------------------------- init --
def _ulps32(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _leaf_pairs(jtree, ttree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        t = ttree
        for k in path:
            t = t[k.key]
        yield jax.tree_util.keystr(path), np.asarray(leaf), t


def _hold_init(jtree, ttree):
    n = 0
    for name, want, got in _leaf_pairs(jtree, ttree):
        assert tuple(got.shape) == want.shape, name
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, name
            w = want.astype(np.float32)
            g = got.float().numpy()
            assert np.abs(g - w).max() <= np.abs(w).max() * 2.0 ** -8, name
        else:
            assert got.dtype == torch.float32, name
            assert _ulps32(got.numpy(), want).max() <= 4, name
        n += 1
    return n


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_init_matches_jax(arch, dtype):
    jcfg, tcfg, d = _cfgs(arch)
    jd, td = DTYPES[dtype]
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg, d, jd)
    tp = tmoe.moe_init(trandom.PRNGKey(3), tcfg, d, td, device="cpu")
    assert tp["router"].dtype == torch.float32
    assert _hold_init(jp, tp) == 7


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_jax(arch):
    jc, tc = jax_arch(arch).SMOKE_CONFIG, get_arch(arch).SMOKE_CONFIG
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    tp = tm.init_params(trandom.PRNGKey(0), tc, device="cpu")
    want = len(jax.tree_util.tree_leaves(jp))
    assert _hold_init(jp, tp) == want
    assert "ffn" not in tp["blocks"]["layer0"]
    assert tp["blocks"]["layer0"]["moe"]["w_gate"].shape == (
        tc.n_groups, tc.moe.n_experts, tc.d_model, tc.moe.d_ff)


def test_sliced_draw_is_the_whole_draw(monkeypatch):
    """A leaf drawn DRAW_CHUNK elements at a time, an expert range drawn
    from its offset, and init_params(experts=) are bit-equal to the
    whole draw's elements."""
    key = trandom.PRNGKey(7)
    shape = (5, 24, 40)
    whole = (trandom.normal(key, shape) * 0.02).to(torch.bfloat16)
    monkeypatch.setattr(L, "DRAW_CHUNK", 1 << 9)
    assert torch.equal(L.normal_init(key, shape, torch.bfloat16), whole)
    monkeypatch.setattr(L, "DRAW_CHUNK", 1000)          # ragged slices
    assert torch.equal(L.normal_init(key, shape, torch.bfloat16), whole)
    part = L.normal_init(key, (2, 24, 40), torch.bfloat16, start=2 * 960)
    assert torch.equal(part, whole[2:4])
    assert torch.equal(trandom.random_bits(key, (100,), start=37),
                       trandom.random_bits(key, (200,))[37:137])
    tc = get_arch("kimi-k2-1t-a32b").SMOKE_CONFIG
    full = tm.init_params(trandom.PRNGKey(0), tc, device="cpu")
    share = tm.init_params(trandom.PRNGKey(0), tc, device="cpu",
                           experts=(2, 6))
    for name in tmoe.EXPERT_LEAVES:
        assert torch.equal(share["blocks"]["layer0"]["moe"][name],
                           full["blocks"]["layer0"]["moe"][name][:, 2:6])
    assert torch.equal(share["blocks"]["layer0"]["wq"],
                       full["blocks"]["layer0"]["wq"])
    with pytest.raises(ValueError, match="outside"):
        tmoe.moe_init(key, tc.moe, 8, torch.float32, device="cpu",
                      experts=(6, 9))


def test_threefry_counters_past_2_32_match_jax():
    """kimi-k2's expert leaf has 5.6e9 elements: past element 2**32 the
    counters' high word is nonzero. The port's threefry there is JAX's
    own threefry2x32 on the same (hi, lo) counters."""
    from jax._src import prng
    key = trandom.PRNGKey(11)
    k1, k2 = (int(w) for w in key.tolist())
    start = 2 ** 32 - 300
    idx = np.arange(start, start + 1000, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = prng.threefry2x32_p.bind(
        jnp.uint32(k1), jnp.uint32(k2), jnp.asarray(hi), jnp.asarray(lo))
    want = np.asarray(b1 ^ b2).astype(np.int64)
    got = trandom.random_bits(key, (1000,), start=start).numpy()
    assert (hi[-1], hi[0]) == (1, 0)
    np.testing.assert_array_equal(got, want)
    # a whole draw of 2**32 + 700 elements reads these counters
    far = trandom.random_bits(key, (10,), start=5 * 2 ** 32 + 3).numpy()
    fidx = np.arange(5 * 2 ** 32 + 3, 5 * 2 ** 32 + 13, dtype=np.uint64)
    f1, f2 = prng.threefry2x32_p.bind(
        jnp.uint32(k1), jnp.uint32(k2),
        jnp.asarray((fidx >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((fidx & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    np.testing.assert_array_equal(far, np.asarray(f1 ^ f2).astype(np.int64))


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_jax(arch):
    """CONFIG and SMOKE_CONFIG field for field, and the analytic counts at
    full size (llama4 ~107e9, kimi ~1.0e12: tests/test_smoke_archs.py)."""
    jmod, tmod = jax_arch(arch), get_arch(arch)
    for name in ("CONFIG", "SMOKE_CONFIG"):
        jc, tc = getattr(jmod, name), getattr(tmod, name)
        for f in dataclasses.fields(tc):
            if f.name in ("dtype", "moe"):
                continue
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert dataclasses.asdict(tc.moe) == dataclasses.asdict(jc.moe)
        assert tc.dtype == DTYPES[jnp.dtype(jc.dtype).name][1]
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
    assert tmod.SHAPES == jmod.SHAPES
    total = tmod.CONFIG.param_count()
    assert 0.9 * {ARCHS[0]: 107e9, ARCHS[1]: 1.0e12}[arch] < total
    assert tmod.CONFIG.active_param_count() < total


def test_convert_keeps_router_f32_and_experts_bf16():
    jc = dataclasses.replace(jax_arch("kimi-k2-1t-a32b").SMOKE_CONFIG,
                             dtype=jnp.bfloat16)
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    moe = tp["blocks"]["layer0"]["moe"]
    assert moe["router"].dtype == torch.float32
    for name in tmoe.EXPERT_LEAVES:
        assert moe[name].dtype == torch.bfloat16
        assert moe["shared"][name].dtype == torch.bfloat16
    for name, want, got in _leaf_pairs(jp, tp):
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- the LMs --
@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jc, tc = jax_arch(arch).SMOKE_CONFIG, get_arch(arch).SMOKE_CONFIG
        jp = jm.init_params(jax.random.PRNGKey(0), jc)
        out[arch] = (jc, jp, tc, lm_params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(models, arch):
    jc, jp, tc, tp = models[arch]
    toks = np.random.default_rng(5).integers(0, jc.vocab, (2, 11))
    want, waux = jm.forward(jp, jc, jnp.asarray(toks, jnp.int32))
    got, gaux = tm.forward(tp, tc, torch.tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert abs(float(gaux) - float(waux)) <= 1e-6 and float(gaux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(models, arch):
    """A left-padded batch: the prefill's last logits, then three decode
    steps (each routing the call's B tokens)."""
    jc, jp, tc, tp = models[arch]
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jc.vocab, (3, 13)).astype(np.int32)
    pad = np.array([0, 4, 9], np.int32)
    jcache = jm.init_cache(jc, 3, 17)
    tcache = tm.init_cache(tc, 3, 17, device="cpu")
    want, jcache = jm.prefill_with_cache(jp, jc, jcache, jnp.asarray(toks),
                                         jnp.asarray(pad))
    got, tcache = tm.prefill_with_cache(tp, tc, tcache, torch.tensor(toks),
                                        torch.tensor(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    for step in range(3):
        tok = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
        want, jcache = jm.decode_step(jp, jc, jcache, jnp.asarray(tok),
                                      jnp.int32(13 + step), jnp.asarray(pad))
        got, tcache = tm.decode_step(tp, tc, tcache, torch.tensor(tok),
                                     13 + step, torch.tensor(pad))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_matches_jax_cli(models, arch, capsys):
    """`launch.serve --arch` on the smoke config: the JAX CLI's requests
    and tokens (its weights from PRNGKey(0), drawn by the port)."""
    jc, jp, _, _ = models[arch]
    res = serve_cli.main(["--device", "cpu", "--arch", arch])
    out = capsys.readouterr().out
    assert out.startswith("[serve] 6 requests, 96 tokens in ")
    jsrv = JaxBatchServer(jp, jc, batch_slots=4,
                          scfg=JaxServeConfig(max_new_tokens=16))
    rng = np.random.default_rng(0)
    ids = [jsrv.submit(rng.integers(0, jc.vocab, size=rng.integers(4, 12))
                       .astype(np.int32)) for _ in range(6)]
    want = jsrv.serve()
    assert res["ids"] == ids and res["tokens"] == 96
    for rid in ids:
        np.testing.assert_array_equal(res["results"][rid],
                                      np.asarray(want[rid]))
    assert f"  req 0: {np.asarray(want[0]).tolist()}" in out


# ------------------------------------------------------------ mesh branch --
MESHES = {2: (2,), 4: (2, 2)}


def _mesh_cases():
    """(name, MoEConfig fields, port params, x (B, S, D), share, JAX
    params): kimi's widths (E = 8, k = 2) with and without drops, llama4's
    (E = 4, k = 1, sigmoid), a decode shape (S = 1: tokens replicated over
    the model axis), each rank holding all experts or its share, and
    E = 3 over m = 2 (does not divide)."""
    out = []
    for arch, drops, share, shape in (
            ("kimi-k2-1t-a32b", False, False, (4, 16)),
            ("kimi-k2-1t-a32b", True, True, (4, 16)),
            ("llama4-scout-17b-16e", False, True, (2, 24)),
            ("llama4-scout-17b-16e", True, False, (4, 1))):
        jcfg, _, d = _cfgs(arch, drops)
        jp, tp = _params(jcfg, d, "float32")
        name = f"{arch} drops={drops} share={share} {shape}"
        out.append((name, dataclasses.asdict(jcfg), tp,
                    torch.tensor(_x((*shape, d), seed=4)), share, jp))
    fields = dict(n_experts=3, top_k=1, d_ff=8)
    tp = tmoe.moe_init(trandom.PRNGKey(0), tmoe.MoEConfig(**fields), 8,
                       torch.float32, device="cpu")
    out.append(("E=3", fields, tp, torch.zeros((4, 4, 8)), False, None))
    return out


@pytest.fixture(scope="module")
def mesh_runs():
    cases = _mesh_cases()
    wire = [c[:5] for c in cases]
    return cases, {w: run_ranks(ranks.moe_cases, w, wire, MESHES[w],
                                devices=["cpu"] * w)
                   for w in MESHES}


def _shards(shape, mesh_shape):
    """The token shards of a (B, S) call by JAX's tok_spec rule, in
    gather order: [(batch slice, seq slice)]."""
    b, s = shape
    n_data, m = (1, *mesh_shape) if len(mesh_shape) == 1 else mesh_shape
    bs = b % n_data == 0 and b >= n_data
    ss = s % m == 0 and s >= m
    nb, ns = (n_data if bs else 1), (m if ss else 1)
    return [(slice(i * b // nb, (i + 1) * b // nb),
             slice(j * s // ns, (j + 1) * s // ns))
            for i in range(nb) for j in range(ns)]


@pytest.mark.parametrize("world", sorted(MESHES))
def test_moe_mesh_branch(mesh_runs, world):
    """Every rank returns the same whole output: each token shard's
    one-process dispatch plus the shared expert, and JAX's
    `_dispatch_combine(params, cfg, shard, None)` on that shard; aux the
    mean of the shards' aux; the buffers cross by all_to_all, twice a
    call."""
    cases, runs = mesh_runs
    results = runs[world]
    for name, fields, tp, x, share, jp in cases:
        outs = [r[name] for r in results]
        if jp is None:
            continue
        assert all(isinstance(o, tuple) for o in outs), outs
        got, aux, a2a = outs[0]
        for o in outs[1:]:
            np.testing.assert_array_equal(o[0], got)
            assert o[1] == aux
        cfg = tmoe.MoEConfig(**fields)
        jcfg = jmoe.MoEConfig(**fields)
        b, s, d = x.shape
        want = torch.zeros_like(x)
        jwant = np.zeros(x.shape, np.float32)
        auxes = []
        for bsl, ssl in _shards((b, s), MESHES[world]):
            xs = x[bsl, ssl]
            o, a = tmoe._dispatch_combine(tp, cfg, xs.reshape(-1, d))
            want[bsl, ssl] = o.view(xs.shape)
            jo, _ = jmoe._dispatch_combine(
                jp, jcfg, jnp.asarray(xs.reshape(-1, d).numpy()), None)
            jwant[bsl, ssl] = np.asarray(jo).reshape(xs.shape)
            auxes.append(float(a))
        want = want + tmoe._shared_ffn(tp, x)
        jwant = jwant + np.asarray(jmoe._shared_ffn(jp, jnp.asarray(
            x.numpy())))
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, jwant, rtol=0, atol=1e-6)
        assert abs(aux - float(np.mean(auxes))) <= 1e-6
        assert a2a["calls"] == 2
        if not share and s > 1:
            # no drops and the whole call on every rank's experts: the
            # one-process moe_apply of the whole batch
            one, _ = tmoe.moe_apply(tp, cfg, x)
            if not fields["capacity_factor"] < 1:
                np.testing.assert_allclose(got, one.numpy(), rtol=0,
                                           atol=1e-6)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_moe_mesh_raises_where_experts_do_not_divide(mesh_runs, world):
    """3 experts over a model axis of 2: every rank raises ValueError
    before any collective, as JAX's shard_map refuses the split."""
    _, runs = mesh_runs
    for r in runs[world]:
        assert r["E=3"] == ("moe_apply: 3 experts do not divide over a "
                            "model axis of 2")
