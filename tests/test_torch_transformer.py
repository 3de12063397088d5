"""The port's dense LMs (`repro_torch.models.transformer`) against the JAX
package's, on the smoke configs of danube, deepseek and gemma2 (f32) and
bf16 variants of them.

Tolerances:
- init_params: the normal draws of the port's threefry are within 4 ulps
  of jax's (XLA's CPU log1p is its own polynomial; tests/
  test_torch_random.py), so f32 weights are held to 4 ulps; rounded to
  bf16 they are equal here, and held to at most one bf16 ulp.
- logits in f32: rtol 1e-5, atol 1e-6 (logits of magnitude ~0.6; the
  packages sum the products in their own orders, measured <= 5e-7 apart).
- logits in bf16: atol 2e-2, five bf16 ulps at the logits' scale: each
  dense product, norm and residual add rounds to bf16, and an f32 sum-order
  difference flips some of those roundings (measured <= 6.4e-3).
The weights are the JAX package's own, converted by lm_params_from_numpy,
wherever logits are compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import transformer as jm
from repro_torch import random as trandom
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import transformer as tm

ARCHS = ["h2o-danube-1.8b", "deepseek-7b", "gemma2-27b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(arch, dtype="float32"):
    jc, tc = jax_arch(arch).SMOKE_CONFIG, get_arch(arch).SMOKE_CONFIG
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jc, dtype=jd),
            dataclasses.replace(tc, dtype=td))


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, port config, port params from the JAX
    params) per (arch, dtype), built once."""
    out = {}
    for arch in ARCHS:
        for dtype in DTYPES:
            jc, tc = _configs(arch, dtype)
            jp = jm.init_params(jax.random.PRNGKey(0), jc)
            tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
            out[arch, dtype] = (jc, jp, tc, tp)
    return out


def _leaves(jtree, ttree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        t = ttree
        for k in path:
            t = t[k.key]
        yield jax.tree_util.keystr(path), np.asarray(leaf), t


def _ulps32(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _close(got: torch.Tensor, want, dtype: str):
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert g.shape == w.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_jax(models, arch, dtype):
    jc, jp, tc, _ = models[arch, dtype]
    tp = tm.init_params(trandom.PRNGKey(0), tc, device="cpu")
    n = 0
    for name, want, got in _leaves(jp, tp):
        assert got.dtype == DTYPES[dtype][1] or name.endswith("norm']") \
            or "ln_" in name, name
        got = got.float().numpy()
        want = want.astype(np.float32)
        assert got.shape == want.shape, name
        if dtype == "float32":
            assert _ulps32(got, want).max() <= 4, name
        else:
            gb = got.view(np.int32) >> 16
            wb = want.view(np.int32) >> 16
            assert np.abs(gb.astype(np.int64) - wb).max() <= 1, name
        n += 1
    assert n == len(jax.tree.leaves(tp)) == len(jax.tree.leaves(jp))
    assert tc.param_count() == jc.param_count() == sum(
        t.numel() for t in jax.tree.leaves(tp))


def test_full_width_param_counts():
    danube = get_arch("h2o-danube-1.8b").CONFIG
    assert danube.param_count() == 1_831_201_280
    for arch in ARCHS:
        jc, tc = jax_arch(arch).CONFIG, get_arch(arch).CONFIG
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert tc.dtype == torch.bfloat16


def test_lm_params_from_numpy_round_trips_bf16(models):
    _, jp, _, tp = models["gemma2-27b", "bfloat16"]
    for name, want, got in _leaves(jp, tp):
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, name
            back = got.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(back, want.view(np.uint16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(models, arch, dtype):
    jc, jp, tc, tp = models[arch, dtype]
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, 12))
    want, _ = jm.forward(jp, jc, jnp.asarray(toks, jnp.int32))
    got, aux = tm.forward(tp, tc, torch.tensor(toks))
    _close(got, want, dtype)
    assert float(aux) == 0.0
    again, _ = tm.forward(tp, tc, torch.tensor(toks), training=False)
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_logits_match_jax(models, arch, dtype):
    """A left-padded prefill (lengths 3, 9, 6 of 9) then three decode steps,
    logits compared after each; the caches too."""
    jc, jp, tc, tp = models[arch, dtype]
    rng = np.random.default_rng(3)
    lens, p = np.array([3, 9, 6]), 9
    prompts = np.zeros((3, p), np.int32)
    for i, n in enumerate(lens):
        prompts[i, p - n:] = rng.integers(1, jc.vocab, n)
    pad = (p - lens).astype(np.int32)
    jcache = jm.init_cache(jc, 3, p + 4)
    tcache = tm.init_cache(tc, 3, p + 4, device="cpu")
    want, jcache = jm.prefill_with_cache(jp, jc, jcache, jnp.asarray(prompts),
                                         jnp.asarray(pad))
    got, tcache = tm.prefill_with_cache(tp, tc, tcache, torch.tensor(prompts),
                                        torch.tensor(pad))
    _close(got, want, dtype)
    tok = rng.integers(1, jc.vocab, (3, 1)).astype(np.int32)
    for s in range(3):
        want, jcache = jm.decode_step(jp, jc, jcache, jnp.asarray(tok),
                                      jnp.int32(p + s), jnp.asarray(pad))
        got, tcache = tm.decode_step(tp, tc, tcache, torch.tensor(tok), p + s,
                                     torch.tensor(pad))
        _close(got, want, dtype)
        tok = np.asarray(jnp.argmax(want, -1), np.int32)[:, None]
    for i in range(len(jc.pattern)):
        for kv in ("k", "v"):
            _close(tcache[f"layer{i}"][kv],
                   np.asarray(jcache[f"layer{i}"][kv].astype(jnp.float32)),
                   dtype)


def test_prefill_last_position_equals_full_head(models):
    """prefill_with_cache runs the head on the last position only; its
    logits are that position's of the full cache forward."""
    _, _, tc, tp = models["gemma2-27b", "float32"]
    toks = torch.tensor(np.random.default_rng(4).integers(0, tc.vocab,
                                                          (2, 7)))
    last, _ = tm.prefill_with_cache(tp, tc, tm.init_cache(tc, 2, 8, device="cpu"),
                                    toks)
    full, _ = tm._cache_forward(tp, tc, tm.init_cache(tc, 2, 8, device="cpu"),
                                toks, 0)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("kind", ["full", "local", "chunked", "full_nope"])
def test_pattern_kinds_match_jax(kind):
    """Every attention kind of the pattern, on a small config of each."""
    kw = dict(name=f"tiny-{kind}", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, head_dim=8, d_ff=64, vocab=128, pattern=(kind,),
              window=5, chunk=4)
    jc = jm.LMConfig(**kw, dtype=jnp.float32, remat=False)
    tc = tm.LMConfig(**kw, dtype=torch.float32)
    jp = jm.init_params(jax.random.PRNGKey(2), jc)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, 128, (2, 11))
    want, _ = jm.forward(jp, jc, jnp.asarray(toks, jnp.int32))
    got, _ = tm.forward(tp, tc, torch.tensor(toks))
    _close(got, want, "float32")


def test_moe_and_unported_archs_raise():
    """Every arch resolves (the MoE ones since their slice: a MoE
    LMConfig builds); an unknown id raises KeyError."""
    from repro_torch.models.moe import MoEConfig
    cfg = tm.LMConfig(name="moe", n_layers=1, d_model=8, n_heads=1,
                      n_kv_heads=1, head_dim=8, d_ff=8, vocab=8,
                      moe=MoEConfig(n_experts=4, top_k=1, d_ff=8))
    # attention 4 x 64, experts 3 x 8 x 8 x 4, router 8 x 4, norms 2 x 8,
    # the tied embedding 8 x 8, the final norm 8
    assert cfg.param_count() == 4 * 64 + 3 * 8 * 8 * 4 + 8 * 4 + 2 * 8 \
        + 8 * 8 + 8
    assert cfg.active_param_count() == 4 * 64 + 3 * 8 * 8 + 8 * 8
    assert len(ARCH_IDS) == 10
    ported = set(ARCHS) | {"bst", "gin-tu", "graphsage-reddit",
                           "meshgraphnet", "graphcast",
                           "llama4-scout-17b-16e", "kimi-k2-1t-a32b"}
    for arch in ARCH_IDS:
        assert get_arch(arch).CONFIG.name == arch
    assert ported == set(ARCH_IDS)
    assert len(ported) == 10
    with pytest.raises(KeyError):
        get_arch("gpt-5")
