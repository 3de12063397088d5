"""The port's optimizers and gradient compression (`repro_torch.train.
optimizers`, `repro_torch.train.compression`) against the JAX package's, on
random trees drawn with numpy from a seed.

Tolerances (measured; both packages compute the same f32 ops in the same
order but for the reductions and the transcendental functions):
- lr_schedule: within 4 f32 ulps (jnp.cos vs torch.cos), rtol 5e-7
  (measured 2 ulps).
- global_norm: rtol 1e-6 (f32 sums of squares in each library's order).
- opt_update over 3 steps: f32 params, master copies and moments within
  rtol 2e-6 plus 2e-6 of the leaf's largest magnitude (the clip scale and
  the bias corrections' f32 pow may differ by an ulp, which moves every
  gradient of a step by an ulp; a moment that cancels to near 0 then
  differs by up to ~1e-5 of itself); bf16 params at most one bf16 ulp apart; the step counter
  equal.
- int8 compression: the quantized ints equal, the rest rtol 1e-6; top-k:
  the indices equal (no ties in these draws), values and residuals equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as jcomp
from repro.train import optimizers as jopt
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizers as topt

STEPS = 3
# JAX's side compiled once a config (eager dispatch compiles every op at
# every leaf's shape, which costs more here than the whole update)
J_UPDATE = jax.jit(jopt.opt_update, static_argnums=0)


def _tree(rng, dtype=np.float32):
    """A small params-like tree: matrices (factored under adafactor), a
    stacked 3-D leaf, vectors and a scalar, in nested dicts and a list."""
    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return {"embed": a(12, 8), "blocks": {"w": a(2, 8, 6), "ln": a(8)},
            "layers": [{"eps": a(), "b": a(6)}, {"eps": a(), "b": a(6)}],
            "head": a(8, 1)}


def _small_tree(rng):
    """Three leaf shapes (a matrix, a vector, a scalar) in a dict and a
    list: the compressors run eagerly in JAX, one compile per op and shape."""
    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return {"w": a(12, 8), "b": [a(6), a()]}


def _jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _to_np(t):
    if isinstance(t, dict):
        return {k: _to_np(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_np(v) for v in t]
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}/{i}")
        return
    w = np.asarray(want)
    if w.dtype.name == "bfloat16":
        gb = torch.tensor(np.asarray(got, np.float32)).to(torch.bfloat16)
        wb = torch.tensor(w.astype(np.float32)).to(torch.bfloat16)
        diff = (gb.view(torch.int16).int() - wb.view(torch.int16).int()).abs()
        assert int(diff.max()) <= 1, path
        return
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(np.asarray(got), w, rtol=2e-6,
                               atol=2e-6 * scale, err_msg=path)


CASES = [("adamw", True, "float32"), ("adamw", True, "bfloat16"),
         ("adamw", False, "bfloat16"), ("adafactor", True, "float32"),
         ("sgdm", True, "float32")]


@pytest.mark.parametrize("kind,master,dtype", CASES)
def test_opt_update_matches_jax(kind, master, dtype):
    """Three steps of opt_update on the same params and gradients: params,
    state and metrics as the JAX package's (adamw with and without the
    f32 master of bf16 params; adafactor over factored matrices, a
    stacked 3-D leaf and unfactored vectors and scalars; sgdm)."""
    rng = np.random.default_rng(CASES.index((kind, master, dtype)))
    cfg_kw = dict(kind=kind, lr=1e-2, warmup=2, decay_steps=10,
                  master_fp32=master, grad_clip=0.5)
    jcfg, tcfg = jopt.OptConfig(**cfg_kw), topt.OptConfig(**cfg_kw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = _jax(_tree(rng), jdt)
    js = jopt.init_opt_state(jcfg, jp)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ts = topt.init_opt_state(tcfg, tp)
    _close(_to_np(ts["leaves"]), jax.tree.map(np.asarray, js["leaves"]))
    for _ in range(STEPS):
        g = _tree(rng)
        jp, js, jm = J_UPDATE(jcfg, _jax(g, jdt), js, jp)
        tg = lm_params_from_numpy(jax.tree.map(np.asarray, _jax(g, jdt)),
                                  device="cpu")
        tp, ts, tm = topt.opt_update(tcfg, tg, ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=5e-7)
    assert int(ts["step"]) == int(js["step"]) == STEPS
    _close(_to_np(tp), jax.tree.map(np.asarray, jp))
    _close(_to_np(ts["leaves"]), jax.tree.map(np.asarray, js["leaves"]))
    if master and dtype == "bfloat16":
        assert "master" in ts["leaves"]["embed"]


def test_lr_schedule_and_clip_match_jax():
    """The warmup + cosine schedule at every step of a short run, and the
    clip: the norm and every clipped leaf as f32."""
    cfg = dict(lr=3e-3, warmup=5, decay_steps=40, min_lr_ratio=0.1)
    jc, tc = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    for step in range(0, 45):
        np.testing.assert_allclose(
            float(topt.lr_schedule(tc, step)),
            float(jopt.lr_schedule(jc, jnp.int32(step))), rtol=5e-7)
    rng = np.random.default_rng(5)
    tree = _tree(rng)
    jg, jn = jax.jit(jopt.clip_by_global_norm, static_argnums=1)(
        _jax(tree, jnp.float32), 0.3)
    tg, tn = topt.clip_by_global_norm(
        lm_params_from_numpy(tree, device="cpu"), 0.3)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close(_to_np(tg), jax.tree.map(np.asarray, jg))
    assert all(t.dtype == torch.float32 for t in topt.tree_leaves(tg))


def test_opt_state_carries_from_a_jax_checkpoint():
    """A JAX optimizer state (after two steps) converted by
    opt_state_from_numpy continues in the port as it does in JAX."""
    rng = np.random.default_rng(6)
    cfg_kw = dict(lr=1e-2, warmup=1, decay_steps=6)
    jcfg, tcfg = jopt.OptConfig(**cfg_kw), topt.OptConfig(**cfg_kw)
    jp = _jax(_tree(rng), jnp.bfloat16)
    js = jopt.init_opt_state(jcfg, jp)
    for _ in range(2):
        jp, js, _ = J_UPDATE(jcfg, _jax(_tree(rng), jnp.bfloat16), js, jp)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert int(ts["step"]) == 2 and ts["step"].dtype == torch.int32
    g = _tree(rng)
    jp, js, _ = J_UPDATE(jcfg, _jax(g, jnp.bfloat16), js, jp)
    tp, ts, _ = topt.opt_update(
        tcfg, lm_params_from_numpy(jax.tree.map(
            np.asarray, _jax(g, jnp.bfloat16)), device="cpu"), ts, tp)
    _close(_to_np(tp), jax.tree.map(np.asarray, jp))
    _close(_to_np(ts["leaves"]), jax.tree.map(np.asarray, js["leaves"]))


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_error_feedback_compression_matches_jax(method):
    """Two rounds of ef_compress_grads (the residual carried), the wire
    bytes, and the compressors alone."""
    rng = np.random.default_rng(7)
    tree = _small_tree(rng)
    jef = jcomp.init_ef_state(_jax(tree, jnp.float32))
    tef = tcomp.init_ef_state(lm_params_from_numpy(tree, device="cpu"))
    for _ in range(2):
        g = _small_tree(rng)
        jd, jef, js = jcomp.ef_compress_grads(_jax(g, jnp.float32), jef,
                                              method, topk_frac=0.25)
        td, tef, ts = tcomp.ef_compress_grads(
            lm_params_from_numpy(g, device="cpu"), tef, method,
            topk_frac=0.25)
        _close(_to_np(td), jax.tree.map(np.asarray, jd))
        _close(_to_np(tef.residual), jax.tree.map(np.asarray, jef.residual))
        np.testing.assert_allclose(float(ts["ef_residual_sq"]),
                                   float(js["ef_residual_sq"]), rtol=1e-6)
    assert tcomp.compressed_bytes(lm_params_from_numpy(tree, device="cpu"),
                                  method, 0.25) == \
        jcomp.compressed_bytes(_jax(tree, jnp.float32), method, 0.25)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    if method == "int8":
        jq, jsc = jcomp.compress_int8(jnp.asarray(x))
        tq, tsc = tcomp.compress_int8(torch.tensor(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(tsc), float(jsc), rtol=1e-6)
    else:
        jv, ji, _ = jcomp.compress_topk(jnp.asarray(x), 0.3)
        tv, ti, shp = tcomp.compress_topk(torch.tensor(x), 0.3)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(
            tcomp.decompress_topk(tv, ti, shp).numpy(),
            np.asarray(jcomp.decompress_topk(jv, ji, (5, 7))))
