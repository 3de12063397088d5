"""The port's BST (`repro_torch.models.bst`, its layers, data, config and
serving steps) against the JAX package's, on `SMOKE_CONFIG` (f32).

Tolerances:
- weights (`init_params`, `he_init`): within 4 f32 ulps of jax's, the
  normal draws' own bound (tests/test_torch_random.py); zeros and ones
  equal.
- `bst_batch`: ids, categories and clicks equal; dense features within 4
  ulps.
- layers (dense with a bias, layer_norm, gelu, the MLP): rtol 1e-6, atol
  1e-6 (sum orders of the products and means).
- logits of forward, the serve step and the retrieval step: rtol 1e-5,
  atol 1e-5, on logits of magnitude ~2; measured <= 1.2e-6 apart (the
  packages sum the products in their own orders). The weights are the JAX
  package's own, converted by `bst_params_from_numpy`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data.recsys import bst_batch as jax_batch
from repro.models import bst as jm
from repro.models import layers as jl
from repro.train import steps as jsteps
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.configs.registry import RECSYS_SHAPES
from repro_torch.convert import bst_params_from_numpy
from repro_torch.data.recsys import bst_batch
from repro_torch.models import bst as tm
from repro_torch.models import layers as L
from repro_torch.train import steps as tsteps


def _ulps32(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.fixture(scope="module")
def model():
    """(JAX config, JAX params, port config, port params from the JAX
    params)."""
    jc, tc = jax_arch("bst").SMOKE_CONFIG, get_arch("bst").SMOKE_CONFIG
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    tp = bst_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _batch(cfg, b, step=1, pads=False):
    """bst_batch from the JAX package, as jnp and torch dicts; with `pads`
    a third of the multi-hot ids set to -1 (interspersed, some fields
    empty), as a short multi-hot field is padded."""
    jb = jax_batch(jnp.int32(step), batch=b, seq_len=cfg.seq_len,
                   item_vocab=cfg.item_vocab, cat_vocab=cfg.cat_vocab,
                   n_dense=cfg.n_dense, n_multi=cfg.n_multi,
                   multi_bag=cfg.multi_bag, multi_vocab=cfg.multi_vocab)
    jb = {k: np.array(v) for k, v in jb.items()}
    if pads:
        rng = np.random.default_rng(step)
        jb["multi_ids"][rng.random(jb["multi_ids"].shape) < 0.33] = -1
        jb["multi_ids"][::5, 0] = -1
    return ({k: jnp.asarray(v) for k, v in jb.items()},
            {k: torch.tensor(v) for k, v in jb.items()})


def _close(got: torch.Tensor, want, rtol=1e-5, atol=1e-5):
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_get_arch_bst_and_recsys_shapes():
    from repro.configs.registry import RECSYS_SHAPES as JAX_SHAPES
    mod = get_arch("bst")
    jmod = jax_arch("bst")
    assert mod.SHAPES == jmod.SHAPES
    assert RECSYS_SHAPES == JAX_SHAPES
    for name in ("CONFIG", "SMOKE_CONFIG"):
        tc, jc = getattr(mod, name), getattr(jmod, name)
        for field in ("name", "embed_dim", "seq_len", "n_blocks", "n_heads",
                      "mlp", "item_vocab", "cat_vocab", "n_dense", "n_multi",
                      "multi_bag", "multi_vocab", "dropout"):
            assert getattr(tc, field) == getattr(jc, field), field
        assert tc.dtype == torch.float32
        jp = jax.eval_shape(lambda c=jc: jm.init_params(
            jax.random.PRNGKey(0), c))
        assert tc.param_count() == sum(int(np.prod(x.shape))
                                       for x in jax.tree.leaves(jp))


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32) * 3
    w = rng.standard_normal((24, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    s, bb = rng.standard_normal(24).astype(np.float32), \
        rng.standard_normal(24).astype(np.float32)
    tx = torch.tensor(x)
    _close(L.dense(tx, torch.tensor(w), torch.tensor(b)),
           jl.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           1e-6, 1e-6)
    _close(L.layer_norm(tx, torch.tensor(s), torch.tensor(bb)),
           jl.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(bb)),
           1e-6, 1e-6)
    _close(L.gelu(tx), jax.nn.gelu(jnp.asarray(x)), 1e-6, 1e-6)
    _close(L.leaky_relu(tx), jax.nn.leaky_relu(jnp.asarray(x)), 0, 0)
    key = jax.random.PRNGKey(3)
    jmlp = jl.mlp_init(key, (24, 32, 8), jnp.float32)
    tmlp = L.mlp_init(trandom.PRNGKey(3), (24, 32, 8), torch.float32)
    assert sorted(tmlp) == sorted(jmlp)
    for k in jmlp:
        assert _ulps32(tmlp[k].numpy(), jmlp[k]).max() <= 4, k
    conv = {k: torch.tensor(np.asarray(v)) for k, v in jmlp.items()}
    _close(L.mlp_apply(conv, tx, act=L.gelu),
           jl.mlp_apply(jmlp, jnp.asarray(x), act=jax.nn.gelu), 1e-6, 1e-6)
    he = L.he_init(trandom.PRNGKey(4), (300, 7), torch.float32, fan_in=50)
    assert _ulps32(he.numpy(), jl.he_init(jax.random.PRNGKey(4), (300, 7),
                                          jnp.float32, fan_in=50)).max() <= 4


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to approximate=True; torch's default is the
    exact erf form, which differs by up to ~5e-4."""
    x = torch.linspace(-6, 6, 2001)
    got = L.gelu(x)
    assert torch.allclose(got, torch.nn.functional.gelu(x, approximate="tanh"),
                          rtol=1e-6, atol=1e-6)
    assert (got - torch.nn.functional.gelu(x)).abs().max() > 1e-4
    assert L.layer_norm(torch.zeros(2, 4), torch.ones(4), torch.zeros(4)) \
        .abs().max() == 0                     # eps keeps a flat row finite


def test_init_params_match_jax(model):
    jc, jp, tc, _ = model
    tp = tm.init_params(trandom.PRNGKey(0), tc, device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert len(jleaves) == len(tleaves) == 22
    for (jpath, want), (tpath, got) in zip(jleaves, tleaves):
        name = jax.tree_util.keystr(jpath)
        assert name == jax.tree_util.keystr(tpath)
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        assert _ulps32(got.numpy(), want).max() <= 4, name
    assert sum(t.numel() for t in jax.tree.leaves(tp)) == tc.param_count()


@pytest.mark.parametrize("step,seed", [(0, 0), (3, 7), (11, 2)])
def test_bst_batch_matches_jax(step, seed):
    kw = dict(batch=257, seq_len=20, item_vocab=4_194_304, cat_vocab=65_536,
              n_dense=16, n_multi=2, multi_bag=8, multi_vocab=131_072,
              seed=seed)
    want = jax_batch(jnp.int32(step), **kw)
    got = bst_batch(step, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "dense_feats":
            assert _ulps32(g, w).max() <= 4
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert 0 < int(got["labels"].sum()) < 257


@pytest.mark.parametrize("pads", [False, True], ids=["full", "padded"])
def test_forward_and_serve_step_match_jax(model, pads):
    jc, jp, tc, tp = model
    jb, tb = _batch(jc, 24, pads=pads)
    want = jsteps.make_bst_serve_step(jc)(jp, jb)
    got = tsteps.make_bst_serve_step(tc)(tp, tb)
    _close(got, want)
    inp = tm.BSTInputs(**{k: v for k, v in tb.items() if k != "labels"})
    assert torch.equal(tm.forward(tp, tc, inp), got)
    assert torch.equal(tm.forward(tp, tc, inp, backend="ref"), got)


def test_retrieval_step_matches_jax(model):
    """One user's context against 50 candidates: the JAX retrieval step's
    logits, and each equal to the serve step's logit of the user's
    context with that candidate as its target."""
    jc, jp, tc, tp = model
    jb, tb = _batch(jc, 50, step=4, pads=True)
    user = ("seq_items", "seq_cats", "dense_feats", "multi_ids")
    jr = {k: jb[k][:1] for k in user}
    jr.update(cand_items=jb["target_item"], cand_cats=jb["target_cat"])
    tr = {k: tb[k][:1] for k in user}
    tr.update(cand_items=tb["target_item"], cand_cats=tb["target_cat"])
    want = jsteps.make_bst_retrieval_step(jc)(jp, jr)
    got = tsteps.make_bst_retrieval_step(tc)(tp, tr)
    _close(got, want)
    tiled = {k: tb[k][:1].expand(50, *tb[k].shape[1:]) for k in user}
    tiled.update(target_item=tb["target_item"], target_cat=tb["target_cat"])
    served = tsteps.make_bst_serve_step(tc)(tp, tiled)
    torch.testing.assert_close(got, served, rtol=1e-6, atol=1e-6)


def test_bst_params_from_numpy_keeps_the_tree(model):
    _, jp, _, tp = model
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 1
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for k in path:
            t = t[k.idx if hasattr(k, "idx") else k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
