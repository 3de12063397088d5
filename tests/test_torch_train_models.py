"""The port's GNN and BST train steps (`train.steps.make_gnn_train_step`,
`make_bst_train_step`) against the JAX package's, on the SMOKE_CONFIGs, on
the CPU (the plain route: torch differentiates the plain ops, the node and
table gathers sum their gradients through `ops.segment_matmul`, BST's
bags through `ops.embedding_bag`); and the GNNs' remat.

Tolerances: the loss rtol 1e-5; the params after one step within 1e-5 of
each leaf's largest magnitude plus 1e-2 lr (AdamW's first update is
lr g / (|g| + eps), which a gradient's last bits swing by a fraction of lr
where |g| is near eps); remat on / off bit-equal. The weights are the
port's init_params (within 4 f32 ulps of JAX's) handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.train import steps as jsteps
from repro.train.optimizers import OptConfig as JOpt
from repro_torch.configs import get_arch
from repro_torch.models.bst import init_params as tinit_bst
from repro_torch.models.gnn import init_params as tinit_gnn
from repro_torch.random import PRNGKey
from repro_torch.train import steps as tsteps
from repro_torch.train.optimizers import OptConfig, init_opt_state, \
    tree_leaves

OPT = dict(lr=1e-3, warmup=1, decay_steps=4)
STEP_ATOL = 1e-2 * OPT["lr"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(tree):
    """A port tree as numpy copies (JAX may read a numpy buffer in place,
    after the port's in-place step has run)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree.detach().numpy().copy()


def _leafwise_close(got, want, frac, what="", atol=0.0):
    gl = tree_leaves(got)
    wl = [np.asarray(x, np.float32) for x in jax.tree.leaves(want)]
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        g = g.detach().float().numpy()
        assert g.shape == w.shape, (what, i)
        scale = float(np.abs(w).max()) if w.size else 0.0
        assert float(np.abs(g - w).max(initial=0.0)) <= frac * scale + atol, \
            (what, i, float(np.abs(g - w).max()), scale)


# ------------------------------------------------------------ GNN, BST --
def _gnn(arch, jax_too=False):
    """(port config, port params, port batch) of an arch's smoke config on
    a small graph of its loss kind; with jax_too also the JAX side."""
    from repro_torch.data import graphs as tgraphs
    jc = jax_arch(arch).SMOKE_CONFIG
    tc = get_arch(arch).SMOKE_CONFIG
    mse = jc.kind in ("mgn", "graphcast")
    # the port's draw of the JAX package's batch (equal arrays,
    # tests/test_torch_graphs.py)
    jb = {k: v.numpy() for k, v in tgraphs.synth_full_graph_batch(
        120, 480, jc.d_in, "node_mse" if mse else "node_ce", jc.n_out, 3,
        with_edge_feat=mse, device="cpu").items()}
    tp = tinit_gnn(PRNGKey(0), tc, device="cpu")
    layers = _np(tp["layers"])
    jp = jax.tree.map(jnp.asarray, {**_np(tp), "layers": jax.tree.map(
        lambda *xs: np.stack(xs), *layers)})
    tb = {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}
    if jax_too:
        return tc, tp, tb, jc, jp, jb
    return tc, tp, tb


@pytest.mark.parametrize("arch", ["gin-tu", "graphsage-reddit",
                                  "meshgraphnet", "graphcast"])
def test_gnn_train_step_matches_jax(arch):
    """One GNN train step on each arch's smoke config: the loss and the
    updated params as the JAX step's (MeshGraphNet and GraphCast on
    node_mse with edge features, GIN and SAGE on node_ce)."""
    tc, tp, tb, jc, jp, jb = _gnn(arch, jax_too=True)
    kind = "node_mse" if jc.kind in ("mgn", "graphcast") else "node_ce"
    jopt, topt = JOpt(**OPT), OptConfig(**OPT)
    jp2, _, jm = jax.jit(jsteps.make_gnn_train_step(jc, jopt, kind))(
        jp, jsteps.init_opt_state(jopt, jp), jb)
    tp2, _, tm = tsteps.make_gnn_train_step(tc, topt, kind)(
        tp, init_opt_state(topt, tp), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    stacked = {**tp2, "layers": jax.tree.map(
        lambda *xs: torch.stack(xs), *tp2["layers"])}
    _leafwise_close(stacked, jp2, 1e-5, arch, STEP_ATOL)


def test_bst_train_step_matches_jax():
    """One BST train step on its smoke config, with -1 pads in the
    multi-hot fields: the loss and the updated params as the JAX step's
    (the tables' gradients through gather_rows, the bags' through
    embedding_bag's backward)."""
    from repro_torch.data.recsys import bst_batch
    jc, tc = jax_arch("bst").SMOKE_CONFIG, get_arch("bst").SMOKE_CONFIG
    # the port's draw of the JAX package's batch (tests/test_torch_bst.py)
    jb = {k: v.numpy() for k, v in bst_batch(
        2, batch=16, seq_len=tc.seq_len, item_vocab=tc.item_vocab,
        cat_vocab=tc.cat_vocab, n_dense=tc.n_dense, n_multi=tc.n_multi,
        multi_bag=tc.multi_bag, multi_vocab=tc.multi_vocab,
        device="cpu").items()}
    jb["multi_ids"][np.random.default_rng(2).random(
        jb["multi_ids"].shape) < 0.3] = -1
    tp = tinit_bst(PRNGKey(0), tc, device="cpu")
    jp = jax.tree.map(jnp.asarray, _np(tp))
    jopt, topt = JOpt(**OPT), OptConfig(**OPT)
    jp2, _, jm = jax.jit(jsteps.make_bst_train_step(jc, jopt))(
        jp, jsteps.init_opt_state(jopt, jp),
        {k: jnp.asarray(v) for k, v in jb.items()})
    tp2, _, tm = tsteps.make_bst_train_step(tc, topt)(
        tp, init_opt_state(topt, tp),
        {k: torch.tensor(v) for k, v in jb.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    _leafwise_close(tp2, jp2, 1e-5, "bst", STEP_ATOL)


def test_gnn_remat_on_and_off_give_the_same_bits():
    """Checkpointing each message-passing layer recomputes the forward's
    bits: the gradients with remat on and off are equal."""
    gc, gp, batch = _gnn("gin-tu")
    gg = [tsteps.value_and_grad(lambda p: tsteps.gnn_loss(
        p, dataclasses.replace(gc, remat=r), batch, "node_ce"), gp)[1]
        for r in (True, False)]
    for a, b in zip(tree_leaves(gg[0]), tree_leaves(gg[1])):
        assert torch.equal(a, b)
