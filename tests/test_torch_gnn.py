"""The port's GNNs (`repro_torch.models.gnn`, their configs and registry
cells, `convert.gnn_params_from_numpy`, `train.steps.gnn_loss`) against
the JAX package's, on the CPU, where every segment sum runs the op's
plain version.

Tolerances:
- weights (`init_params`): within 4 f32 ulps of jax's, the normal draws'
  own bound (tests/test_torch_random.py); zeros equal; bf16 leaves
  converted bit for bit.
- f32 logits of the four SMOKE_CONFIGs: |port - jax| <= 1e-5 x the
  largest |logit| (measured <= 3.3e-7: the packages sum the products and
  the segments in their own orders).
- bf16 (MeshGraphNet's smoke config): the aggregate bit-equal to the JAX
  package's `segment_matmul_ref` on the same messages (both sum in f32
  and round once); the logits within (n_layers + 1) bf16 ulps at the
  largest |logit|'s scale (measured 1), since the JAX model sums its
  segments in bf16 (`jax.ops.segment_sum`), the port in f32 (ROADMAP C).
- GIN's bf16 layer: f32 out, as JAX's promotion has it; rtol 1e-5 of the
  largest output against JAX's line on the same aggregate.
- losses: rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.kernels.ref import segment_matmul_ref as jax_segment_ref
from repro.models import gnn as jm
from repro.models import layers as jl
from repro.train import steps as jsteps
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.configs import registry as treg
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import gnn as tm
from repro_torch.train import steps as tsteps

ARCHS = ["gin-tu", "graphsage-reddit", "meshgraphnet", "graphcast"]
CFG_FIELDS = ("name", "kind", "n_layers", "d_hidden", "d_in", "n_out",
              "aggregator", "mlp_layers", "d_edge_in", "graph_level",
              "remat")
N_NODES, N_EDGES, N_GRAPHS = 40, 160, 4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the graphs are small, and a pool of one thread
    a core in each of several test workers oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _ulps32(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _torch_dtype(jdtype):
    return getattr(torch, jnp.dtype(jdtype).name)


def _graph(seed=1, edge_feat=False, graph_ids=False, d_in=8):
    """N = 40 nodes, E = 160 edges: -1 pads trailing (7) and interspersed
    (3, their destinations kept), one edge with a valid source and
    destination -1, and the last 4 nodes with no valid in-edge (isolated
    under the mean). As numpy arrays."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_NODES, N_EDGES).astype(np.int32)
    dst = rng.integers(0, N_NODES, N_EDGES).astype(np.int32)
    src[-7:] = -1
    dst[-7:] = -1
    src[[3, 50, 90]] = -1
    dst[5] = -1
    src[dst >= N_NODES - 4] = -1
    assert src[5] >= 0
    return dict(
        node_feat=rng.normal(size=(N_NODES, d_in)).astype(np.float32),
        edge_src=src, edge_dst=dst,
        edge_feat=(rng.normal(size=(N_EDGES, 4)).astype(np.float32)
                   if edge_feat else None),
        graph_ids=(np.repeat(np.arange(N_GRAPHS), N_NODES // N_GRAPHS)
                   .astype(np.int32) if graph_ids else None))


def _batches(arrays, n_graphs=1):
    def conv(f):
        return {k: None if v is None else f(v) for k, v in arrays.items()}
    return (jm.GraphBatch(**conv(jnp.asarray), n_graphs=n_graphs),
            tm.GraphBatch(**conv(torch.tensor), n_graphs=n_graphs))


def _configs(arch, **changes):
    jc = dataclasses.replace(jax_arch(arch).SMOKE_CONFIG, **changes)
    tchanges = dict(changes)
    if "dtype" in changes:
        tchanges["dtype"] = _torch_dtype(changes["dtype"])
    return jc, dataclasses.replace(get_arch(arch).SMOKE_CONFIG, **tchanges)


def _models(arch, **changes):
    jc, tc = _configs(arch, **changes)
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    return jc, jp, tc, gnn_params_from_numpy(jax.tree.map(np.asarray, jp),
                                             device="cpu")


# ---------------------------------------------------------------- registry --
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "ogb_products", "molecule"])
def test_make_cell_matches_jax(arch, shape):
    want = jax_arch(arch).make_cell(shape)
    got = get_arch(arch).make_cell(shape)
    assert isinstance(got, treg.Cell) and got.cell_id == want.cell_id
    for f in ("arch", "shape", "kind", "step", "loss_kind", "skip_reason",
              "notes"):
        assert getattr(got, f) == getattr(want, f), f
    for f in CFG_FIELDS:
        assert getattr(got.model_cfg, f) == getattr(want.model_cfg, f), f
    assert got.model_cfg.dtype == _torch_dtype(want.model_cfg.dtype)
    wspec, gspec = want.input_specs(), got.input_specs()
    assert sorted(gspec) == sorted(wspec)
    for k, s in wspec.items():
        assert gspec[k] == (tuple(s.shape), _torch_dtype(s.dtype)), k


def test_gnn_configs_and_shapes_match_jax():
    from repro.configs.registry import GNN_SHAPES, pad_to
    assert treg.GNN_SHAPES == GNN_SHAPES
    for n in (2708, 61_859_140, 512, 1):
        assert treg.pad_to(n) == pad_to(n) and treg.pad_to(n, 7) == \
            pad_to(n, 7)
    for arch in ARCHS:
        jmod, tmod = jax_arch(arch), get_arch(arch)
        assert tmod.SHAPES == jmod.SHAPES
        for name in ("CONFIG", "SMOKE_CONFIG"):
            jc, tc = getattr(jmod, name), getattr(tmod, name)
            assert [getattr(tc, f) for f in CFG_FIELDS] == \
                [getattr(jc, f) for f in CFG_FIELDS]
            assert tc.dtype == _torch_dtype(jc.dtype)
        for const in ("SAMPLE_SIZES", "N_CLASSES", "N_VARS",
                      "MESH_REFINEMENT"):
            assert getattr(tmod, const, None) == getattr(jmod, const, None)
    assert get_arch("meshgraphnet").CONFIG.dtype == torch.bfloat16
    assert get_arch("graphcast").CONFIG.dtype == torch.bfloat16


# -------------------------------------------------------------- parameters --
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_jax(arch):
    jc, jp, tc, _ = _models(arch)
    got = tm.init_params(trandom.PRNGKey(0), tc, device="cpu")
    assert len(got["layers"]) == jc.n_layers
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = jax.tree_util.tree_flatten_with_path(
        {**got, "layers": jax.tree.map(lambda *xs: torch.stack(xs),
                                       *got["layers"])})[0]
    assert len(jleaves) == len(tleaves)
    for (jpath, want), (tpath, have) in zip(jleaves, tleaves):
        name = jax.tree_util.keystr(jpath)
        assert name == jax.tree_util.keystr(tpath)
        assert have.dtype == _torch_dtype(want.dtype), name
        assert tuple(have.shape) == want.shape, name
        assert _ulps32(have.numpy(), want).max() <= 4, name


@pytest.mark.parametrize("arch,dtype", [(a, jnp.float32) for a in ARCHS]
                         + [("meshgraphnet", jnp.bfloat16),
                            ("gin-tu", jnp.bfloat16)])
def test_params_from_numpy_round_trip(arch, dtype):
    """The converted tree, its layers stacked back, holds the JAX tree's
    leaves bit for bit (bf16 through its bits, GIN's f32 eps scalars)."""
    jc, jp, tc, tp = _models(arch, dtype=dtype)
    back = {**tp, "layers": jax.tree.map(lambda *xs: torch.stack(xs),
                                         *tp["layers"])}
    jleaves, jdef = jax.tree.flatten(jp)
    tleaves, tdef = jax.tree.flatten(back)
    assert jdef == tdef
    for want, have in zip(jleaves, tleaves):
        assert have.dtype == _torch_dtype(want.dtype)
        w = np.asarray(want)
        bits = np.int16 if w.dtype.itemsize == 2 else np.int32
        assert np.array_equal(have.view(getattr(torch, bits.__name__))
                              .numpy(), w.view(bits))


# ----------------------------------------------------------------- forward --
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("edge_feat", [False, True], ids=["no_ef", "ef"])
@pytest.mark.parametrize("graph_level", [False, True],
                         ids=["nodes", "graphs"])
def test_forward_matches_jax(arch, edge_feat, graph_level):
    """Each SMOKE_CONFIG on the JAX parameters: pads trailing and
    interspersed, a valid source with destination -1, isolated nodes under
    SAGE's mean, edge features absent (zeros) or given, and the per-graph
    pool over graph_ids."""
    jc, jp, tc, tp = _models(arch, graph_level=graph_level)
    jg, tg = _batches(_graph(edge_feat=edge_feat, graph_ids=graph_level),
                      N_GRAPHS if graph_level else 1)
    want = np.asarray(jm.forward(jp, jc, jg))
    got = tm.forward(tp, tc, tg).numpy()
    assert got.shape == want.shape == (
        N_GRAPHS if graph_level else N_NODES, jc.n_out)
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_graph_pool_without_ids_pools_everything():
    jc, jp, tc, tp = _models("gin-tu", graph_level=True)
    jg, tg = _batches(_graph())
    want = np.asarray(jm.forward(jp, jc, jg))
    got = tm.forward(tp, tc, tg).numpy()
    assert got.shape == want.shape == (1, jc.n_out)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("aggregator", ["sum", "mean"])
def test_aggregate_matches_jax(aggregator):
    """`_aggregate` against the JAX model's on the same messages: pads and
    the destination -1 skipped, isolated nodes 0 under both aggregators."""
    arrays = _graph()
    src, dst = arrays["edge_src"], arrays["edge_dst"]
    msg = np.random.default_rng(2).normal(size=(N_EDGES, 16)) \
        .astype(np.float32)
    valid = src >= 0
    safe = np.where(valid, dst, 0)
    want = np.asarray(jm._aggregate(jnp.asarray(msg), jnp.asarray(safe),
                                    N_NODES, aggregator, jnp.asarray(valid)))
    got = tm._aggregate(torch.tensor(msg), torch.tensor(safe), N_NODES,
                        aggregator, torch.tensor(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all(got[N_NODES - 4:] == 0)


def test_bf16_aggregate_is_the_kernel_semantics():
    """In bf16 the port's aggregate is `segment_matmul_ref`'s (f32 sums
    rounded once), bit for bit; the JAX model's own bf16 sum differs."""
    arrays = _graph()
    src, dst = arrays["edge_src"], arrays["edge_dst"]
    msg = np.random.default_rng(2).normal(size=(N_EDGES, 16)) \
        .astype(np.float32)
    jmsg = jnp.asarray(msg).astype(jnp.bfloat16)
    valid = src >= 0
    want = jax_segment_ref(jmsg, jnp.asarray(np.where(valid, dst, -1)),
                           N_NODES)
    got = tm._aggregate(torch.tensor(msg).to(torch.bfloat16),
                        torch.tensor(np.where(valid, dst, 0)), N_NODES,
                        "sum", torch.tensor(valid))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))


def test_meshgraphnet_bf16_within_bf16_ulps():
    jc, jp, tc, tp = _models("meshgraphnet", dtype=jnp.bfloat16)
    jg, tg = _batches(_graph(edge_feat=True))
    want = np.asarray(jm.forward(jp, jc, jg)).astype(np.float32)
    got = tm.forward(tp, tc, tg)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert np.abs(got - want).max() <= (jc.n_layers + 1) * ulp


def test_gin_bf16_layer_promotes_to_f32():
    """The JAX line `(1.0 + eps) * h + agg` (gnn.py:185) promotes a bf16 h
    to f32 with the f32 eps scalar, so a bf16 GIN layer's MLP runs in f32
    and h leaves it in f32. The port's layer does the same, on the same
    aggregate (the kernel's, f32 sums rounded once to bf16)."""
    jc, jp, tc, tp = _models("gin-tu", dtype=jnp.bfloat16)
    arrays = _graph()
    src, dst = arrays["edge_src"], arrays["edge_dst"]
    valid = src >= 0
    h = np.random.default_rng(3).normal(size=(N_NODES, 16)) \
        .astype(np.float32)
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    agg = jax_segment_ref(jh[np.where(valid, src, 0)],
                          jnp.asarray(np.where(valid, dst, -1)), N_NODES)
    lp = jax.tree.map(lambda x: x[0], jp["layers"])
    want = jl.mlp_apply(lp["mlp"], (1.0 + lp["eps"]) * jh + agg,
                        act=jax.nn.relu, final_act=True)
    assert want.dtype == jnp.float32
    edges = tm.edges_of(tm.GraphBatch(None, torch.tensor(src),
                                      torch.tensor(dst)))
    got, _ = tm.apply_layer(tp["layers"][0], tc,
                            torch.tensor(h).to(torch.bfloat16), None, edges)
    assert got.dtype == torch.float32
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_kernel_backend_refuses_cpu_tensors():
    """backend="kernel" on CPU tensors raises before anything launches;
    "auto" on the CPU is the plain version, with no launch."""
    jc, jp, tc, tp = _models("graphsage-reddit")
    _, tg = _batches(_graph())
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        tm.forward(tp, tc, tg, backend="kernel")
    assert torch.equal(tm.forward(tp, tc, tg),
                       tm.forward(tp, tc, tg, backend="ref"))
    assert ops.launch_counts() == before


# -------------------------------------------------------------------- loss --
def _loss_case(kind):
    """(arch, config changes, batch as numpy) for each loss kind."""
    from repro.data import graphs as jgraphs
    if kind == "node_ce":
        b = jgraphs.synth_full_graph_batch(300, 1200, 8, "node_ce", 2, 4)
        return "gin-tu", {}, b
    if kind == "node_mse":
        b = jgraphs.synth_full_graph_batch(300, 1200, 8, "node_mse", 3, 4,
                                           with_edge_feat=True)
        return "meshgraphnet", {}, b
    b = jgraphs.molecule_batch(8, 10, 20, 8, 5, seed=2, step=1)
    return "graphsage-reddit", {"graph_level": True}, b


@pytest.mark.parametrize("kind", ["node_ce", "node_mse", "graph_ce"])
def test_gnn_loss_matches_jax(kind):
    arch, changes, batch = _loss_case(kind)
    jc, jp, tc, tp = _models(arch, **changes)
    want, wmet = jsteps.gnn_loss(jp, jc, batch, kind)
    tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    got, gmet = tsteps.gnn_loss(tp, tc, tb, kind)
    assert sorted(gmet) == sorted(wmet)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in wmet:
        np.testing.assert_allclose(float(gmet[k]), float(wmet[k]), rtol=1e-5)
