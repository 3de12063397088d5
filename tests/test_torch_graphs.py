"""The port's graph data (`repro_torch.data.graphs`) against the JAX
package's `data/graphs.py`, on the CPU.

Tolerances: integers (CSR arrays, sampled neighbours, block edges and
node ids, molecule edges, labels, graph ids and targets) equal; normal
draws (node and edge features, regression targets) within 4 f32 ulps,
`random.normal`'s own bound (tests/test_torch_random.py); features
gathered from the caller's array equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graphs as jg
from repro_torch import random as trandom
from repro_torch.data import graphs as tg


def _ulps32(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _same(want, got: torch.Tensor, ulps=0):
    w = np.asarray(want)
    g = got.numpy()
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    if ulps:
        assert _ulps32(g, w).max() <= ulps
    else:
        assert np.array_equal(g, w)


@pytest.mark.parametrize("n,e,clustered", [(3000, 20_000, True),
                                           (3000, 20_000, False),
                                           (1200, 900, True)])
def test_synth_graph_bit_equal(n, e, clustered):
    """Bit-equal CSR arrays, sparse enough in the last case that most
    nodes have no out-edge."""
    want = jg.synth_graph(n, e, seed=3, clustered=clustered)
    got = tg.synth_graph(n, e, seed=3, clustered=clustered, device="cpu")
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges)
    _same(want.indptr, got.indptr)
    _same(want.indices, got.indices)


@pytest.fixture(scope="module")
def graphs():
    """A sparse graph (many isolated nodes) from both packages."""
    return (jg.synth_graph(1200, 900, seed=5),
            tg.synth_graph(1200, 900, seed=5, device="cpu"))


@pytest.mark.parametrize("fanout", [1, 5])
def test_sample_neighbors_equal(graphs, fanout):
    jgraph, tgraph = graphs
    seeds = np.arange(0, 1200, 7).astype(np.int32)
    want = jg.sample_neighbors(jgraph, jnp.asarray(seeds), fanout,
                               jax.random.PRNGKey(4))
    got = tg.sample_neighbors(tgraph, torch.tensor(seeds), fanout,
                              trandom.PRNGKey(4))
    _same(want, got)
    deg = np.diff(np.asarray(jgraph.indptr))[seeds]
    assert (deg == 0).sum() > 20                       # isolated: self-loops
    assert np.array_equal(got.numpy()[deg == 0],
                          np.repeat(seeds[deg == 0, None], fanout, 1))


@pytest.mark.parametrize("fanouts,step", [((4, 3), 5), ((15, 10), 0)])
def test_sample_block_equal(graphs, fanouts, step):
    jgraph, tgraph = graphs
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(1200, 6)).astype(np.float32)
    labels = rng.integers(0, 5, 1200).astype(np.int32)
    want = jg.sample_block(jgraph, jnp.asarray(feats), jnp.asarray(labels),
                           16, fanouts, 2, step)
    got = tg.sample_block(tgraph, torch.tensor(feats), torch.tensor(labels),
                          16, fanouts, 2, step)
    assert sorted(got) == sorted(want)
    for k in want:
        _same(want[k], got[k])
    shapes = tg.block_shapes(16, fanouts, 6)
    for k, (shape, dtype) in shapes.items():
        assert tuple(got[k].shape) == shape and got[k].dtype == dtype, k


@pytest.mark.parametrize("batch,fanouts,d", [(1024, (15, 10), 602),
                                             (7, (3,), 2), (5, (), 9)])
def test_block_shapes_equal(batch, fanouts, d):
    want = jg.block_shapes(batch, fanouts, d)
    got = tg.block_shapes(batch, fanouts, d)
    assert sorted(got) == sorted(want)
    for k, (shape, dtype) in want.items():
        assert got[k][0] == shape, k
        assert got[k][1] == getattr(torch, jnp.dtype(dtype).name), k


@pytest.mark.parametrize("step", [0, 3])
def test_molecule_batch_equal(step):
    want = jg.molecule_batch(6, 30, 64, 16, 5, seed=1, step=step)
    got = tg.molecule_batch(6, 30, 64, 16, 5, seed=1, step=step,
                            device="cpu")
    assert sorted(got) == sorted(want)
    _same(want["node_feat"], got["node_feat"], ulps=4)
    for k in ("edge_src", "edge_dst", "graph_ids", "graph_targets"):
        _same(want[k], got[k])


@pytest.mark.parametrize("out_kind,edge_feat", [("node_ce", False),
                                                ("node_mse", True)])
def test_synth_full_graph_batch_equal(out_kind, edge_feat):
    """N = 1,000, E = 5,000 padded to 1,024 / 5,120: pad edges -1, pad
    nodes' features 0, labels -1 or targets 0 with node_mask 0."""
    want = jg.synth_full_graph_batch(1000, 5000, 7, out_kind, 3, seed=1,
                                     with_edge_feat=edge_feat)
    got = tg.synth_full_graph_batch(1000, 5000, 7, out_kind, 3, seed=1,
                                    with_edge_feat=edge_feat, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        floats = np.asarray(want[k]).dtype == np.float32 and k != "node_mask"
        _same(want[k], got[k], ulps=4 if floats else 0)
    assert int((got["edge_src"] < 0).sum()) == 120
    assert bool((got["node_feat"][1000:] == 0).all())
