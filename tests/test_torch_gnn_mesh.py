"""The GNNs' mesh branch (`repro_torch.models.gnn.forward` under a mesh
context: the JAX model's shard_map branch of `sharded_message_pass`) in
spawned gloo ranks, W = 2 over a ("data",) mesh and W = 4 over a
(2, 2) ("data", "model") mesh, whose flattened axes split the graph
4 ways. Every rank passes the whole graph; the gathered node outputs are
held to the port's one-process forward and to the JAX model's forward
without a mesh.

Tolerances (the split changes only the order of the partial sums):
- f32: |mesh - one process| <= 2e-6 x the largest |output| (measured
  <= 5.0e-7 at W = 2 and 4); against JAX 1e-5 x the largest |output|, as
  tests/test_torch_gnn.py holds the one-process forward.
- bf16 (MeshGraphNet, GraphCast): the partial sums are reduced in f32 and
  rounded once, the one-process forward's semantics; within (n_layers +
  1) bf16 ulps at the largest |output|'s scale of both references.
- a node count that no mesh axis divides: exactly the one-process result
  (every rank runs the whole graph); edges that split over the first axis
  but not over the whole group raise, as JAX's shard_map does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.configs import get_arch as jax_arch
from repro.models import gnn as jm
from repro_torch.configs import get_arch
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.distributed.spawn import run_ranks
from repro_torch.models import gnn as tm

ARCHS = ["gin-tu", "graphsage-reddit", "meshgraphnet", "graphcast"]
N_GRAPHS = 4
F32_TOL = 2e-6
JAX_TOL = 1e-5
MESHES = {2: (2,), 4: (2, 2)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _graph(n, e, d_in, edge_feat, graph_ids, seed=1):
    """n nodes, e edges: -1 pads trailing (7) and interspersed (3), one
    edge with a valid source and destination -1. As numpy arrays."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src[-7:] = -1
    dst[-7:] = -1
    src[[3, 50, 90]] = -1
    dst[5] = -1
    return dict(
        node_feat=rng.normal(size=(n, d_in)).astype(np.float32),
        edge_src=src, edge_dst=dst,
        edge_feat=(rng.normal(size=(e, 4)).astype(np.float32)
                   if edge_feat else None),
        graph_ids=(np.repeat(np.arange(N_GRAPHS), -(-n // N_GRAPHS))[:n]
                   .astype(np.int32) if graph_ids else None))


def _case_list():
    """(name, arch, dtype, n_nodes, n_edges, graph_level)."""
    out = [(f"{a}-f32", a, "float32", 40, 160, False) for a in ARCHS]
    out += [(f"{a}-bf16", a, "bfloat16", 40, 160, False)
            for a in ("meshgraphnet", "graphcast")]
    out += [("gin-tu-pooled", "gin-tu", "float32", 40, 160, True),
            ("graphcast-pooled-bf16", "graphcast", "bfloat16", 40, 160, True),
            ("sage-odd-nodes", "graphsage-reddit", "float32", 41, 160,
             False),
            ("mgn-odd-nodes", "meshgraphnet", "float32", 41, 160, False),
            ("gin-odd-edges", "gin-tu", "float32", 40, 162, False)]
    return out


CASES = _case_list()


def _configs(arch, dtype, graph_level):
    jc = dataclasses.replace(jax_arch(arch).SMOKE_CONFIG,
                             dtype=getattr(jnp, dtype),
                             graph_level=graph_level)
    tc = dataclasses.replace(get_arch(arch).SMOKE_CONFIG,
                             dtype=getattr(torch, dtype),
                             graph_level=graph_level)
    return jc, tc


@pytest.fixture(scope="module")
def cases():
    """Per case: the rank case, the port's one-process output and the JAX
    forward's, and the layer count."""
    out = {}
    for name, arch, dtype, n, e, pooled in CASES:
        jc, tc = _configs(arch, dtype, pooled)
        jp = jm.init_params(jax.random.PRNGKey(0), jc)
        pnp = jax.tree.map(np.asarray, jp)
        arrays = _graph(n, e, jc.d_in, arch in ("meshgraphnet", "graphcast"),
                        pooled)
        tg = tm.GraphBatch(**{k: None if v is None else torch.tensor(v)
                              for k, v in arrays.items()},
                           n_graphs=N_GRAPHS)
        one = tm.forward(gnn_params_from_numpy(pnp, device="cpu"), tc, tg)
        jg = jm.GraphBatch(**{k: None if v is None else jnp.asarray(v)
                              for k, v in arrays.items()},
                           n_graphs=N_GRAPHS)
        want = np.asarray(jm.forward(jp, jc, jg)).astype(np.float32)
        rank_case = (name, arch, {"dtype": getattr(torch, dtype),
                                  "graph_level": pooled}, arrays, N_GRAPHS,
                     pnp)
        out[name] = (rank_case, one.float().numpy(), want, jc.n_layers)
    return out


@pytest.fixture(scope="module")
def mesh_outputs(cases):
    runs: dict = {}

    def get(world):
        if world not in runs:
            runs[world] = run_ranks(
                ranks.gnn_cases, world, [c[0] for c in cases.values()],
                MESHES[world], devices=["cpu"] * world, timeout=600)
        return runs[world]
    return get


def _bf16_ulp(scale):
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
@pytest.mark.parametrize("world", [2, 4])
def test_gnn_mesh_forward(cases, mesh_outputs, world, name):
    outs = mesh_outputs(world)
    _, one, want, layers = cases[name]
    got = outs[0][name]
    if name == "gin-odd-edges" and world == 4:
        # 162 edges split over the first axis (2) but not over 4 ranks
        assert isinstance(got, str) and "do not split" in got
        assert all(out[name] == got for out in outs)
        return
    y, split = got
    for out in outs[1:]:                 # every rank returns the same
        np.testing.assert_array_equal(out[name][0], y)
    assert y.shape == one.shape
    if "odd-nodes" in name:
        assert split is None
        np.testing.assert_array_equal(y, one)
        return
    assert split == world
    if "bf16" in name:
        for ref in (one, want):
            scale = np.abs(ref).max()
            assert np.abs(y - ref).max() <= (layers + 1) * _bf16_ulp(scale)
        return
    assert np.abs(y - one).max() <= F32_TOL * np.abs(one).max()
    assert np.abs(y - want).max() <= JAX_TOL * np.abs(want).max()
