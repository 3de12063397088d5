"""The port's `distributed` package and `launch/mesh.py` against the JAX
package's: the sharding rules (`logical_spec`, `degrade_spec`,
`zero_shard_spec`, `store_specs`, `lm_param_specs`, `gnn_param_specs`,
`bst_param_specs`, `opt_state_specs`) entry for entry on JAX-shaped
abstract trees over (4, 2) and (2, 4) meshes and with no context, and
`placements`; then the collectives, the context helpers and the mesh
builders in spawned gloo ranks (W = 2 and 4) against numpy.

The JAX rules run against a `jax.sharding.AbstractMesh` of the wanted
shape; the port's against a `DeviceMesh` built without process groups
(`_init_backend=False`): the rules read only the axes' names and sizes."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as JP
from torch.distributed.device_mesh import DeviceMesh

import torch_mesh_ranks as ranks
from repro.configs import get_arch as jax_arch
from repro.core.store import build_store as jbuild_store
from repro.distributed import context as jctx
from repro.distributed import shardings as jshd
from repro.lsh.pstable import LSHParams as JLSHParams
from repro.models import bst as jbst
from repro.models import gnn as jgnn
from repro.models import transformer as jlm
from repro.train.optimizers import OptConfig, init_opt_state
from repro_torch import random as trandom
from repro_torch.core.store import build_store
from repro_torch.distributed import context as tctx
from repro_torch.distributed import shardings as tshd
from repro_torch.distributed.spawn import run_ranks
from repro_torch.lsh.pstable import LSHParams

MESHES = [None, (4, 2), (2, 4)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _contexts(shape, fsdp=True):
    """(JAX context, port context) over a mesh of `shape`, or (None,
    None)."""
    if shape is None:
        return None, None
    names = ("data", "model")
    jmesh = AbstractMesh(shape, names)
    tmesh = DeviceMesh("cpu", torch.arange(np.prod(shape)).reshape(shape),
                       mesh_dim_names=names, _init_backend=False, _rank=0)
    return (jctx.MeshContext(mesh=jmesh, fsdp=fsdp),
            tctx.MeshContext(mesh=tmesh, fsdp=fsdp))


def _both(shape, jfn, tfn, fsdp=True):
    jc, tc = _contexts(shape, fsdp)
    with jctx.mesh_context(jc):
        want = jfn()
    with tctx.mesh_context(tc):
        got = tfn()
    return want, got


def _port_tree(tree):
    """A JAX abstract tree as the port's: dicts and lists kept, each leaf
    a `shardings.Leaf` of its shape."""
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_port_tree(v) for v in tree)
    return tshd.Leaf(tuple(tree.shape), str(tree.dtype))


def _same_specs(want, got):
    jl = jax.tree.leaves(want, is_leaf=lambda s: isinstance(s, JP))
    tl = tshd.tree_leaves(got, is_leaf=lambda s: isinstance(
        s, tshd.PartitionSpec))
    assert len(jl) == len(tl) > 0
    for j, t in zip(jl, tl):
        assert isinstance(t, tshd.PartitionSpec)
        assert tuple(t) == tuple(j), (t, j)


@pytest.mark.parametrize("shape", MESHES)
def test_logical_and_degrade_specs(shape):
    axes = ["batch", "tokens", "seeds", "kv_seq", "bags", "shards", "edges",
            "nodes", "candidates", "heads", "kv_heads", "mlp", "vocab",
            "expert", "model", "embed", "seq", "none", None]
    want, got = _both(shape, lambda: jshd.logical_spec(*axes),
                      lambda: tshd.logical_spec(*axes))
    assert tuple(got) == tuple(want)
    # shapes that divide, that divide only the first axis, and none
    for spec_axes, dims in [(("edges", None), (64, 3)),
                            (("edges", None), (6, 3)),
                            (("edges", "heads"), (3, 5)),
                            (("batch", "mlp", None), (8, 12, 7)),
                            (("batch",), (5, 4))]:
        want, got = _both(
            shape,
            lambda: jshd.degrade_spec(jshd.logical_spec(*spec_axes), dims),
            lambda: tshd.degrade_spec(tshd.logical_spec(*spec_axes), dims))
        assert tuple(got) == tuple(want), (spec_axes, dims)
    with pytest.raises(ValueError, match="unknown logical axis"):
        with tctx.mesh_context(_contexts((2, 4))[1]):
            tshd.logical_spec("nope")


@pytest.mark.parametrize("shape", MESHES)
def test_zero_shard_spec(shape):
    for spec, dims in [((None, None), (64, 128)), ((None, "model"), (6, 8)),
                       (("data", None), (8, 8)), ((None,), (7,)),
                       ((None, None, None), (3, 16, 16))]:
        want, got = _both(shape,
                          lambda: jshd.zero_shard_spec(JP(*spec), dims),
                          lambda: tshd.zero_shard_spec(tshd.P(*spec), dims))
        assert tuple(got) == tuple(want), (spec, dims)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ["gemma2-27b", "kimi-k2-1t-a32b",
                                  "h2o-danube-1.8b"])
@pytest.mark.parametrize("fsdp", [True, False])
def test_lm_param_specs(arch, shape, fsdp):
    cfg = jax_arch(arch).CONFIG
    abstract = jlm.abstract_params(cfg)
    want, got = _both(shape, lambda: jshd.lm_param_specs(abstract, cfg),
                      lambda: tshd.lm_param_specs(_port_tree(abstract), cfg),
                      fsdp)
    _same_specs(want, got)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_opt_state_specs(shape, kind):
    cfg = jax_arch("h2o-danube-1.8b").CONFIG
    abstract = jlm.abstract_params(cfg)
    opt = jax.eval_shape(functools.partial(init_opt_state,
                                           OptConfig(kind=kind)), abstract)

    def jfn():
        return jshd.opt_state_specs(jshd.lm_param_specs(abstract, cfg),
                                    abstract, opt)

    def tfn():
        tabs = _port_tree(abstract)
        return tshd.opt_state_specs(tshd.lm_param_specs(tabs, cfg), tabs,
                                    {"leaves": _port_tree(opt["leaves"])})
    want, got = _both(shape, jfn, tfn)
    assert tuple(got["step"]) == tuple(want["step"]) == ()
    _same_specs(want["leaves"], got["leaves"])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("model", ["bst", "gin-tu", "graphcast"])
def test_bst_and_gnn_param_specs(model, shape):
    if model == "bst":
        abstract = jbst.abstract_params(jax_arch("bst").CONFIG)
        jfn, tfn = jshd.bst_param_specs, tshd.bst_param_specs
    else:
        abstract = jgnn.abstract_params(jax_arch(model).CONFIG)
        jfn, tfn = jshd.gnn_param_specs, tshd.gnn_param_specs
    want, got = _both(shape, lambda: jfn(abstract),
                      lambda: tfn(_port_tree(abstract)))
    _same_specs(want, got)
    if model == "bst" and shape is not None:
        assert any(tuple(s) == ("model", None)
                   for s in tshd.tree_leaves(got, is_leaf=lambda s:
                                             isinstance(s, tshd.P)))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("n_shards", [8, 6])
def test_store_specs(shape, n_shards):
    """A ShardedStore's specs: S = 8 divides both meshes' data axes, S = 6
    only (2, 4)'s, so degrade_spec replicates the payload on (4, 2)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 6)).astype(np.float32)
    lsh = (4, 4, 1.0, 16)
    jstore = jbuild_store(jax.numpy.asarray(pts), JLSHParams(*lsh),
                          jax.random.PRNGKey(1), n_shards=n_shards,
                          backend="ref")
    tstore = build_store(torch.tensor(pts), LSHParams(*lsh),
                         trandom.PRNGKey(1), n_shards=n_shards)
    want, got = _both(shape, lambda: jshd.store_specs(jstore),
                      lambda: tshd.store_specs(tstore))
    assert type(got) is type(tstore)
    _same_specs(want, got)


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    _, tc = _contexts((4, 2))
    assert tshd.placements(tshd.P("data", None), tc) == (Shard(0),
                                                         Replicate())
    assert tshd.placements(tshd.P(None, "model"), tc) == (Replicate(),
                                                          Shard(1))
    assert tshd.placements(tshd.P(("data", "model"), None), tc) == (
        Shard(0), Shard(0))
    assert tshd.placements(tshd.P(), tc) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="not in the mesh"):
        tshd.placements(tshd.P("pod"), tc)
    with pytest.raises(ValueError, match="two tensor dims"):
        tshd.placements(tshd.P("data", "data"), tc)


def test_context_without_mesh():
    assert tctx.get_mesh_context() is None
    assert tctx.data_axes() is None and tctx.model_axis() is None
    _, tc = _contexts((2, 4), fsdp=False)
    assert (tc.n_data, tc.n_model, tc.fsdp) == (2, 4, False)
    with tctx.mesh_context(tc):
        assert tctx.get_mesh_context() is tc
        assert tctx.data_axes() == ("data",)
        assert tctx.model_axis() == "model"
    assert tctx.get_mesh_context() is None
    with pytest.raises(dataclasses.FrozenInstanceError):
        tc.fsdp = True


# ------------------------------------------------ collectives in ranks ----
@pytest.fixture(scope="module", params=[2, 4])
def collectives(request):
    world = request.param
    return world, run_ranks(ranks.collective_cases, world,
                            devices=["cpu"] * world, timeout=300)


CASES = ["all_gather", "all_gather_bool", "max", "reduce_scatter",
         "all_reduce_sum", "broadcast", "stats", "contexts", "meshes"]


@pytest.mark.parametrize("case", CASES)
def test_collectives_in_ranks(collectives, case):
    world, outs = collectives
    x = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r
         for r in range(world)]
    masks = [np.array([r == 0, r == world - 1, False]) for r in range(world)]
    for r, out in enumerate(outs):
        assert out["rank"] == r
        if case == "all_gather":
            np.testing.assert_array_equal(out["all_gather"],
                                          np.concatenate(x))
        elif case == "all_gather_bool":
            assert out["all_gather_bool"].dtype == bool
            np.testing.assert_array_equal(out["all_gather_bool"],
                                          np.concatenate(masks))
        elif case == "max":
            np.testing.assert_array_equal(out["max"], [True, True, False])
        elif case == "reduce_scatter":
            full = np.arange(2 * world * 3, dtype=np.float32).reshape(
                2 * world, 3) * sum(range(1, world + 1))
            np.testing.assert_array_equal(out["reduce_scatter"],
                                          full[2 * r:2 * r + 2])
        elif case == "all_reduce_sum":
            np.testing.assert_array_equal(out["all_reduce_sum"], sum(x))
        elif case == "broadcast":
            np.testing.assert_array_equal(out["broadcast"],
                                          np.full(4, world - 1.0))
        elif case == "stats":
            st = out["stats"]
            assert st["all_gather"]["calls"] == 2
            assert st["all_gather"]["bytes"] == 6 * 4 + 3
            assert st["broadcast"]["bytes"] == (32 if r == world - 1 else 0)
            assert st["reduce_scatter"]["bytes"] == 2 * world * 3 * 4
            # seconds only under the profiling switch: the main path
            # makes no device synchronisation for them
            assert all(v["seconds"] == 0.0 for v in st.values())
            timed = out["stats_timed"]
            assert timed["all_gather"]["calls"] == 3
            assert timed["all_gather"]["seconds"] > 0.0
            assert timed["broadcast"] == st["broadcast"]
        elif case == "contexts":
            assert out["data_context"] == (world, world, ("data",), "data")
            assert out["axes_in_ctx"] == (("data",), "data", True)
            assert out["axes_after"] == (None, None, None)
        else:                                              # meshes
            nm = 2 if world == 4 else 1
            nd = world // nm
            n_data, n_model, data_g, model_g, both = out["small"]
            assert (n_data, n_model) == (nd, nm)
            assert data_g == list(range(r % nm, world, nm))
            assert model_g == list(range(r // nm * nm, r // nm * nm + nm))
            assert both == list(range(world))
            np.testing.assert_array_equal(out["small_sum"],
                                          [float(sum(data_g))])
            assert out["placements"] == [
                "(Shard(dim=0), Replicate())", "(Replicate(), Shard(dim=1))",
                "(Shard(dim=0), Shard(dim=0))", "(Replicate(), Replicate())"]
            assert out["pod"] == (("pod", "data", "model"),
                                  (2, world // 2, 1), ("pod", "data"),
                                  world, 1, True)
            assert out["prod"] == (("data", "model"), (nd, nm), nd, nm,
                                   False)


def test_run_ranks_puts_a_rank_on_each_card(monkeypatch):
    """run_ranks defaults to card r for rank r (NCCL): more ranks than
    cards is refused, naming the count, before any rank starts; the CPU
    (gloo) is asked for by name; the launcher sets no deadline of its own
    unless asked."""
    import inspect

    from repro_torch.distributed import spawn
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="this host has 1"):
        run_ranks(ranks.collective_cases, 2)
    assert spawn.rank_devices("cuda", 1) == ["cuda:0"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert spawn.rank_devices("cuda", 3) == ["cuda:0", "cuda:1", "cuda:2"]
    assert spawn.rank_devices("cpu", 3) == ["cpu"] * 3
    assert inspect.signature(run_ranks).parameters["timeout"].default is None
