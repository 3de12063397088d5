"""Rank bodies of the port's multi-device tests (tests/test_torch_mesh.py,
test_torch_gnn_mesh.py, test_torch_distributed.py, test_torch_moe.py):
module-level
functions, so that `distributed.spawn.run_ranks` can start them in fresh
gloo processes. This module imports no JAX: the JAX side of each test is
computed in the test process."""

from __future__ import annotations

import dataclasses
import warnings
from unittest import mock

import torch
import torch.distributed as dist

from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.core.engine import fit, make_engine
from repro_torch.core import store as store_mod
from repro_torch.core.palid import detect_clusters_parallel
from repro_torch.core.source import as_source
from repro_torch.distributed import context as C
from repro_torch.distributed.shardings import P, placements
from repro_torch.launch.mesh import (data_context, make_context,
                                     make_small_context, model_context)
from repro_torch.models import gnn as tm
from repro_torch.models import moe as moe_m


def fit_cases(rank, world, cases, ckpt_root=None):
    """Each case (name, kind, points, cfg): "fit" = `fit` on the mesh
    engine cfg names; "store" = the same with the engine kept, returning
    (result, shards held, slot shards, payload bytes); "shim" =
    `detect_clusters_parallel` twice (without and with k=), returning the
    two results and the warnings' texts; "resume" = a crash at round 2,
    then a resume from the checkpoints (rank 0 writes them), returning the
    resumed result and the checkpoint steps each rank saw."""
    out = {}
    for name, kind, points, cfg in cases:
        if kind == "fit":
            out[name] = fit(points, cfg, trandom.PRNGKey(0), device="cpu")
        elif kind == "store":
            engine = make_engine(cfg.spec, device="cpu")
            # the split store is built without the whole store anywhere
            with mock.patch.object(store_mod, "_build_store_impl",
                                   side_effect=AssertionError(
                                       "built the whole store")):
                res = fit(points, cfg, trandom.PRNGKey(0), engine=engine,
                          device="cpu")
            st = engine.store
            # and with build_store's bits, shard for shard
            own = store_mod.build_mesh_store(
                as_source(points), cfg.lsh, trandom.PRNGKey(3),
                cfg.spec.n_shards, engine.group, device="cpu",
                chunk_size=7)
            parts = {k: getattr(own, k).numpy() for k in (
                "shards", "valid", "global_idx", "perm", "sorted_keys",
                "shard_of", "slot_of", "centers", "radii", "bucket_sizes")}
            out[name] = (res, st.shards.shape[0], st._slot[0].shape,
                         st.payload_bytes(), parts)
            engine.close()
        elif kind == "shim":
            ctx = data_context("cpu")
            with warnings.catch_warnings(record=True) as w1:
                warnings.simplefilter("always")
                a = detect_clusters_parallel(points, cfg,
                                             trandom.PRNGKey(0), ctx,
                                             device="cpu")
            with warnings.catch_warnings(record=True) as w2:
                warnings.simplefilter("always")
                b = detect_clusters_parallel(points, cfg,
                                             trandom.PRNGKey(0), ctx,
                                             k=a.k, device="cpu")
            texts = [[str(x.message) for x in w
                      if issubclass(x.category, DeprecationWarning)]
                     for w in (w1, w2)]
            out[name] = (a, b, texts)
        elif kind == "resume":
            from repro_torch.checkpoint.manager import list_checkpoints
            ckpt = f"{ckpt_root}/{name}"
            try:
                fit(points, cfg, trandom.PRNGKey(0), checkpoint_dir=ckpt,
                    crash_at_round=2, device="cpu")
            except RuntimeError as exc:
                assert "injected crash" in str(exc), exc
            steps = list_checkpoints(ckpt)
            res = fit(points, cfg, trandom.PRNGKey(0), checkpoint_dir=ckpt,
                      resume=True, device="cpu")
            out[name] = (res, steps)
        else:
            raise ValueError(kind)
    return out


def gnn_cases(rank, world, cases, mesh_shape):
    """Each case (name, arch, config changes, graph arrays, n_graphs,
    params as numpy): the port's forward under a mesh context of
    `mesh_shape` ((n_data,) or (n_data, n_model)); returns the outputs as
    f32 numpy (the same on every rank), or the error text where the
    forward raises, and this rank's segment_matmul partial sizes."""
    ctx = (data_context("cpu") if len(mesh_shape) == 1
           else make_small_context(*mesh_shape, device_type="cpu"))
    out = {}
    with C.mesh_context(ctx):
        for name, arch, changes, arrays, n_graphs, params_np in cases:
            cfg = dataclasses.replace(get_arch(arch).SMOKE_CONFIG,
                                      **changes)
            params = gnn_params_from_numpy(params_np, device="cpu")
            g = tm.GraphBatch(**{k: None if v is None else torch.tensor(v)
                                 for k, v in arrays.items()},
                              n_graphs=n_graphs)
            try:
                split = tm.mesh_split(g.node_feat.shape[0],
                                      g.edge_src.shape[0])
                y = tm.forward(params, cfg, g)
            except ValueError as exc:
                out[name] = str(exc)
                continue
            out[name] = (y.float().numpy(),
                         None if split is None else split.size)
    return out


def collective_cases(rank, world):
    """The collectives on CPU tensors, the context helpers and the mesh
    builders at this world size."""
    g = dist.group.WORLD
    out: dict = {"rank": rank}
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * rank
    out["all_gather"] = C.all_gather(x, g).numpy()
    mask = torch.tensor([rank == 0, rank == world - 1, False])
    out["all_gather_bool"] = C.all_gather(mask, g).numpy()
    out["max"] = C.all_reduce_max(mask, g).numpy()
    full = torch.arange(2 * world * 3, dtype=torch.float32).reshape(
        2 * world, 3) * (rank + 1)
    out["reduce_scatter"] = C.reduce_scatter(full, g).numpy()
    out["all_reduce_sum"] = C.all_reduce_sum(x, g).numpy()
    t = torch.full((4,), float(rank), dtype=torch.float64)
    out["broadcast"] = C.broadcast(t, world - 1, g).numpy()
    out["stats"] = C.collective_stats()
    with C.timed_collectives():
        C.all_gather(x, g)
    out["stats_timed"] = C.collective_stats()
    ctx = data_context("cpu")
    out["data_context"] = (ctx.n_data, ctx.n_model, ctx.data_axes,
                           ctx.model_axis)
    with C.mesh_context(ctx):
        out["axes_in_ctx"] = (C.data_axes(), C.model_axis(),
                              C.get_mesh_context() is ctx)
    out["axes_after"] = (C.data_axes(), C.model_axis(),
                         C.get_mesh_context())
    nm = 2 if world == 4 else 1
    small = make_small_context(world // nm, nm, device_type="cpu")
    ranks_of = dist.get_process_group_ranks
    out["small"] = (small.n_data, small.n_model,
                    ranks_of(small.mesh.get_group("data")),
                    ranks_of(small.mesh.get_group("model")),
                    ranks_of(C.axis_group(small.mesh, ("data", "model"))))
    out["small_sum"] = C.all_reduce_sum(
        torch.tensor([float(rank)]),
        C.axis_group(small.mesh, "data")).numpy()
    out["placements"] = [repr(placements(s, small)) for s in (
        P("data", None), P(None, "model"), P(("data", "model"), None),
        P())]
    pod = make_context(multi_pod=True, device_type="cpu")
    out["pod"] = (tuple(pod.mesh.mesh_dim_names),
                  tuple(pod.mesh.mesh.shape), pod.data_axes, pod.n_data,
                  pod.n_model, pod.fsdp)
    prod = make_context(n_model=nm, fsdp=False, device_type="cpu")
    out["prod"] = (tuple(prod.mesh.mesh_dim_names),
                   tuple(prod.mesh.mesh.shape), prod.n_data, prod.n_model,
                   prod.fsdp)
    return out


def moe_cases(rank, world, cases, mesh_shape):
    """Each case (name, MoEConfig fields, params, x (B, S, D), share): the
    port's `moe_apply` under a mesh context of `mesh_shape` ((m,) over
    ("model",), or (n_data, n_model)); with `share` the rank holds only its
    model rank's E/m experts. Returns per case (out f32 numpy, aux,
    all_to_all stats), the same on every rank, or the error text where
    the call raises."""
    ctx = (model_context("cpu") if len(mesh_shape) == 1
           else make_small_context(*mesh_shape, device_type="cpu"))
    m = ctx.n_model
    mr = dist.get_rank(C.axis_group(ctx.mesh, ctx.model_axis))
    out = {}
    with C.mesh_context(ctx):
        for name, fields, params, x, share in cases:
            cfg = moe_m.MoEConfig(**fields)
            if share:
                per = cfg.n_experts // m
                params = {k: (v[mr * per:(mr + 1) * per].clone()
                              if k in moe_m.EXPERT_LEAVES else v)
                          for k, v in params.items()}
            C.reset_collective_stats()
            try:
                y, aux = moe_m.moe_apply(params, cfg, x)
            except ValueError as exc:
                out[name] = str(exc)
                continue
            out[name] = (y.float().numpy(), float(aux),
                         C.collective_stats().get("all_to_all"))
    return out
