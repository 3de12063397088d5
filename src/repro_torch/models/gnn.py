"""Message-passing GNNs of the four assigned architectures, ported from the
JAX package's `models/gnn.py` with the same parameter tree (the layers as
a list, one dict a layer) and cast points:

  gin-tu            5 layers, d=64, sum aggregator, learnable eps
  graphsage-reddit  2 layers, d=128, mean aggregator (+ real neighbor sampler)
  meshgraphnet      15 layers, d=128, edge+node MLPs (2-layer), residual
  graphcast         encoder-processor(16 x d=512)-decoder, n_vars outputs

Graphs arrive as a GraphBatch of (node_feat, edge_src, edge_dst [,
edge_feat, graph_ids]); an edge whose source is -1 is padding, wherever it
sits. Every segment sum, the aggregation of each layer, the mean's count
and the graph-level pool, goes through `kernels.ops.segment_matmul` (the
hand-written `csrc/segment_matmul.cu` on the card), keyed by each edge's
destination where its source is valid and by -1 where it is not: pads and
destinations outside [0, N) fall into the kernel's overflow bin and are
never read. The kernel sums in f32 and rounds once, so in bf16 the port's
aggregate is the better rounded of the two (the JAX model sums in the
message's dtype, `jax.ops.segment_sum`). Every entry point takes `backend`
("auto" | "ref" | "kernel") and hands it down to the op.

Under a mesh context the forward splits the nodes and edges over the
ranks, as the JAX model's shard_map branch does (`forward`,
`sharded_message_pass`).

Forward only: training waits for backward kernels (ROADMAP A16). The JAX
model's `lax.scan` over stacked layers is a loop here; `remat` is kept in
the config and has no effect without a backward pass. The JAX model's
sharding constraints (`constrain`) place tensors for XLA; here the split
is explicit, so they have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch import random as trandom
from repro_torch.core.alid import resolve_device
from repro_torch.distributed.context import (all_gather, all_reduce_sum,
                                             axes_size, axis_group,
                                             axis_size, get_mesh_context,
                                             reduce_scatter)
from repro_torch.kernels import ops
from repro_torch.models import layers as L


class GraphBatch(NamedTuple):
    node_feat: torch.Tensor              # (N, d_in)
    edge_src: torch.Tensor               # (E,) int32, -1 = pad
    edge_dst: torch.Tensor               # (E,) int32, -1 = pad
    edge_feat: Optional[torch.Tensor] = None   # (E, d_edge)
    graph_ids: Optional[torch.Tensor] = None   # (N,) for batched small graphs
    n_graphs: int = 1


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                   # gin | sage | mgn | graphcast
    n_layers: int
    d_hidden: int
    d_in: int
    n_out: int
    aggregator: str = "sum"     # sum | mean
    mlp_layers: int = 2
    d_edge_in: int = 4          # raw edge features (mgn/graphcast stub:
                                # displacement)
    graph_level: bool = False   # pool to per-graph outputs (molecule shape)
    remat: bool = True          # the JAX model's per-layer checkpoint; no
                                # effect in a forward pass
    dtype: Any = torch.float32


class MeshSplit(NamedTuple):
    """A forward's split over the ranks of `group` (`mesh_split`): group
    rank `rank` of `size` holds node rows [rank*N/size, (rank+1)*N/size)
    and edges [rank*E/size, (rank+1)*E/size)."""
    group: Any
    rank: int
    size: int


def _aggregate(msg, dst, n_nodes, aggregator, valid, backend="auto",
               mesh: Optional[MeshSplit] = None):
    """Messages summed (or averaged) into their destinations: (n_nodes, d)
    in msg's dtype. An edge counts where `valid` (its source is not a pad)
    and its destination lies in [0, n_nodes); the others are keyed -1 and
    skipped by the op, never read. The mean divides by the count of such
    edges, itself a segment sum over the same keys (f32, exact up to
    2**24), with isolated nodes divided by 1.

    Under a `mesh` the edges are this rank's: their partial sums into all
    n_nodes rows (f32, the kernel's sums before it rounds) are
    sum-reduce-scattered to the ranks' node slices in f32 and rounded
    once, so this rank gets its (n_nodes / size, d) rows; the mean's
    count goes the same way."""
    key = torch.where(valid, dst, -1)
    if mesh is None:
        out = ops.segment_matmul(msg, key, n_nodes, backend=backend)
    else:
        partial = ops.segment_matmul(msg.float(), key, n_nodes,
                                     backend=backend)
        out = reduce_scatter(partial, mesh.group).to(msg.dtype)
    if aggregator == "mean":
        ones = torch.ones((key.shape[0], 1), dtype=torch.float32,
                          device=key.device)
        cnt = ops.segment_matmul(ones, key, n_nodes, backend=backend)
        if mesh is not None:
            cnt = reduce_scatter(cnt, mesh.group)
        out = out / torch.clamp(cnt, min=1.0).to(msg.dtype)
    return out


def _mesh_axes_for(n: int):
    """All mesh axes that evenly divide n (widest first), or None: the JAX
    function's rule (an axis named twice, the default engine context's
    model axis, counts once)."""
    ctx = get_mesh_context()
    if ctx is None:
        return None, None
    full = tuple(dict.fromkeys(ctx.data_axes + (ctx.model_axis,)))
    for axes in (full, ctx.data_axes):
        size = axes_size(ctx.mesh, axes)
        if n % size == 0 and size > 1:
            return ctx, axes
    return None, None


def mesh_split(n_nodes: int, n_edges: int) -> Optional[MeshSplit]:
    """The split of a forward over the mesh context's ranks, or None where
    there is no context or the shapes do not divide, as the JAX function
    decides (`_mesh_axes_for` on the nodes, then the edges over the first
    axis): every rank then runs the whole graph without a mesh. Edges that
    divide the first axis but not the whole group raise, as JAX's
    shard_map does."""
    ctx, axes = _mesh_axes_for(n_nodes)
    if ctx is None or n_edges % axis_size(ctx.mesh, axes[0]) != 0:
        return None
    group = axis_group(ctx.mesh, axes)
    size = dist.get_world_size(group)
    if n_edges % size:
        raise ValueError(f"{n_edges} edges do not split over the {size} "
                         f"ranks of mesh axes {axes}")
    return MeshSplit(group, dist.get_rank(group), size)


def sharded_message_pass(h, edge_fn, src, dst, valid, n_nodes, aggregator,
                         edge_feat=None, backend="auto",
                         mesh: Optional[MeshSplit] = None):
    """One round of message passing: edge_fn(h[src], h[dst], edge_feat) ->
    (messages, new edge state), the messages aggregated into their
    destinations. `edge_fn=None` sends h[src] and keeps the edge state (GIN
    and SAGE), and then h[dst] is never gathered: at ogb_products it would
    be another (E, d) array, 15.8 GB at GIN's width.

    Without a `mesh` this is the JAX function's branch without one. Under
    a mesh (the JAX function's shard_map branch) h holds this rank's node
    rows and src / dst / valid / edge_feat its edges, with global node ids:
      1. h is all-gathered once, in tiles in rank order (in its dtype);
      2. the gather h[src] / h[dst] and edge_fn run on the local edges;
      3. the partial segment sums (`ops.segment_matmul`) into all n_nodes
         rows are sum-reduce-scattered back to the node slices
         (`_aggregate`)."""
    if mesh is not None:
        h = all_gather(h, mesh.group)
    if edge_fn is None:
        msg, e_out = h[src], edge_feat
    else:
        msg, e_out = edge_fn(h[src], h[dst], edge_feat)
    return _aggregate(msg, dst, n_nodes, aggregator, valid, backend,
                      mesh), e_out


def _mlp_sizes(cfg: GNNConfig, d_in: int, d_out: int) -> tuple[int, ...]:
    return (d_in,) + (cfg.d_hidden,) * (cfg.mlp_layers - 1) + (d_out,)


def init_params(rng, cfg: GNNConfig, device="cuda") -> dict:
    """The JAX package's `init_params(rng, cfg)`, drawn with the port's
    threefry on `device`: the same keys, the same weights (normal draws
    within the ulps of `random.normal`); `layers` is a list of the JAX
    tree's stacked leaves, one dict a layer."""
    dev = resolve_device(device)
    d, dt = cfg.d_hidden, cfg.dtype
    ks = iter(trandom.split(rng, 4 + 4 * cfg.n_layers))

    def mlp(sizes):
        return L.mlp_init(next(ks), sizes, dt, device=dev)

    p: dict = {"encoder": mlp((cfg.d_in, d, d))}
    if cfg.kind in ("mgn", "graphcast"):
        p["edge_encoder"] = mlp((cfg.d_edge_in, d, d))
    layers = []
    for _ in range(cfg.n_layers):
        lp = {}
        if cfg.kind == "gin":
            lp["eps"] = torch.zeros((), dtype=torch.float32, device=dev)
            lp["mlp"] = mlp(_mlp_sizes(cfg, d, d))
        elif cfg.kind == "sage":
            lp["w_self"] = L.he_init(next(ks), (d, d), dt, device=dev)
            lp["w_nbr"] = L.he_init(next(ks), (d, d), dt, device=dev)
            lp["b"] = torch.zeros((d,), dtype=dt, device=dev)
        else:  # mgn / graphcast processor layer
            lp["edge_mlp"] = mlp(_mlp_sizes(cfg, 3 * d, d))
            lp["node_mlp"] = mlp(_mlp_sizes(cfg, 2 * d, d))
        layers.append(lp)
    p["layers"] = layers
    p["decoder"] = mlp((d, d, cfg.n_out))
    return p


class Edges(NamedTuple):
    """A batch's edges as every layer reads them: the gather indices (pads
    read node 0), the destinations and the validity (source not a pad)."""
    src: torch.Tensor
    dst: torch.Tensor
    valid: torch.Tensor


def edges_of(g: GraphBatch) -> Edges:
    valid = g.edge_src >= 0
    return Edges(src=torch.where(valid, g.edge_src, 0),
                 dst=torch.where(valid, g.edge_dst, 0), valid=valid)


def apply_layer(lp: dict, cfg: GNNConfig, h: torch.Tensor,
                e: Optional[torch.Tensor], edges: Edges,
                backend: str = "auto",
                mesh: Optional[MeshSplit] = None) -> tuple:
    """One message-passing layer, the body of the JAX model's scan:
    (h, e) -> (h, e). Under a `mesh`, h is this rank's node rows and
    `edges` / e its edges (`forward`)."""
    n = h.shape[0] * (mesh.size if mesh is not None else 1)
    src, dst, valid = edges
    if cfg.kind == "gin":
        agg, _ = sharded_message_pass(h, None, src, dst, valid, n, "sum",
                                      backend=backend, mesh=mesh)
        # jnp promotes the f32 scalar (1 + eps) times a bf16 h to f32, so
        # a bf16 GIN layer computes its MLP in f32 (torch would keep bf16)
        x = (1.0 + lp["eps"]) * h.float() + agg
        h = L.mlp_apply(lp["mlp"], x, act=torch.relu, final_act=True)
    elif cfg.kind == "sage":
        agg, _ = sharded_message_pass(h, None, src, dst, valid, n, "mean",
                                      backend=backend, mesh=mesh)
        h = torch.relu(L.dense(h, lp["w_self"]) + L.dense(agg, lp["w_nbr"])
                       + lp["b"])
        h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                            min=1e-6)
    else:  # mgn / graphcast
        def edge_fn(hs, hd, ef):
            e_new = ef + L.mlp_apply(lp["edge_mlp"],
                                     torch.cat([ef, hs, hd], -1))
            return e_new, e_new
        agg, e = sharded_message_pass(h, edge_fn, src, dst, valid, n,
                                      cfg.aggregator, edge_feat=e,
                                      backend=backend, mesh=mesh)
        h = h + L.mlp_apply(lp["node_mlp"], torch.cat([h, agg], -1))
    return h, e


def forward(params: dict, cfg: GNNConfig, g: GraphBatch,
            backend: str = "auto") -> torch.Tensor:
    """Node outputs (N, n_out), or per-graph outputs (n_graphs, n_out) with
    `cfg.graph_level`, in the model's dtype (f32 for a bf16 GIN, as the
    JAX promotion has it).

    Under a mesh context (`distributed.mesh_context`) whose axes divide
    the graph (`mesh_split`), every rank passes the whole graph and
    computes on its slice: its N/W node rows (the encoder, the node MLPs,
    the decoder) and its E/W edges (the gathers, edge_fn, the edge state,
    the partial sums), each layer all-gathering h and
    sum-reduce-scattering the partial sums (`sharded_message_pass`). The
    node outputs are all-gathered, so every rank returns the whole
    (N, n_out); the graph-level pool all-reduces per-graph partial sums
    (f32, rounded once). Where the shapes do not divide, every rank runs
    the whole graph without a mesh."""
    n = g.node_feat.shape[0]
    n_edges = g.edge_src.shape[0]
    mesh = mesh_split(n, n_edges)
    node_feat, gids = g.node_feat, g.graph_ids
    if mesh is not None:
        rows = slice(mesh.rank * n // mesh.size,
                     (mesh.rank + 1) * n // mesh.size)
        cut = slice(mesh.rank * n_edges // mesh.size,
                    (mesh.rank + 1) * n_edges // mesh.size)
        node_feat = node_feat[rows]
        gids = gids[rows] if gids is not None else None
        g = g._replace(edge_src=g.edge_src[cut], edge_dst=g.edge_dst[cut],
                       edge_feat=(g.edge_feat[cut] if g.edge_feat is not None
                                  else None))
    edges = edges_of(g)
    h = L.mlp_apply(params["encoder"], node_feat.to(cfg.dtype))
    e = None
    if cfg.kind in ("mgn", "graphcast"):
        ef = g.edge_feat if g.edge_feat is not None else torch.zeros(
            (g.edge_src.shape[0], cfg.d_edge_in), dtype=cfg.dtype,
            device=h.device)
        e = L.mlp_apply(params["edge_encoder"], ef.to(cfg.dtype))
    for lp in params["layers"]:
        h, e = apply_layer(lp, cfg, h, e, edges, backend, mesh)
    out = L.mlp_apply(params["decoder"], h)
    if cfg.graph_level:
        if gids is None:
            gids = torch.zeros((out.shape[0],), dtype=torch.int32,
                               device=out.device)
        if mesh is None:
            return ops.segment_matmul(out, gids, g.n_graphs, backend=backend)
        partial = ops.segment_matmul(out.float(), gids, g.n_graphs,
                                     backend=backend)
        return all_reduce_sum(partial, mesh.group).to(out.dtype)
    return out if mesh is None else all_gather(out, mesh.group)
