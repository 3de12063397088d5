"""Graph substrate, a port of the JAX package's `data/graphs.py`: synthetic
graphs with mild degree skew and community structure, CSR utilities, a
uniform neighbour sampler with GraphSAGE's fanout semantics, and batched
small graphs (molecules). Every sampler is a pure function of (seed, step),
drawn with the port's threefry, so that it gives the JAX package's
integers (equal) and normal draws (within the ulps of `random.normal`).

`synth_graph` draws its edges with numpy's `default_rng`, as the JAX
package does, so that they are the JAX package's bit for bit; the ordering
by source and the degree count then run on `device` (a stable sort has one
result, and at ogb_products' 61.9M edges the card sorts in milliseconds
what numpy's stable argsort takes tens of seconds for). Outputs are tensors
on `device`, default the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core.alid import resolve_device


class CSRGraph(NamedTuple):
    indptr: torch.Tensor    # (N+1,) int32
    indices: torch.Tensor   # (E,) int32 neighbour ids
    n_nodes: int
    n_edges: int


def synth_graph(n_nodes: int, n_edges: int, seed: int = 0,
                clustered: bool = True, device="cuda") -> CSRGraph:
    """Synthetic graph with mild degree skew + community structure; edges
    drawn on the host (numpy, deterministic), sorted by source (stable) on
    `device`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if clustered:
        n_comm = max(4, n_nodes // 1000)
        rng.integers(0, n_comm, size=n_nodes)     # the communities' draw
        src = rng.integers(0, n_nodes, size=n_edges).astype(np.int64)
        intra = rng.random(n_edges) < 0.7
        dst = np.where(
            intra,
            # rewire to a random node of the same community (approximate:
            # jump within a hashed bucket ordering)
            (src + rng.integers(1, 50, size=n_edges) * 31) % n_nodes,
            rng.integers(0, n_nodes, size=n_edges),
        ).astype(np.int64)
    else:
        src = rng.integers(0, n_nodes, size=n_edges).astype(np.int64)
        dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int64)
    src_t = torch.from_numpy(src).to(dev)
    order = torch.sort(src_t, stable=True).indices
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(src_t, minlength=n_nodes), 0)
    del src_t
    indices = torch.from_numpy(dst).to(dev)[order].to(torch.int32)
    return CSRGraph(indptr=indptr.to(torch.int32), indices=indices,
                    n_nodes=n_nodes, n_edges=n_edges)


def sample_neighbors(g: CSRGraph, seeds: torch.Tensor, fanout: int,
                     rng: torch.Tensor) -> torch.Tensor:
    """Uniform with-replacement neighbour sampling (GraphSAGE semantics when
    degree > fanout). seeds:(S,) -> (S, fanout) int32 neighbour ids;
    isolated nodes self-loop."""
    dev = g.indices.device
    seeds = seeds.to(torch.int64)
    start = g.indptr[seeds].to(torch.int64)
    deg = g.indptr[seeds + 1].to(torch.int64) - start
    u = trandom.uniform(rng, (seeds.shape[0], fanout), device=dev)
    # jnp promotes the int32 degree to f32 for the product
    offs = torch.floor(u * deg.clamp(min=1).to(torch.float32)[:, None])
    idx = torch.clamp(start[:, None] + offs.to(torch.int32),
                      max=g.n_edges - 1)
    nbrs = g.indices[idx]
    return torch.where(deg[:, None] > 0, nbrs,
                       seeds[:, None].to(torch.int32))


def sample_block(g: CSRGraph, feats: torch.Tensor, labels: torch.Tensor,
                 batch_nodes: int, fanouts: tuple[int, ...], seed: int,
                 step: int) -> dict:
    """Layered GraphSAGE block: seeds -> fanout[0] -> fanout[1] ... Builds a
    flat graph batch whose edges point child->parent, so one forward pass
    over the block aggregates exactly like layered sampling. Stateless in
    (seed, step); on the graph's device."""
    dev = g.indices.device
    rng = trandom.fold_in(trandom.PRNGKey(seed), step)
    k_seed, *k_layers = trandom.split(rng, 1 + len(fanouts))
    seeds = trandom.randint(k_seed, (batch_nodes,), 0, g.n_nodes,
                            dev).to(torch.int32)

    node_list = [seeds]
    edge_src, edge_dst = [], []
    offset = 0
    frontier = seeds
    for li, f in enumerate(fanouts):
        nbrs = sample_neighbors(g, frontier, f, k_layers[li])   # (F, f)
        flat = nbrs.reshape(-1)
        child_offset = offset + frontier.shape[0]
        edge_src.append(child_offset + torch.arange(
            flat.shape[0], dtype=torch.int32, device=dev))
        edge_dst.append(offset + torch.repeat_interleave(
            torch.arange(frontier.shape[0], dtype=torch.int32, device=dev),
            f))
        node_list.append(flat)
        offset = child_offset
        frontier = flat

    nodes = torch.cat(node_list).to(torch.int64)    # block-local -> global
    first = torch.arange(nodes.shape[0], device=dev) < batch_nodes
    return {
        "node_feat": feats[nodes],
        "edge_src": torch.cat(edge_src),
        "edge_dst": torch.cat(edge_dst),
        "labels": torch.where(first, labels[nodes], -1),
    }


def block_shapes(batch_nodes: int, fanouts: tuple[int, ...], d_feat: int):
    """Static shapes of sample_block's outputs, as (shape, torch dtype)."""
    total_nodes = batch_nodes
    n_edges = 0
    frontier = batch_nodes
    for f in fanouts:
        n_edges += frontier * f
        frontier = frontier * f
        total_nodes += frontier
    return {
        "node_feat": ((total_nodes, d_feat), torch.float32),
        "edge_src": ((n_edges,), torch.int32),
        "edge_dst": ((n_edges,), torch.int32),
        "labels": ((total_nodes,), torch.int32),
    }


def molecule_batch(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                   n_classes: int, seed: int, step: int,
                   device="cuda") -> dict:
    """Batched small graphs flattened block-diagonally, on `device`."""
    dev = resolve_device(device)
    rng = trandom.fold_in(trandom.PRNGKey(seed), step)
    k1, k2, k3, k4 = trandom.split(rng, 4)
    feats = trandom.normal(k1, (batch * n_nodes, d_feat), dev)
    src = trandom.randint(k2, (batch, n_edges), 0, n_nodes, dev)
    dst = trandom.randint(k3, (batch, n_edges), 0, n_nodes, dev)
    offs = (torch.arange(batch, device=dev) * n_nodes)[:, None]
    tgt = trandom.randint(k4, (batch,), 0, n_classes, dev)
    return {
        "node_feat": feats,
        "edge_src": (src + offs).reshape(-1).to(torch.int32),
        "edge_dst": (dst + offs).reshape(-1).to(torch.int32),
        "graph_ids": torch.repeat_interleave(
            torch.arange(batch, dtype=torch.int32, device=dev), n_nodes),
        "graph_targets": tgt.to(torch.int32),
    }


def synth_full_graph_batch(n_nodes: int, n_edges: int, d_feat: int,
                           out_kind: str, n_out: int, seed: int,
                           with_edge_feat: bool = False,
                           pad_multiple: int = 512, device="cuda") -> dict:
    """Full-batch graph inputs (node CE or node MSE), padded to the sizes
    the registry's input specs declare (-1 edges, masked pad nodes), on
    `device`."""
    dev = resolve_device(device)
    n_pad = n_nodes + (-n_nodes) % pad_multiple
    e_pad = n_edges + (-n_edges) % pad_multiple
    g = synth_graph(n_nodes, n_edges, seed, device=dev)
    k1, k2 = trandom.split(trandom.PRNGKey(seed + 1))
    src = torch.repeat_interleave(
        torch.arange(n_nodes, dtype=torch.int32, device=dev),
        torch.diff(g.indptr).to(torch.int64))
    pad_e = torch.full((e_pad - n_edges,), -1, dtype=torch.int32, device=dev)
    feats = torch.zeros((n_pad, d_feat), dtype=torch.float32, device=dev)
    feats[:n_nodes] = trandom.normal(k1, (n_nodes, d_feat), dev)
    batch = {
        "node_feat": feats,
        "edge_src": torch.cat([src, pad_e]),
        "edge_dst": torch.cat([g.indices, pad_e]),
    }
    del g, src
    if with_edge_feat:
        ef = torch.zeros((e_pad, 4), dtype=torch.float32, device=dev)
        ef[:n_edges] = trandom.normal(trandom.fold_in(k1, 7), (n_edges, 4),
                                      dev)
        batch["edge_feat"] = ef
    if out_kind == "node_ce":
        labels = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
        labels[:n_nodes] = trandom.randint(k2, (n_nodes,), 0, n_out, dev)
        batch["labels"] = labels
    else:
        tgt = torch.zeros((n_pad, n_out), dtype=torch.float32, device=dev)
        tgt[:n_nodes] = trandom.normal(k2, (n_nodes, n_out), dev)
        batch["targets"] = tgt
        batch["node_mask"] = (torch.arange(n_pad, device=dev)
                              < n_nodes).to(torch.float32)
    return batch
