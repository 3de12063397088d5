"""Architecture registry: the JAX package's ten assigned archs by id.

`get_arch(id)` returns the config module (`CONFIG`, `SMOKE_CONFIG`) of an
arch the port runs: all ten, the dense and MoE LMs, BST and the four
GNNs. The recsys and GNN shape sets (`RECSYS_SHAPES`, `GNN_SHAPES`, `pad_to`) are
copied as data, and a GNN arch's cells (`Cell`, `gnn_input_specs`,
`make_gnn_cell`) are ported: `input_specs()` gives `(shape, torch dtype)`
pairs where the JAX package gives `ShapeDtypeStruct`s. The rest of the
JAX registry's dry-run machinery (`get_cell`, `all_cells`, the LM shape
set and cells) waits for the dry-run (ROADMAP A16).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Optional

import torch

ARCH_IDS = [
    "gemma2-27b",
    "deepseek-7b",
    "h2o-danube-1.8b",
    "llama4-scout-17b-16e",
    "kimi-k2-1t-a32b",
    "gin-tu",
    "graphcast",
    "meshgraphnet",
    "graphsage-reddit",
    "bst",
]

_MODULES = {
    "gemma2-27b": "gemma2_27b",
    "deepseek-7b": "deepseek_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "llama4-scout-17b-16e": "llama4_scout_17b_16e",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "gin-tu": "gin_tu",
    "graphcast": "graphcast",
    "meshgraphnet": "meshgraphnet",
    "graphsage-reddit": "graphsage_reddit",
    "bst": "bst",
}



@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str          # lm | gnn | recsys
    step: str          # train | prefill | decode | serve | retrieval
    model_cfg: Any
    input_specs: Callable[[], dict]
    loss_kind: Optional[str] = None    # gnn only
    skip_reason: Optional[str] = None
    notes: str = ""

    @property
    def cell_id(self) -> str:
        return f"{self.arch}__{self.shape}"


# the recsys cells' shapes, as the JAX registry has them: BST's step and
# batch (serving: candidates scored; retrieval: one user's context against
# n_candidates items)
RECSYS_SHAPES = {
    "train_batch": dict(step="train", batch=65_536),
    "serve_p99": dict(step="serve", batch=512),
    "serve_bulk": dict(step="serve", batch=262_144),
    "retrieval_cand": dict(step="retrieval", batch=1, n_candidates=1_000_000),
}


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; expected one of "
                       f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


# ------------------------------------------------------ shared GNN shapes --
GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": dict(n_nodes=232_965, n_edges=114_615_892, d_feat=602,
                         batch_nodes=1024, fanout=(15, 10)),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16),
}


def pad_to(n: int, multiple: int = 512) -> int:
    """The assigned graph sizes are exact (N = 2,708, E = 61,859,140, ...);
    the JAX package pads them to a multiple of 512 for its input shardings,
    with -1 edges and masked pad nodes, which changes no result."""
    return n + (-n) % multiple


def gnn_input_specs(shape_name: str, loss_kind: str, n_out: int,
                    with_edge_feat: bool) -> Callable[[], dict]:
    """The batch a GNN cell takes, as {name: (shape, torch dtype)}."""
    spec = GNN_SHAPES[shape_name]

    def build():
        f32, i32 = torch.float32, torch.int32
        if shape_name == "molecule":
            n = spec["batch"] * spec["n_nodes"]
            e = spec["batch"] * spec["n_edges"]
            out = {
                "node_feat": ((n, spec["d_feat"]), f32),
                "edge_src": ((e,), i32),
                "edge_dst": ((e,), i32),
                "graph_ids": ((n,), i32),
                "graph_targets": ((spec["batch"],), i32),
            }
        elif shape_name == "minibatch_lg":
            from repro_torch.data.graphs import block_shapes
            out = block_shapes(spec["batch_nodes"], spec["fanout"],
                               spec["d_feat"])
            if loss_kind == "node_mse":
                n_total = out["node_feat"][0][0]
                out.pop("labels")
                out["targets"] = ((n_total, n_out), f32)
                out["node_mask"] = ((n_total,), f32)
        else:
            n, e = pad_to(spec["n_nodes"]), pad_to(spec["n_edges"])
            out = {
                "node_feat": ((n, spec["d_feat"]), f32),
                "edge_src": ((e,), i32),
                "edge_dst": ((e,), i32),
            }
            if loss_kind == "node_ce":
                out["labels"] = ((n,), i32)
            else:
                out["targets"] = ((n, n_out), f32)
                out["node_mask"] = ((n,), f32)
        if with_edge_feat:
            e = out["edge_src"][0][0]
            out["edge_feat"] = ((e, 4), f32)
        return out
    return build


def make_gnn_cell(arch: str, make_cfg, shape: str, loss_kind: str,
                  n_out: int, notes: str = "") -> Cell:
    spec = GNN_SHAPES[shape]
    graph_level = shape == "molecule"
    lk = "graph_ce" if graph_level else loss_kind
    cfg = make_cfg(d_in=spec["d_feat"], n_out=n_out, graph_level=graph_level)
    with_edge = cfg.kind in ("mgn", "graphcast")
    return Cell(arch=arch, shape=shape, kind="gnn", step="train",
                model_cfg=cfg, loss_kind=lk,
                input_specs=gnn_input_specs(shape, lk, n_out, with_edge),
                notes=notes)
