"""graphcast [arXiv:2212.12794; unverified]: encoder-processor-decoder mesh
GNN — 16 processor layers, d_hidden=512, sum aggregator, n_vars=227 outputs,
mesh_refinement=6 (the icosahedral mesh frontend is a stub per the
assignment; the assigned graph shapes drive the processor)."""

import torch

from repro_torch.configs.registry import Cell, make_gnn_cell
from repro_torch.models.gnn import GNNConfig

SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]

MESH_REFINEMENT = 6  # recorded config constant (frontend stub)
N_VARS = 227


def _make(d_in: int, n_out: int, graph_level: bool) -> GNNConfig:
    # bf16 activations as in the real GraphCast training setup
    return GNNConfig(name="graphcast", kind="graphcast", n_layers=16,
                     d_hidden=512, d_in=d_in, n_out=n_out, aggregator="sum",
                     mlp_layers=2, graph_level=graph_level,
                     dtype=torch.bfloat16)


CONFIG = _make(d_in=1433, n_out=N_VARS, graph_level=False)
SMOKE_CONFIG = GNNConfig(name="graphcast-smoke", kind="graphcast", n_layers=2,
                         d_hidden=16, d_in=8, n_out=4, aggregator="sum")


def make_cell(shape: str) -> Cell:
    return make_gnn_cell("graphcast", _make, shape, loss_kind="node_mse",
                         n_out=N_VARS)
