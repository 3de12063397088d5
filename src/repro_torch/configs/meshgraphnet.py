"""meshgraphnet [arXiv:2010.03409; unverified]: 15 message-passing layers,
d_hidden=128, sum aggregator, 2-layer edge/node MLPs, residual."""

import torch

from repro_torch.configs.registry import Cell, make_gnn_cell
from repro_torch.models.gnn import GNNConfig

SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def _make(d_in: int, n_out: int, graph_level: bool) -> GNNConfig:
    return GNNConfig(name="meshgraphnet", kind="mgn", n_layers=15,
                     d_hidden=128, d_in=d_in, n_out=n_out, aggregator="sum",
                     mlp_layers=2, graph_level=graph_level,
                     dtype=torch.bfloat16)


CONFIG = _make(d_in=1433, n_out=3, graph_level=False)
SMOKE_CONFIG = GNNConfig(name="mgn-smoke", kind="mgn", n_layers=2,
                         d_hidden=16, d_in=8, n_out=3, aggregator="sum")


def make_cell(shape: str) -> Cell:
    return make_gnn_cell("meshgraphnet", _make, shape, loss_kind="node_mse",
                         n_out=3)
