"""gin-tu [arXiv:1810.00826; paper]: GIN, 5 layers, d_hidden=64,
sum aggregator, learnable eps."""

from repro_torch.configs.registry import Cell, make_gnn_cell
from repro_torch.models.gnn import GNNConfig

SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def _make(d_in: int, n_out: int, graph_level: bool) -> GNNConfig:
    return GNNConfig(name="gin-tu", kind="gin", n_layers=5, d_hidden=64,
                     d_in=d_in, n_out=n_out, aggregator="sum",
                     mlp_layers=2, graph_level=graph_level)


CONFIG = _make(d_in=1433, n_out=2, graph_level=False)
SMOKE_CONFIG = GNNConfig(name="gin-smoke", kind="gin", n_layers=2, d_hidden=16,
                         d_in=8, n_out=2, aggregator="sum")


def make_cell(shape: str) -> Cell:
    return make_gnn_cell("gin-tu", _make, shape, loss_kind="node_ce", n_out=2)
