"""graphsage-reddit [arXiv:1706.02216; paper]: 2 layers, d_hidden=128, mean
aggregator, sample sizes 25-10 (the assigned minibatch shape samples 15-10).
Reddit: 41 classes."""

from repro_torch.configs.registry import Cell, make_gnn_cell
from repro_torch.models.gnn import GNNConfig

SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]

SAMPLE_SIZES = (25, 10)   # arch's own config; shapes may override fanout
N_CLASSES = 41


def _make(d_in: int, n_out: int, graph_level: bool) -> GNNConfig:
    return GNNConfig(name="graphsage-reddit", kind="sage", n_layers=2,
                     d_hidden=128, d_in=d_in, n_out=n_out, aggregator="mean",
                     mlp_layers=2, graph_level=graph_level)


CONFIG = _make(d_in=602, n_out=N_CLASSES, graph_level=False)
SMOKE_CONFIG = GNNConfig(name="sage-smoke", kind="sage", n_layers=2,
                         d_hidden=16, d_in=8, n_out=5, aggregator="mean")


def make_cell(shape: str) -> Cell:
    return make_gnn_cell("graphsage-reddit", _make, shape,
                         loss_kind="node_ce", n_out=N_CLASSES)
