"""ALID on GNN node embeddings, on the PyTorch port: an untrained GraphSAGE
embeds a synthetic community graph (its aggregations through the
segment-sum kernel), then ALID finds the dominant communities from the
embeddings. The twin of `examples/gnn_cluster.py`, on the same graph,
config and keys.

    PYTHONPATH=src python examples/torch_gnn_cluster.py   # the card
    PYTHONPATH=src python examples/torch_gnn_cluster.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core.alid import ALIDConfig
from repro_torch.core.engine import fit
from repro_torch.data import auto_lsh_params
from repro_torch.models import gnn as gnn_m
from repro_torch.random import PRNGKey
from repro_torch.utils import avg_f1_score


def community_graph(n_comm=6, size=60, d_feat=16, p_intra=0.05, seed=0):
    rng = np.random.default_rng(seed)
    n = n_comm * size
    comm = np.repeat(np.arange(n_comm), size)
    src, dst = [], []
    for c in range(n_comm):
        nodes = np.where(comm == c)[0]
        n_edges = int(p_intra * size * size)
        src.append(rng.choice(nodes, n_edges))
        dst.append(rng.choice(nodes, n_edges))
    # sprinkle of inter-community noise edges
    src.append(rng.integers(0, n, n // 2))
    dst.append(rng.integers(0, n, n // 2))
    feats = rng.normal(size=(n, d_feat)).astype(np.float32)
    feats += comm[:, None] * 0.5  # weak community signal in features
    return (feats, np.concatenate(src).astype(np.int32),
            np.concatenate(dst).astype(np.int32), comm.astype(np.int32))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model and the fit run (default: the "
                         "card; 'cpu' runs the plain PyTorch versions)")
    args = ap.parse_args(argv)

    feats, src, dst, comm = community_graph()
    cfg = gnn_m.GNNConfig(name="sage-demo", kind="sage", n_layers=2,
                          d_hidden=32, d_in=feats.shape[1], n_out=16,
                          remat=False)
    params = gnn_m.init_params(PRNGKey(0), cfg, device=args.device)
    g = gnn_m.GraphBatch(
        node_feat=torch.tensor(feats, device=args.device),
        edge_src=torch.tensor(src, device=args.device),
        edge_dst=torch.tensor(dst, device=args.device))
    emb = gnn_m.forward(params, cfg, g).cpu().numpy()
    print(f"[gnn] embedded {emb.shape[0]} nodes -> {emb.shape[1]}-d "
          f"(untrained SAGE aggregation already mixes communities)")

    acfg = ALIDConfig(a_cap=96, delta=96, lsh=auto_lsh_params(emb),
                      seeds_per_round=16, max_rounds=30)
    res = fit(emb, acfg, PRNGKey(1), device=args.device)
    f = avg_f1_score(comm, res.labels)
    print(f"[gnn] ALID found {res.n_clusters} dominant node clusters, "
          f"AVG-F vs true communities = {f:.3f}")
    return res, f


if __name__ == "__main__":
    main()
