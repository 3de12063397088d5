"""The step functions of the JAX package's `train/steps.py` that run
without a backward pass: BST's serving steps (`make_bst_serve_step`,
`make_bst_retrieval_step`, the functions its dry-run builds its recsys
serve cells from), each `step(params, batch) -> logits` over a batch dict
as `data.recsys.bst_batch` draws it, and the GNNs' loss (`gnn_loss`) of a
batch as `data.graphs` draws it, computed without a gradient. `backend`
("auto" | "ref" | "kernel") goes down to the kernel ops. `bst_loss`, the
train steps (`make_gnn_train_step` among them) and the optimizers wait
for backward kernels (ROADMAP A16)."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import bst as bst_m
from repro_torch.models import gnn as gnn_m


def make_bst_serve_step(cfg: bst_m.BSTConfig,
                        backend: str = "auto") -> Callable:
    """CTR logits (B,) f32 of a batch of (user, target) pairs; its
    `labels`, if any, are ignored."""
    def serve_step(params: dict, batch: dict) -> torch.Tensor:
        inp = bst_m.BSTInputs(**{k: v for k, v in batch.items()
                                 if k != "labels"})
        return bst_m.forward(params, cfg, inp, backend)
    return serve_step


def make_bst_retrieval_step(cfg: bst_m.BSTConfig,
                            backend: str = "auto") -> Callable:
    """Logits (n_candidates,) f32 of one user's context (seq_items,
    seq_cats (1, S), dense_feats (1, n_dense), multi_ids (1, n_multi,
    bag)) against cand_items, cand_cats (n_candidates,)."""
    def retrieval_step(params: dict, batch: dict) -> torch.Tensor:
        zero = torch.zeros((1,), dtype=torch.int32,
                           device=batch["seq_items"].device)
        user = bst_m.BSTInputs(
            seq_items=batch["seq_items"], seq_cats=batch["seq_cats"],
            target_item=zero, target_cat=zero,
            dense_feats=batch["dense_feats"], multi_ids=batch["multi_ids"])
        return bst_m.retrieval_score(params, cfg, user, batch["cand_items"],
                                     batch["cand_cats"], backend)
    return retrieval_step


@torch.no_grad()
def gnn_loss(params: dict, cfg: gnn_m.GNNConfig, batch: dict,
             loss_kind: str, backend: str = "auto"):
    """(loss, metrics) of one batch, forward only: "node_ce" (mean
    cross-entropy over nodes whose label is >= 0), "node_mse" (mean
    squared error, pad nodes masked out by `node_mask` where given) or
    "graph_ce" (mean cross-entropy of the per-graph outputs), in f32."""
    g = gnn_m.GraphBatch(
        node_feat=batch["node_feat"], edge_src=batch["edge_src"],
        edge_dst=batch["edge_dst"], edge_feat=batch.get("edge_feat"),
        graph_ids=batch.get("graph_ids"),
        n_graphs=(int(batch["graph_targets"].shape[0])
                  if "graph_targets" in batch else 1))
    out = gnn_m.forward(params, cfg, g, backend)
    if loss_kind == "node_ce":
        labels = batch["labels"].to(torch.int64)
        mask = labels >= 0
        logp = torch.log_softmax(out.float(), -1)
        ll = torch.gather(logp, 1, labels.clamp(min=0)[:, None])[:, 0]
        ce = -torch.sum(torch.where(mask, ll, 0.0)) / torch.clamp(
            mask.sum(), min=1)
        return ce, {"ce": ce}
    if loss_kind == "node_mse":
        err2 = (out.float() - batch["targets"]) ** 2
        if "node_mask" in batch:   # padded graphs: exclude pad nodes
            w = batch["node_mask"]
            mse = torch.sum(err2 * w[:, None]) / torch.clamp(
                torch.sum(w) * err2.shape[-1], min=1.0)
        else:
            mse = torch.mean(err2)
        return mse, {"mse": mse}
    if loss_kind == "graph_ce":
        tgt = batch["graph_targets"].to(torch.int64)
        logp = torch.log_softmax(out.float(), -1)
        ce = -torch.mean(torch.gather(logp, 1, tgt[:, None]))
        return ce, {"ce": ce}
    raise ValueError(loss_kind)
