"""BST's serving steps, ported from the JAX package's `train/steps.py`
(`make_bst_serve_step`, `make_bst_retrieval_step`), the functions its
dry-run builds its recsys serve cells from. Each returns
`step(params, batch) -> logits` over a batch dict as `data.recsys.
bst_batch` draws it; `backend` ("auto" | "ref" | "kernel") goes down to
the attention and EmbeddingBag ops. `bst_loss`, the train steps and the
optimizers wait for backward kernels (ROADMAP A16)."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import bst as bst_m


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
