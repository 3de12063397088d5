"""The step functions of the JAX package's `train/steps.py`: the train
steps of the LMs (`lm_loss`, `make_lm_train_step`, with gradient
accumulation over microbatches), the GNNs (`gnn_loss`,
`make_gnn_train_step`) and BST (`bst_loss`, `make_bst_train_step`),
`init_train_state`, and BST's serving steps (`make_bst_serve_step`,
`make_bst_retrieval_step`). `backend` ("auto" | "ref" | "kernel") goes
down to the kernel ops.

A train step is `step(params, opt_state, batch) -> (params, opt_state,
metrics)`, run eagerly (the JAX package jits it): the loss's gradients by
autograd (the attention, segment-sum and bag kernels with their backward
kernels on the card), then `optimizers.opt_update`, which updates the
params and the state in place and returns the same trees. Under a mesh
context the train steps raise NotImplementedError: the JAX steps place
their gradients with sharding constraints (`grad_constrain`) that wait
for ROADMAP A16's dry-run, and they must not train unsharded silently.
The prefill and decode steps (`make_lm_prefill_step`,
`make_lm_decode_step`) come with the dry-run too."""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed.context import get_mesh_context
from repro_torch.models import bst as bst_m
from repro_torch.models import gnn as gnn_m
from repro_torch.models import transformer as lm_m
from repro_torch.train.optimizers import (OptConfig, init_opt_state,
                                          opt_update, tree_leaves, tree_map)


def _refuse_mesh(what: str) -> None:
    if get_mesh_context() is not None:
        raise NotImplementedError(
            f"{what} under a mesh context: the gradients' sharding "
            "constraints wait for ROADMAP A16: the dry-run; run it without "
            "a mesh context")


def value_and_grad(loss_fn: Callable, params: Any):
    """((loss, metrics), grads) of loss_fn(params) -> (loss, metrics): the
    params' leaves require grad for the call only, and a leaf the loss
    does not reach gets zeros, as jax.value_and_grad gives. The loss and
    metrics come back detached."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = loss_fn(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    del grads
    grads = _unflatten(params, it)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        grads


def _unflatten(tree: Any, it) -> Any:
    """A tree of `tree`'s structure whose leaves come from `it`, in
    `tree_leaves` order."""
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return None if tree is None else next(it)


# ------------------------------------------------------------------- LM ----
def lm_loss(params: dict, cfg: lm_m.LMConfig, tokens: torch.Tensor,
            backend: str = "auto"):
    """Next-token cross-entropy (mean over B x S, f32) plus the MoE aux
    loss; tokens (B, S + 1). Returns (loss, {"ce", "aux"})."""
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits, aux = lm_m.forward(params, cfg, inputs, backend=backend)
    logp = torch.log_softmax(logits.float(), dim=-1)
    del logits
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    ce = -torch.mean(ll)
    return ce + aux, {"ce": ce, "aux": aux}


def make_lm_train_step(cfg: lm_m.LMConfig, opt: OptConfig,
                       microbatches: int = 1, accum_dtype=torch.float32,
                       backend: str = "auto") -> Callable:
    """The LM train step over tokens (B, S + 1). With `microbatches` > 1
    the batch is cut into that many equal microbatches, whose gradients
    (each cast to `accum_dtype`) are summed in order and divided by their
    number, as the JAX step's scan does; the loss and metrics are their
    means."""
    def train_step(params, opt_state, tokens):
        _refuse_mesh("make_lm_train_step")
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(
                lambda p: lm_loss(p, cfg, tokens, backend), params)
        else:
            b = tokens.shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            mtoks = tokens.reshape(microbatches, b // microbatches, -1)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tokens.device)
            ms = []
            for i in range(microbatches):
                (l, m), g = value_and_grad(
                    lambda p: lm_loss(p, cfg, mtoks[i], backend), params)
                tree_map(lambda a, x: a.add_(x.to(accum_dtype)), grads, g)
                del g
                loss = loss + l
                ms.append(m)
            grads = tree_map(lambda a: a / microbatches, grads)
            loss = loss / microbatches
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                       for k in ms[0]}
        params, opt_state, opt_metrics = opt_update(opt, grads, opt_state,
                                                    params)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}
    return train_step


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


def gnn_loss(params: dict, cfg: gnn_m.GNNConfig, batch: dict,
             loss_kind: str, backend: str = "auto"):
    """(loss, metrics) of one batch: "node_ce" (mean
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


def make_gnn_train_step(cfg: gnn_m.GNNConfig, opt: OptConfig,
                        loss_kind: str, backend: str = "auto") -> Callable:
    """The GNN train step over a batch dict as `data.graphs` draws it."""
    def train_step(params, opt_state, batch):
        _refuse_mesh("make_gnn_train_step")
        (loss, metrics), grads = value_and_grad(
            lambda p: gnn_loss(p, cfg, batch, loss_kind, backend), params)
        params, opt_state, opt_metrics = opt_update(opt, grads, opt_state,
                                                    params)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}
    return train_step


# ------------------------------------------------------------------ BST ----
def bst_loss(params: dict, cfg: bst_m.BSTConfig, batch: dict,
             backend: str = "auto"):
    """Mean binary cross-entropy of the CTR logits against `labels`, in the
    JAX package's stable form max(z, 0) - z y + log1p(exp(-|z|))."""
    inp = bst_m.BSTInputs(**{k: v for k, v in batch.items()
                             if k != "labels"})
    logits = bst_m.forward(params, cfg, inp, backend)
    labels = batch["labels"].float()
    bce = torch.mean(torch.clamp(logits, min=0) - logits * labels
                     + torch.log1p(torch.exp(-torch.abs(logits))))
    return bce, {"bce": bce}


def make_bst_train_step(cfg: bst_m.BSTConfig, opt: OptConfig,
                        backend: str = "auto") -> Callable:
    """The BST train step over a batch dict as `data.recsys.bst_batch`
    draws it."""
    def train_step(params, opt_state, batch):
        _refuse_mesh("make_bst_train_step")
        (loss, metrics), grads = value_and_grad(
            lambda p: bst_loss(p, cfg, batch, backend), params)
        params, opt_state, opt_metrics = opt_update(opt, grads, opt_state,
                                                    params)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}
    return train_step


def init_train_state(rng, kind: str, cfg: Any, opt: OptConfig,
                     device="cuda"):
    """(params, opt_state) of a model family ("lm", "gnn" or "recsys"),
    the weights drawn as the JAX package's from the same key."""
    init = {"lm": lm_m.init_params, "gnn": gnn_m.init_params,
            "recsys": bst_m.init_params}[kind]
    params = init(rng, cfg, device=device)
    return params, init_opt_state(opt, params)
