"""Behavior Sequence Transformer (Alibaba, arXiv:1905.06874), ported from
the JAX package's `models/bst.py` with the same parameter tree and cast
points.

Per the paper: item + category + position embeddings of the user's
behaviour sequence and the target item -> one post-LN transformer block (8
heads) -> flattened, concatenated with the "other features" (dense profile
features and multi-hot fields summed by EmbeddingBag) -> MLP 1024-512-256
-> one CTR logit. `retrieval_score` scores one user's context against many
candidate items as one batched forward, the user's inputs broadcast.

Attention goes through `kernels.ops.flash_attention` (dh = 4, not causal)
and the multi-hot fields through `kernels.ops.embedding_bag`; every entry
point takes `backend` ("auto" | "ref" | "kernel") and hands it down to
both. The sequence and target lookups stay plain indexing, as in the JAX
package. Its sharding constraint (`constrain`) has no counterpart on one
card, and dropout none in serving (the JAX model keeps it for config
fidelity only).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import random as trandom
from repro_torch.core.alid import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    embed_dim: int = 32
    seq_len: int = 20                 # behaviour sequence length
    n_blocks: int = 1
    n_heads: int = 8
    mlp: tuple[int, ...] = (1024, 512, 256)
    item_vocab: int = 4_194_304
    cat_vocab: int = 65_536
    n_dense: int = 16                 # dense profile / context features
    n_multi: int = 2                  # multi-hot fields (EmbeddingBag)
    multi_bag: int = 8                # ids per multi-hot field
    multi_vocab: int = 131_072
    dropout: float = 0.0              # kept for config fidelity; eval mode
    dtype: Any = torch.float32

    def param_count(self) -> int:
        """Parameters of `init_params`, counted from the shapes."""
        d, s1 = self.embed_dim, self.seq_len + 1
        n = (self.item_vocab + self.cat_vocab + self.multi_vocab + s1) * d
        ffn = (d * 4 * d + 4 * d) + (4 * d * d + d)
        n += self.n_blocks * (4 * d * d + 4 * d + ffn)
        sizes = (s1 * d + self.n_dense + self.n_multi * d, *self.mlp, 1)
        return n + sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))


class BSTInputs(NamedTuple):
    seq_items: torch.Tensor       # (B, S) int
    seq_cats: torch.Tensor        # (B, S) int
    target_item: torch.Tensor     # (B,) int
    target_cat: torch.Tensor      # (B,) int
    dense_feats: torch.Tensor     # (B, n_dense) f32
    multi_ids: torch.Tensor       # (B, n_multi, bag) int, -1 pad
    labels: Optional[torch.Tensor] = None  # (B,) {0, 1} clicks (training)


def init_params(rng, cfg: BSTConfig, device="cuda") -> dict:
    """The JAX package's `init_params(rng, cfg)`, drawn with the port's
    threefry on `device`: the same keys, the same weights (normal draws
    within the ulps of `random.normal`)."""
    dev = resolve_device(device)
    d, dt = cfg.embed_dim, cfg.dtype
    ks = iter(trandom.split(rng, 12))
    s1 = cfg.seq_len + 1

    def normal(shape):
        return L.normal_init(next(ks), shape, dt, device=dev)

    def norm(fill):
        return torch.full((d,), fill, dtype=torch.float32, device=dev)

    p: dict = {"item_table": normal((cfg.item_vocab, d)),
               "cat_table": normal((cfg.cat_vocab, d)),
               "multi_table": normal((cfg.multi_vocab, d)),
               "pos_embed": normal((s1, d))}
    blocks = []
    for _ in range(cfg.n_blocks):
        b = {name: normal((d, d)) for name in ("wq", "wk", "wv", "wo")}
        b.update(ln1_s=norm(1.0), ln1_b=norm(0.0), ln2_s=norm(1.0),
                 ln2_b=norm(0.0))
        b["ffn"] = L.mlp_init(next(ks), (d, 4 * d, d), dt, device=dev)
        blocks.append(b)
    p["blocks"] = blocks
    d_flat = s1 * d + cfg.n_dense + cfg.n_multi * d
    p["mlp"] = L.mlp_init(next(ks), (d_flat, *cfg.mlp, 1), dt, device=dev)
    return p


def _block(b: dict, cfg: BSTConfig, x: torch.Tensor,
           backend: str = "auto") -> torch.Tensor:
    """Post-LN transformer block (as in the BST paper), x (B, S1, d)."""
    bsz, s1, d = x.shape
    hd = d // cfg.n_heads

    def heads(w):
        return L.dense(x, w).view(bsz, s1, cfg.n_heads, hd).transpose(1, 2)

    att = ops.flash_attention(heads(b["wq"]), heads(b["wk"]), heads(b["wv"]),
                              0, causal=False, backend=backend)
    att = att.transpose(1, 2).reshape(bsz, s1, d)
    x = L.layer_norm(x + L.dense(att, b["wo"]), b["ln1_s"], b["ln1_b"])
    f = L.mlp_apply(b["ffn"], x, act=L.gelu)
    return L.layer_norm(x + f, b["ln2_s"], b["ln2_b"])


def bag_inputs(cfg: BSTConfig, multi_ids: torch.Tensor):
    """EmbeddingBag's arguments for the multi-hot fields (B, n_multi, bag):
    the flat ids (B * n_multi * bag,), their bags (field f of row b is bag
    b * n_multi + f; -1 where the id is a pad) and n_bags = B * n_multi."""
    n_bags = multi_ids.shape[0] * cfg.n_multi
    flat_ids = multi_ids.reshape(-1)
    bag_ids = torch.arange(n_bags, dtype=torch.int32, device=flat_ids.device)
    bag_ids = bag_ids.repeat_interleave(cfg.multi_bag)
    return flat_ids, torch.where(flat_ids >= 0, bag_ids, -1), n_bags


def multi_hot_bags(params: dict, cfg: BSTConfig, multi_ids: torch.Tensor,
                   backend: str = "auto") -> torch.Tensor:
    """The multi-hot fields (B, n_multi, bag), -1 pads anywhere, summed
    per field by EmbeddingBag: (B, n_multi * d)."""
    bags = ops.embedding_bag(params["multi_table"],
                             *bag_inputs(cfg, multi_ids), backend=backend)
    return bags.reshape(multi_ids.shape[0], cfg.n_multi * cfg.embed_dim)


def forward(params: dict, cfg: BSTConfig, inp: BSTInputs,
            backend: str = "auto") -> torch.Tensor:
    """CTR logits (B,) f32."""
    bsz = inp.seq_items.shape[0]
    items = torch.cat([inp.seq_items, inp.target_item[:, None]], dim=1)
    cats = torch.cat([inp.seq_cats, inp.target_cat[:, None]], dim=1)
    x = (params["item_table"][items] + params["cat_table"][cats]
         + params["pos_embed"][None])
    x = x.to(cfg.dtype)
    for b in params["blocks"]:
        x = _block(b, cfg, x, backend)
    bags = multi_hot_bags(params, cfg, inp.multi_ids, backend)
    feat = torch.cat([x.reshape(bsz, -1), inp.dense_feats.to(cfg.dtype),
                      bags.to(cfg.dtype)], dim=-1)
    del x
    logit = L.mlp_apply(params["mlp"], feat, act=L.leaky_relu)
    return logit[:, 0].float()


def retrieval_score(params: dict, cfg: BSTConfig, user: BSTInputs,
                    cand_items: torch.Tensor, cand_cats: torch.Tensor,
                    backend: str = "auto") -> torch.Tensor:
    """Score ONE user context (B = 1 inputs) against n_candidates items:
    the user's inputs broadcast over the candidates (views, no copies)."""
    nc = cand_items.shape[0]

    def tile(a):
        return a.expand(nc, *a.shape[1:])

    inp = BSTInputs(seq_items=tile(user.seq_items),
                    seq_cats=tile(user.seq_cats), target_item=cand_items,
                    target_cat=cand_cats, dense_feats=tile(user.dense_feats),
                    multi_ids=tile(user.multi_ids))
    return forward(params, cfg, inp, backend)
