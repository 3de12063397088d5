"""Synthetic recsys event stream for BST, a port of the JAX package's
`data/recsys.py`: stateless-indexable batches drawn with the port's
threefry, so that batch `step` of seed `seed` holds the JAX package's ids
and clicks (equal ints) and its dense features (within the ulps of
`random.normal`).

A target shares the "category bucket" of part of the user's history; the
click probability is sigmoid(4 * match - 1), match the share of history
items in the target's category. Categories come from Knuth's
multiplicative hash of the item id, in uint32 arithmetic (here int64
masked to 32 bits). The multi-hot ids are drawn over the whole vocabulary:
no -1 pads.
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch.core.alid import resolve_device

_M32 = 0xFFFFFFFF
_KNUTH = 2654435761


def category_of(items: torch.Tensor, cat_vocab: int) -> torch.Tensor:
    """(uint32(item) * 2654435761 mod 2**32) mod cat_vocab, int32."""
    h = ((items.to(torch.int64) & _M32) * _KNUTH) & _M32
    return (h % cat_vocab).to(torch.int32)


def bst_batch(step: int, *, batch: int, seq_len: int, item_vocab: int,
              cat_vocab: int, n_dense: int = 16, n_multi: int = 2,
              multi_bag: int = 8, multi_vocab: int = 131_072, seed: int = 0,
              device="cuda") -> dict:
    """Batch `step` of the stream, on `device`: seq_items, seq_cats (B, S),
    target_item, target_cat, labels (B,) int32, dense_feats (B, n_dense)
    f32, multi_ids (B, n_multi, multi_bag) int32."""
    dev = resolve_device(device)
    ks = trandom.split(trandom.fold_in(trandom.PRNGKey(seed), step), 8)
    seq_items = trandom.randint(ks[0], (batch, seq_len), 0, item_vocab, dev)
    target = trandom.randint(ks[1], (batch,), 0, item_vocab, dev)
    seq_cats = category_of(seq_items, cat_vocab)
    tgt_cat = category_of(target, cat_vocab)
    match = torch.mean((seq_cats == tgt_cat[:, None]).float(), dim=1)
    p = torch.sigmoid(4.0 * match - 1.0)
    labels = trandom.bernoulli(ks[2], p).to(torch.int32)
    multi = trandom.randint(ks[4], (batch, n_multi, multi_bag), 0,
                            multi_vocab, dev)
    return {
        "seq_items": seq_items.to(torch.int32),
        "seq_cats": seq_cats,
        "target_item": target.to(torch.int32),
        "target_cat": tgt_cat,
        "dense_feats": trandom.normal(ks[3], (batch, n_dense), dev),
        "multi_ids": multi.to(torch.int32),
        "labels": labels,
    }
