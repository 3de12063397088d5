"""bst [arXiv:1905.06874; paper]: Behavior Sequence Transformer (Alibaba) —
embed_dim=32, seq_len=20, 1 transformer block, 8 heads, MLP 1024-512-256,
transformer-seq feature interaction. Embedding tables: 4.19M items, 65k
categories (Taobao-scale stand-ins)."""

import dataclasses

import torch

from repro_torch.models.bst import BSTConfig

SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]

CONFIG = BSTConfig(
    name="bst", embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
    mlp=(1024, 512, 256), item_vocab=4_194_304, cat_vocab=65_536,
    n_dense=16, n_multi=2, multi_bag=8, multi_vocab=131_072,
    dtype=torch.float32,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="bst-smoke", item_vocab=1024, cat_vocab=64,
    multi_vocab=256, seq_len=8, mlp=(64, 32))
