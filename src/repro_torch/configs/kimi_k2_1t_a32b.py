"""kimi-k2-1t-a32b [arXiv:2501.kimi2; unverified, paper-table]: 61L
d_model=7168 64H (GQA kv=8) head_dim=128 d_ff=2048(per expert) vocab=163840,
MoE 384 experts top-8 + 1 shared — trillion-parameter MoE.

`make_cell` waits for the dry-run (ROADMAP A16)."""

import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab=163_840,
    pattern=("full",),
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, n_shared=1,
                  router="softmax", norm_topk=True),
    tie_embeddings=False, rope_theta=50_000.0, dtype=torch.bfloat16,
)

SMOKE_CONFIG = LMConfig(
    name="kimi-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=32, vocab=512, pattern=("full",),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1,
                  router="softmax", norm_topk=True, capacity_factor=2.0),
    tie_embeddings=False, dtype=torch.float32, remat=False,
)
