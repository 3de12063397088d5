"""llama4-scout-17b-16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]:
48L d_model=5120 40H (GQA kv=8) head_dim=128 d_ff=8192 vocab=202048,
MoE 16 experts top-1 (sigmoid router) + 1 shared expert.

iRoPE interleaving per the public Llama-4 description: 3 chunked-local
attention layers (chunk 8192, RoPE) : 1 full-attention NoPE layer.

`make_cell` waits for the dry-run (ROADMAP A16)."""

import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

CONFIG = LMConfig(
    name="llama4-scout-17b-16e",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202_048,
    pattern=("chunked", "chunked", "chunked", "full_nope"), chunk=8192,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192, n_shared=1,
                  router="sigmoid", norm_topk=False),
    tie_embeddings=False, rope_theta=500_000.0, dtype=torch.bfloat16,
)

SMOKE_CONFIG = LMConfig(
    name="llama4-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=512,
    pattern=("chunked", "chunked", "chunked", "full_nope"), chunk=8,
    moe=MoEConfig(n_experts=4, top_k=1, d_ff=96, n_shared=1,
                  router="sigmoid", norm_topk=False, capacity_factor=2.0),
    tie_embeddings=False, dtype=torch.float32,
)
