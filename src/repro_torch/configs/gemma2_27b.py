"""gemma2-27b [arXiv:2408.00118; hf]: 46L d_model=4608 32H (GQA kv=16)
head_dim=128 d_ff=36864 vocab=256000 — local(4096)+global alternating,
attention softcap 50, final softcap 30, post-norms, sqrt(d) embed scaling."""

import torch

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="gemma2-27b",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256_000,
    pattern=("local", "full"), window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    post_norms=True, embed_scale=True, tie_embeddings=True,
    rope_theta=10_000.0, dtype=torch.bfloat16,
)

SMOKE_CONFIG = LMConfig(
    name="gemma2-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    pattern=("local", "full"), window=8,
    attn_softcap=50.0, final_softcap=30.0,
    post_norms=True, embed_scale=True, tie_embeddings=True,
    dtype=torch.float32, remat=False,
)
