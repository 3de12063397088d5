"""deepseek-7b [arXiv:2401.02954; hf]: 30L d_model=4096 32H (GQA kv=32 = MHA)
head_dim=128 d_ff=11008 vocab=102400 — llama architecture."""

import torch

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="deepseek-7b",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab=102_400,
    pattern=("full",),
    tie_embeddings=False, rope_theta=10_000.0, dtype=torch.bfloat16,
)

SMOKE_CONFIG = LMConfig(
    name="deepseek-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=160, vocab=512, pattern=("full",), tie_embeddings=False,
    dtype=torch.float32, remat=False,
)
