"""h2o-danube-1.8b [arXiv:2401.16818; hf]: 24L d_model=2560 32H (GQA kv=8)
head_dim=80 d_ff=6912 vocab=32000 — llama+mistral mix with sliding-window
attention (4096) throughout."""

import torch

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="h2o-danube-1.8b",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab=32_000,
    pattern=("local",), window=4096,
    tie_embeddings=False, rope_theta=10_000.0, dtype=torch.bfloat16,
)

SMOKE_CONFIG = LMConfig(
    name="danube-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab=512, pattern=("local",), window=8,
    tie_embeddings=False, dtype=torch.float32, remat=False,
)
