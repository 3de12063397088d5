"""End-to-end LM training on the port, the twin of
examples/train_lm_100m.py: a ~100M-param transformer (deepseek-7b family
scaled down) trained for a few hundred steps on the synthetic Markov
corpus; the loss must drop well below the unigram entropy. Checkpoints
land in --ckpt-dir and the run is resumable (kill it and re-run).

    PYTHONPATH=src python examples/torch_train_lm_100m.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm_100m.py --tiny --steps 40 \\
        --device cpu                                      # CPU-quick

Without --device it trains on the card, the attention's backward through
csrc/flash_attention_bwd.cu.
"""

import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.data.lm import lm_batch
from repro_torch.models.transformer import LMConfig
from repro_torch.random import PRNGKey
from repro_torch.train import steps as S
from repro_torch.train.optimizers import OptConfig, tree_leaves
from repro_torch.train.trainer import TrainerConfig, train_loop


def lm_100m() -> LMConfig:
    # ~100M params: 12L x d768 (llama-style, deepseek family)
    return LMConfig(name="lm-100m", n_layers=12, d_model=768, n_heads=12,
                    n_kv_heads=4, head_dim=64, d_ff=2048, vocab=32_000,
                    pattern=("full",), tie_embeddings=True,
                    dtype=torch.float32, remat=False)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="use the smoke config instead of 100M")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch("deepseek-7b").SMOKE_CONFIG if args.tiny else lm_100m()
    opt = OptConfig(lr=3e-4, warmup=20, decay_steps=args.steps,
                    grad_clip=1.0)
    params, opt_state = S.init_train_state(PRNGKey(0), "lm", cfg, opt,
                                           device=args.device)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"[lm100m] {cfg.name}: {n / 1e6:.1f}M params")

    step_fn = S.make_lm_train_step(cfg, opt)

    def batch_fn(step):
        return lm_batch(step, batch=args.batch, seq_len=args.seq,
                        vocab=cfg.vocab, seed=0, device=args.device)

    tcfg = TrainerConfig(total_steps=args.steps, log_every=10,
                         ckpt_every=100, ckpt_dir=args.ckpt_dir)
    _, _, history = train_loop(step_fn, batch_fn, params, opt_state, tcfg)
    print(f"[lm100m] loss {history[0]['loss']:.3f} -> "
          f"{history[-1]['loss']:.3f} in {history[-1]['wall_s']:.0f}s")
    return history


if __name__ == "__main__":
    main()
