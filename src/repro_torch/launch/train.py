"""Training launcher on the port, as the JAX package's
`python -m repro.launch.train`:

  # the smoke config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
  # on the card (the default device)
  PYTHONPATH=src python -m repro_torch.launch.train --steps 20

--smoke (the default) takes the reduced config; --full takes the arch's
CONFIG at full width (h2o-danube-1.8b: 1.8B params, ~37 GB of params,
gradients and AdamW state; for the card). Weights are
`init_params(PRNGKey(0), cfg)`, the JAX package's weights, and the tokens
`data.lm.lm_batch`'s, the JAX package's stream. `--device` (default cuda)
is the port's own flag. Under a mesh context the train step refuses to run
(ROADMAP A16: the dry-run).
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_arch
from repro_torch.data.lm import lm_batch
from repro_torch.random import PRNGKey
from repro_torch.train import steps as S
from repro_torch.train.optimizers import OptConfig, tree_leaves
from repro_torch.train.trainer import TrainerConfig, train_loop


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    cfg = mod.SMOKE_CONFIG if args.smoke else mod.CONFIG
    opt = OptConfig(lr=args.lr, warmup=min(20, args.steps // 10 + 1),
                    decay_steps=args.steps)
    params, opt_state = S.init_train_state(PRNGKey(0), "lm", cfg, opt,
                                           device=args.device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq}")

    step_fn = S.make_lm_train_step(cfg, opt, microbatches=args.microbatches)

    def batch_fn(step):
        return lm_batch(step, batch=args.batch, seq_len=args.seq,
                        vocab=cfg.vocab, seed=0, device=args.device)

    tcfg = TrainerConfig(total_steps=args.steps, log_every=args.log_every,
                         ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)
    _, _, history = train_loop(step_fn, batch_fn, params, opt_state, tcfg)
    first, last = history[0], history[-1]
    print(f"[train] loss {first['loss']:.4f} -> {last['loss']:.4f} "
          f"({last['wall_s']:.1f}s)")
    return history


if __name__ == "__main__":
    main()
