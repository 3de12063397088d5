"""Serving launcher on the port: batched generation with the BatchServer,
as the JAX package's `python -m repro.launch.serve`.

  # the smoke config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  # h2o-danube-1.8b at full width (random weights) on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --full

Weights are `init_params(PRNGKey(0), cfg)`, the JAX package's weights.
`--device` (default cuda) is the port's own flag.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.models import transformer as lm_m
from repro_torch.random import PRNGKey
from repro_torch.serve import BatchServer, ServeConfig


def mix_prompts(vocab: int, requests: int = 6) -> list[np.ndarray]:
    """The launcher's requests: prompts of 4-11 random tokens, numpy seed
    0, as the JAX launcher draws them."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=rng.integers(4, 12)).astype(np.int32)
            for _ in range(requests)]


def run(params, cfg: lm_m.LMConfig, *, requests: int = 6, max_new: int = 16,
        slots: int = 4, temperature: float = 0.0, device="cuda") -> dict:
    """Submit `mix_prompts(cfg.vocab, requests)`, serve them, print the JAX
    launcher's lines; return the prompts, the results, the wall seconds,
    the token count and the server's per-batch stats."""
    srv = BatchServer(params, cfg, batch_slots=slots,
                      scfg=ServeConfig(max_new_tokens=max_new,
                                       temperature=temperature),
                      device=device)
    prompts = mix_prompts(cfg.vocab, requests)
    t0 = time.time()
    ids = [srv.submit(p) for p in prompts]
    results = srv.serve()
    dt = time.time() - t0
    toks = sum(len(v) for v in results.values())
    print(f"[serve] {len(ids)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s)")
    for rid in ids[:3]:
        print(f"  req {rid}: {results[rid].tolist()}")
    return dict(ids=ids, prompts=prompts, results=results, seconds=dt, tokens=toks,
                batch_stats=srv.batch_stats)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    cfg = mod.SMOKE_CONFIG if args.smoke else mod.CONFIG
    params = lm_m.init_params(PRNGKey(0), cfg, device=args.device)
    return run(params, cfg, requests=args.requests, max_new=args.max_new,
               slots=args.slots, temperature=args.temperature,
               device=args.device)


if __name__ == "__main__":
    main()
