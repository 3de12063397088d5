"""Serve a small LM with batched requests through the PyTorch port's
BatchServer (continuous-batching-lite: fixed slots, left-padded prompts).
The twin of `examples/serve_lm.py`: gemma2-27b's smoke config, the same
weights' keys, prompts and sampling, so the same tokens.

    PYTHONPATH=src python examples/torch_serve_lm.py               # the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.models import transformer as lm_m
from repro_torch.random import PRNGKey
from repro_torch.serve import BatchServer, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model serves (default: the card; 'cpu' "
                         "runs the plain PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = get_arch("gemma2-27b").SMOKE_CONFIG
    params = lm_m.init_params(PRNGKey(0), cfg, device=args.device)
    srv = BatchServer(params, cfg, batch_slots=4,
                      scfg=ServeConfig(max_new_tokens=12, temperature=0.8),
                      device=args.device)

    rng = np.random.default_rng(1)
    t0 = time.time()
    ids = [srv.submit(rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32))
           for n in rng.integers(3, 10, size=10)]
    results = srv.serve()
    dt = time.time() - t0
    total = sum(len(v) for v in results.values())
    print(f"[serve_lm] {len(ids)} requests -> {total} tokens in {dt:.2f}s")
    for rid in ids[:4]:
        print(f"  request {rid}: generated {results[rid].tolist()}")
    return results


if __name__ == "__main__":
    main()
