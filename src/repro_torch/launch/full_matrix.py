"""The full-matrix baselines on the port: estimate_k, the n x n affinity
matrix (the `affinity` kernel on the card), then IID or DS peeling, on
`make_blobs_with_noise` data. The port's home for the JAX package's
`benchmarks/common.py::run_full_matrix` and the quickstart's IID check.

  # on the card, at the defaults (n = 40,000, d = 128: a 6.4 GB matrix)
  PYTHONPATH=src python -m repro_torch.launch.full_matrix --solver iid
  # a small set on the CPU, through the plain versions
  PYTHONPATH=src python -m repro_torch.launch.full_matrix --device cpu \\
      --n-clusters 4 --cluster-size 25 --n-noise 60 --d 8

The defaults are the full-matrix configuration: 200 blobs of 80 points and
24,000 noise points in d = 128 (clusters of 80 and 60 % noise, as the
full-width fit's data), the largest n whose matrix fits one 80 GB card with
room for the peel. It prints one `[full-matrix] ...` line.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.affinity import affinity_matrix, estimate_k
from repro_torch.core.alid import resolve_device
from repro_torch.core.peeling import ds_detect, iid_detect
from repro_torch.data import make_blobs_with_noise
from repro_torch.utils import avg_f1_score


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-clusters", type=int, default=200)
    ap.add_argument("--cluster-size", type=int, default=80)
    ap.add_argument("--n-noise", type=int, default=24_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mean-range", type=float, default=50.0)
    ap.add_argument("--cov-max", type=float, default=10.0)
    ap.add_argument("--overlap-pairs", type=int, default=2)
    ap.add_argument("--noise-range", type=float, default=60.0)
    ap.add_argument("--solver", choices=("iid", "ds"), default="iid")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Run and print the path; return its numbers (and the PeelResult)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    spec = make_blobs_with_noise(
        args.n_clusters, args.cluster_size, args.n_noise, d=args.d,
        seed=args.seed, mean_range=args.mean_range, cov_max=args.cov_max,
        overlap_pairs=args.overlap_pairs, noise_range=args.noise_range)
    pts = torch.as_tensor(spec.points, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    k = estimate_k(pts)
    _sync(dev)
    t0 = time.perf_counter()
    a = affinity_matrix(pts, k)
    _sync(dev)
    t1 = time.perf_counter()
    detect = iid_detect if args.solver == "iid" else ds_detect
    res = detect(a)
    _sync(dev)
    t2 = time.perf_counter()
    out = dict(n=pts.shape[0], d=pts.shape[1], k=k, matrix_s=t1 - t0,
               peel_s=t2 - t1, rounds=res.n_rounds,
               clusters=len(res.densities),
               avg_f=avg_f1_score(spec.labels, res.labels),
               peak_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
               result=res)
    peak = ("n/a (cpu)" if out["peak_bytes"] is None
            else str(out["peak_bytes"]))
    print(f"[full-matrix] solver={args.solver} device={dev} n={out['n']} "
          f"d={out['d']} k={k:.6g} matrix_s={out['matrix_s']:.3f} "
          f"peel_s={out['peel_s']:.3f} rounds={res.n_rounds} "
          f"clusters={out['clusters']} AVG-F={out['avg_f']:.4f} "
          f"max_memory_allocated={peak}")
    return out


if __name__ == "__main__":
    main()
