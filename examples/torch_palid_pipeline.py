"""End-to-end PALID pipeline on the PyTorch port (the paper's SIFT-50M
scenario, scaled down): build the LSH index -> parallel seed rounds over
the ranks of a process group -> the shared segment-max reduce -> report
clusters and quality, through `repro_torch.core.engine.fit` with
EngineSpec(engine="mesh"). The twin of `examples/palid_pipeline.py`, on
the same data, config and key.

With --devices D > 1 the example spawns D ranks (`torch.multiprocessing`,
`distributed.spawn.run_ranks`); every rank runs `fit` on the same data
and rank 0's result is reported. On the card each rank takes its own card
and the ranks talk over NCCL; with --device cpu they are gloo processes.
--shards S splits the store over the ranks (S a multiple of D).

    PYTHONPATH=src python examples/torch_palid_pipeline.py --devices 2
    PYTHONPATH=src python examples/torch_palid_pipeline.py --device cpu \\
        --n 3000 --devices 2 --shards 4
"""

import argparse
import time

import numpy as np

from repro_torch.core.alid import ALIDConfig, EngineSpec
from repro_torch.core.engine import fit
from repro_torch.data import auto_lsh_params, make_blobs_with_noise
from repro_torch.distributed.spawn import rank_devices, run_ranks
from repro_torch.random import PRNGKey
from repro_torch.utils import avg_f1_score


def fit_rank(rank, world, points, cfg, devices):
    """One rank of the mesh fit; rank 0 hands its result back."""
    res = fit(points, cfg, PRNGKey(1), device=devices[rank])
    return res if rank == 0 else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30000)
    ap.add_argument("--d", type=int, default=32,
                    help="SIFT-like descriptor dim")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--shards", type=int, default=0,
                    help="split the store over the ranks (0 = replicated)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (a card a rank) or 'cpu' (gloo ranks)")
    args = ap.parse_args(argv)

    n_clusters = 20
    cluster_size = max(8, int(args.n * 0.35) // n_clusters)
    spec = make_blobs_with_noise(
        n_clusters, cluster_size, args.n - n_clusters * cluster_size,
        d=args.d, seed=7)
    print(f"[pipeline] {args.n} descriptors, {n_clusters} visual-word "
          f"clusters of ~{cluster_size}, rest noise")

    if args.devices > 1:
        espec = EngineSpec(engine="mesh", n_shards=args.shards)
        mode = f"PALID x{args.devices}"
    else:
        espec = EngineSpec(engine="replicated")
        mode = "ALID serial"
    cfg = ALIDConfig(a_cap=max(64, cluster_size + 32), delta=128,
                     lsh=auto_lsh_params(spec.points),
                     seeds_per_round=32, max_rounds=48, spec=espec)
    t0 = time.time()
    if args.devices > 1:
        devices = rank_devices(args.device, args.devices)
        res = run_ranks(fit_rank, args.devices, spec.points, cfg, devices,
                        devices=devices)[0]
    else:
        res = fit(spec.points, cfg, PRNGKey(1), device=args.device)
    dt = time.time() - t0

    sizes = np.bincount(res.labels[res.labels >= 0]) if res.n_clusters \
        else np.zeros(0, np.int64)
    f = avg_f1_score(spec.labels, res.labels)
    print(f"[pipeline] {mode}: {dt:.1f}s, {res.n_clusters} clusters, "
          f"sizes {sorted(sizes.tolist(), reverse=True)[:10]}...")
    print(f"[pipeline] AVG-F = {f:.3f}")
    return res, f


if __name__ == "__main__":
    main()
