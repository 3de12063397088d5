"""Quickstart on the PyTorch port: detect dominant clusters in a noisy point
cloud with ALID, on the replicated, sharded and streamed engines.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --quick

The data mimics the paper's synthetic setup: Gaussian clusters buried in
uniform background noise; ALID finds the clusters without knowing their
number and leaves the noise unlabeled (-1). The fitted `Clustering` then
assigns NEW points via `predict`, without the original dataset. The
sharded engine keeps the dataset in shards on the device; the streamed
engine fits straight from an on-disk .npy that is never loaded whole, and
both give the replicated engine's labels.
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.core.alid import ALIDConfig, EngineSpec
from repro_torch.core.engine import fit
from repro_torch.core.source import MemmapSource
from repro_torch.data import auto_lsh_params, make_blobs_with_noise
from repro_torch.random import PRNGKey
from repro_torch.utils import avg_f1_score


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small-n smoke run")
    ap.add_argument("--device", default="cuda",
                    help="where the fits run (default: the card; 'cpu' "
                         "runs the plain PyTorch versions)")
    args = ap.parse_args(argv)

    n_clusters, cluster_size, n_noise = \
        (4, 24, 100) if args.quick else (8, 50, 600)
    spec = make_blobs_with_noise(n_clusters=n_clusters,
                                 cluster_size=cluster_size,
                                 n_noise=n_noise, d=24, seed=42)
    print(f"data: {spec.points.shape[0]} points "
          f"({n_clusters * cluster_size} in clusters, {n_noise} noise), "
          f"d={spec.points.shape[1]}")

    # probe=128 keeps retrieval exhaustive at this scale, so the engines
    # agree exactly
    cfg = ALIDConfig(a_cap=cluster_size * 2, delta=96,
                     lsh=auto_lsh_params(spec.points, probe=128),
                     seeds_per_round=16,
                     max_rounds=24 if args.quick else 40,
                     spec=EngineSpec(engine="replicated"))
    res = fit(spec.points, cfg, PRNGKey(0), device=args.device)
    print(f"ALID: {res.n_clusters} dominant clusters "
          f"(densities {np.round(res.densities, 3).tolist()})")
    print(f"ALID AVG-F = {avg_f1_score(spec.labels, res.labels):.3f}")

    # the fitted result assigns held-out queries
    members = spec.points[res.labels >= 0][:8]
    far = spec.points[:8] + 100.0          # far outside every cluster
    print(f"predict(members) = "
          f"{res.predict(members, device=args.device).tolist()}")
    print(f"predict(far noise) = "
          f"{res.predict(far, device=args.device).tolist()}")

    # the sharded out-of-core engine is one spec away: the same labels
    shd = fit(spec.points,
              cfg._replace(spec=EngineSpec(engine="sharded", n_shards=4)),
              PRNGKey(0), device=args.device)
    agree_shd = float(np.mean(shd.labels == res.labels))
    print(f"sharded engine agreement = {agree_shd:.3f}")

    # datasets beyond device memory: fit straight from an on-disk npy
    # through the DataSource API and the streamed engine (peak device
    # memory O(shard + cap)); the labels still match
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "points.npy")
        np.save(path, spec.points)
        stm = fit(MemmapSource(path),
                  cfg._replace(spec=EngineSpec(engine="streamed",
                                               n_shards=4, scratch_dir=td)),
                  PRNGKey(0), device=args.device)
    agree_stm = float(np.mean(stm.labels == res.labels))
    print(f"streamed-from-npy engine agreement = {agree_stm:.3f}")

    if not args.quick:
        # reference: the O(n^2) full-matrix IID baseline the paper beats
        import torch
        from repro_torch.core.affinity import affinity_matrix, estimate_k
        from repro_torch.core.peeling import iid_detect
        pts = torch.as_tensor(spec.points, device=args.device)
        full = iid_detect(affinity_matrix(pts, estimate_k(pts)))
        print(f"IID  AVG-F = {avg_f1_score(spec.labels, full.labels):.3f} "
              f"(full affinity matrix: {spec.points.shape[0]}^2 entries)")
    return res, agree_shd, agree_stm


if __name__ == "__main__":
    main()
