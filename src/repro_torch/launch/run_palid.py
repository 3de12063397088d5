"""PALID launcher on the port: dominant-cluster detection over synthetic
SIFT-like blobs on the replicated engine (paper Sec. 5.3); with
--serve-bench the continuous-batching assignment server over the result,
driven by open-loop traffic; with --online the online-update round trip
(insert, commit, rollback, re-serve) over `LiveServing`. It prints the
lines the JAX package's `python -m repro.launch.run_palid` prints.

  # on the card
  PYTHONPATH=src python -m repro_torch.launch.run_palid --serve-bench
  PYTHONPATH=src python -m repro_torch.launch.run_palid --online --quick
  # the small preset on the CPU, through the plain versions
  PYTHONPATH=src python -m repro_torch.launch.run_palid --quick \\
      --device cpu --serve-bench --online

The JAX CLI's flags that need a part not ported yet (other engines, data
sources, bf16 storage, fault injection, fit checkpoints, the contract
checker) raise NotImplementedError naming their ROADMAP item; the
streamed engine's tuning flags (--chunk-size, --cache-bytes,
--prefetch-depth, --scratch-dir, --profile, --checkpoint-every) are not
accepted.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from repro_torch.core.alid import ALIDConfig, EngineSpec
from repro_torch.core.engine import fit
from repro_torch.core.online import OnlineClustering
from repro_torch.core.source import as_source
from repro_torch.data import auto_lsh_params, make_blobs_with_noise
from repro_torch.random import PRNGKey
from repro_torch.serve import ClusterServer, LiveServing, run_open_loop
from repro_torch.utils import avg_f1_score

SERVE_SLOTS = 64
SERVE_QUERIES = 1024
_ENGINE_ITEMS = {"sharded": "A10", "streamed": "A11", "mesh": "A13"}


def _unported_flags(args) -> list[str]:
    """The given flags of the JAX CLI whose parts are not ported yet, each
    with its ROADMAP item."""
    checks = [
        (args.engine in _ENGINE_ITEMS, f"--engine {args.engine} (ROADMAP "
         f"{_ENGINE_ITEMS.get(args.engine)})"),
        (args.devices > 1, "--devices > 1, the mesh engine (ROADMAP A13)"),
        (args.shards > 0, "--shards, the sharded and streamed engines "
         "(ROADMAP A10, A11)"),
        (args.dtype != "float32", f"--dtype {args.dtype} (ROADMAP queue "
         "item 'bf16 storage in the four kernels')"),
        (bool(args.source), "--source, make_source (ROADMAP A11)"),
        (bool(args.inject_faults), "--inject-faults, fault injection "
         "(ROADMAP A11)"),
        (bool(args.checkpoint_dir), "--checkpoint-dir, fit checkpoints "
         "(ROADMAP A11)"),
        (args.resume, "--resume, fit checkpoints (ROADMAP A11)"),
        (args.check, "--check, the contract checker (ROADMAP A15)"),
    ]
    return [what for given, what in checks if given]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--clusters", type=int, default=20)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "ref", "kernel"],
                    help="kernel backend for every hot-path op "
                         "(repro_torch.kernels.ops): 'auto' = the CUDA "
                         "kernels on the card, the plain versions on the "
                         "CPU; 'ref' = the plain versions anywhere; "
                         "'kernel' = the CUDA kernels")
    ap.add_argument("--device", default="cuda",
                    help="where the fit and the server run (default: the "
                         "card; 'cpu' runs the plain versions)")
    ap.add_argument("--quick", action="store_true",
                    help="small-n smoke preset (n=600 d=8, few rounds)")
    ap.add_argument("--serve-bench", action="store_true",
                    help="after the fit, stand up the continuous-batching "
                         "assignment server over the result and drive it "
                         "with open-loop traffic; prints p50/p99 latency, "
                         "throughput and batch occupancy")
    ap.add_argument("--serve-rate", type=float, default=2000.0,
                    help="--serve-bench open-loop arrival rate (req/s)")
    ap.add_argument("--a-cap", type=int, default=0,
                    help="support capacity override (0 = auto)")
    ap.add_argument("--seeds-per-round", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--online", action="store_true",
                    help="after the fit, drive the online-update round trip:"
                         " insert a jittered delta, commit, roll back and "
                         "re-serve through LiveServing; the post-rollback "
                         "labels must be bit-identical to the pre-insert "
                         "ones")
    # the JAX CLI's flags whose parts are not ported yet: refused in main
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "replicated", "sharded", "mesh",
                             "streamed"])
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--source", default="")
    ap.add_argument("--inject-faults", default="", metavar="SPEC")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--check", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    refused = _unported_flags(args)
    if refused:
        raise NotImplementedError(f"{refused[0]} is not ported yet")
    if args.quick:
        args.n, args.d, args.clusters = 600, 8, 4
        args.rounds = min(args.rounds, 8)
        args.seeds_per_round = min(args.seeds_per_round, 8)

    cluster_size = max(4, int(args.n * 0.4) // args.clusters)
    noise = args.n - args.clusters * cluster_size
    spec = make_blobs_with_noise(args.clusters, cluster_size, noise,
                                 d=args.d, seed=0)
    cfg = ALIDConfig(a_cap=args.a_cap or max(64, cluster_size + 32),
                     delta=128, lsh=auto_lsh_params(spec.points),
                     seeds_per_round=args.seeds_per_round,
                     max_rounds=args.rounds,
                     spec=EngineSpec(backend=args.backend))
    n, d = spec.points.shape
    t0 = time.time()
    res = fit(spec.points, cfg, PRNGKey(0), device=args.device)
    dt = time.time() - t0
    n_members = int((res.labels >= 0).sum())
    print(f"[palid] n={n} d={d} engine={cfg.spec.engine} "
          f"backend={cfg.spec.backend} dtype={cfg.spec.dtype} "
          f"devices=1 shards=0 time={dt:.2f}s clusters={res.n_clusters} "
          f"members={n_members} "
          f"AVG-F={avg_f1_score(spec.labels, res.labels):.3f}")
    if args.serve_bench:
        _serve_bench(res, spec.points, args.serve_rate, device=args.device)
    if args.online:
        _online_demo(res, spec.points, cfg, device=args.device)


def serve_queries(source) -> np.ndarray:
    """The --serve-bench queries: min(n, 1024) distinct rows of the source,
    drawn with numpy seed 0 and sorted, as the JAX CLI draws them."""
    src = as_source(source)
    n_q = min(src.n, SERVE_QUERIES)
    rng = np.random.default_rng(0)
    return src.sample(np.sort(rng.choice(src.n, size=n_q, replace=False)))


def _serve_bench(res, source, rate_hz: float, device="cuda"):
    """Open-loop traffic against the continuous-batching assignment server,
    replaying rows of the just-fitted dataset as queries. Returns
    `run_open_loop`'s result with the batch occupancy, the server's stats
    snapshot and the queries, or None where the fit found no cluster."""
    if res.n_clusters == 0:
        print("[palid] --serve-bench: fit produced 0 clusters, skipping")
        return None
    queries = serve_queries(source)
    n_q = len(queries)
    with ClusterServer(batch_slots=SERVE_SLOTS, queue_limit=max(128, n_q),
                       policy="block", device=device) as server:
        server.add_tenant("default", res)
        # the first batch builds the kernels where they are not built yet
        server.submit(queries[0]).result(timeout=600)
        out = run_open_loop(server, queries, rate_hz)
        occ = server.stats.occupancy(SERVE_SLOTS)
        stats = server.stats.snapshot()
    print(f"[palid] serve n={n_q} rate={rate_hz:.0f}rps "
          f"p50={out['latency_ms_p50']:.2f}ms "
          f"p99={out['latency_ms_p99']:.2f}ms "
          f"tput={out['throughput_rps']:.0f}rps occupancy={occ:.2f}")
    return dict(out, occupancy=occ, stats=stats, queries=queries)


def _online_demo(res, source, cfg, device="cuda") -> None:
    """Insert → commit → rollback → re-serve round trip over the live
    serving stack: the rollback must restore the pre-insert label array
    BIT-IDENTICALLY from the checkpoint snapshot, with the tenant
    hot-swapping versions while submits keep flowing. The epochs go to a
    temporary directory, removed at the end."""
    src = as_source(source)
    pts = np.asarray(src.sample(np.arange(src.n)), np.float32)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="alid_epochs_") as ckpt, \
            ClusterServer(batch_slots=32, queue_limit=256, policy="block",
                          device=device) as server:
        oc = OnlineClustering(res, pts, cfg, ckpt_dir=ckpt, device=device)
        pre_labels = oc.labels.copy()
        base_epoch = oc.epoch_id
        live = LiveServing(server, oc, name="palid")
        live.publish()
        probe = pts[0]
        # the first batch builds the kernels where they are not built yet
        lab_pre = live.submit(probe).result(timeout=600)
        # delta: jittered copies of labeled points, which land inside
        # existing outer ROI balls and exercise the warm-start path
        labeled = np.flatnonzero(pre_labels >= 0)
        take = (labeled[rng.choice(labeled.size, size=min(8, labeled.size),
                                   replace=False)]
                if labeled.size else np.arange(min(8, len(pts))))
        delta = pts[take] + 0.01 * rng.standard_normal(
            (take.size, pts.shape[1])).astype(np.float32)
        ids = oc.insert(delta)
        ep, _ = live.commit_and_publish({"delta": int(ids.size)})
        eid, _ = live.rollback_and_publish(base_epoch)
        lab_post = live.submit(probe).result(timeout=30)
        if not np.array_equal(oc.labels, pre_labels):
            raise RuntimeError("post-rollback labels differ from the "
                               "pre-insert snapshot")
        if lab_post != lab_pre:
            raise RuntimeError(f"the probe served {lab_post} after the "
                               f"rollback, {lab_pre} before")
        info = server.tenant_info()["palid"]
        s = server.stats.snapshot()
    o = oc.stats.snapshot()
    print(f"[palid] online insert={ids.size} routed={o['routed']} "
          f"buffered={o['buffered']} commit=epoch{ep.id} "
          f"rollback=epoch{eid} bit-identical=True "
          f"versions={[r['version'] for r in info]} "
          f"active_epoch={[r['epoch'] for r in info if r['active']][0]} "
          f"swaps={s['version_swaps']} rollbacks={s['rollbacks']}")


if __name__ == "__main__":
    main()
