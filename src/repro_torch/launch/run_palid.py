"""PALID launcher on the port: dominant-cluster detection over synthetic
SIFT-like blobs (paper Sec. 5.3), or over a real dataset through the
DataSource API (--source), on the replicated, sharded, mesh or streamed
engine; with --serve-bench the continuous-batching assignment server over the
result, driven by open-loop traffic; with --online the online-update round
trip (insert, commit, rollback, re-serve) over `LiveServing`; with
--inject-faults the fit again under injected faults, whose labels must be
bit-identical to the clean run's. It prints the lines the JAX package's
`python -m repro.launch.run_palid` prints.

  # on the card
  PYTHONPATH=src python -m repro_torch.launch.run_palid --serve-bench
  PYTHONPATH=src python -m repro_torch.launch.run_palid \\
      --source memmap:descriptors.npy --engine streamed --shards 16
  # the small preset on the CPU, through the plain versions
  PYTHONPATH=src python -m repro_torch.launch.run_palid --quick \\
      --device cpu --engine streamed --shards 4 --profile \\
      --inject-faults transient:0.1,corrupt:0.05,kill-reader:3

  # bf16 point storage (the JAX CLI's --dtype), on the card
  PYTHONPATH=src python -m repro_torch.launch.run_palid --quick \
      --dtype bfloat16

  # the mesh engine over 2 spawned ranks: one card each over NCCL, or
  # gloo processes on the CPU; --shards splits the store over them
  PYTHONPATH=src python -m repro_torch.launch.run_palid --quick \
      --device cpu --devices 2 --shards 4

With --devices D (or --engine mesh) the CLI spawns D ranks itself
(`distributed.spawn.run_ranks`, a file:// rendezvous in a temp dir); every
rank fits the same data, and rank 0's lines are printed here, the serving
and online arms running here on its result. The JAX CLI's flag that needs
a part not ported yet (--check, the contract checker) raises
NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.alid import ALIDConfig, EngineSpec
from repro_torch.core.engine import fit, make_engine
from repro_torch.core.online import OnlineClustering
from repro_torch.core.resilience import (FaultySource, PipelineFaults,
                                         RetryPolicy)
from repro_torch.core.source import (as_source, make_source,
                                     strided_sample_indices)
from repro_torch.data import auto_lsh_params, make_blobs_with_noise
from repro_torch.distributed.spawn import rank_devices, run_ranks
from repro_torch.random import PRNGKey
from repro_torch.serve import ClusterServer, LiveServing, run_open_loop
from repro_torch.utils import avg_f1_score

SERVE_SLOTS = 64
SERVE_QUERIES = 1024


def _unported_flags(args) -> list[str]:
    """The given flags of the JAX CLI whose parts are not ported yet, each
    with its ROADMAP item."""
    checks = [
        (args.check, "--check, the contract checker (ROADMAP A15)"),
    ]
    return [what for given, what in checks if given]


def engine_spec(engine: str, shards: int, chunk_size: int = 0,
                cache_bytes: int = EngineSpec._field_defaults["cache_bytes"],
                prefetch_depth: int = (
                    EngineSpec._field_defaults["prefetch_depth"]),
                scratch_dir: str = "", backend: str = "auto",
                dtype: str = "float32", devices: int = 0) -> EngineSpec:
    """Resolve --engine (+ --devices / --shards) into an EngineSpec:
    "auto" is the mesh engine with --devices > 1, else the sharded engine
    when --shards is given, else the replicated one. The mesh engine's
    mesh is the spawned ranks' world (`spec.mesh_ctx=None`), its store
    replicated or, with --shards, split over the ranks. The pipeline knobs
    matter for engine="streamed" only: `cache_bytes` bounds the host LRU
    of shard bundles, `prefetch_depth` sizes the reader's slot ring (0 =
    synchronous), `scratch_dir` places the build-time scratch memmap (""
    = system temp dir, "none" disables persistence)."""
    scratch = None if scratch_dir == "none" else scratch_dir
    if engine == "auto":
        if devices > 1:
            engine = "mesh"
        elif shards > 0:
            engine = "sharded"
        else:
            engine = "replicated"
    if engine == "mesh":
        return EngineSpec(engine="mesh", n_shards=shards,
                          chunk_size=chunk_size, backend=backend,
                          dtype=dtype)
    if engine == "streamed":
        # 0 lets StreamedEngine apply its own default (8 shards)
        return EngineSpec(engine="streamed", n_shards=shards,
                          chunk_size=chunk_size, cache_bytes=cache_bytes,
                          prefetch_depth=prefetch_depth, scratch_dir=scratch,
                          backend=backend, dtype=dtype)
    if engine == "sharded":
        return EngineSpec(engine="sharded", n_shards=max(1, shards),
                          chunk_size=chunk_size, backend=backend,
                          dtype=dtype)
    return EngineSpec(engine=engine, chunk_size=chunk_size, backend=backend,
                      dtype=dtype)


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
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "replicated", "sharded", "mesh",
                             "streamed"],
                    help="EngineSpec.engine; 'auto' = 'mesh' with "
                         "--devices > 1, else 'sharded' with --shards, "
                         "else 'replicated'")
    ap.add_argument("--shards", type=int, default=0,
                    help="ShardedStore / StreamedStore shard count (0 = "
                         "the replicated engine under --engine auto)")
    ap.add_argument("--source", default="",
                    help="ingest a dataset instead of the synthetic blobs: "
                         "'memmap:path.npy' (out of core) or 'npy:path.npy'"
                         " (in host memory); --n/--d/--clusters are ignored")
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="host chunk rows of the streamed store's build "
                         "(0 = default)")
    ap.add_argument("--cache-bytes", type=int,
                    default=EngineSpec._field_defaults["cache_bytes"],
                    help="streamed engine: host LRU budget of shard bundles "
                         "in bytes (<= 0 disables the cache)")
    ap.add_argument("--prefetch-depth", type=int,
                    default=EngineSpec._field_defaults["prefetch_depth"],
                    help="streamed engine: slot-ring depth of the shard "
                         "reader (0 = synchronous, no reader thread)")
    ap.add_argument("--scratch-dir", default="",
                    help="streamed engine: directory of the build-time "
                         "scratch memmap ('' = system temp dir, 'none' = "
                         "no persistence)")
    ap.add_argument("--profile", action="store_true",
                    help="print the pipeline stage report (read / put / "
                         "compute / wait seconds, cache and prefetch hits) "
                         "after the fit")
    ap.add_argument("--inject-faults", default="", metavar="SPEC",
                    help="re-run the fit under injected faults and check "
                         "its labels against the clean run's. SPEC is "
                         "comma-separated name:value pairs: 'transient:0.1'"
                         " (seeded transient read-error rate), 'corrupt:"
                         "0.05' (scratch-slab corruption rate per fetch; "
                         "streamed engine with scratch), 'kill-reader:3' "
                         "(kill the prefetch reader at the k-th bundle; "
                         "streamed with prefetch). Prints "
                         "'fault-parity=True'")
    ap.add_argument("--checkpoint-dir", default="",
                    help="persist round-level fit state here every "
                         "--checkpoint-every rounds; with --inject-faults "
                         "also a crash-at-round-2 + resume arm, printing "
                         "'resume-parity=True'")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="rounds between fit checkpoints (default 1)")
    ap.add_argument("--resume", action="store_true",
                    help="resume the fit from the latest intact checkpoint "
                         "in --checkpoint-dir (bit-identical to the "
                         "uninterrupted run)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="point STORAGE dtype (EngineSpec.dtype): bfloat16 "
                         "halves the points' device memory; k, distances, "
                         "affinities and the LID state stay f32")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks of the mesh engine (0 = one process, no "
                         "mesh): the CLI spawns them itself, one card a "
                         "rank over NCCL on the card, gloo processes with "
                         "--device cpu; --shards must divide over them")
    # the JAX CLI's flag whose part is not ported yet: refused in main
    ap.add_argument("--check", action="store_true")
    return ap.parse_args(argv)


def _data(args):
    """(source, planted spec or None, LSH params, a_cap) of the run."""
    if args.source:
        source = make_source(args.source)
        # calibrate the LSH scale on a strided subsample, never the file
        lshp = auto_lsh_params(
            source.sample(strided_sample_indices(source.n, 512)))
        return source, None, lshp, args.a_cap or 128
    cluster_size = max(4, int(args.n * 0.4) // args.clusters)
    noise = args.n - args.clusters * cluster_size
    spec = make_blobs_with_noise(args.clusters, cluster_size, noise,
                                 d=args.d, seed=0)
    return (spec.points, spec, auto_lsh_params(spec.points),
            args.a_cap or max(64, cluster_size + 32))


def main(argv=None) -> None:
    args = parse_args(argv)
    refused = _unported_flags(args)
    if refused:
        raise NotImplementedError(f"{refused[0]} is not ported yet")
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume needs --checkpoint-dir")
    if args.quick:
        args.n, args.d, args.clusters = 600, 8, 4
        args.rounds = min(args.rounds, 8)
        args.seeds_per_round = min(args.seeds_per_round, 8)

    spec_ = engine_spec(args.engine, args.shards, args.chunk_size,
                        args.cache_bytes, args.prefetch_depth,
                        args.scratch_dir, args.backend, args.dtype,
                        args.devices)
    n_ranks = max(args.devices, 1)
    if spec_.engine == "mesh":
        devices = rank_devices(args.device, n_ranks)
        if args.shards % n_ranks:
            raise ValueError(f"--shards {args.shards} does not split over "
                             f"--devices {n_ranks}")
    source, spec, lshp, a_cap = _data(args)
    cfg = ALIDConfig(a_cap=a_cap, delta=128, lsh=lshp,
                     seeds_per_round=args.seeds_per_round,
                     max_rounds=args.rounds, spec=spec_)
    if spec_.engine == "mesh":
        # every rank fits the same data with this cfg; rank 0's result
        # and lines come back here
        res, fit_lines, chaos_lines = run_ranks(
            _mesh_rank, n_ranks, args, cfg, devices=devices)[0]
        print(fit_lines, end="")
    else:
        res = _fit(args, cfg, source, spec, args.device)
        chaos_lines = ""
    if args.serve_bench:
        _serve_bench(res, source, args.serve_rate, device=args.device)
    if args.online:
        _online_demo(res, source, cfg, device=args.device)
    if spec_.engine == "mesh":
        print(chaos_lines, end="")
    elif args.inject_faults:
        _chaos_demo(res, source, cfg, args, args.device)


def _fit(args, cfg, source, spec, device, n_ranks: int = 1):
    """The fit and its [palid] line (and --profile's), on `device`."""
    # the engine is made here, so that --profile can read its stage
    # counters after the fit; closing it is then ours
    engine = make_engine(cfg.spec, device=device)
    try:
        t0 = time.time()
        res = fit(source, cfg, PRNGKey(0), engine=engine,
                  checkpoint_dir=args.checkpoint_dir or None,
                  checkpoint_every=args.checkpoint_every,
                  resume=args.resume)
        dt = time.time() - t0
        n_members = int((res.labels >= 0).sum())
        n, d = as_source(source).n, as_source(source).dim
        line = (f"[palid] n={n} d={d} engine={cfg.spec.engine} "
                f"backend={cfg.spec.backend} dtype={cfg.spec.dtype} "
                f"devices={n_ranks} shards={args.shards} time={dt:.2f}s "
                f"clusters={res.n_clusters} members={n_members}")
        if spec is not None:
            line += f" AVG-F={avg_f1_score(spec.labels, res.labels):.3f}"
        print(line)
        if args.profile:
            stats = getattr(engine, "stats", None)
            print(f"[palid] {stats.report()}" if stats is not None else
                  f"[palid] --profile: engine {cfg.spec.engine!r} has no "
                  "pipeline stats (streamed only)")
    finally:
        engine.close()
    return res


def _mesh_rank(rank: int, world: int, args, cfg):
    """One rank of `run_palid --devices`: the fit (and the chaos arm) on
    this rank's device. Rank 0 returns (result, fit lines, chaos lines);
    the others' output is dropped."""
    device = (f"cuda:{torch.cuda.current_device()}"
              if torch.device(args.device).type == "cuda" else args.device)
    source, spec, _, _ = _data(args)
    fit_out, chaos_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(fit_out):
        res = _fit(args, cfg, source, spec, device, world)
    if args.inject_faults:
        with contextlib.redirect_stdout(chaos_out):
            _chaos_demo(res, source, cfg, args, device)
    if rank:
        return None
    return res, fit_out.getvalue(), chaos_out.getvalue()


def _parse_faults(spec: str) -> dict:
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, value = part.partition(":")
        if name not in ("transient", "corrupt", "kill-reader"):
            raise SystemExit(
                f"--inject-faults: unknown fault {name!r} (expected "
                "transient|corrupt|kill-reader)")
        out[name] = float(value) if value else 0.0
    return out


def _chaos_demo(clean, source, cfg, args, device) -> dict:
    """Re-run the finished fit under injected faults; its labels must be
    BIT-IDENTICAL to the clean result's. With --checkpoint-dir, also crash
    at round 2 and resume. Prints one line with 'fault-parity=' (and
    'resume-parity='); returns what it printed as a dict."""
    faults = _parse_faults(args.inject_faults)
    fast = RetryPolicy(base_delay=0.001, max_delay=0.05)
    faulty = FaultySource(as_source(source),
                          rate=faults.get("transient", 0.0), seed=1)
    engine = make_engine(cfg.spec, device=device)
    if faults.get("corrupt", 0.0) > 0.0 or "kill-reader" in faults:
        engine.faults = PipelineFaults(
            corrupt_rate=faults.get("corrupt", 0.0),
            kill_reader_at=int(faults.get("kill-reader", -1.0)), seed=2)
    try:
        res = fit(faulty, cfg, PRNGKey(0), engine=engine, retry_policy=fast)
        stats = getattr(engine, "stats", None)
        corruptions = int(stats.corruptions) if stats is not None else 0
        deaths = int(stats.reader_deaths) if stats is not None else 0
    finally:
        engine.close()
    out = dict(injected=faulty.injected, corruptions=corruptions,
               reader_deaths=deaths,
               fault_parity=bool(np.array_equal(clean.labels, res.labels)
                                 and res.n_rounds == clean.n_rounds))
    resume_txt = ""
    if args.checkpoint_dir:
        ckpt = os.path.join(args.checkpoint_dir, "chaos")
        try:
            fit(source, cfg, PRNGKey(0), checkpoint_dir=ckpt,
                checkpoint_every=args.checkpoint_every, crash_at_round=2,
                device=device)
        except RuntimeError as exc:
            if "injected crash" not in str(exc):
                raise
        resumed = fit(source, cfg, PRNGKey(0), checkpoint_dir=ckpt,
                      resume=True, device=device)
        out["resume_parity"] = bool(
            np.array_equal(clean.labels, resumed.labels)
            and resumed.n_rounds == clean.n_rounds)
        resume_txt = f" resume-parity={out['resume_parity']}"
    print(f"[palid] chaos faults={args.inject_faults!r} "
          f"injected={out['injected']} corruptions={corruptions} "
          f"reader_deaths={deaths} retries_ok=True "
          f"fault-parity={out['fault_parity']}{resume_txt}")
    return out


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
