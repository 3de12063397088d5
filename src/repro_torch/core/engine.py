"""The fit: ONE host peel-reduce loop over four engines.

`fit` runs the host-level peeling loop of paper Sec. 4.4: rounds of batched
seeds, each resolved by the PALID reducer (Sec. 4.6): a point belongs to the
claiming instance of maximum density, exact ties broken toward the larger
seed row id. That reducer exists once (`resolve_claims`). The random stream
is consumed as the JAX package consumes it (one split for the store build,
one per round for seeding, drawn a round ahead), so on tie-free data the
port and the JAX package find the same clusters, on every engine.

Engines differ only in where the retrieval substrate lives:

  * ReplicatedEngine  the full dataset + monolithic LSH on the device;
  * ShardedEngine     the out-of-core `ShardedStore` on the device, CIVS
                      probes one shard at a time;
  * MeshEngine        PALID over the ranks of a process group: each rank
                      maps its block of the round's seeds, the results
                      are all-gathered and reduced on every rank; the
                      store replicated or split over the ranks
                      (`MeshStore`);
  * StreamedEngine    the ALID outer loop on the HOST over a host-resident
                      `StreamedStore`: one routed shard at a time is
                      uploaded through the shard pipeline
                      (`core.pipeline`), so peak device memory is
                      O((prefetch_depth + 1) shards + cap).

Resilience: `fit` wraps its source for transient-read retries
(`core.resilience`), and with `checkpoint_dir` saves its round-level state
through `checkpoint.manager`, in the JAX package's layout: either package
resumes the other's fit.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`), which then runs every op's plain PyTorch version.
"""

from __future__ import annotations

import concurrent.futures
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import random as trandom
from repro_torch.core.affinity import estimate_k
from repro_torch.core.alid import (ALIDConfig, Clustering, EngineSpec,
                                   SeedResult, _sample_seeds, alid_from_seed,
                                   resolve_device)
from repro_torch.core.pipeline import PipelineStats, ShardPipeline, Uploader
from repro_torch.core.resilience import (DEFAULT_RETRY, ResilientSource,
                                         RetryPolicy, resilient)
from repro_torch.core.source import (DataSource, as_source,
                                     strided_sample_indices)
from repro_torch.core.store import (build_mesh_store, build_store,
                                    build_store_streamed,
                                    global_bucket_sizes)
from repro_torch.distributed.context import all_gather, axis_group
from repro_torch.kernels import ops
from repro_torch.lsh.pstable import (bucket_sizes, build_lsh,
                                     shard_bucket_windows_host)

__all__ = ["EngineSpec", "Clustering", "fit", "make_engine",
           "resolve_claims", "ReplicatedEngine", "ShardedEngine",
           "MeshEngine", "StreamedEngine"]

# rows drawn for k estimation when cfg.k is None (estimate_k's default)
_K_SAMPLE = 512


def resolve_claims(member_idx: torch.Tensor, member_mask: torch.Tensor,
                   dens: torch.Tensor, seed_valid: torch.Tensor, n: int):
    """THE claim reducer (paper Sec. 4.6): segment-max over all (seed row,
    member) claims; each point goes to the claiming instance of maximum
    density, exact ties (within 1e-9) to the larger seed row id.

    member_idx/member_mask: (s, cap); dens/seed_valid: (s,).
    Returns (claimed (n,) bool, best_row (n,) int32, best_dens (n,) f32)."""
    s_batch, cap = member_idx.shape
    dev = member_idx.device
    flat_idx = member_idx.reshape(-1).long()
    flat_valid = member_mask.reshape(-1) & (flat_idx >= 0)
    flat_valid &= seed_valid.repeat_interleave(cap)
    flat_dens = dens.float().repeat_interleave(cap)
    safe = torch.clamp(flat_idx, 0, n - 1)

    best_dens = torch.full((n,), float("-inf"), device=dev).scatter_reduce(
        0, safe, torch.where(flat_valid, flat_dens, float("-inf")), "amax")
    flat_row = torch.arange(s_batch, dtype=torch.int32,
                            device=dev).repeat_interleave(cap)
    is_winner = flat_valid & (flat_dens >= best_dens[safe] - 1e-9)
    best_row = torch.full((n,), -1, dtype=torch.int32,
                          device=dev).scatter_reduce(
        0, safe, torch.where(is_winner, flat_row, -1), "amax")
    return best_row >= 0, best_row, best_dens


class _EngineBase:
    """build_source() ingests a DataSource (consuming rng exactly once),
    after which `k` and `bucket_sizes` are available; run_round() maps a
    batch of seeds and resolves their claims through `resolve_claims`."""

    def __init__(self, spec: EngineSpec = EngineSpec(), device="cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.k: Optional[float] = None
        self._cfg: Optional[ALIDConfig] = None
        self._n = 0
        self._bsizes: Optional[torch.Tensor] = None

    def _setup_k(self, source: DataSource, cfg: ALIDConfig) -> None:
        """k from a STRIDED subsample drawn through the source (the same
        indices on every engine), or cfg.k rounded to f32."""
        self._cfg = cfg
        self._n = source.n
        if cfg.k is not None:
            self.k = float(np.float32(cfg.k))
        else:
            idx = strided_sample_indices(source.n, _K_SAMPLE)
            self.k = estimate_k(torch.as_tensor(source.sample(idx),
                                                device=self.device),
                                backend=cfg.backend)

    def build_source(self, source: DataSource, cfg: ALIDConfig,
                     rng: torch.Tensor) -> None:
        """Sample k from the UNROUNDED source, then materialize it on the
        device in the storage dtype (rounded block by block on the way, so
        a bf16 store never holds an f32 copy on the device) and build (the
        replicated and sharded engines are device-resident; the streamed
        engine overrides this)."""
        self._setup_k(source, cfg)
        self.build(ops.to_storage(
            torch.as_tensor(source.get_chunk(0, source.n),
                            dtype=torch.float32),
            cfg.spec.dtype, self.device), cfg, rng)

    @property
    def bucket_sizes(self) -> torch.Tensor:
        if self._bsizes is None:
            raise RuntimeError("call build_source() first")
        return self._bsizes

    def prepare_round(self, seeds) -> None:
        """Round-level overlap hook: the fit loop announces the seed batch it
        SPECULATES the next round will use while the current round runs.
        Device-resident engines have nothing to prepare."""

    def close(self) -> None:
        """Release engine-held resources (device slots, caches, scratch
        files, worker threads). `fit` calls this on the way out for an
        engine it made."""

    # fit checkpoints: the engines of one process write them; the mesh
    # engine lets one rank write and holds the others until it has
    writes_checkpoints = True

    def sync(self) -> None:
        """Wait for the engine's peers (a no-op on one process)."""

    def _reduce(self, results: SeedResult, seed_valid: torch.Tensor):
        claimed, best_row, _ = resolve_claims(
            results.member_idx, results.member_mask, results.density,
            seed_valid, self._n)
        return claimed, best_row, results


class ReplicatedEngine(_EngineBase):
    """Full dataset + monolithic LSH tables in one device's memory."""

    def build(self, points: torch.Tensor, cfg: ALIDConfig,
              rng: torch.Tensor) -> None:
        # rounded to the storage dtype BEFORE hashing (k was estimated from
        # the unrounded source, identically on every engine)
        self.points = ops.to_storage(points, cfg.spec.dtype)
        self.tables = build_lsh(self.points, cfg.lsh, rng, cfg.backend)
        self._bsizes = bucket_sizes(self.tables)

    def run_round(self, active: torch.Tensor, seeds: torch.Tensor,
                  seed_valid: torch.Tensor):
        results = alid_from_seed(self.points, active, self.tables, seeds,
                                 self.k, self._cfg)
        return self._reduce(results, seed_valid)


class ShardedEngine(_EngineBase):
    """Out-of-core ShardedStore on the device: CIVS probes one shard at a
    time, so the live candidate state is O(shard + cap), not O(n)."""

    def build(self, points: torch.Tensor, cfg: ALIDConfig,
              rng: torch.Tensor) -> None:
        self.store = build_store(points, cfg.lsh, rng,
                                 n_shards=max(1, self.spec.n_shards),
                                 backend=cfg.backend, dtype=cfg.spec.dtype)
        self._bsizes = global_bucket_sizes(self.store)

    def run_round(self, active: torch.Tensor, seeds: torch.Tensor,
                  seed_valid: torch.Tensor):
        results = alid_from_seed(self.store, active, None, seeds, self.k,
                                 self._cfg)
        return self._reduce(results, seed_valid)


class MeshEngine(_EngineBase):
    """PALID over the ranks of a process group (paper Sec. 4.6, Alg. 3; the
    JAX package's `MeshEngine`). SPMD: every rank runs `fit` on the same
    data, cfg and rng, so every rank builds the same k, LSH tables and
    seeds. A round's seed batch splits over the data axes in contiguous
    blocks (rank r runs seeds[r*B/W:(r+1)*B/W], the order of the JAX
    engine's P("data")) through `alid_from_seed`; every `SeedResult` leaf
    is all-gathered in rank order, and every rank resolves the one
    `resolve_claims` over the whole batch, so the global seed row breaks
    exact density ties as on one device. Every rank returns the same
    `Clustering`.

    The store is replicated on every rank, or (n_shards > 0) a
    `core.store.MeshStore`: the shards split over the ranks, each built
    and held only by its owner, each routed shard broadcast from its
    owner during a CIVS step. With
    `spec.mesh_ctx=None` the mesh is one "data" axis over the whole
    initialized group (`launch.mesh.data_context`). Fit checkpoints are
    written by group rank 0 only and read by every rank."""

    def _setup_mesh(self, cfg: ALIDConfig) -> None:
        from repro_torch.launch.mesh import data_context
        self.ctx = self.spec.mesh_ctx or data_context(self.device.type)
        n_data = self.ctx.n_data
        if cfg.seeds_per_round % n_data:
            raise ValueError(f"seeds_per_round={cfg.seeds_per_round} does "
                             f"not split over {n_data} data ranks")
        if self.spec.n_shards % n_data:
            raise ValueError(f"n_shards={self.spec.n_shards} does not "
                             f"split over {n_data} data ranks")
        self.group = axis_group(self.ctx.mesh, self.ctx.data_axes)
        self.rank = dist.get_rank(self.group)

    def build_source(self, source: DataSource, cfg: ALIDConfig,
                     rng: torch.Tensor) -> None:
        """The replicated store as the replicated engine builds it; the
        split store (n_shards > 0) from the source, each rank uploading
        only its own shards (`build_mesh_store`)."""
        self._setup_mesh(cfg)
        if self.spec.n_shards == 0:
            super().build_source(source, cfg, rng)
            return
        self._setup_k(source, cfg)
        self.points = self.tables = None
        self.store = build_mesh_store(
            source, cfg.lsh, rng, self.spec.n_shards, self.group,
            backend=cfg.backend, dtype=cfg.spec.dtype, device=self.device,
            chunk_size=self.spec.chunk_size)
        self._bsizes = self.store.bucket_sizes

    def build(self, points: torch.Tensor, cfg: ALIDConfig,
              rng: torch.Tensor) -> None:
        self.store = None
        self.points = ops.to_storage(points, cfg.spec.dtype)
        self.tables = build_lsh(self.points, cfg.lsh, rng, cfg.backend)
        self._bsizes = bucket_sizes(self.tables)

    @property
    def writes_checkpoints(self) -> bool:
        return self.rank == 0

    def sync(self) -> None:
        dist.barrier(group=self.group)

    def run_round(self, active: torch.Tensor, seeds: torch.Tensor,
                  seed_valid: torch.Tensor):
        b = seeds.shape[0] // self.ctx.n_data
        mine = seeds[self.rank * b:(self.rank + 1) * b]
        if self.store is not None:
            local = alid_from_seed(self.store, active, None, mine, self.k,
                                   self._cfg)
        else:
            local = alid_from_seed(self.points, active, self.tables, mine,
                                   self.k, self._cfg)
        results = SeedResult(*(all_gather(t, self.group) for t in local))
        return self._reduce(results, seed_valid)


class StreamedEngine(_EngineBase):
    """Host-streamed out-of-core engine: the dataset stays behind a
    DataSource, the store (`core.store.StreamedStore`) is built shard by
    shard from source chunks, and the ALID outer loop runs on the HOST over
    the live lanes. Shard I/O goes through `core.pipeline.ShardPipeline`:
    payloads persist once to a scratch memmap at build, hot bundles sit in
    a bounded host LRU, and (prefetch_depth >= 1) a reader thread walks
    each CIVS pass's ROUTED shard list ahead of the compute, uploading
    bundles into a depth-k slot ring. Peak device memory is
    O((prefetch_depth + 1) shards + cap); peak host memory adds the LRU
    budget.

    The PRNG schedule, the seeding statistics (exact global bucket sizes),
    the chunk step (`civs.retrieve_chunk`, shared with ShardedEngine) and
    the claim reducer are the other engines', and the pipeline consumes
    shards in routed order whatever their arrival, so on tie-free data the
    streamed engine gives the replicated engine's labels."""

    def __init__(self, spec: EngineSpec = EngineSpec(), device="cuda"):
        super().__init__(spec, device)
        self.stats = PipelineStats()
        self._pipeline: Optional[ShardPipeline] = None
        self._store = None
        self._executor = None               # round-overlap seed prefetch
        self._seed_uploader = Uploader(self.device, 3)
        # fault-injection hooks (core.resilience.PipelineFaults): set BEFORE
        # build_source / fit to install them on the shard pipeline
        self.faults = None
        # checksum verification on scratch / cache reads
        self.verify_checksums = True
        # pending (seeds_np, Future[(rows, event)]) pairs, newest last: the
        # current round's rows and the next round's speculation
        self._prepared: list = []

    def build_source(self, source, cfg, rng):
        if isinstance(source, ResilientSource):
            # transient source errors absorbed under fit's retry policy
            # count in this engine's read_retries too
            source.retry_hooks.append(
                lambda attempt, exc: self.stats.add("read_retries"))
        self._setup_k(source, cfg)
        self._store = build_store_streamed(
            source, cfg.lsh, rng, n_shards=max(1, self.spec.n_shards or 8),
            chunk_size=self.spec.chunk_size,
            scratch_dir=self.spec.scratch_dir, backend=cfg.backend,
            dtype=cfg.spec.dtype, device=self.device)
        self._bsizes = torch.as_tensor(self._store.bucket_sizes,
                                       device=self.device)
        self._pipeline = ShardPipeline(
            self._store, cache_bytes=self.spec.cache_bytes,
            prefetch_depth=self.spec.prefetch_depth, stats=self.stats,
            faults=self.faults, verify_checksums=self.verify_checksums,
            device=self.device)

    def build(self, points, cfg, rng):
        self.build_source(as_source(torch.as_tensor(points).cpu().numpy()),
                          cfg, rng)

    def run_round(self, active, seeds, seed_valid):
        # the engine is the retrieval substrate: alid_from_seed takes the
        # seed rows from `seed_rows` and CIVS streams its shards
        results = alid_from_seed(self, active, None, seeds, self.k,
                                 self._cfg)
        return self._reduce(results, seed_valid)

    def prepare_round(self, seeds) -> None:
        """Round-level overlap: fetch the NEXT round's seed rows (a
        scattered source read) and upload them in the background while the
        current round's shards stream. `seed_rows` uses the prepared rows
        only for a batch equal to the one announced."""
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="alid-seed-prefetch")
        seeds_np = np.array(torch.as_tensor(seeds).cpu().numpy(), copy=True)

        def fetch(idx=seeds_np):
            rows = np.asarray(self._store.source.sample(idx), np.float32)
            return self._seed_uploader.upload((rows,))

        self._prepared.append((seeds_np, self._executor.submit(fetch)))
        del self._prepared[:-2]     # current round + one speculation ahead

    def close(self) -> None:
        """Release the slot ring, staging buffers and host LRU, the seed
        prefetch thread and the scratch memmap (unlinked). Idempotent."""
        self._prepared.clear()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        if self._pipeline is not None:
            self._pipeline.release()
        store = self._store
        if store is not None and store.scratch is not None:
            store.scratch.close()

    # -- the retrieval substrate (`civs.retrieve_shards`) ------------------
    def seed_rows(self, seeds) -> torch.Tensor:
        """The seeds' rows from the source, rounded to storage on the
        device (the source holds the unrounded points)."""
        seeds_np = torch.as_tensor(seeds).cpu().numpy()
        for i, (prep_np, fut) in enumerate(self._prepared):
            if np.array_equal(prep_np, seeds_np):
                # older entries go too: rounds only move forward
                self._prepared = self._prepared[i + 1:]
                self.stats.add("seed_prefetch_hits")
                return ops.to_storage(Uploader.ready(*fut.result())[0],
                                      self._store.dtype)
        # an invalidated speculation, or the first round
        self.stats.add("seed_prefetch_misses")
        return ops.to_storage(
            torch.as_tensor(self._store.source.sample(seeds_np),
                            dtype=torch.float32, device=self.device),
            self._store.dtype)

    @property
    def proj(self) -> torch.Tensor:
        return self._store.proj

    @property
    def bias(self) -> torch.Tensor:
        return self._store.bias

    def balls(self) -> tuple[np.ndarray, np.ndarray]:
        """The shards' centres and radii, host f64 metadata."""
        return self._store.centers, self._store.radii

    def routed(self, touch: np.ndarray) -> np.ndarray:
        """The shards some lane's ROI ball meets, ascending."""
        return np.flatnonzero(touch.any(axis=0))

    def windows(self, keys, salts, routed: np.ndarray, probe: int):
        """The global probe windows carved on the host over the ROUTED
        shards only: an unrouted shard holds no point of any lane's ROI, so
        the probe budget goes to the reachable shards (the JAX package's
        streamed engine does the same)."""
        host = shard_bucket_windows_host(
            self._store.sorted_keys[routed],
            keys.cpu().numpy().astype(np.uint32),
            salts.cpu().numpy().astype(np.uint32), probe)
        return tuple(torch.as_tensor(t.astype(np.int64), device=self.device)
                     for t in host)

    def stream(self, routed: np.ndarray):
        """The routed shards through the pipeline, in routed order; the
        time the caller spends on a shard counts as `compute_s`. A shard's
        slab holds storage-rounded f32 values (`store._round_to_storage`)
        and is cast to the storage dtype on the device, exactly."""
        for pos, s, (pts, *rest) in self._pipeline.stream(routed):
            t0 = time.perf_counter()
            yield pos, s, (ops.to_storage(pts, self._store.dtype), *rest)
            self.stats.add("compute_s", time.perf_counter() - t0)


_ENGINES = {
    "replicated": ReplicatedEngine,
    "sharded": ShardedEngine,
    "mesh": MeshEngine,
    "streamed": StreamedEngine,
}


def make_engine(spec: EngineSpec, device="cuda") -> _EngineBase:
    """Instantiate the engine an EngineSpec names (unbuilt)."""
    if spec.engine not in _ENGINES:
        raise ValueError(f"unknown engine {spec.engine!r}; expected one of "
                         f"{sorted(_ENGINES)}")
    ops.storage_dtype(spec.dtype)      # validate the knob up front
    return _ENGINES[spec.engine](spec, device)


# ----------------------------------------------------------- the fit loop --
def _save_fit_checkpoint(ckpt_dir: str, rounds: int, labels, active_np, rng,
                         seeds, seed_valid, any_eligible, densities,
                         sup_idx, sup_w, sup_v, next_label: int,
                         cap: int, d: int) -> None:
    """Persist the fit loop's round-level state (the resume point after round
    `rounds`) in the JAX package's layout: the labels and active mask, the
    PRNG chain value as jax's uint32 key words, the ALREADY-SAMPLED
    next-round seed batch, and the peeled supports."""
    from repro_torch.checkpoint.manager import save_checkpoint
    tree = {
        "labels": labels,
        "active": active_np,
        "rng": torch.as_tensor(rng).cpu().numpy().astype(np.uint32),
        "seeds": torch.as_tensor(seeds).cpu().numpy().astype(np.int32),
        "seed_valid": torch.as_tensor(seed_valid).cpu().numpy(),
        "densities": np.asarray(densities, np.float32),
        "sup_idx": (np.stack(sup_idx) if sup_idx
                    else np.zeros((0, cap), np.int32)),
        "sup_w": (np.stack(sup_w) if sup_w
                  else np.zeros((0, cap), np.float32)),
        "sup_v": (np.stack(sup_v).astype(np.float32) if sup_v
                  else np.zeros((0, cap, d), np.float32)),
    }
    save_checkpoint(ckpt_dir, rounds, tree, metadata={
        "kind": "alid-fit", "round": int(rounds),
        "next_label": int(next_label), "any_eligible": bool(any_eligible),
        "n": int(labels.shape[0])})


def _restore_fit_checkpoint(ckpt_dir: str):
    """The latest INTACT fit checkpoint: steps are tried newest first, and
    a step whose bytes fail their crc32 (or cannot be read) is skipped with
    a warning."""
    from repro_torch.checkpoint.manager import (CheckpointCorruption,
                                                list_checkpoints,
                                                restore_checkpoint_tree)
    for step in reversed(list_checkpoints(ckpt_dir)):
        try:
            manifest, tree = restore_checkpoint_tree(ckpt_dir, step)
        except (CheckpointCorruption, OSError, KeyError, ValueError) as exc:
            warnings.warn(
                f"fit checkpoint step {step} is unusable ({exc}); falling "
                "back to the previous one", RuntimeWarning)
            continue
        if manifest.get("metadata", {}).get("kind") != "alid-fit":
            raise ValueError(
                f"checkpoint step {step} in {ckpt_dir!r} is not a fit-loop "
                f"checkpoint (kind="
                f"{manifest.get('metadata', {}).get('kind')!r})")
        return manifest, tree
    return None, None


def fit(data, cfg: ALIDConfig = ALIDConfig(),
        rng: Optional[torch.Tensor] = None,
        engine: Optional[_EngineBase] = None, *,
        retry_policy: Optional[RetryPolicy] = DEFAULT_RETRY,
        checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
        resume: bool = False, crash_at_round: int = 0,
        device="cuda") -> Clustering:
    """Dominant-cluster detection: THE host peel-reduce loop (Sec. 4.4).

    `data` is a DataSource or an (n, d) array; the loop touches rows only
    through the source, so on the streamed engine a memmapped dataset is
    never materialized. Rounds of batched seeds (sampled from large LSH
    buckets) run on the engine `cfg.spec` selects; claims resolve through
    `resolve_claims`; claimed points + seeds are peeled until no
    dominant-cluster candidate remains (or, with cfg.exhaustive, no active
    point at all). `rng` is a `repro_torch.random.PRNGKey`.

    While round r runs, round r+1's seeds are sampled against `active`
    minus round r's seeds and announced to the engine (`prepare_round`);
    the speculation is exact unless a speculated winner was claimed, which
    the loop checks, resampling with the same key.

    Pass a made `engine` to keep it after fit returns (to read
    `StreamedEngine.stats`): the caller then owns `engine.close()`.

    Resilience: the source is wrapped so every read retries transient
    `OSError`s under `retry_policy` (None disables). With `checkpoint_dir`
    the round-level state is saved every `checkpoint_every` rounds;
    `resume=True` restores the latest intact checkpoint and continues, with
    labels bit-identical to the uninterrupted run. `crash_at_round=r`
    raises at the START of round r (the chaos tests' crash)."""
    source = resilient(as_source(data), retry_policy)
    rng = trandom.PRNGKey(0) if rng is None else rng
    owns_engine = engine is None
    if engine is None:
        engine = make_engine(cfg.spec, device)
    # refuse a norm the kernels do not compute before building anything
    ops.check_norm(ops.resolve_backend(
        cfg.backend, torch.empty(0, device=engine.device)), cfg.p, "fit")
    try:
        keys = trandom.split(rng)
        rng, kb = keys[0], keys[1]
        engine.build_source(source, cfg, kb)
        return _fit_loop(source, cfg, rng, engine,
                         checkpoint_dir=checkpoint_dir,
                         checkpoint_every=max(1, int(checkpoint_every)),
                         resume=resume, crash_at_round=int(crash_at_round))
    finally:
        if owns_engine:
            engine.close()


def _fit_loop(source: DataSource, cfg: ALIDConfig, rng: torch.Tensor,
              engine: _EngineBase, checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 1, resume: bool = False,
              crash_at_round: int = 0) -> Clustering:
    n = source.n
    dev = engine.device
    bsizes = engine.bucket_sizes
    bsizes_np = bsizes.cpu().numpy()
    stats = getattr(engine, "stats", None)
    cap, d = cfg.cap, source.dim

    restored = None
    if resume:
        if checkpoint_dir is None:
            raise ValueError("fit(resume=True) needs checkpoint_dir=...")
        manifest, tree = _restore_fit_checkpoint(checkpoint_dir)
        if manifest is not None:
            meta = manifest["metadata"]
            if int(meta["n"]) != n:
                raise ValueError(
                    f"checkpoint in {checkpoint_dir!r} was written for "
                    f"n={meta['n']} points, this fit has n={n}")
            restored = (meta, tree)

    if restored is not None:
        meta, tree = restored
        labels = np.array(tree["labels"], np.int32)
        active_np = np.array(tree["active"], bool)
        active = torch.as_tensor(active_np, device=dev)
        # the restored key REPLACES the local chain: the build split already
        # happened in fit(), and the saved key is the original run's value
        # after round r
        rng = torch.as_tensor(np.asarray(tree["rng"]).astype(np.int64))
        seeds = torch.as_tensor(np.asarray(tree["seeds"], np.int32),
                                device=dev)
        seed_valid = torch.as_tensor(np.asarray(tree["seed_valid"], bool),
                                     device=dev)
        densities = [float(x) for x in tree["densities"]]
        sup_idx = [np.asarray(r, np.int32) for r in tree["sup_idx"]]
        sup_w = [np.asarray(r, np.float32) for r in tree["sup_w"]]
        sup_v = [np.asarray(r, np.float32) for r in tree["sup_v"]]
        next_label = int(meta["next_label"])
        any_eligible = bool(meta["any_eligible"])
        start_round = int(meta["round"])
    else:
        active_np = np.ones((n,), bool)
        active = torch.as_tensor(active_np, device=dev)
        labels = np.full((n,), -1, np.int32)
        densities, sup_idx, sup_w, sup_v = [], [], [], []
        next_label = 0
        start_round = 0
        keys = trandom.split(rng)
        rng, kr = keys[0], keys[1]
        seeds, seed_valid, any_eligible = _sample_seeds(active, bsizes, kr,
                                                        cfg)
    rounds = start_round

    for rounds in range(start_round + 1, cfg.max_rounds + 1):
        if crash_at_round and rounds == crash_at_round:
            raise RuntimeError(f"injected crash at round {rounds}")
        valid_np = seed_valid.cpu().numpy()
        if not valid_np.any():
            break
        if not cfg.exhaustive and not any_eligible:
            break
        seeds_np = seeds.cpu().numpy()
        peeled_seeds = seeds_np[valid_np]

        # speculative round r+1 sampling, drawn BEFORE round r runs: the
        # seeds themselves are sure to peel, claims are checked below
        keys = trandom.split(rng)
        rng, kr_next = keys[0], keys[1]
        spec_active = active.clone()
        spec_active[torch.as_tensor(peeled_seeds, device=dev).long()] = False
        spec_seeds, spec_valid, _ = _sample_seeds(spec_active, bsizes,
                                                  kr_next, cfg)
        engine.prepare_round(spec_seeds)
        if stats is not None:
            stats.add("rounds_speculated")

        claimed, best_row, results = engine.run_round(active, seeds,
                                                      seed_valid)

        claimed_np = claimed.cpu().numpy()
        row_np = best_row.cpu().numpy()
        dens_np = results.density.cpu().numpy()
        member_np = results.member_idx.cpu().numpy()
        weight_np = results.member_w.cpu().numpy()
        # peel everything claimed + the seeds themselves
        new_inactive = claimed_np.copy()
        new_inactive[peeled_seeds] = True
        active_np &= ~new_inactive
        active = torch.as_tensor(active_np, device=dev)

        # the speculation is exact unless a speculated winner was claimed
        spec_np = spec_seeds.cpu().numpy()[spec_valid.cpu().numpy()]
        if claimed_np[spec_np].any():
            spec_seeds, spec_valid, _ = _sample_seeds(active, bsizes,
                                                      kr_next, cfg)
            engine.prepare_round(spec_seeds)
            if stats is not None:
                stats.add("rounds_resampled")
        seeds, seed_valid = spec_seeds, spec_valid
        any_eligible = bool((active_np & (bsizes_np > cfg.min_bucket)).any())

        # labels for winning rows that clear the density threshold, in one
        # segment pass (rows in ascending order)
        claimed_pts = np.where(claimed_np)[0]
        grp = np.argsort(row_np[claimed_pts], kind="stable")
        sorted_pts = claimed_pts[grp]
        uniq_rows, counts = np.unique(row_np[claimed_pts],
                                      return_counts=True)
        keep = (dens_np[uniq_rows] >= cfg.density_min) & (counts > 1)
        lab = np.full(uniq_rows.shape[0], -1, np.int32)
        lab[keep] = next_label + np.arange(int(keep.sum()), dtype=np.int32)
        labels[sorted_pts] = np.repeat(lab, counts)
        for row in uniq_rows[keep]:
            densities.append(float(dens_np[row]))
            midx, mw = member_np[row], weight_np[row]
            valid = (midx >= 0) & (mw > 0)
            w = np.where(valid, mw, 0.0).astype(np.float32)
            w /= max(float(w.sum()), 1e-12)
            sup_idx.append(np.where(valid, midx, -1).astype(np.int32))
            sup_w.append(w)
            sup_v.append(np.asarray(
                source.sample(np.clip(midx, 0, n - 1)), np.float32)
                * valid[:, None])
        next_label += int(keep.sum())
        if not active_np.any():
            break
        # the round-level resume point, saved only when the loop goes on,
        # so a resumed run re-enters at round + 1 where this run did
        if checkpoint_dir is not None and rounds % checkpoint_every == 0:
            if engine.writes_checkpoints:
                _save_fit_checkpoint(checkpoint_dir, rounds, labels,
                                     active_np, rng, seeds, seed_valid,
                                     any_eligible, densities, sup_idx,
                                     sup_w, sup_v, next_label, cap, d)
            engine.sync()

    return Clustering(
        labels=labels,
        densities=np.asarray(densities, np.float32),
        n_rounds=rounds,
        k=float(engine.k),
        support_idx=(np.stack(sup_idx) if sup_idx
                     else np.zeros((0, cap), np.int32)),
        support_w=(np.stack(sup_w) if sup_w
                   else np.zeros((0, cap), np.float32)),
        support_v=(np.stack(sup_v).astype(np.float32) if sup_v
                   else np.zeros((0, cap, d), np.float32)),
    )
