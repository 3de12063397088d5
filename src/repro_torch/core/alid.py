"""ALID, the complete algorithm (paper Alg. 2): config, the batched ALID run
from a batch of seeds, bucket-based seed sampling (Sec. 4.6), and the
`Clustering` result object.

One ALID instance iterates (LID -> ROI -> CIVS) from a seed vertex until the
local dense subgraph is immune against everything the ROI can still add, or
c > C. The JAX package vmaps instances over a batch of seeds; here the batch
is the lanes of every tensor, each lane with its own done mask, and each
outer iteration runs only on the lanes still going. The peel-reduce driver
lives in `repro_torch.core.engine`; `assign_labels` is the one assignment
path of `Clustering.predict` and the serving layer (`repro_torch.serve`).
`detect_clusters` and `detect_clusters_sharded` are the JAX package's
deprecated shims over `engine.fit`.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core.civs import civs_update, top_k
from repro_torch.core.lid import (density, init_state_from, lid_solve,
                                  put_lanes, take_lanes)
from repro_torch.core.pipeline import DEFAULT_CACHE_BYTES
from repro_torch.core.roi import estimate_roi
from repro_torch.core.source import (InMemorySource, is_data_source,
                                     iter_source_chunks)
from repro_torch.kernels import ops
from repro_torch.lsh.pstable import LSHParams, LSHTables


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


class EngineSpec(NamedTuple):
    """Declarative engine selection, folded into ALIDConfig.

    engine:   "replicated": the full dataset and the monolithic LSH tables
              on one device; "sharded": the out-of-core ShardedStore on the
              device, CIVS probes one shard at a time; "streamed": a
              host-resident StreamedStore fed by a DataSource, the CIVS
              shard loop on the host uploading one routed shard at a time,
              so peak device memory is O(shard + cap); "mesh": PALID over
              the ranks of a process group (`torch.distributed`), each
              rank running its block of every round's seeds against a
              replicated store or, with n_shards > 0, the shards split
              over the ranks (`core.store.MeshStore`).
    n_shards: store shard count (sharded: at least 1; streamed: 0 = 8;
              mesh: 0 = the replicated store, else a multiple of the
              data-axes size).
    chunk_size: host chunk rows of the streamed store's build (0 = 32,768).
    cache_bytes: host LRU budget for streamed shard bundles
              (`core.pipeline.ShardBundleCache`); <= 0 disables the cache.
    prefetch_depth: slot-ring depth of the streamed engine's shard reader
              thread: the read and upload of shard s+1 overlap the compute
              of shard s, and peak device memory grows to (depth + 1)
              shards. 0 = the synchronous two-slot path (no reader).
    scratch_dir: where the streamed store persists its reordered shard
              payloads at build ("" = the system temp dir), so steady-state
              shard reads are sequential slabs; None re-gathers shards from
              the source. The engine's close() unlinks the file.
    backend:  kernel backend for every hot-path op: "auto" (the CUDA kernels
              for tensors on the card, the plain versions on the CPU), "ref"
              (the plain PyTorch versions anywhere) or "kernel". See
              `repro_torch.kernels.ops.resolve_backend`.
    dtype:    point STORAGE dtype, "float32" or "bfloat16" (`kernels.ops.
              DTYPES`): the points, the store shards and the LID support
              blocks are rounded to it once, after k is estimated from the
              unrounded source and before hashing, which halves their
              device memory at bf16; every distance / affinity contraction
              and the LID state (x, Ax, pi) stay f32, each kernel widening
              the rows it reads. The supports a fit exports are f32 rows of
              the source, as in the JAX package.
    mesh_ctx: the mesh engine's `distributed.MeshContext` (seeds split
              over its data axes); None = a one-axis "data" mesh over the
              whole initialized process group.
    """
    engine: str = "replicated"
    n_shards: int = 0
    chunk_size: int = 0
    cache_bytes: int = DEFAULT_CACHE_BYTES
    prefetch_depth: int = 2
    scratch_dir: Optional[str] = ""
    backend: str = "auto"
    dtype: str = "float32"
    mesh_ctx: Optional[Any] = None


class ALIDConfig(NamedTuple):
    """Static algorithm configuration (hashable)."""
    k: float | None = None        # Laplacian scale; None -> estimate_k at setup
    p: float = 2.0                # norm (paper uses p=2 in all experiments)
    a_cap: int = 64               # max support (cluster) size tracked
    delta: int = 128              # paper's delta: max CIVS retrievals
    t_lid: int = 256              # LID iteration cap (paper's T)
    c_outer: int = 16             # ALID iteration cap (paper's C)
    tol: float = 1e-5
    support_eps: float = 1e-6
    density_min: float = 0.75     # paper: keep clusters with pi(x) >= 0.75
    r0: float = 0.4               # paper: ROI radius for c == 1
    stop_frac: float = 0.95       # declare global immunity once R >= frac*R_out
    lsh: LSHParams = LSHParams()
    seeds_per_round: int = 32
    max_rounds: int = 128
    min_bucket: int = 5           # paper: seed from buckets with > 5 items
    exhaustive: bool = False      # peel until no active point remains
    spec: EngineSpec = EngineSpec()
    sweep_steps: int = 8          # LID iterations fused per lid_sweep launch
    refresh_every: int = 0        # in-sweep exact Ax refresh period (0 = off)

    @property
    def cap(self) -> int:
        return self.a_cap + self.delta

    @property
    def backend(self) -> str:
        """Kernel backend (EngineSpec.backend — one knob for every op)."""
        return self.spec.backend

    @property
    def dtype(self) -> str:
        """Point storage dtype (EngineSpec.dtype): float32 | bfloat16."""
        return self.spec.dtype


class SeedResult(NamedTuple):
    member_idx: torch.Tensor   # (B, cap) global indices of the final beta
    member_w: torch.Tensor     # (B, cap) weights (support = w > support_eps)
    member_mask: torch.Tensor  # (B, cap) validity & support
    density: torch.Tensor      # (B,) pi(x*)
    n_outer: torch.Tensor      # (B,) ALID iterations used
    overflow: torch.Tensor     # (B,) support hit a_cap


def assign_labels(q, sup_v, sup_w, densities, k, threshold: float,
                  backend: str = "auto", valid=None,
                  device="cuda") -> np.ndarray:
    """Label queries by max weighted support affinity, -1 below the bar.

    Shared by `Clustering.predict` and the serving layer. Array arguments
    may be numpy arrays or tensors; tensors already on `device` are used in
    place, which is how `serve.batching.Tenant` keeps the supports resident
    on the card instead of uploading them per batch. The score, argmax and
    threshold chain is one kernel-layer op (`ops.assign_clusters`).

    `valid` ((m,) bool, optional) is the slot-validity mask of a padded
    fixed-shape batch: pad slots come out -1, real slots are bitwise the
    unmasked call's. Returns host int32 labels (the call is synchronous).
    """
    dev = resolve_device(device)

    def on(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    labels, _ = ops.assign_clusters(
        on(q, torch.float32), on(sup_v, torch.float32),
        on(sup_w, torch.float32), on(densities, torch.float32), k,
        threshold, None if valid is None else on(valid, torch.bool),
        backend=backend)
    return labels.cpu().numpy()


def assign_labels_source(source, sup_v, sup_w, densities, k,
                         threshold: float, batch_size: int = 0,
                         backend: str = "auto",
                         device="cuda") -> np.ndarray:
    """Bulk assignment: label every row of a DataSource against the
    supports in fixed-shape batches of `batch_size` rows (0 = 4096), the
    tail zero-padded to the same shape and sliced off. The supports go to
    the device once; peak memory is O(batch x C x A), never O(n)."""
    bs = int(batch_size) or 4096
    dev = resolve_device(device)
    sup_v, sup_w, densities = (torch.as_tensor(x, dtype=torch.float32,
                                               device=dev)
                               for x in (sup_v, sup_w, densities))
    out = np.empty((source.n,), np.int32)
    for start, block in iter_source_chunks(source, bs):
        m = block.shape[0]
        q = block if m == bs else np.concatenate(
            [block, np.zeros((bs - m, source.dim), np.float32)], axis=0)
        out[start:start + m] = assign_labels(q, sup_v, sup_w, densities, k,
                                             threshold, backend,
                                             device=dev)[:m]
    return out


def _npz_path(path) -> str:
    """np.savez's suffix rule, applied symmetrically on save and load."""
    p = os.fspath(path)
    return p if p.endswith(".npz") else p + ".npz"


class Clustering(NamedTuple):
    """Clustering result: labels + per-cluster weighted supports, with the
    same .npz layout as the JAX package's, so a file saved by either loads
    in the other. The supports make it self-contained: `predict` assigns
    new points without the original dataset."""
    labels: np.ndarray      # (n,) int32, -1 = unclustered / noise
    densities: np.ndarray   # (n_clusters,)
    n_rounds: int
    k: float
    support_idx: Optional[np.ndarray] = None  # (C, cap) int32, -1 pad
    support_w: Optional[np.ndarray] = None    # (C, cap) f32, simplex per row
    support_v: Optional[np.ndarray] = None    # (C, cap, d) f32, 0 on pad

    @property
    def n_clusters(self) -> int:
        return int(len(self.densities))

    def predict(self, queries, threshold: float = 0.5, batch_size: int = 0,
                backend: str = "auto", device="cuda") -> np.ndarray:
        """Assign queries to the detected dominant clusters; -1 = none.

        A query joins the cluster of maximal weighted support affinity
        sum_j w_j exp(-k ||q - v_j||) (paper Eq. 1 against the stored
        support, O(C x cap) per query whatever n was), if that score is at
        least `threshold * densities[c]`; far-away noise decays to ~0 and
        stays unassigned.

        `queries` is an (m, d) array or a DataSource (e.g. a MemmapSource).
        Arrays go in one call when `batch_size` is 0 or covers them, else
        in `batch_size`-row batches; a source goes in batches of
        `batch_size` rows (0 = 4096). Runs on `device` (the card unless
        the caller asks for the CPU)."""
        if not is_data_source(queries):
            q = np.atleast_2d(np.asarray(queries, np.float32))
            if self.support_v is None or self.n_clusters == 0:
                return np.full((q.shape[0],), -1, np.int32)
            if not batch_size or batch_size >= q.shape[0]:
                return assign_labels(q, self.support_v, self.support_w,
                                     self.densities, self.k, threshold,
                                     backend, device=device)
            queries = InMemorySource(q)
        if self.support_v is None or self.n_clusters == 0:
            return np.full((queries.n,), -1, np.int32)
        return assign_labels_source(queries, self.support_v, self.support_w,
                                    self.densities, self.k, threshold,
                                    batch_size, backend, device=device)

    def to_dict(self) -> dict:
        out = {
            "labels": np.asarray(self.labels, np.int32),
            "densities": np.asarray(self.densities, np.float32),
            "n_rounds": np.int32(self.n_rounds),
            "k": np.float32(self.k),
        }
        if self.support_idx is not None:
            out["support_idx"] = np.asarray(self.support_idx, np.int32)
            out["support_w"] = np.asarray(self.support_w, np.float32)
            out["support_v"] = np.asarray(self.support_v, np.float32)
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "Clustering":
        return cls(
            labels=np.asarray(d["labels"], np.int32),
            densities=np.asarray(d["densities"], np.float32),
            n_rounds=int(d["n_rounds"]),
            k=float(d["k"]),
            support_idx=np.asarray(d["support_idx"], np.int32)
            if "support_idx" in d else None,
            support_w=np.asarray(d["support_w"], np.float32)
            if "support_w" in d else None,
            support_v=np.asarray(d["support_v"], np.float32)
            if "support_v" in d else None,
        )

    def save(self, path) -> str:
        """Write the result as .npz and return the path written."""
        path = _npz_path(path)
        np.savez(path, **self.to_dict())
        return path

    @classmethod
    def load(cls, path) -> "Clustering":
        with np.load(_npz_path(path)) as z:
            return cls.from_dict({k: z[k] for k in z.files})


def alid_from_seed(points, active: torch.Tensor, tables: LSHTables | None,
                   seed_idx: torch.Tensor, k: float,
                   cfg: ALIDConfig) -> SeedResult:
    """Alg. 2: one complete ALID run from each seed of seed_idx:(B,).

    `points` is the replicated (n, d) tensor with its monolithic `tables`,
    or a shard substrate (`tables=None`), a ShardedStore, a MeshStore or
    the streamed engine: its `seed_rows` gives the seeds' rows and CIVS
    probes its shards (`civs.retrieve_shards`). The lanes follow the JAX
    package's vmap of a while loop: an outer iteration runs on every lane
    with ~done & c <= C, and a lane that has stopped keeps its state."""
    if isinstance(points, torch.Tensor):
        rows = points[seed_idx.long()]
    else:
        rows = points.seed_rows(seed_idx)
    state = init_state_from(rows, seed_idx, cfg.cap)
    dev = rows.device
    bsz = seed_idx.shape[0]
    c = torch.ones(bsz, dtype=torch.int32, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    overflow = torch.zeros(bsz, dtype=torch.bool, device=dev)
    solve = dict(max_iters=cfg.t_lid, tol=cfg.tol, p=cfg.p,
                 backend=cfg.backend, sweep_steps=cfg.sweep_steps,
                 refresh_every=cfg.refresh_every, support_eps=cfg.support_eps)
    # a substrate split over ranks (`core.store.MeshStore`) runs its CIVS
    # steps in lockstep: every rank goes on while any rank has a live lane
    lockstep = getattr(points, "lockstep", None)
    while True:
        lanes = torch.nonzero((~done) & (c <= cfg.c_outer))[:, 0]
        if lockstep is None:
            if lanes.numel() == 0:
                break
        elif not lockstep(lanes.numel()):
            break
        elif lanes.numel() == 0:
            continue                  # took part in the step's collectives
        sub = lid_solve(take_lanes(state, lanes), k, **solve)
        cl = c[lanes]
        roi = estimate_roi(sub.v_beta, sub.beta_idx, sub.beta_mask, sub.x, k,
                           cl, r0=cfg.r0, p=cfg.p,
                           support_eps=cfg.support_eps, backend=cfg.backend)
        res = civs_update(sub, roi, points, active, tables, cfg.lsh, k,
                          a_cap=cfg.a_cap, delta=cfg.delta, tol=cfg.tol,
                          support_eps=cfg.support_eps, p=cfg.p,
                          backend=cfg.backend)
        # Global immunity: nothing infective was retrievable AND the ROI has
        # essentially reached the outer ball (Prop. 1 then guarantees no
        # infective vertex exists anywhere)
        grown = roi.radius >= cfg.stop_frac * roi.r_out
        stop = (~res.infective_found) & (grown | (res.n_candidates == 0)) \
            & (cl > 1)
        state = put_lanes(state, lanes, res.state)
        c[lanes] = cl + 1
        done[lanes] = stop
        overflow[lanes] |= res.overflow
    # final polish: converge LID on the last beta
    state = lid_solve(state, k, **solve)

    sup = state.beta_mask & (state.x > cfg.support_eps)
    return SeedResult(
        member_idx=torch.where(sup, state.beta_idx, -1),
        member_w=torch.where(sup, state.x, 0.0),
        member_mask=sup,
        density=density(state),
        n_outer=c - 1,
        overflow=overflow,
    )


def _sample_seeds(active: torch.Tensor, bsizes: torch.Tensor,
                  rng: torch.Tensor, cfg: ALIDConfig):
    """Gumbel-top-k sampling, biased to large LSH buckets (paper Sec. 4.6).
    Returns (seeds (S,) int32, valid (S,) bool, any_eligible bool)."""
    eligible = active & (bsizes > cfg.min_bucket)
    any_eligible = bool(eligible.any())
    w = torch.where(eligible, 1.0, torch.where(active, 1e-6, 0.0))
    logw = torch.where(w > 0, torch.log(w), float("-inf"))
    g = trandom.gumbel(rng, logw.shape, device=active.device)
    vals, seeds = top_k(logw + g, cfg.seeds_per_round)
    return seeds.to(torch.int32), vals > float("-inf"), any_eligible


# --------------------------------------------------------------------------
# Deprecated entry points — thin shims over repro_torch.core.engine.fit, as
# the JAX package keeps them. New code sets ALIDConfig.spec and calls fit().
# --------------------------------------------------------------------------

def detect_clusters(points, cfg: ALIDConfig, rng, n_shards: int = 0,
                    device="cuda") -> Clustering:
    """Deprecated: use `repro_torch.core.engine.fit` with
    `ALIDConfig.spec`. A replicated fit, or a sharded one on `n_shards`
    shards when n_shards > 0; the rest of cfg.spec is replaced, as in the
    JAX package."""
    warnings.warn(
        "detect_clusters is deprecated; use repro_torch.core.engine.fit "
        "with ALIDConfig(spec=EngineSpec(engine='replicated'|'sharded', "
        "...))", DeprecationWarning, stacklevel=2)
    from repro_torch.core.engine import fit
    spec = (EngineSpec(engine="sharded", n_shards=int(n_shards))
            if n_shards > 0 else EngineSpec(engine="replicated"))
    return fit(points, cfg._replace(spec=spec), rng, device=device)


def detect_clusters_sharded(points, cfg: ALIDConfig, rng, n_shards: int = 8,
                            device="cuda") -> Clustering:
    """Deprecated: use `repro_torch.core.engine.fit` with
    engine="sharded" (at least one shard)."""
    warnings.warn(
        "detect_clusters_sharded is deprecated; use "
        "repro_torch.core.engine.fit with ALIDConfig(spec=EngineSpec("
        "engine='sharded', n_shards=...))", DeprecationWarning, stacklevel=2)
    from repro_torch.core.engine import fit
    spec = EngineSpec(engine="sharded", n_shards=max(1, int(n_shards)))
    return fit(points, cfg._replace(spec=spec), rng, device=device)
