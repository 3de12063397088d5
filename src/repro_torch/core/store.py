"""ShardedStore and StreamedStore: the out-of-core data layouts behind the
sharded and streamed engines (the JAX package's `core/store.py`).

ALID's space bound is O(a*(a* + delta)): only the LOCAL affinity graph is
ever materialized. These layouts partition the dataset and its LSH into S
fixed-size shards, so the CIVS hot path touches one shard at a time:

  * points are ordered by their projection onto the first LSH direction
    (`pstable.spatial_score`), then cut into contiguous equal shards:
    spatially coherent, so each shard has a tight bounding ball;
  * each shard carries its own sorted-key LSH tables (projections shared)
    and routing metadata (centroid + bounding radius): a CIVS query visits
    a shard only when its ROI ball can intersect the shard's ball, which is
    exact by the triangle inequality.

`ShardedStore` keeps everything on the device; `StreamedStore` keeps only
metadata (the order, the per-shard key tables, the balls, the bucket sizes)
on the host and fetches a shard's rows on demand, through a scratch memmap
(`core.pipeline.ScratchShards`) or from the source.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.pipeline import ScratchShards
from repro_torch.core.source import DataSource, iter_source_chunks
from repro_torch.kernels import ops
from repro_torch.kernels.ref import pinned_sum
from repro_torch.lsh.pstable import (PAD_KEY, LSHParams, ShardedLSHTables,
                                     build_lsh_sharded, hash_chunk,
                                     make_projections, shard_bucket_windows,
                                     spatial_score)


class ShardedStore(NamedTuple):
    shards: torch.Tensor      # (S, cap, d) storage dtype, padded (+0)
    valid: torch.Tensor       # (S, cap) bool, False on padding
    global_idx: torch.Tensor  # (S, cap) int64 data index, -1 on padding
    shard_of: torch.Tensor    # (n,) int64 inverse map: point -> shard
    slot_of: torch.Tensor     # (n,) int64 inverse map: point -> slot
    centers: torch.Tensor     # (S, d) f32 shard centroid
    radii: torch.Tensor       # (S,) f32 bounding radius around it
    tables: ShardedLSHTables

    @property
    def n_shards(self) -> int:
        return self.shards.shape[0]

    @property
    def shard_cap(self) -> int:
        return self.shards.shape[1]

    @property
    def n_points(self) -> int:
        return self.shard_of.shape[0]

    # -- the retrieval substrate (`civs.retrieve_shards`) ------------------
    @property
    def proj(self) -> torch.Tensor:
        return self.tables.proj

    @property
    def bias(self) -> torch.Tensor:
        return self.tables.bias

    def seed_rows(self, idx: torch.Tensor) -> torch.Tensor:
        return take(self, idx)

    def balls(self) -> tuple[np.ndarray, np.ndarray]:
        """The shards' centres (S, d) and radii (S,) on the host, f64."""
        return (self.centers.double().cpu().numpy(),
                self.radii.double().cpu().numpy())

    def windows(self, keys, salts, routed: np.ndarray, probe: int):
        """The routed shards' (R, L, B*q) global probe windows (starts, lo,
        hi), carved over ALL shards as the JAX package's sharded engine
        carves them."""
        rows = torch.as_tensor(routed, device=keys.device)
        return tuple(t[rows] for t in shard_bucket_windows(
            self.tables.sorted_keys, keys, salts, probe))

    def stream(self, routed: np.ndarray):
        """(pos, s, (points, sorted_keys, perm, global_idx)) of each routed
        shard, in routed order."""
        for pos, s in enumerate(routed):
            yield pos, s, (self.shards[s], self.tables.sorted_keys[s],
                           self.tables.perm[s], self.global_idx[s])


def take(store: ShardedStore, idx: torch.Tensor) -> torch.Tensor:
    """Gather point rows by GLOBAL index (the out-of-core points[idx])."""
    safe = torch.clamp(idx.long(), 0, store.n_points - 1)
    return store.shards[store.shard_of[safe], store.slot_of[safe]]


def ball_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a - b|| over the last dim, from the differences (no |a|^2 + |b|^2 -
    2ab cancellation), for the routing balls: the shard radii and the ROI
    ball's distance to a shard's centre."""
    diff = a.float() - b.float()
    return torch.sqrt(pinned_sum(diff * diff))


def _build_store_impl(points: torch.Tensor, params: LSHParams,
                      rng: torch.Tensor, n_shards: int,
                      backend: str = "auto") -> ShardedStore:
    n, d = points.shape
    dev = points.device
    cap = -(-n // n_shards)                    # ceil: the last shard padded
    pad = n_shards * cap - n

    # spatial order along the first LSH direction: the projections are
    # drawn again from the same key, as build_lsh_sharded draws them
    proj, _ = make_projections(rng, params, d, dev)
    order = torch.sort(spatial_score(points, proj[0, 0]), stable=True).indices

    gidx = torch.cat([order, torch.full((pad,), -1, dtype=torch.int64,
                                        device=dev)]).reshape(n_shards, cap)
    valid = gidx >= 0
    shards = torch.where(valid[..., None],
                         points[torch.clamp(gidx, 0, n - 1)], 0.0)

    sid = torch.arange(n_shards, device=dev)[:, None].expand(-1, cap)
    slot = torch.arange(cap, device=dev)[None, :].expand(n_shards, -1)
    safe_g = torch.where(valid, gidx, n).reshape(-1)
    shard_of = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    shard_of[safe_g] = sid.reshape(-1)
    slot_of = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    slot_of[safe_g] = slot.reshape(-1)

    cnt = torch.clamp_min(valid.sum(1), 1)
    # centres in f32 even for bf16 shards (a bf16 row-sum accumulator loses
    # mantissa long before shard_cap rows); the radii are the f32 distances
    # from it to the STORED (rounded) points, so routing stays exact
    centers = shards.float().sum(1) / cnt[:, None].float()
    radii = torch.where(valid, ball_distance(shards, centers[:, None, :]),
                        0.0).amax(1)

    tables = build_lsh_sharded(shards, valid, params, rng, backend)
    return ShardedStore(shards=shards, valid=valid, global_idx=gidx,
                        shard_of=shard_of[:n], slot_of=slot_of[:n],
                        centers=centers, radii=radii, tables=tables)


def build_store(points: torch.Tensor, params: LSHParams, rng: torch.Tensor,
                n_shards: int = 8, backend: str = "auto",
                dtype: str = "float32") -> ShardedStore:
    """Partition `points` + LSH into `n_shards` routing-aware shards on
    `points`' device. Consumes `rng` exactly like `build_lsh`, so a store
    built with the same key is query for query consistent with the
    monolithic tables. `dtype` is the point STORAGE dtype (`ops.DTYPES`):
    points are rounded to it here, BEFORE hashing, so LSH keys match a
    replicated build over the same rounded points bit for bit."""
    points = ops.to_storage(points, dtype)
    n_shards = max(1, min(int(n_shards), points.shape[0]))
    return _build_store_impl(points, params, rng, n_shards, backend)


# ----------------------------------------------------- host-streamed store --
_PAD_KEY_NP = np.uint32(PAD_KEY)
_DEFAULT_CHUNK = 32768


def _round_to_storage(rows: np.ndarray, dtype: str) -> np.ndarray:
    """Round an np.float32 slab to the storage dtype, kept in np.float32.

    numpy has no bf16, so streamed slabs stay np.float32 on the host but
    hold bf16-ROUNDED values: f32 -> bf16 -> f32 is an exact round trip, so
    the device-side cast of an uploaded slab recovers the stored bf16 bits,
    and every engine sees the same rounded points."""
    if ops.storage_dtype(dtype) == torch.float32:
        return rows
    return ops.to_storage(torch.from_numpy(np.ascontiguousarray(
        rows, np.float32)), dtype).float().numpy()


class StreamedStore(NamedTuple):
    """Host-resident analogue of ShardedStore for the streamed engine.

    The O(n d) payload never leaves the source: a shard's rows are fetched
    on demand (`shard_points`) and copied to the device one shard at a time
    by the engine's CIVS loop. The store keeps metadata only: the spatial
    order, the per-shard sorted-key tables ((S, L, cap) uint32), the
    bounding balls and the global table-0 bucket sizes. The (L, m, d)
    projections live on the device, so query hashing is the other engines'.
    """
    source: DataSource
    order: np.ndarray        # (n,) int32 spatial order
    global_idx: np.ndarray   # (S, cap) int32 shard slot -> original index
    valid: np.ndarray        # (S, cap) bool
    sorted_keys: np.ndarray  # (S, L, cap) uint32, ascending per (shard, table)
    perm: np.ndarray         # (S, L, cap) int32 sorted pos -> slot, -1 pad
    centers: np.ndarray      # (S, d) f64 shard centroids
    radii: np.ndarray        # (S,) f64 bounding radii
    bucket_sizes: np.ndarray  # (n,) int32 global table-0 bucket sizes
    proj: torch.Tensor       # (L, m, d) on the device
    bias: torch.Tensor       # (L, m)
    # the reordered payloads persisted at build (None: every fetch
    # re-gathers from the source)
    scratch: Optional[ScratchShards] = None
    # (S,) int64 per-shard mutation counters (`update_shard_points`): a
    # cached bundle filled at an older generation is dropped on its probe
    generations: Optional[np.ndarray] = None
    dtype: str = "float32"

    @property
    def n_shards(self) -> int:
        return self.global_idx.shape[0]

    @property
    def shard_cap(self) -> int:
        return self.global_idx.shape[1]

    @property
    def n_points(self) -> int:
        return self.order.shape[0]

    @property
    def dim(self) -> int:
        return self.source.dim

    def shard_count(self, s: int) -> int:
        return int(self.valid[s].sum())

    def shard_points(self, s: int) -> np.ndarray:
        """One shard's rows, zero-padded to (shard_cap, d): one sequential
        slab read with scratch, else a re-gather from the source. The bytes
        are the same either way."""
        if self.scratch is not None:
            return self.scratch.read(s)
        return self.gather_shard_points(s)

    def gather_shard_points(self, s: int) -> np.ndarray:
        """Re-gather one shard's rows from the SOURCE, bypassing scratch:
        the bottom of the pipeline's tier chain. Valid as a fallback only at
        generation 0 (`ShardPipeline._read_points` enforces that)."""
        m = self.shard_count(s)
        out = np.zeros((self.shard_cap, self.dim), np.float32)
        out[:m] = _round_to_storage(
            np.asarray(self.source.sample(self.global_idx[s, :m]),
                       np.float32), self.dtype)
        return out


def build_store_streamed(source: DataSource, params: LSHParams,
                         rng: torch.Tensor, n_shards: int = 8,
                         chunk_size: int = 0,
                         scratch_dir: Optional[str] = None,
                         backend: str = "auto", dtype: str = "float32",
                         device="cpu") -> StreamedStore:
    """Build the streamed store shard by shard from source chunks.

    Two passes, neither holding more than O(chunk) rows on the device or
    the host (beyond the int32 / uint32 metadata):

      1. chunked hashing: each chunk is hashed ONCE on `device` through
         `pstable.hash_chunk` (keys and the spatial score, both bit-equal
         to a whole-dataset pass); keys land in a host (L, n) uint32 table
         and the host sorts the (n,) scores stably into the shard order;
      2. per shard: gather its <= cap rows from the source (for the
         bounding ball, and the scratch slab when `scratch_dir` is not
         None; "" = the system temp dir), sort the per-table keys stably
         into shard-local tables, and take the bounding ball (f64 centroid,
         exact max radius).

    Consumes `rng` exactly like `build_lsh` / `build_store`; the global
    table-0 bucket sizes are re-aggregated from the per-shard tables, equal
    to the replicated engine's integer for integer. `dtype` is the storage
    dtype: chunks are rounded to it BEFORE hashing (and hashed in it), and
    the scratch slabs persist the rounded values (`_round_to_storage`).
    """
    ops.storage_dtype(dtype)      # validate the knob up front
    chunk_size = int(chunk_size) or _DEFAULT_CHUNK
    n, d = source.n, source.dim
    n_shards = max(1, min(int(n_shards), n))
    cap = -(-n // n_shards)
    n_tables = params.n_tables
    dev = torch.device(device)
    proj, bias = make_projections(rng, params, d, dev)

    scores = np.empty((n,), np.float32)
    keys_full = np.empty((n_tables, n), np.uint32)
    for start, block in iter_source_chunks(source, chunk_size):
        block32 = np.asarray(block, np.float32)
        kk, sc = hash_chunk(ops.to_storage(torch.as_tensor(block32,
                                                           device=dev),
                                           dtype),
                            proj, bias, params.seg_len, backend)
        stop = start + block.shape[0]
        keys_full[:, start:stop] = kk.cpu().numpy().astype(np.uint32)
        scores[start:stop] = sc.cpu().numpy()
    order = np.argsort(scores, kind="stable").astype(np.int32)

    global_idx = np.full((n_shards, cap), -1, np.int32)
    valid = np.zeros((n_shards, cap), bool)
    sorted_keys = np.full((n_shards, n_tables, cap), _PAD_KEY_NP, np.uint32)
    perm = np.full((n_shards, n_tables, cap), -1, np.int32)
    centers = np.zeros((n_shards, d), np.float64)
    radii = np.zeros((n_shards,), np.float64)

    scratch = (ScratchShards.create(n_shards, cap, d, scratch_dir)
               if scratch_dir is not None else None)

    slot = np.arange(cap)
    for s in range(n_shards):
        idx = order[s * cap:min((s + 1) * cap, n)]
        m = idx.shape[0]
        rows = _round_to_storage(np.asarray(source.sample(idx), np.float32),
                                 dtype)
        if scratch is not None:
            scratch.write(s, rows)
        global_idx[s, :m] = idx
        valid[s, :m] = True
        kfull = np.full((n_tables, cap), _PAD_KEY_NP, np.uint32)
        kfull[:, :m] = keys_full[:, idx]
        o = np.argsort(kfull, axis=1, kind="stable").astype(np.int32)
        sorted_keys[s] = np.take_along_axis(kfull, o, axis=1)
        perm[s] = np.where(np.take_along_axis(
            np.broadcast_to((slot < m)[None], (n_tables, cap)), o, axis=1),
            o, -1)
        rows64 = rows.astype(np.float64)
        centers[s] = rows64.mean(axis=0)
        radii[s] = float(np.sqrt(
            ((rows64 - centers[s]) ** 2).sum(-1)).max())

    keys0 = keys_full[0]
    bsizes = np.zeros((n,), np.int64)
    for s in range(n_shards):
        sk0 = sorted_keys[s, 0]
        bsizes += (np.searchsorted(sk0, keys0, side="right")
                   - np.searchsorted(sk0, keys0, side="left"))

    if scratch is not None:
        scratch.flush()
    return StreamedStore(source=source, order=order, global_idx=global_idx,
                         valid=valid, sorted_keys=sorted_keys, perm=perm,
                         centers=centers, radii=radii,
                         bucket_sizes=bsizes.astype(np.int32),
                         proj=proj, bias=bias, scratch=scratch,
                         generations=np.zeros((n_shards,), np.int64),
                         dtype=dtype)


def update_shard_points(store: StreamedStore, s: int,
                        rows: np.ndarray) -> int:
    """Mutate one shard's resident payload in place (online deltas).

    Writes the full (shard_cap, d) zero-padded slab to the scratch memmap
    (the source is read-only, so mutation needs scratch persistence) and
    bumps the shard's generation, so no cached bundle of the old bytes is
    served again. Returns the new generation."""
    if store.scratch is None:
        raise ValueError(
            "update_shard_points needs scratch persistence: build the "
            "store with scratch_dir=... (the DataSource is read-only)")
    if store.generations is None:
        raise ValueError("store predates generation counters: rebuild "
                         "with build_store_streamed")
    rows = _round_to_storage(np.asarray(rows, np.float32), store.dtype)
    if rows.shape != (store.shard_cap, store.dim):
        raise ValueError(f"expected a full ({store.shard_cap}, {store.dim}) "
                         f"zero-padded slab, got {rows.shape}")
    store.scratch.write(s, rows)
    store.generations[s] += 1
    return int(store.generations[s])


def global_bucket_sizes(store: ShardedStore) -> torch.Tensor:
    """Per data item: the size of its table-0 bucket across ALL shards.

    The projections are shared, so the monolithic bucket of key k is the
    disjoint union of the per-shard buckets of k: summing per-shard counts
    reproduces `bucket_sizes(build_lsh(...))` without the monolithic table
    (PALID seeding, paper Sec. 4.6). (n,) int32."""
    n = store.n_points
    sk0 = store.tables.sorted_keys[:, 0, :]                   # (S, cap)
    perm0 = store.tables.perm[:, 0, :]
    safe_slot = torch.clamp(perm0, 0, store.shard_cap - 1)
    g_of_sorted = torch.gather(store.global_idx, 1, safe_slot)
    g_of_sorted = torch.where(perm0 >= 0, g_of_sorted, n)     # drop pads
    keys = torch.zeros(n + 1, dtype=sk0.dtype, device=sk0.device)
    keys[g_of_sorted.reshape(-1)] = sk0.reshape(-1)
    keys = keys[:n].unsqueeze(0).expand(sk0.shape[0], -1).contiguous()
    counts = (torch.searchsorted(sk0.contiguous(), keys, side="right")
              - torch.searchsorted(sk0.contiguous(), keys, side="left"))
    return counts.sum(0).to(torch.int32)
