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
import torch.distributed as dist

from repro_torch.core.pipeline import ScratchShards
from repro_torch.core.source import DataSource, iter_source_chunks
from repro_torch.distributed.context import (all_gather, all_reduce_max,
                                             broadcast)
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

    def routed(self, touch: np.ndarray) -> np.ndarray:
        """The shards some lane's ROI ball meets, ascending."""
        return np.flatnonzero(touch.any(axis=0))

    def windows(self, keys, salts, routed: np.ndarray, probe: int):
        """The routed shards' (R, L, B*q) global probe windows (starts, lo,
        hi), carved over ALL shards as the JAX package's sharded engine
        carves them."""
        return _windows(self.tables.sorted_keys, keys, salts, routed, probe)

    def stream(self, routed: np.ndarray):
        """(pos, s, (points, sorted_keys, perm, global_idx)) of each routed
        shard, in routed order."""
        for pos, s in enumerate(routed):
            yield pos, s, (self.shards[s], self.tables.sorted_keys[s],
                           self.tables.perm[s], self.global_idx[s])


def _windows(sorted_keys, keys, salts, routed: np.ndarray, probe: int):
    rows = torch.as_tensor(routed, device=keys.device)
    return tuple(t[rows] for t in shard_bucket_windows(
        sorted_keys, keys, salts, probe))


class MeshStore:
    """A ShardedStore placed over the ranks of a process group (the JAX
    package's mesh engine with `n_shards > 0`, `store_specs`): the
    retrieval substrate of `civs.retrieve_shards` on every rank.

    Group rank r holds the payload of shards [r*S/W, (r+1)*S/W): their
    points, validity, slot -> index maps and perms. The routing state is
    replicated: the (n,) inverse maps, the balls, the LSH projections,
    and the per-shard sorted keys, which the global probe windows are
    carved from (4 tables x n keys; the JAX rules shard them, ROADMAP C).
    A CIVS step routes the UNION of every rank's routed shards (a MAX
    all-reduce of the (S,) mask), so every rank enters the same broadcasts
    in the same order: `stream` broadcasts each routed shard from its
    owner into a one-shard slot. A rank's device holds S/W shards plus the
    one in flight: `build_mesh_store` builds it without the whole store
    on any device.

    The ranks run their CIVS steps in lockstep: `lockstep` (called by
    `alid_from_seed` at the top of each outer iteration) tells whether any
    rank still has a live lane, and a rank with none takes part in that
    step's collectives without computing."""

    def __init__(self, group, shards, valid, global_idx, perm, sorted_keys,
                 shard_of, slot_of, centers, radii, proj, bias,
                 bucket_sizes):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        # this rank's shards: points, validity, slot -> index maps, perms
        self.shards, self.valid = shards, valid
        self.global_idx, self.perm = global_idx, perm
        self.per_rank = shards.shape[0]
        # replicated: the routing state and the (n,) table-0 bucket sizes
        self.sorted_keys = sorted_keys
        self.shard_of, self.slot_of = shard_of, slot_of
        self.centers, self.radii = centers, radii
        self._proj, self._bias = proj, bias
        self.bucket_sizes = bucket_sizes
        self.n_shards = sorted_keys.shape[0]
        self.n_points = shard_of.shape[0]
        # the one-shard slot a broadcast lands in
        self._slot = (torch.empty_like(self.shards[0]),
                      torch.empty_like(self.perm[0]),
                      torch.empty_like(self.global_idx[0]))

    @property
    def proj(self) -> torch.Tensor:
        return self._proj

    @property
    def bias(self) -> torch.Tensor:
        return self._bias

    def owner(self, s: int) -> int:
        return int(s) // self.per_rank

    def payload_bytes(self) -> int:
        """Device bytes of this rank's shards (points, validity, maps,
        perms) and of the slot."""
        return sum(t.numel() * t.element_size() for t in (
            self.shards, self.valid, self.global_idx, self.perm,
            *self._slot))

    def seed_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Every rank's seeds' rows, each from the rank that owns it: the
        seed ids are all-gathered, each rank fills the rows it owns, the
        rows are all-gathered and each is SELECTED from its owner (a
        summed all-reduce would turn -0.0 into +0.0). Returns this rank's
        rows."""
        ids = all_gather(idx.long(), self.group)
        safe = torch.clamp(ids, 0, self.n_points - 1)
        shard = self.shard_of[safe]
        owner = shard // self.per_rank
        mine = owner == self.rank
        rows = torch.zeros((ids.shape[0], self.shards.shape[-1]),
                           dtype=self.shards.dtype, device=ids.device)
        rows[mine] = self.shards[shard[mine] - self.rank * self.per_rank,
                                 self.slot_of[safe][mine]]
        every = all_gather(rows, self.group).reshape(
            self.size, ids.shape[0], -1)
        picked = every[owner, torch.arange(ids.shape[0], device=ids.device)]
        b = idx.shape[0]
        return picked[self.rank * b:(self.rank + 1) * b]

    def balls(self) -> tuple[np.ndarray, np.ndarray]:
        return (self.centers.double().cpu().numpy(),
                self.radii.double().cpu().numpy())

    def routed(self, touch: np.ndarray) -> np.ndarray:
        """The union over the ranks of the shards some lane's ROI ball
        meets, ascending."""
        mask = torch.as_tensor(touch.any(axis=0), device=self.shards.device)
        return np.flatnonzero(all_reduce_max(mask, self.group).cpu().numpy())

    def windows(self, keys, salts, routed: np.ndarray, probe: int):
        return _windows(self.sorted_keys, keys, salts, routed, probe)

    def stream(self, routed: np.ndarray):
        """(pos, s, (points, sorted_keys, perm, global_idx)) of each routed
        shard in routed order, broadcast from its owner (the owner's own
        tensors, the slot elsewhere)."""
        for pos, s in enumerate(routed):
            owner = self.owner(s)
            if owner == self.rank:
                i = int(s) - self.rank * self.per_rank
                held = (self.shards[i], self.perm[i], self.global_idx[i])
            else:
                held = self._slot
            for t in held:
                broadcast(t, owner, self.group)
            yield pos, s, (held[0], self.sorted_keys[s], held[1], held[2])

    def lockstep(self, n_live: int) -> bool:
        """Whether any rank has a live lane this outer iteration; a rank
        with none takes part in the step's collectives (an empty routing
        mask, then the union's broadcasts)."""
        live = torch.tensor([n_live > 0], device=self.shards.device)
        any_live = bool(all_reduce_max(live, self.group)[0])
        if any_live and n_live == 0:
            for _ in self.stream(self.routed(
                    np.zeros((0, self.n_shards), bool))):
                pass
        return any_live


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


def _shard_layout(order: torch.Tensor, n_shards: int):
    """The shards of a spatial order (n,): contiguous equal runs of it, the
    last padded. Returns (global_idx (S, cap), valid (S, cap), shard_of
    (n,), slot_of (n,)), every index int64."""
    n = order.shape[0]
    dev = order.device
    cap = -(-n // n_shards)                    # ceil: the last shard padded
    pad = n_shards * cap - n
    gidx = torch.cat([order, torch.full((pad,), -1, dtype=torch.int64,
                                        device=dev)]).reshape(n_shards, cap)
    valid = gidx >= 0
    sid = torch.arange(n_shards, device=dev)[:, None].expand(-1, cap)
    slot = torch.arange(cap, device=dev)[None, :].expand(n_shards, -1)
    safe_g = torch.where(valid, gidx, n).reshape(-1)
    shard_of = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    shard_of[safe_g] = sid.reshape(-1)
    slot_of = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    slot_of[safe_g] = slot.reshape(-1)
    return gidx, valid, shard_of[:n], slot_of[:n]


def _shard_balls(shards: torch.Tensor, valid: torch.Tensor):
    """Each shard's centre (S, d) and radius (S,), one shard at a time, so
    a shard's ball is the same bits whatever shards share the call (the
    mesh build takes only its own). Centres in f32 even for bf16 shards (a
    bf16 row-sum accumulator loses mantissa long before shard_cap rows);
    the radii are the f32 distances from it to the STORED (rounded)
    points, so routing stays exact."""
    cnt = torch.clamp_min(valid.sum(1), 1).float()
    centers, radii = [], []
    for s in range(shards.shape[0]):
        c = shards[s].float().sum(0) / cnt[s]
        centers.append(c)
        radii.append(torch.where(valid[s], ball_distance(shards[s], c[None]),
                                 0.0).amax())
    return torch.stack(centers), torch.stack(radii)


def _build_store_impl(points: torch.Tensor, params: LSHParams,
                      rng: torch.Tensor, n_shards: int,
                      backend: str = "auto") -> ShardedStore:
    n, d = points.shape
    dev = points.device

    # spatial order along the first LSH direction: the projections are
    # drawn again from the same key, as build_lsh_sharded draws them
    proj, _ = make_projections(rng, params, d, dev)
    order = torch.sort(spatial_score(points, proj[0, 0]), stable=True).indices
    gidx, valid, shard_of, slot_of = _shard_layout(order, n_shards)
    shards = torch.where(valid[..., None],
                         points[torch.clamp(gidx, 0, n - 1)], 0.0)
    centers, radii = _shard_balls(shards, valid)
    tables = build_lsh_sharded(shards, valid, params, rng, backend)
    return ShardedStore(shards=shards, valid=valid, global_idx=gidx,
                        shard_of=shard_of, slot_of=slot_of,
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


def build_mesh_store(source: DataSource, params: LSHParams,
                     rng: torch.Tensor, n_shards: int, group,
                     backend: str = "auto", dtype: str = "float32",
                     device="cpu", chunk_size: int = 0) -> MeshStore:
    """The store of `source` split over the ranks of `group`, built
    without the whole store on any device: each rank's device holds its
    own S/W shards and the replicated routing state, and every rank gets
    `build_store`'s bits shard for shard (it consumes `rng` as
    `build_store` does).

      1. each rank scores its contiguous 1/W block of the rows, chunk by
         chunk, no chunk longer than a shard (`spatial_score` sums in the
         pinned order, so a chunk's scores are a whole pass's bits); the
         scores are all-gathered and every rank sorts them into the one
         spatial order;
      2. each rank reads its own shards' rows from the source, one shard
         at a time, hashes them (`build_lsh_sharded`: a row's keys do not
         depend on its batch) and takes their balls;
      3. the balls, the sorted keys and table 0's point at each sorted
         position are all-gathered: the routing state, and the global
         table-0 bucket sizes every rank computes from them.
    """
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    n, d = source.n, source.dim
    n_shards = max(1, min(int(n_shards), n))
    if n_shards % size:
        raise ValueError(f"{n_shards} shards do not divide over {size} "
                         f"ranks")
    dev = torch.device(device)
    chunk = min(int(chunk_size) or _DEFAULT_CHUNK, -(-n // n_shards))

    def upload(rows):
        return ops.to_storage(torch.as_tensor(np.asarray(rows, np.float32)),
                              dtype, dev)

    proj, _ = make_projections(rng, params, d, dev)
    block = -(-n // size)
    lo, hi = min(rank * block, n), min((rank + 1) * block, n)
    part = torch.zeros(block, dtype=torch.float32, device=dev)
    for start in range(lo, hi, chunk):
        stop = min(start + chunk, hi)
        part[start - lo:stop - lo] = spatial_score(
            upload(source.get_chunk(start, stop - start)), proj[0, 0])
    order = torch.sort(all_gather(part, group)[:n], stable=True).indices
    del part
    gidx, valid, shard_of, slot_of = _shard_layout(order, n_shards)

    per = n_shards // size
    gidx = gidx[rank * per:(rank + 1) * per].contiguous()
    valid = valid[rank * per:(rank + 1) * per].contiguous()
    shards = torch.zeros((per, gidx.shape[1], d),
                         dtype=ops.storage_dtype(dtype), device=dev)
    for i, row in enumerate(gidx.cpu().numpy()):
        idx = row[row >= 0]                    # a shard's pads come last
        if idx.size:
            shards[i, :idx.size] = upload(source.sample(idx))
    centers, radii = _shard_balls(shards, valid)
    tables = build_lsh_sharded(shards, valid, params, rng, backend)
    sorted_keys = all_gather(tables.sorted_keys, group)
    points0 = all_gather(_table0_points(tables.perm[:, 0], gidx, n), group)
    return MeshStore(group, shards, valid, gidx, tables.perm, sorted_keys,
                     shard_of, slot_of, all_gather(centers, group),
                     all_gather(radii, group), tables.proj, tables.bias,
                     _bucket_sizes(sorted_keys[:, 0], points0, n))


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
    return _bucket_sizes(store.tables.sorted_keys[:, 0, :], _table0_points(
        store.tables.perm[:, 0, :], store.global_idx, n), n)


def _table0_points(perm0: torch.Tensor, global_idx: torch.Tensor,
                   n: int) -> torch.Tensor:
    """(S, cap) data index at each sorted position of table 0 (n at the
    pads)."""
    safe_slot = torch.clamp(perm0, 0, perm0.shape[-1] - 1)
    return torch.where(perm0 >= 0, torch.gather(global_idx, 1, safe_slot), n)


def _bucket_sizes(sk0: torch.Tensor, points0: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Each point's table-0 key counted in every shard's sorted table 0
    (sk0 (S, cap)), summed over the shards: (n,) int32."""
    keys = torch.zeros(n + 1, dtype=sk0.dtype, device=sk0.device)
    keys[points0.reshape(-1)] = sk0.reshape(-1)
    keys = keys[:n]
    counts = torch.zeros(n, dtype=torch.int64, device=sk0.device)
    for row in sk0:
        counts += (torch.searchsorted(row, keys, side="right")
                   - torch.searchsorted(row, keys, side="left"))
    return counts.to(torch.int32)
