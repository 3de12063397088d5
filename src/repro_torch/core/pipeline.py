"""Shard pipeline: the I/O subsystem behind the streamed engine (the JAX
package's `core/pipeline.py`, with the device copies made by PyTorch).

An ALID instance's ROI only ever touches a handful of shards, so a small
cache and a short prefetch ring hide most of the streamed engine's I/O:

  * ScratchShards    the spatially-reordered shard payloads written ONCE at
                     build time to a scratch memmap, so a steady-state shard
                     read is one sequential (cap, d) slab instead of a
                     scattered per-row gather from the source;
  * ShardBundleCache a bounded host LRU of shard bundles (points +
                     sorted_keys + perm + global_idx). Only the points slab
                     owns memory (the metadata leaves are views of the
                     StreamedStore arrays), so the budget counts points
                     bytes only;
  * ShardPipeline    fetch orchestration (cache -> scratch -> source) plus
                     a background READER thread that walks the routed shard
                     list, pulls bundles and copies them to the device into
                     a depth-k slot ring, so the disk read and the upload of
                     shard s+1 overlap the device compute of shard s.

Device copies (`upload`): a bundle goes through a pinned staging buffer
and is copied to the card on a side stream; the consumer's stream waits on
an event recorded after the copy before any kernel reads the bundle, and
every device tensor is marked with `record_stream` for the consumer's
stream, so the caching allocator cannot hand its memory to a later upload
while a kernel still reads it. A staging buffer is reused only after the
copy out of it has finished.

Determinism: shards are CONSUMED in routed order whatever the arrival
order (the ring is a FIFO fed in routed order), bundles are bit-identical
whichever tier served them, and the window math is shared, so the
pipelined engine's labels are bit-identical to the synchronous path.

Device memory: at most `prefetch_depth` bundles sit in the ring while one
is being consumed, so the peak is (prefetch_depth + 1) bundles plus the
O(cap) per-seed state; `prefetch_depth=0` is the synchronous two-slot
rotation.
"""

from __future__ import annotations

import os
import queue
import tempfile
import threading
import time
import warnings
import zlib
from collections import OrderedDict
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.resilience import (CorruptionError, DEFAULT_RETRY,
                                         RetryPolicy)

__all__ = ["PipelineStats", "ScratchShards", "ShardBundleCache",
           "ShardPipeline", "DEFAULT_CACHE_BYTES", "Uploader"]


def _indexed(device) -> torch.device:
    """`device` with its index: "cuda" names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


DEFAULT_CACHE_BYTES = 256 * 2**20          # 256 MiB of hot shard payloads


class PipelineStats:
    """Per-engine counters for the read / put / compute stage breakdown.

    Stage seconds are host times, accumulated where the work is issued:
    `read_s` on the host fetch (cache / scratch / source, the crc32 check
    of a cache hit included: the JAX package times only the reads below
    the cache), `put_s` around the staging copy and the upload's issue,
    `compute_s` around the engine's chunk fold (kernels launch
    asynchronously, so this is issue time unless a step copies to the
    host), and `wait_s` on the consumer side of the ring (time the compute
    loop spent starved: the I/O-bound indicator). With the reader thread
    on, read_s and put_s accrue concurrently with the main loop.
    `read_retries` counts transient read errors absorbed on the pipeline's
    tiers and, on the streamed engine, on fit's retried source.
    `shards_prefetched` counts the bundles the reader thread put in the
    ring: with the reader on and no reader death it equals
    `shards_streamed`, and a shortfall is a shard fetched inline.
    """

    _FIELDS = ("read_s", "put_s", "compute_s", "wait_s", "cache_hits",
               "cache_misses", "cache_stale", "scratch_reads", "source_reads",
               "shards_streamed", "shards_prefetched", "seed_prefetch_hits",
               "seed_prefetch_misses", "rounds_speculated", "rounds_resampled",
               "read_retries", "corruptions", "tier_fallbacks",
               "reader_deaths", "readers_abandoned")
    # the counters of a fallback: all 0 on a clean run
    _FALLBACKS = ("read_retries", "corruptions", "tier_fallbacks",
                  "reader_deaths", "readers_abandoned")

    def __init__(self) -> None:
        for f in self._FIELDS:
            setattr(self, f, 0.0 if f.endswith("_s") else 0)
        self._lock = threading.Lock()

    def add(self, field: str, amount=1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + amount)

    def snapshot(self) -> dict:
        return {f: (float(v) if isinstance(v := getattr(self, f), float)
                    else int(v)) for f in self._FIELDS}

    def fallbacks(self, prefetched: bool) -> dict:
        """The fallback counters that are not 0 and, where the reader
        thread ran (`prefetched`), the shards it did not produce
        (`shards_inline`): {} on a run that took no fallback."""
        s = self.snapshot()
        out = {f: s[f] for f in self._FALLBACKS if s[f]}
        inline = s["shards_streamed"] - s["shards_prefetched"]
        if prefetched and inline:
            out["shards_inline"] = inline
        return out

    def report(self) -> str:
        s = self.snapshot()
        return ("pipeline stages: "
                f"read={s['read_s']:.3f}s put={s['put_s']:.3f}s "
                f"compute={s['compute_s']:.3f}s wait={s['wait_s']:.3f}s | "
                f"shards={s['shards_streamed']} "
                f"({s['shards_prefetched']} by the reader) "
                f"cache={s['cache_hits']}/{s['cache_hits'] + s['cache_misses']}"
                f" hit ({s['cache_stale']} stale) | "
                f"reads: scratch={s['scratch_reads']} "
                f"source={s['source_reads']} | seed-prefetch "
                f"{s['seed_prefetch_hits']}/{s['seed_prefetch_hits'] + s['seed_prefetch_misses']}"
                f" hit, rounds speculated={s['rounds_speculated']} "
                f"resampled={s['rounds_resampled']} | resilience: "
                f"retries={s['read_retries']} corrupt={s['corruptions']} "
                f"fallbacks={s['tier_fallbacks']} "
                f"reader_deaths={s['reader_deaths']} "
                f"abandoned={s['readers_abandoned']}")


class ScratchShards:
    """(S, cap, d) f32 scratch memmap of the spatially-reordered payloads.

    `build_store_streamed` writes each shard's rows exactly once (zero-padded
    to cap, the bytes `shard_points` would re-gather), after which a shard
    read is one contiguous slab. `close()` unlinks the file.

    Integrity: every `write` records a crc32 of the FULL zero-padded slab,
    and `read(verify=True)` checks it, so a flipped bit on the scratch tier
    surfaces as `CorruptionError`. The pipeline then refetches from the
    source (generation 0 shards only: a mutated shard's slab is the sole
    owner of its bytes). `corrupt()` is the chaos hook: it tampers the slab
    without updating the checksum.
    """

    def __init__(self, path: str, mm: np.memmap):
        self.path = path
        self._mm = mm
        self._crc: dict[int, int] = {}

    @classmethod
    def create(cls, n_shards: int, cap: int, dim: int,
               scratch_dir: str = "") -> "ScratchShards":
        """Open a fresh zero-filled scratch file. Empty `scratch_dir` uses
        the system temp dir; the file name is unique per store build."""
        directory = scratch_dir or None
        if directory:
            os.makedirs(directory, exist_ok=True)
        fd, path = tempfile.mkstemp(suffix=".npy", prefix="alid_scratch_",
                                    dir=directory)
        os.close(fd)
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                       shape=(n_shards, cap, dim))
        return cls(path, mm)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self._mm.shape)) * 4

    def write(self, s: int, rows: np.ndarray) -> None:
        self._mm[s, :rows.shape[0]] = rows
        # checksum the full padded slab (what read() returns)
        self._crc[int(s)] = _crc32(np.asarray(self._mm[s]))

    def read(self, s: int, verify: bool = True) -> np.ndarray:
        """One sequential (cap, d) slab read, returned as an OWNED array.
        `verify=True` checks it against the crc recorded at write time and
        raises `CorruptionError` on mismatch."""
        out = np.array(self._mm[s], np.float32)
        if verify:
            want = self._crc.get(int(s))
            if want is not None and _crc32(out) != want:
                raise CorruptionError(
                    f"scratch slab for shard {int(s)} failed its checksum")
        return out

    def corrupt(self, s: int) -> None:
        """Chaos hook: flip one mantissa bit in shard `s`'s slab WITHOUT
        updating the recorded checksum."""
        v = np.array(self._mm[s, 0, 0], np.float32)
        self._mm[s, 0, 0] = (v.view(np.uint32) ^ np.uint32(1)).view(
            np.float32)

    def flush(self) -> None:
        self._mm.flush()

    def close(self) -> None:
        """Drop the mapping and unlink the backing file (idempotent)."""
        if self._mm is not None:
            del self._mm
            self._mm = None
        if self.path is not None:
            try:
                os.unlink(self.path)
            except OSError:
                pass
            self.path = None


class ShardBundleCache:
    """Bounded host LRU of shard bundles keyed by shard id.

    A bundle is the 4-tuple (points, sorted_keys, perm, global_idx) of host
    arrays. Only `points` owns bytes, so the budget charges points bytes; an
    entry larger than the whole budget is never cached. Hits return the
    SAME arrays that were stored.

    Each entry remembers the shard GENERATION it was filled at (the store's
    per-shard mutation counter); a probe with a newer generation drops the
    entry and misses (`stale_evictions`). Each entry also carries a crc32 of
    its points, re-checked at `get` when `verify` is on: a corrupted
    resident bundle is dropped and missed (`corrupt_evictions`).
    """

    def __init__(self, budget_bytes: int, verify: bool = True):
        self.budget = int(budget_bytes)
        self.verify = bool(verify)
        self._entries: OrderedDict[int, tuple[int, int, tuple]] = OrderedDict()
        self._bytes = 0
        self.stale_evictions = 0
        self.corrupt_evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def _drop(self, s: int) -> None:
        _, _, old = self._entries.pop(s)
        self._bytes -= int(old[0].nbytes)

    def get(self, s: int, gen: int = 0):
        entry = self._entries.get(s)
        if entry is None:
            return None
        egen, ecrc, bundle = entry
        if egen != gen:                     # filled before the last mutation
            self._drop(s)
            self.stale_evictions += 1
            return None
        if self.verify and _crc32(bundle[0]) != ecrc:
            self._drop(s)                   # poisoned resident bytes
            self.corrupt_evictions += 1
            return None
        self._entries.move_to_end(s)
        return bundle

    def put(self, s: int, bundle: tuple, gen: int = 0) -> None:
        cost = int(bundle[0].nbytes)
        if cost > self.budget:
            return                          # one shard exceeds the budget
        if s in self._entries:
            if self._entries[s][0] == gen:
                self._entries.move_to_end(s)
                return
            self._drop(s)                   # replace the stale entry
            self.stale_evictions += 1
        while self._bytes + cost > self.budget and self._entries:
            _, (_, _, old) = self._entries.popitem(last=False)
            self._bytes -= int(old[0].nbytes)
        self._entries[s] = (gen, _crc32(bundle[0]), bundle)
        self._bytes += cost

    def clear(self) -> None:
        self._entries.clear()
        self._bytes = 0


class Uploader:
    """Host arrays -> tensors on `device`.

    On the card: each upload copies the arrays into one slot of a ring of
    pinned staging buffers and from there to the device on a side stream,
    then records an event; `ready()` makes the calling stream wait on that
    event and marks the tensors with `record_stream`. A slot's staging
    buffers are refilled only after the copy out of them has finished. On
    the CPU the arrays are wrapped as tensors (a copy where the dtype
    changes). uint32 arrays become int64 tensors holding the uint32 values,
    the port's key convention.

    One Uploader serves one thread at a time; the streamed engine keeps one
    for its shard reader and one for its seed prefetch.
    """

    def __init__(self, device, slots: int = 2):
        self.device = _indexed(device)
        self.n_slots = max(1, int(slots))
        self._staging: list = [None] * self.n_slots
        self._done: list = [None] * self.n_slots
        self._next = 0
        self._stream = None

    @staticmethod
    def _host_tensor(a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a)

    @staticmethod
    def _finish(t: torch.Tensor, a: np.ndarray) -> torch.Tensor:
        if a.dtype == np.uint32:
            return t.long() & 0xFFFFFFFF
        if a.dtype == np.int32:
            return t.long()
        return t

    def upload(self, arrays: tuple) -> tuple:
        """Issue the copy of `arrays`; returns (tensors, event or None)."""
        hosts = [self._host_tensor(a) for a in arrays]
        if self.device.type != "cuda":
            return tuple(self._finish(h, a)
                         for h, a in zip(hosts, arrays)), None
        torch.cuda.set_device(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        slot = self._next
        self._next = (slot + 1) % self.n_slots
        if self._done[slot] is not None:
            self._done[slot].synchronize()  # its last copy has left it
        staged = self._staging[slot]
        if staged is None or any(b.shape != h.shape or b.dtype != h.dtype
                                 for b, h in zip(staged, hosts)):
            staged = [torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
                      for h in hosts]
            self._staging[slot] = staged
        for buf, h in zip(staged, hosts):
            buf.copy_(h)
        with torch.cuda.stream(self._stream):
            out = tuple(self._finish(buf.to(self.device, non_blocking=True),
                                     a) for buf, a in zip(staged, arrays))
            event = torch.cuda.Event()
            event.record(self._stream)
        self._done[slot] = event
        return out, event

    @staticmethod
    def ready(tensors: tuple, event) -> tuple:
        """Make the current stream wait for the copy; keep the memory of
        `tensors` from reuse until that stream's work on them is done."""
        if event is not None:
            stream = torch.cuda.current_stream(tensors[0].device)
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
        return tensors


class _ProducerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class ShardPipeline:
    """Fetch + prefetch orchestrator over a StreamedStore-shaped object.

    `store` must expose `shard_points(s)` (scratch-aware), plus the host
    metadata arrays `sorted_keys` / `perm` / `global_idx` with a leading S
    axis. `stream(routed)` yields `(pos, s, device_bundle)` strictly in
    routed order, the bundle as tensors on `device` (points f32, keys int64
    holding uint32, perm and global map int64):

      * prefetch_depth == 0: the synchronous path, fetch + upload inline
        into two alternating slots;
      * prefetch_depth >= 1: a reader thread walks the routed list, pulls
        bundles (cache -> scratch -> source) and uploads them into a
        bounded FIFO ring of `prefetch_depth` slots; the consumer blocks on
        the ring head, so consumption order, and therefore every carry
        fold, is the synchronous path's.
    """

    def __init__(self, store, cache_bytes: int = 0, prefetch_depth: int = 0,
                 stats: Optional[PipelineStats] = None,
                 retry: RetryPolicy = DEFAULT_RETRY,
                 verify_checksums: bool = True, faults=None,
                 join_timeout: float = 5.0, device="cpu"):
        self.store = store
        self.depth = max(0, int(prefetch_depth))
        self.verify_checksums = bool(verify_checksums)
        self.cache = (ShardBundleCache(cache_bytes, verify=verify_checksums)
                      if cache_bytes > 0 else None)
        self.stats = stats if stats is not None else PipelineStats()
        self.retry = retry if retry is not None else RetryPolicy(attempts=1)
        # fault-injection hooks (core.resilience.PipelineFaults): None in
        # production; installed by chaos tests / run_palid --inject-faults
        self.faults = faults
        self.join_timeout = float(join_timeout)
        self.device = _indexed(device)
        # a staging slot per bundle that can be in flight: the ring's depth
        # plus the one the consumer holds (two in the synchronous path)
        self._uploader = Uploader(self.device, max(2, self.depth + 1))
        self._slots: list = [None, None]    # sync-mode double buffer
        self._slot = 0

    # -- host fetch tier: cache -> scratch -> source -----------------------
    def _count_retry(self, attempt, exc) -> None:
        self.stats.add("read_retries")

    def _read_points(self, s: int, gen: int) -> np.ndarray:
        """Tiered shard-payload read below the cache: the scratch slab
        (verified + retried) first, the source re-gather as the fallback. A
        checksum failure falls back ONE tier, unless the shard was mutated
        in place: then the slab is the sole owner of its bytes and the
        corruption is surfaced."""
        store = self.store
        scratch = getattr(store, "scratch", None)
        if scratch is not None:
            try:
                pts = self.retry.call(scratch.read, s,
                                      verify=self.verify_checksums,
                                      on_retry=self._count_retry)
                self.stats.add("scratch_reads")
                return pts
            except CorruptionError:
                self.stats.add("corruptions")
                if gen > 0:
                    raise CorruptionError(
                        f"scratch slab for shard {s} is corrupt at "
                        f"generation {gen}: the shard was mutated in place "
                        "(update_shard_points), so the source holds "
                        "pre-mutation bytes and no clean tier remains")
        gather = getattr(store, "gather_shard_points", store.shard_points)
        pts = self.retry.call(gather, s, on_retry=self._count_retry)
        self.stats.add("source_reads")
        if scratch is not None:
            # heal the corrupt slab with the source's bytes
            self.stats.add("tier_fallbacks")
            scratch.write(s, pts)
        return pts

    def fetch_bundle(self, s: int) -> tuple:
        stats = self.stats
        s = int(s)
        gens = getattr(self.store, "generations", None)
        gen = int(gens[s]) if gens is not None else 0
        if self.faults is not None:
            self.faults.on_fetch(self, s)
        t0 = time.perf_counter()
        if self.cache is not None:
            stale0 = self.cache.stale_evictions
            corrupt0 = self.cache.corrupt_evictions
            bundle = self.cache.get(s, gen=gen)
            if bundle is not None:
                stats.add("cache_hits")
                stats.add("read_s", time.perf_counter() - t0)
                return bundle
            stats.add("cache_misses")
            if self.cache.stale_evictions > stale0:
                stats.add("cache_stale")
            if self.cache.corrupt_evictions > corrupt0:
                stats.add("corruptions")
                stats.add("tier_fallbacks")
        pts = self._read_points(s, gen)
        stats.add("read_s", time.perf_counter() - t0)
        bundle = (pts, self.store.sorted_keys[s], self.store.perm[s],
                  self.store.global_idx[s])
        if self.cache is not None:
            self.cache.put(s, bundle, gen=gen)
        return bundle

    def _device_put(self, bundle: tuple):
        t0 = time.perf_counter()
        dev = self._uploader.upload(bundle)
        self.stats.add("put_s", time.perf_counter() - t0)
        return dev

    # -- streaming ---------------------------------------------------------
    def stream(self, routed: Iterable[int]) -> Iterator[tuple]:
        routed = [int(s) for s in routed]
        self.stats.add("shards_streamed", len(routed))
        if self.depth <= 0:
            yield from self._stream_sync(routed)
        else:
            yield from self._stream_prefetched(routed)

    def _stream_sync(self, routed) -> Iterator[tuple]:
        for pos, s in enumerate(routed):
            dev = Uploader.ready(*self._device_put(self.fetch_bundle(s)))
            # two alternating slots: at most two bundles are device-live
            self._slot ^= 1
            self._slots[self._slot] = dev
            yield pos, s, dev

    def _stream_prefetched(self, routed) -> Iterator[tuple]:
        # `slots` bounds the bundles produced but not yet consumed; the
        # reader RESERVES one before it fetches or uploads, so at most
        # `depth` bundles sit device-live in the ring while the consumer
        # holds one more: the documented (depth + 1) bundle peak
        ring: queue.Queue = queue.Queue()
        slots = threading.Semaphore(self.depth)
        cancel = threading.Event()

        def acquire_cancellable() -> bool:
            # a bounded wait that gives up once the consumer is gone
            while not cancel.is_set():
                if slots.acquire(timeout=0.05):
                    return True
            return False

        def producer():
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                for s in routed:
                    if not acquire_cancellable():
                        return
                    if self.faults is not None:
                        self.faults.on_produce()
                    bundle = self._device_put(self.fetch_bundle(s))
                    self.stats.add("shards_prefetched")
                    ring.put(bundle)
            except BaseException as exc:    # surfaced on the consumer side
                ring.put(_ProducerError(exc))

        reader = threading.Thread(target=producer, daemon=True,
                                  name="alid-shard-prefetch")
        reader.start()
        try:
            for pos, s in enumerate(routed):
                t0 = time.perf_counter()
                item = ring.get()
                self.stats.add("wait_s", time.perf_counter() - t0)
                if isinstance(item, _ProducerError):
                    # the reader died before producing bundle `pos`: finish
                    # the routed list INLINE, in order, so the carry folds
                    # (and the labels) stay bit-identical. A genuine
                    # per-shard error re-raises here when the inline fetch
                    # hits the same shard.
                    self.stats.add("reader_deaths")
                    reader.join(self.join_timeout)
                    for pos2 in range(pos, len(routed)):
                        dev = Uploader.ready(*self._device_put(
                            self.fetch_bundle(routed[pos2])))
                        self._slot ^= 1
                        self._slots[self._slot] = dev
                        yield pos2, routed[pos2], dev
                    return
                # the popped bundle is now the consumer-held "+1"; free its
                # ring slot so the reader can run one further ahead
                slots.release()
                yield pos, s, Uploader.ready(*item)
        finally:
            cancel.set()
            reader.join(self.join_timeout)
            if reader.is_alive():
                # a source read stuck past the cancel flag: abandon the
                # daemon thread rather than hang the fit's teardown
                self.stats.add("readers_abandoned")
                warnings.warn(
                    "alid-shard-prefetch reader did not exit within "
                    f"{self.join_timeout}s of cancellation; abandoning the "
                    "daemon thread", RuntimeWarning)

    def release(self) -> None:
        """Drop every reference the pipeline holds (device slots, staging
        buffers, host cache): the engine's close() path."""
        self._slots = [None, None]
        self._uploader = Uploader(self.device, self._uploader.n_slots)
        if self.cache is not None:
            self.cache.clear()
