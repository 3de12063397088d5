"""Continuous-batching, multi-tenant cluster-assignment serving (the port
of the JAX package's `serve/batching.py`; the threading, futures,
admission control, deadlines and worker supervision are its semantics).

`serve.cluster_service.ClusterService` is the synchronous fixed-slot path:
callers submit, then call serve() themselves. This module is the traffic-
scale layer on top of the same fused assignment kernel
(`repro_torch.kernels.ops.assign_clusters`, the `assign` CUDA kernel on
the card):

  * `Tenant`        — one RESIDENT fitted `Clustering`: support tensors
                      uploaded to the device once (never per batch), a host
                      staging pair (queries, validity) per batch size, and
                      the per-tenant kernel backend/threshold. Tenants are
                      keyed by (name, version) in the server registry, so
                      one process serves many datasets/versions side by
                      side.
  * `ClusterServer` — the continuous-batching server: `submit()` enqueues a
                      request and returns a `concurrent.futures.Future`
                      immediately; a background worker packs WHATEVER is
                      queued (up to `batch_slots`, round-robin across
                      tenants) into one fixed-shape device batch per step.
                      Partially-filled batches carry a slot-validity mask
                      so pad slots can never produce a label (see
                      `ops.assign_clusters`).
  * admission control — `queue_limit` bounds the total queued requests;
                      `policy="reject"` raises `QueueFull` at submit,
                      `policy="block"` makes submit wait for space
                      (backpressure), with an optional timeout.
  * `ServingStats`  — counters: queue depth, batch occupancy, and per-stage
                      wait / pack / compute timers.

Why continuous batching matters here: ALID's localization makes assignment
O(C·cap) per query independent of n (paper Sec. 4), so the serving cost is
dominated by HOW queries reach the kernel. A fixed-slot sync server pays a
full batch latency at every call whatever the arrival pattern; the
continuous worker instead drains the queue as fast as the device finishes
batches — occupancy adapts to load, and p99 latency under open-loop traffic
is what `benchmarks/serving_latency.py` measures (BENCH_serving.json).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Optional

import numpy as np
import torch

from repro_torch.core.alid import (Clustering, assign_labels,
                                   assign_labels_source, resolve_device)
from repro_torch.core.source import as_source


class QueueFull(RuntimeError):
    """Admission control rejected a submit: the bounded queue is full
    (policy="reject"), or policy="block" timed out waiting for space."""


class DeadlineExceeded(TimeoutError):
    """A request's per-submit deadline expired before the worker packed it —
    the future resolves with this instead of a stale label."""


class WorkerDied(RuntimeError):
    """The serving worker died (and was not respawned): every pending
    future — queued AND in-flight — resolves with this. No future can hang
    on a dead worker."""


class ShutdownTimeout(RuntimeError):
    """`close(timeout=...)` gave up waiting for a stuck worker: the pending
    futures resolve with this instead of hanging forever."""


def _safe_set_result(fut: Future, value) -> bool:
    """Resolve a future that MAY have been resolved concurrently (a timed-
    out close or a supervisor racing the worker): first writer wins, the
    loser backs off instead of raising out of the worker thread."""
    try:
        fut.set_result(value)
        return True
    except InvalidStateError:
        return False


def _safe_set_exception(fut: Future, exc: BaseException) -> bool:
    try:
        fut.set_exception(exc)
        return True
    except InvalidStateError:
        return False


def _try_set_running(fut: Future) -> bool:
    # RuntimeError: set_running_or_notify_cancel on a future that is already
    # RUNNING/FINISHED (a close-timeout resolved it while it sat queued)
    try:
        return fut.set_running_or_notify_cancel()
    except (InvalidStateError, RuntimeError):
        return False


# ---------------------------------------------------------------- metrics --
class ServingStats:
    """Serving counters.

    Stage seconds are host-side: `wait_s` is worker idle time between
    batches (queue empty), `pack_s` the host packing of queued requests into
    the staging buffer, `compute_s` the device upload + fused assign + sync
    per batch, and `queue_wait_s` the SUM over requests of (pack start −
    submit) — queue_wait_s / served is the mean queueing delay. Occupancy =
    slots_filled / (batches · batch_slots): low occupancy under load means
    the device is spinning on mostly-empty batches, high occupancy with
    rising queue_depth_peak means the device is the bottleneck.
    """

    _FIELDS = ("submitted", "served", "rejected", "cancelled", "expired",
               "batches", "slots_filled", "queue_depth_peak",
               "version_swaps", "rollbacks", "worker_deaths", "respawns",
               "failed_shutdowns", "queue_wait_s", "pack_s", "compute_s",
               "wait_s")

    def __init__(self) -> None:
        for f in self._FIELDS:
            setattr(self, f, 0.0 if f.endswith("_s") else 0)
        self._lock = threading.Lock()

    def add(self, field: str, amount=1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + amount)

    def peak(self, field: str, value) -> None:
        with self._lock:
            setattr(self, field, max(getattr(self, field), value))

    def snapshot(self) -> dict:
        return {f: (float(v) if isinstance(v := getattr(self, f), float)
                    else int(v)) for f in self._FIELDS}

    def occupancy(self, batch_slots: int) -> float:
        s = self.snapshot()
        return (s["slots_filled"] / (s["batches"] * batch_slots)
                if s["batches"] else 0.0)

    def report(self, batch_slots: int = 0) -> str:
        s = self.snapshot()
        occ = (f" occupancy={self.occupancy(batch_slots):.2f}"
               if batch_slots else "")
        return ("serving: "
                f"submitted={s['submitted']} served={s['served']} "
                f"rejected={s['rejected']} cancelled={s['cancelled']} "
                f"expired={s['expired']} | "
                f"batches={s['batches']}{occ} "
                f"queue_peak={s['queue_depth_peak']} | "
                f"swaps={s['version_swaps']} rollbacks={s['rollbacks']} | "
                f"deaths={s['worker_deaths']} respawns={s['respawns']} "
                f"failed_shutdowns={s['failed_shutdowns']} | "
                f"queue_wait={s['queue_wait_s']:.3f}s "
                f"pack={s['pack_s']:.3f}s compute={s['compute_s']:.3f}s "
                f"idle={s['wait_s']:.3f}s")


# ----------------------------------------------------------------- tenant --
class Tenant:
    """One resident fitted `Clustering`: support tensors on the device + the
    per-tenant assignment path. The registry in `ClusterServer` holds many.

    Upload happens ONCE here (construction), not per batch: `sup_v`/`sup_w`/
    `densities` become tensors on `device` immediately. `assign_np` is the
    one batch entry point shared by the sync `ClusterService` and the
    continuous-batching worker — both therefore obey the same padding
    contract: a packed (slots, d) batch with zero-filled pad rows MUST carry
    the slot-validity mask, and pad slots come back -1 always.

    Staging: one host pair (queries, validity) per batch size, copied to
    the device with plain pageable copies. Such a copy has read the host
    buffer when it returns, and `assign_np` returns host labels, so the
    pair is free to refill as soon as `assign_np` returns; no pinned
    buffers, no events.
    """

    def __init__(self, name: str, clustering: Clustering, *,
                 threshold: float = 0.5, backend: str = "auto",
                 version: int = 0, epoch: int = -1, device="cuda"):
        if clustering.support_v is None:
            raise ValueError("Tenant needs a Clustering with stored supports "
                             "(produced by repro_torch.core.engine.fit)")
        self.device = resolve_device(device)
        self.name, self.version = name, int(version)
        # the committed OnlineClustering epoch this snapshot came from
        # (-1 for batch-fit tenants with no online lifecycle)
        self.epoch = int(epoch)
        self.clustering = clustering
        self.threshold = float(threshold)
        self.backend = backend
        self.d = int(clustering.support_v.shape[2])
        self.n_clusters = clustering.n_clusters
        self._sup_v, self._sup_w, self._dens = (
            torch.as_tensor(x, dtype=torch.float32, device=self.device)
            for x in (clustering.support_v, clustering.support_w,
                      clustering.densities))
        # host staging pairs, sized lazily per batch_slots
        self._staging: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    @property
    def key(self) -> tuple[str, int]:
        return (self.name, self.version)

    def check_query(self, q) -> np.ndarray:
        q = np.asarray(q, np.float32)
        if q.shape != (self.d,):
            raise ValueError(
                f"one {self.d}-d point per request for tenant "
                f"{self.name!r} v{self.version}, got shape {q.shape}")
        return q

    def staging(self, slots: int) -> tuple[np.ndarray, np.ndarray]:
        """The host staging pair (queries, validity) for a `slots`-sized
        batch (see the class docstring for why one pair suffices)."""
        if slots not in self._staging:
            self._staging[slots] = (np.zeros((slots, self.d), np.float32),
                                    np.zeros((slots,), bool))
        return self._staging[slots]

    def assign_np(self, q: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Assign one packed batch: (slots, d) f32 + (slots,) bool validity
        -> (slots,) int32 labels, -1 on pad slots and below-threshold real
        slots. Synchronous (returns host labels).

        Only the occupied prefix is computed: slots past the last valid
        one (the packing loops put live requests first) come out -1
        without reaching the device. A row's label does not depend on the
        batch's other rows, so the labels are bitwise the full masked
        batch's."""
        labels = np.full((q.shape[0],), -1, np.int32)
        live = np.flatnonzero(valid)
        if self.n_clusters == 0 or live.size == 0:
            return labels
        n = int(live[-1]) + 1
        labels[:n] = assign_labels(
            q[:n], self._sup_v, self._sup_w, self._dens, self.clustering.k,
            self.threshold, self.backend, valid[:n], device=self.device)
        return labels

    def assign_source(self, source, batch_size: int = 256) -> np.ndarray:
        """Bulk offline counterpart: label every row of a DataSource against
        the resident supports in fixed-shape batches (O(batch·C·cap) peak,
        never O(n))."""
        source = as_source(source)
        if self.n_clusters == 0:
            return np.full((source.n,), -1, np.int32)
        return assign_labels_source(
            source, self._sup_v, self._sup_w, self._dens,
            self.clustering.k, self.threshold, batch_size=batch_size,
            backend=self.backend, device=self.device)


# ----------------------------------------------------------------- server --
class _Request:
    __slots__ = ("tenant_key", "vec", "future", "t_submit", "deadline")

    def __init__(self, tenant_key, vec, future, t_submit, deadline=None):
        self.tenant_key = tenant_key
        self.vec = vec
        self.future = future
        self.t_submit = t_submit
        self.deadline = deadline   # absolute time.monotonic(), or None


class ClusterServer:
    """Continuous-batching, multi-tenant assignment server.

        server = ClusterServer(batch_slots=64, queue_limit=512,
                               policy="block")
        server.add_tenant("sift", clustering)
        fut = server.submit(vec, tenant="sift")   # returns immediately
        label = fut.result(timeout=5.0)           # int, -1 = no cluster
        server.close()                            # drains, then stops

    A single daemon worker loops: wait for work → pick the next tenant
    (round-robin over tenants with queued requests; batches are per-tenant
    because support tensors differ) → pop up to `batch_slots` requests →
    pack them into the tenant's staging pair (zero-filled pad rows + slot-
    validity mask) → one fused device call (the `assign` kernel on the
    card) → resolve futures with int labels. Every tenant lives on the
    server's `device`, and the worker launches with that device current. There is no fixed serve() cadence: as soon as the device
    finishes a batch the worker packs the next from whatever arrived in the
    meantime — occupancy self-adjusts to load.

    Admission control: at most `queue_limit` requests may be queued.
    `policy="reject"` raises `QueueFull` immediately; `policy="block"`
    parks the submitting thread until a slot frees (optionally bounded by
    `timeout`, then `QueueFull`).

    `close(drain=True)` stops intake, serves everything already queued,
    then joins the worker; `close(drain=False)` cancels queued futures
    (callers blocked in `result()` get `CancelledError`).

    Supervision: the worker runs under `_worker_main`, which catches ANY
    escaping exception and hands it to `_handle_worker_death`. Depending on
    `on_worker_death` the server either respawns a fresh worker (up to
    `max_respawns` times; only the in-flight batch fails with `WorkerDied`,
    queued requests survive and are served by the new worker) or fails the
    whole server (every pending future resolves with `WorkerDied`, later
    submits raise). Either way NO future can hang on a dead worker.
    """

    def __init__(self, batch_slots: int = 64, queue_limit: int = 1024,
                 policy: str = "block", start: bool = True,
                 on_worker_death: str = "respawn", max_respawns: int = 3,
                 device="cuda"):
        if policy not in ("block", "reject"):
            raise ValueError(f"policy must be 'block'|'reject', got {policy!r}")
        if on_worker_death not in ("respawn", "fail"):
            raise ValueError("on_worker_death must be 'respawn'|'fail', "
                             f"got {on_worker_death!r}")
        if queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        self.device = resolve_device(device)
        self.batch_slots = int(batch_slots)
        self.queue_limit = int(queue_limit)
        self.policy = policy
        self.on_worker_death = on_worker_death
        self.max_respawns = int(max_respawns)
        self.stats = ServingStats()
        self._tenants: dict[tuple[str, int], Tenant] = {}
        self._queues: dict[tuple[str, int], deque[_Request]] = {}
        self._rr: deque[tuple[str, int]] = deque()   # round-robin order
        self._pending = 0
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)   # worker waits here
        self._space = threading.Condition(self._lock)  # blocked submitters
        self._stopping = False
        self._draining = False
        self._failed = False       # worker died and was not respawned
        self._respawns = 0
        self._kill_worker = False  # fault-injection flag (tests/chaos demo)
        self._inflight: list[_Request] = []  # batch the worker currently owns
        self._worker: Optional[threading.Thread] = None
        if start:
            self.start()

    # ------------------------------------------------------------ registry
    def add_tenant(self, name: str, clustering: Clustering, *,
                   threshold: float = 0.5, backend: str = "auto",
                   version: int = 0, epoch: int = -1) -> Tenant:
        """Register (or replace) a resident store under (name, version).
        Supports are uploaded to the server's device here, once."""
        t = Tenant(name, clustering, threshold=threshold, backend=backend,
                   version=version, epoch=epoch, device=self.device)
        with self._lock:
            if self._stopping:
                raise RuntimeError("server is closed")
            self._tenants[t.key] = t
            self._queues.setdefault(t.key, deque())
            if t.key not in self._rr:
                self._rr.append(t.key)
        return t

    def swap_tenant(self, name: str, clustering: Clustering, *,
                    epoch: int = -1, threshold: float = 0.5,
                    backend: str = "auto", rollback: bool = False,
                    keep_versions: int = 2) -> Tenant:
        """Hot-swap `name` to a new snapshot between batches: register the
        clustering under the next version number (the `_resolve` default —
        latest version — makes it the active one for every submit that
        follows; earlier submits already queued against the old version
        still serve against it). Upload happens OUTSIDE the server lock, so
        `submit()` traffic keeps flowing while device buffers build.

        `epoch` tags the tenant with the committed OnlineClustering epoch
        it serves (surfaced by `tenant_info()`); `rollback=True` counts the
        swap under stats.rollbacks instead of stats.version_swaps — the
        registry mechanics are identical, the version number still moves
        FORWARD even though the epoch moves back (serving versions are an
        append-only history; epochs are the restorable data lineage).
        Old versions beyond the newest `keep_versions` are retired (their
        queued requests cancelled)."""
        if keep_versions < 1:
            raise ValueError("keep_versions must be >= 1")
        with self._lock:
            if self._stopping:
                raise RuntimeError("server is closed")
            versions = [v for (n, v) in self._tenants if n == name]
            version = max(versions) + 1 if versions else 0
        t = Tenant(name, clustering, threshold=threshold, backend=backend,
                   version=version, epoch=epoch, device=self.device)
        with self._lock:
            if self._stopping:
                raise RuntimeError("server is closed")
            self._tenants[t.key] = t
            self._queues.setdefault(t.key, deque())
            if t.key not in self._rr:
                self._rr.append(t.key)
            retire = sorted(v for (n, v) in self._tenants
                            if n == name)[:-keep_versions]
        self.stats.add("rollbacks" if rollback else "version_swaps")
        for v in retire:   # remove_tenant re-takes the lock — call unlocked
            self.remove_tenant(name, v)
        return t

    def tenant_info(self) -> dict:
        """Registry observability: {name: [{version, epoch, n_clusters,
        queued, active}, ...]} sorted by version; `active` marks the
        version new submits resolve to."""
        with self._lock:
            info: dict[str, list[dict]] = {}
            for (n, v), t in sorted(self._tenants.items()):
                info.setdefault(n, []).append({
                    "version": v, "epoch": t.epoch,
                    "n_clusters": t.n_clusters,
                    "queued": len(self._queues.get((n, v), ()))})
            for rows in info.values():
                rows.sort(key=lambda r: r["version"])
                for r in rows:
                    r["active"] = r["version"] == rows[-1]["version"]
            return info

    def remove_tenant(self, name: str, version: int = 0) -> None:
        """Deregister; queued requests for the tenant are cancelled."""
        key = (name, int(version))
        with self._lock:
            self._tenants.pop(key, None)
            dropped = self._queues.pop(key, deque())
            if key in self._rr:
                self._rr.remove(key)
            self._pending -= len(dropped)
            self._space.notify_all()
        for r in dropped:
            if r.future.cancel():
                self.stats.add("cancelled")

    def tenants(self) -> list[tuple[str, int]]:
        with self._lock:
            return sorted(self._tenants)

    def _resolve(self, name: str, version: Optional[int]):
        if version is not None:
            key = (name, int(version))
            if key not in self._tenants:
                raise KeyError(f"no tenant {name!r} v{version}")
            return key
        versions = [v for (n, v) in self._tenants if n == name]
        if not versions:
            raise KeyError(f"no tenant {name!r}")
        return (name, max(versions))   # latest version serves by default

    # -------------------------------------------------------------- intake
    def submit(self, query, tenant: str = "default",
               version: Optional[int] = None,
               timeout: Optional[float] = None,
               deadline: Optional[float] = None) -> Future:
        """Enqueue one query for `tenant` (latest version unless pinned);
        returns a Future resolving to the int cluster label (-1 = none).
        Raises `QueueFull` under admission control, `KeyError` for unknown
        tenants, `ValueError` for wrong dimensionality. `deadline` (seconds
        from now) bounds how long the request may sit queued: a request the
        worker packs after its deadline resolves with `DeadlineExceeded`
        instead of a stale label."""
        with self._lock:
            if self._failed:
                raise RuntimeError(
                    "server worker died and was not respawned — server "
                    "is failed (see stats.worker_deaths)")
            key = self._resolve(tenant, version)
            tn = self._tenants[key]
        # validate/convert OUTSIDE the lock: check_query does a host array
        # copy (np.asarray), and doing that under the registry lock stalls
        # every other submitter and the worker's batch pop for the duration
        vec = tn.check_query(query)
        dl = None if deadline is None else time.monotonic() + float(deadline)
        with self._lock:
            if self._failed:
                raise RuntimeError(
                    "server worker died and was not respawned — server "
                    "is failed (see stats.worker_deaths)")
            if self._stopping:
                raise RuntimeError("server is closed")
            if key not in self._tenants:
                raise KeyError(f"tenant {key} was removed")
            if self._pending >= self.queue_limit:
                if self.policy == "reject":
                    self.stats.add("rejected")
                    raise QueueFull(
                        f"queue_limit={self.queue_limit} reached")
                deadline = (None if timeout is None
                            else time.monotonic() + timeout)
                while self._pending >= self.queue_limit:
                    if self._stopping:
                        raise RuntimeError("server is closed")
                    rem = (None if deadline is None
                           else deadline - time.monotonic())
                    if rem is not None and rem <= 0 or not self._space.wait(rem):
                        self.stats.add("rejected")
                        raise QueueFull(
                            f"queue_limit={self.queue_limit} still full "
                            f"after {timeout}s (policy=block)")
            fut: Future = Future()
            self._queues[key].append(
                _Request(key, vec, fut, time.perf_counter(), dl))
            self._pending += 1
            self.stats.add("submitted")
            self.stats.peak("queue_depth_peak", self._pending)
            self._work.notify()
        return fut

    def queue_depth(self) -> int:
        with self._lock:
            return self._pending

    # -------------------------------------------------------------- worker
    def start(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        with self._lock:
            self._stopping = False
            self._failed = False
            self._respawns = 0
        self._worker = threading.Thread(target=self._worker_main,
                                        name="cluster-serve", daemon=True)
        self._worker.start()

    def _worker_main(self) -> None:
        """Supervised worker entry: any exception that escapes the serve
        loop — a bug, a device error, an injected fault — reaches the
        supervisor instead of silently killing the thread with futures
        still pending. The loop runs with the server's CUDA device current,
        so its launches go to that device's current stream."""
        on_card = (torch.cuda.device(self.device)
                   if self.device.type == "cuda" else contextlib.nullcontext())
        try:
            with on_card:
                self._serve_loop()
        except BaseException as exc:   # noqa: BLE001 — supervisor boundary
            self._handle_worker_death(exc)

    def _handle_worker_death(self, exc: BaseException) -> None:
        """Runs ON the dying worker thread. Decides respawn-vs-fail under
        the lock, then resolves the dropped futures OUTSIDE it.

        respawn: only the in-flight batch (popped, unresolved) fails with
        `WorkerDied`; queued requests stay queued for the fresh worker.
        fail: the server transitions to failed — in-flight AND queued
        futures all resolve with `WorkerDied`, blocked submitters wake and
        raise, later submits raise immediately."""
        self.stats.add("worker_deaths")
        with self._lock:
            dropped = list(self._inflight)
            self._inflight = []
            respawn = (self.on_worker_death == "respawn"
                       and self._respawns < self.max_respawns
                       and not self._stopping)
            if respawn:
                self._respawns += 1
                self._worker = threading.Thread(
                    target=self._worker_main, name="cluster-serve",
                    daemon=True)
                self._worker.start()
            else:
                self._failed = True
                self._stopping = True
                for q in self._queues.values():
                    dropped.extend(q)
                    q.clear()
                self._pending = 0
                self._work.notify_all()
                self._space.notify_all()
        if respawn:
            self.stats.add("respawns")
        err = WorkerDied(f"serving worker died: {exc!r}")
        err.__cause__ = exc
        for r in dropped:
            # set_exception is legal from PENDING and RUNNING alike, so this
            # covers both the queued and the already-packed (in-flight)
            # futures; cancelled/finished ones back off harmlessly
            _safe_set_exception(r.future, err)

    def inject_worker_fault(self) -> None:
        """Deterministic fault injection for tests and the chaos demo: the
        worker raises at its next loop iteration, exercising the real
        `_handle_worker_death` path (not a simulation of it)."""
        with self._lock:
            self._kill_worker = True
            self._work.notify()

    def _next_batch(self) -> Optional[tuple[Tenant, list[_Request]]]:
        """Pop up to batch_slots requests of ONE tenant (round-robin) and
        snapshot that tenant in the same critical section — the worker
        serves the snapshot, so a concurrent remove_tenant/swap_tenant can
        never yank the registry entry between pop and compute.
        Must hold the lock."""
        for _ in range(len(self._rr)):
            key = self._rr[0]
            self._rr.rotate(-1)
            q = self._queues.get(key)
            if q:
                batch = [q.popleft()
                         for _ in range(min(len(q), self.batch_slots))]
                # analysis: allow(unlocked-mutation): _next_batch's contract is "caller holds self._lock" (its docstring); the twin of the pragma at repro/serve/batching.py:610
                self._pending -= len(batch)
                # popped requests are the worker's responsibility until it
                # explicitly resolves them — the supervisor fails whatever
                # is still here if the worker dies mid-batch
                self._inflight = batch
                self._space.notify_all()
                # same critical section as the pop: remove_tenant drops the
                # queue and the registry entry together under this lock, so
                # a non-empty queue implies the tenant is still registered
                return self._tenants[key], batch
        return None

    def _serve_loop(self) -> None:
        while True:
            t_idle = time.perf_counter()
            with self._work:
                while (self._pending == 0 and not self._stopping
                       and not self._kill_worker):
                    self._work.wait(0.1)
                if self._kill_worker:
                    self._kill_worker = False
                    raise RuntimeError("injected worker fault")
                if self._pending == 0 and self._stopping:
                    return
                popped = self._next_batch()
            self.stats.add("wait_s", time.perf_counter() - t_idle)
            if popped:
                self._serve_batch(*popped)

    def _serve_batch(self, tenant: Tenant, batch: list[_Request]) -> None:
        """Serve one popped batch against its snapshotted Tenant. The
        snapshot (not the live registry) is what gets served: every label in
        the batch comes from ONE (name, version) clustering even if a swap
        or removal lands mid-compute."""
        t_pack = time.perf_counter()
        now = time.monotonic()
        live: list[tuple[int, _Request]] = []
        expired: list[_Request] = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                expired.append(r)
            # a future cancelled while queued never reaches the device
            elif _try_set_running(r.future):
                live.append((len(live), r))
            else:
                self.stats.add("cancelled")
        for r in expired:   # resolve outside any lock, before the compute
            self.stats.add("expired")
            _safe_set_exception(r.future, DeadlineExceeded(
                "request deadline expired before it was packed"))
        q, valid = tenant.staging(self.batch_slots)
        q[:] = 0.0
        valid[:] = False
        for i, r in live:
            q[i] = r.vec
            valid[i] = True
            self.stats.add("queue_wait_s", t_pack - r.t_submit)
        t_comp = time.perf_counter()
        self.stats.add("pack_s", t_comp - t_pack)
        try:
            labels = tenant.assign_np(q, valid)
        except Exception as e:               # resolve, don't kill the worker
            for _, r in live:
                _safe_set_exception(r.future, e)
            with self._lock:
                self._inflight = []
            return
        self.stats.add("compute_s", time.perf_counter() - t_comp)
        self.stats.add("batches")
        self.stats.add("slots_filled", len(live))
        self.stats.add("served", len(live))
        for i, r in live:
            _safe_set_result(r.future, int(labels[i]))
        # only after every future is resolved does the worker disown the
        # batch — an exception anywhere above leaves _inflight set so the
        # supervisor can fail the remainder
        with self._lock:
            self._inflight = []

    # ------------------------------------------------------------ shutdown
    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> bool:
        """Stop the server. drain=True serves everything already queued
        first; drain=False cancels queued futures. Idempotent.

        Returns True on clean shutdown. If `timeout` elapses with the
        worker still alive (stuck in a device call, wedged), the stuck
        pending futures — in-flight and queued — resolve with
        `ShutdownTimeout` (never left hanging), `_worker` is KEPT so the
        failure is observable, and close returns False."""
        with self._lock:
            self._stopping = True
            if not drain:
                dropped = []
                for q in self._queues.values():
                    dropped.extend(q)
                    q.clear()
                self._pending = 0
            self._work.notify_all()
            self._space.notify_all()
        if not drain:
            for r in dropped:
                if r.future.cancel():
                    self.stats.add("cancelled")
        worker = self._worker
        if worker is None:
            return True
        worker.join(timeout)
        if worker.is_alive():
            self.stats.add("failed_shutdowns")
            with self._lock:
                stuck = list(self._inflight)
                self._inflight = []
                for q in self._queues.values():
                    stuck.extend(q)
                    q.clear()
                self._pending = 0
                self._work.notify_all()
                self._space.notify_all()
            err = ShutdownTimeout(
                f"worker still alive after close(timeout={timeout}) — "
                "resolving its pending futures with this error")
            for r in stuck:
                _safe_set_exception(r.future, err)
            return False
        self._worker = None
        return True

    def __enter__(self) -> "ClusterServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------ open-loop load generator --
def run_open_loop(server: ClusterServer, queries: np.ndarray,
                  rate_hz: float, tenant: str = "default") -> dict:
    """Open-loop load generator: submit queries[i] at t0 + i/rate_hz
    regardless of completions (the arrival process does not wait for the
    server — the honest way to measure serving latency under load), then
    block on every future. Returns per-request latencies and labels.

    Used by `run_palid --serve-bench`.
    """
    n = len(queries)
    done_at = [0.0] * n
    futures: list[Future] = []
    t0 = time.perf_counter()
    arrivals = t0 + np.arange(n) / float(rate_hz)
    for i in range(n):
        now = time.perf_counter()
        if arrivals[i] > now:
            time.sleep(arrivals[i] - now)
        fut = server.submit(queries[i], tenant=tenant)
        fut.add_done_callback(
            lambda f, i=i: done_at.__setitem__(i, time.perf_counter()))
        futures.append(fut)
    labels = np.asarray([f.result() for f in futures], np.int32)
    wall = max(done_at) - t0
    lat_ms = (np.asarray(done_at) - arrivals) * 1e3
    return {
        "n": n,
        "rate_hz": float(rate_hz),
        "wall_s": float(wall),
        "throughput_rps": float(n / wall),
        "latency_ms_p50": float(np.percentile(lat_ms, 50)),
        "latency_ms_p99": float(np.percentile(lat_ms, 99)),
        "latency_ms_max": float(lat_ms.max()),
        "labels": labels,
    }
