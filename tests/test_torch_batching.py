"""The port's continuous-batching ClusterServer (`repro_torch.serve.
batching`) on the CPU: the behaviours tests/test_batching.py holds the JAX
package's server to (futures, interleaved traffic, multi-tenant
round-robin and versions, admission control, drain/cancel shutdown, tenant
removal, stats, deadlines, bounded close, worker death and respawn, lock
discipline, hot swap under load). Every label a future resolves to equals
the port's per-query `Clustering.predict`, which tests/test_torch_serve.py
holds to the JAX package's.

The store is the port's own fit of tests/test_batching.py's fixture (3
blobs of 30 points, 60 noise points, d = 8, seed 11).
"""

import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest

from repro_torch.core.alid import ALIDConfig, Clustering
from repro_torch.core.engine import fit
from repro_torch.data import auto_lsh_params, make_blobs_with_noise
from repro_torch.random import PRNGKey
from repro_torch.serve import ClusterServer, QueueFull
from repro_torch.serve.batching import (DeadlineExceeded, ShutdownTimeout,
                                        WorkerDied)

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def fitted():
    spec = make_blobs_with_noise(n_clusters=3, cluster_size=30, n_noise=60,
                                 d=8, seed=11, overlap_pairs=0)
    cfg = ALIDConfig(a_cap=48, delta=48,
                     lsh=auto_lsh_params(spec.points, probe=128),
                     seeds_per_round=16, max_rounds=16)
    res = fit(spec.points, cfg, PRNGKey(0), device="cpu")
    assert res.n_clusters > 0
    return spec, res


def _predict_each(res, queries) -> np.ndarray:
    """Per-query predict: one call per query."""
    return np.asarray([int(res.predict(q[None], device="cpu")[0])
                       for q in queries], np.int32)


def _empty_clustering(d=8, cap=8):
    return Clustering(labels=np.full(4, -1, np.int32),
                      densities=np.zeros(0, np.float32), n_rounds=1, k=0.7,
                      support_idx=np.zeros((0, cap), np.int32),
                      support_w=np.zeros((0, cap), np.float32),
                      support_v=np.zeros((0, cap, d), np.float32))


def test_submit_returns_future_with_predict_label(fitted):
    spec, res = fitted
    queries = np.concatenate([spec.points[:20], spec.points[:5] + 200.0]
                             ).astype(np.float32)
    with ClusterServer(batch_slots=8, queue_limit=64, **CPU) as server:
        server.add_tenant("default", res)
        futs = [server.submit(q) for q in queries]
        got = np.asarray([f.result(timeout=30) for f in futs], np.int32)
    np.testing.assert_array_equal(got, _predict_each(res, queries))
    assert (got[-5:] == -1).all()                  # far noise


def test_interleaved_submit_while_serving(fitted):
    spec, res = fitted
    members = spec.points[res.labels >= 0]
    want = _predict_each(res, members)
    results: dict[int, int] = {}
    lock = threading.Lock()
    with ClusterServer(batch_slots=4, queue_limit=16, policy="block",
                       **CPU) as server:
        server.add_tenant("default", res)

        def pump(lo, hi):
            for i in range(lo, hi):
                lab = server.submit(members[i]).result(timeout=30)
                with lock:
                    results[i] = lab

        step = len(members) // 4
        threads = [threading.Thread(target=pump, args=(lo, lo + step))
                   for lo in range(0, len(members) - 3, step)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    assert len(results) >= 4 * step
    for i, lab in results.items():
        assert lab == want[i]
    assert server.stats.served >= len(results)
    assert server.stats.batches >= 1


def test_multi_tenant_round_robin_and_versions(fitted):
    spec, res = fitted
    member = spec.points[res.labels == 0][0]
    want = int(res.predict(member, device="cpu")[0])
    assert want >= 0
    with ClusterServer(batch_slots=4, queue_limit=64, **CPU) as server:
        server.add_tenant("blobs", res, version=0)
        server.add_tenant("blobs", res, version=3)
        server.add_tenant("empty", _empty_clustering(d=res.support_v.shape[2]))
        assert server.tenants() == [("blobs", 0), ("blobs", 3), ("empty", 0)]
        f_latest = server.submit(member, tenant="blobs")
        f_pinned = server.submit(member, tenant="blobs", version=0)
        f_empty = server.submit(member, tenant="empty")
        assert f_latest.result(timeout=30) == want
        assert f_pinned.result(timeout=30) == want
        assert f_empty.result(timeout=30) == -1
        with pytest.raises(KeyError):
            server.submit(member, tenant="nope")
        with pytest.raises(KeyError):
            server.submit(member, tenant="blobs", version=7)
        with pytest.raises(ValueError, match="point per request"):
            server.submit(member[:-1], tenant="blobs")


def test_admission_reject_policy(fitted):
    spec, res = fitted
    server = ClusterServer(batch_slots=2, queue_limit=3, policy="reject",
                           start=False, **CPU)
    server.add_tenant("default", res)
    futs = [server.submit(spec.points[i]) for i in range(3)]
    with pytest.raises(QueueFull):
        server.submit(spec.points[3])
    assert server.stats.rejected == 1
    server.start()
    got = [f.result(timeout=30) for f in futs]
    np.testing.assert_array_equal(got, _predict_each(res, spec.points[:3]))
    server.close()


def test_admission_block_timeout(fitted):
    spec, res = fitted
    server = ClusterServer(batch_slots=2, queue_limit=2, policy="block",
                           start=False, **CPU)
    server.add_tenant("default", res)
    for i in range(2):
        server.submit(spec.points[i])
    t0 = time.perf_counter()
    with pytest.raises(QueueFull, match="policy=block"):
        server.submit(spec.points[2], timeout=0.2)
    assert time.perf_counter() - t0 >= 0.2
    server.close(drain=False)


def test_close_drain_serves_backlog(fitted):
    spec, res = fitted
    server = ClusterServer(batch_slots=4, queue_limit=64, start=False, **CPU)
    server.add_tenant("default", res)
    futs = [server.submit(q) for q in spec.points[:10]]
    server.start()
    server.close(drain=True, timeout=30)
    assert all(f.done() and not f.cancelled() for f in futs)
    np.testing.assert_array_equal([f.result() for f in futs],
                                  _predict_each(res, spec.points[:10]))
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(spec.points[0])


def test_close_cancel_rejects_queued(fitted):
    spec, res = fitted
    server = ClusterServer(batch_slots=4, queue_limit=64, start=False, **CPU)
    server.add_tenant("default", res)
    futs = [server.submit(q) for q in spec.points[:6]]
    server.close(drain=False, timeout=30)
    for f in futs:
        assert f.cancelled()
        with pytest.raises(CancelledError):
            f.result(timeout=1)
    assert server.stats.cancelled == len(futs)


def test_remove_tenant_cancels_queued(fitted):
    spec, res = fitted
    server = ClusterServer(batch_slots=4, queue_limit=64, start=False, **CPU)
    server.add_tenant("default", res)
    futs = [server.submit(q) for q in spec.points[:4]]
    server.remove_tenant("default")
    assert server.tenants() == []
    assert all(f.cancelled() for f in futs)
    assert server.queue_depth() == 0
    server.close()


def test_stats_and_occupancy(fitted):
    spec, res = fitted
    server = ClusterServer(batch_slots=4, queue_limit=64, start=False, **CPU)
    server.add_tenant("default", res)
    futs = [server.submit(q) for q in spec.points[:8]]
    server.start()
    for f in futs:
        f.result(timeout=30)
    server.close()
    s = server.stats.snapshot()
    assert s["submitted"] == s["served"] == 8
    assert s["batches"] == 2 and s["slots_filled"] == 8
    assert server.stats.occupancy(4) == 1.0
    assert "occupancy" in server.stats.report(batch_slots=4)


def test_deadline_expired_request_resolves_with_error(fitted):
    spec, res = fitted
    server = ClusterServer(batch_slots=4, queue_limit=64, start=False, **CPU)
    server.add_tenant("default", res)
    stale = server.submit(spec.points[0], deadline=0.01)
    fresh = server.submit(spec.points[1])
    time.sleep(0.05)
    server.start()
    with pytest.raises(DeadlineExceeded):
        stale.result(timeout=30)
    assert fresh.result(timeout=30) == _predict_each(res, spec.points[1:2])[0]
    assert server.stats.expired == 1
    assert server.stats.served == 1
    server.close()


def test_close_timeout_resolves_stuck_futures(fitted):
    spec, res = fitted
    server = ClusterServer(batch_slots=2, queue_limit=64, **CPU)
    server.add_tenant("default", res)
    tn = server._tenants[("default", 0)]
    release = threading.Event()
    orig = tn.assign_np

    def wedged(q, valid):
        release.wait(30.0)           # the worker hangs mid-compute
        return orig(q, valid)

    tn.assign_np = wedged
    try:
        futs = [server.submit(p) for p in spec.points[:6]]
        t0 = time.perf_counter()
        ok = server.close(drain=True, timeout=0.2)
        assert ok is False
        assert server.stats.failed_shutdowns == 1
        assert server._worker is not None     # failure stays observable
        for f in futs:
            with pytest.raises(ShutdownTimeout):
                f.result(timeout=5)
        assert time.perf_counter() - t0 < 5.0
    finally:
        release.set()
    server._worker.join(10.0)
    assert not server._worker.is_alive()


def test_clean_close_returns_true(fitted):
    spec, res = fitted
    server = ClusterServer(batch_slots=4, queue_limit=64, **CPU)
    server.add_tenant("default", res)
    server.submit(spec.points[0]).result(timeout=30)
    assert server.close(drain=True, timeout=30) is True
    assert server._worker is None
    assert server.stats.failed_shutdowns == 0


def test_worker_death_fail_mode_resolves_everything(fitted):
    spec, res = fitted
    server = ClusterServer(batch_slots=4, queue_limit=64, start=False,
                           on_worker_death="fail", **CPU)
    server.add_tenant("default", res)
    futs = [server.submit(p) for p in spec.points[:5]]
    server.inject_worker_fault()
    server.start()
    for f in futs:
        with pytest.raises(WorkerDied):
            f.result(timeout=30)
    assert server.stats.worker_deaths == 1
    assert server.stats.respawns == 0
    with pytest.raises(RuntimeError, match="died"):
        server.submit(spec.points[0])
    server.close(timeout=10)


def test_worker_death_respawn_keeps_serving(fitted):
    spec, res = fitted
    members = spec.points[res.labels >= 0][:6].astype(np.float32)
    want = _predict_each(res, members)
    server = ClusterServer(batch_slots=4, queue_limit=64, **CPU)
    server.add_tenant("default", res)
    assert server.submit(members[0]).result(timeout=30) == want[0]
    server.inject_worker_fault()
    got = [server.submit(q).result(timeout=30) for q in members]
    np.testing.assert_array_equal(np.asarray(got, np.int32), want)
    assert server.stats.worker_deaths == 1
    assert server.stats.respawns == 1
    server.close(timeout=10)


def test_worker_death_midbatch_fails_inflight_serves_queued(fitted):
    spec, res = fitted
    members = spec.points[res.labels >= 0][:6].astype(np.float32)
    want = _predict_each(res, members)
    server = ClusterServer(batch_slots=4, queue_limit=64, start=False, **CPU)
    server.add_tenant("default", res)
    tn = server._tenants[("default", 0)]
    orig, boom = tn.staging, [True]

    def exploding(slots):
        if boom:
            boom.clear()
            raise MemoryError("injected mid-batch death")
        return orig(slots)

    tn.staging = exploding
    futs = [server.submit(q) for q in members]    # 4 in flight + 2 queued
    server.start()
    for f in futs[:4]:
        with pytest.raises(WorkerDied):
            f.result(timeout=30)
    got = [f.result(timeout=30) for f in futs[4:]]
    np.testing.assert_array_equal(np.asarray(got, np.int32), want[4:])
    assert server.stats.worker_deaths == 1
    assert server.stats.respawns == 1
    server.close(timeout=10)


def test_respawn_budget_exhausts_to_failure(fitted):
    spec, res = fitted
    server = ClusterServer(batch_slots=4, queue_limit=64,
                           on_worker_death="respawn", max_respawns=1, **CPU)
    server.add_tenant("default", res)
    server.inject_worker_fault()
    assert server.submit(spec.points[0]).result(timeout=30) == \
        _predict_each(res, spec.points[:1])[0]
    assert server.stats.respawns == 1
    server.inject_worker_fault()      # wakes the idle worker by itself
    deadline = time.monotonic() + 10.0
    while not server._failed and time.monotonic() < deadline:
        time.sleep(0.01)
    assert server._failed
    assert server.stats.worker_deaths == 2 and server.stats.respawns == 1
    with pytest.raises(RuntimeError, match="died"):
        server.submit(spec.points[1])
    server.close(timeout=10)


def test_submit_converts_query_outside_lock(fitted):
    """A probe inside check_query must be able to take the (non-reentrant)
    server lock, proving submit released it first."""
    _, res = fitted
    server = ClusterServer(batch_slots=4, queue_limit=64, start=False, **CPU)
    server.add_tenant("t", res)
    tn = server._tenants[("t", 0)]
    orig, probes = tn.check_query, []

    def probing(q):
        free = server._lock.acquire(timeout=0.2)
        if free:
            server._lock.release()
        probes.append(free)
        return orig(q)

    tn.check_query = probing
    try:
        server.submit(np.zeros(8, np.float32), tenant="t")
    finally:
        server.close(drain=False)
    assert probes == [True], "submit held the lock through check_query"


def test_popped_batch_survives_tenant_removal(fitted):
    spec, res = fitted
    members = spec.points[res.labels >= 0][:4].astype(np.float32)
    want = _predict_each(res, members)
    server = ClusterServer(batch_slots=4, queue_limit=64, start=False, **CPU)
    server.add_tenant("t", res)
    futs = [server.submit(q, tenant="t") for q in members]
    with server._lock:
        popped = server._next_batch()
    assert popped is not None
    tenant, batch = popped
    server.remove_tenant("t", 0)
    server._serve_batch(tenant, batch)
    got = np.asarray([f.result(timeout=5) for f in futs], np.int32)
    np.testing.assert_array_equal(got, want)
    server.close(drain=False)


def test_submit_hammer_during_swap_no_mixed_versions(fitted):
    """Every request pins its version at submit and every batch serves ONE
    snapshot, so in submit order the labels are all-v0 then all-v1."""
    spec, res = fitted
    rev = res._replace(densities=np.ascontiguousarray(res.densities[::-1]),
                       support_idx=np.ascontiguousarray(res.support_idx[::-1]),
                       support_w=np.ascontiguousarray(res.support_w[::-1]),
                       support_v=np.ascontiguousarray(res.support_v[::-1]))
    members = spec.points[res.labels >= 0].astype(np.float32)
    v0 = res.predict(members, device="cpu")
    v1 = rev.predict(members, device="cpu")
    keep = v0 != v1                 # queries whose label names the version
    members, v0, v1 = members[keep], v0[keep], v1[keep]
    assert len(members) >= 4, "need label-distinguishing queries"

    n_requests = 120
    with ClusterServer(batch_slots=4, queue_limit=256, **CPU) as server:
        server.add_tenant("t", res)
        futs = []
        swapped = threading.Event()

        def hammer():
            for i in range(n_requests):
                futs.append((i % len(members),
                             server.submit(members[i % len(members)],
                                           tenant="t")))
                if i == n_requests // 3:
                    swapped.wait(5.0)   # traffic on both sides of the swap

        t = threading.Thread(target=hammer)
        t.start()
        time.sleep(0.02)
        server.swap_tenant("t", rev)
        swapped.set()
        t.join(30.0)
        assert not t.is_alive()
        versions = []
        for qi, f in futs:
            label = f.result(timeout=30)
            if label == v0[qi]:
                versions.append(0)
            elif label == v1[qi]:
                versions.append(1)
            else:
                raise AssertionError(
                    f"label {label} matches neither tenant version "
                    f"({v0[qi]} / {v1[qi]}): a mixed-version batch")
        assert versions == sorted(versions), (
            "v0 label served after a v1 label: a batch mixed snapshots")
        assert versions[0] == 0 and versions[-1] == 1, (
            "swap produced no version transition under load")
