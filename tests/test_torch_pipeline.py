"""The port's shard pipeline behind StreamedEngine, mirroring
tests/test_pipeline.py: every pipeline configuration against the
replicated fit (the JAX package's, canonically, and the port's, bit for
bit), scratch-slab fidelity, LRU semantics (bit-identical hits, bounded
eviction, forced-eviction exactness, generations), the prefetch order and
bytes, reader errors, the steady-state I/O contract and engine teardown.
"""

import os

import jax
import numpy as np
import pytest
import torch

from repro.core.alid import ALIDConfig as JALIDConfig, EngineSpec as JSpec
from repro.core.engine import fit as jfit
from repro.data import auto_lsh_params, make_blobs_with_noise
from repro.utils import canonical_labels
from repro_torch import random as trandom
from repro_torch.core.alid import ALIDConfig, EngineSpec
from repro_torch.core.engine import StreamedEngine, fit, make_engine
from repro_torch.core.pipeline import (ScratchShards, ShardBundleCache,
                                       ShardPipeline)
from repro_torch.core.source import CountingSource, InMemorySource
from repro_torch.core.store import build_store_streamed, update_shard_points
from repro_torch.lsh.pstable import LSHParams


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the data is small, and a pool of one thread a
    core in each of several test workers oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blobs():
    return make_blobs_with_noise(n_clusters=4, cluster_size=25, n_noise=80,
                                 d=10, seed=7, overlap_pairs=0)


@pytest.fixture(scope="module")
def lshp(blobs):
    # probe >= max bucket: retrieval exhaustive, every engine exact
    return auto_lsh_params(blobs.points, probe=128)


@pytest.fixture(scope="module")
def cfg(lshp):
    return ALIDConfig(a_cap=48, delta=48, lsh=LSHParams(*lshp),
                      seeds_per_round=16, max_rounds=20)


def _sync_spec(**kw):
    """The synchronous path: no scratch, no cache, no reader thread."""
    return EngineSpec(engine="streamed", n_shards=5, cache_bytes=0,
                      prefetch_depth=0, scratch_dir=None, **kw)


@pytest.fixture(scope="module")
def jax_exhaustive(blobs, lshp):
    return jfit(blobs.points, JALIDConfig(
        a_cap=48, delta=48, lsh=lshp, seeds_per_round=16, max_rounds=20,
        exhaustive=True, spec=JSpec(backend="ref")), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def reference(blobs, cfg, lshp):
    """The JAX package's replicated fit and the port's replicated and
    synchronous-streamed fits: equal labels; everything here must match."""
    want = jfit(blobs.points, JALIDConfig(
        a_cap=48, delta=48, lsh=lshp, seeds_per_round=16, max_rounds=20,
        spec=JSpec(backend="ref")), jax.random.PRNGKey(0))
    rep = fit(blobs.points, cfg, trandom.PRNGKey(0), device="cpu")
    sync = fit(blobs.points, cfg._replace(spec=_sync_spec()),
               trandom.PRNGKey(0), device="cpu")
    np.testing.assert_array_equal(canonical_labels(rep.labels),
                                  canonical_labels(want.labels))
    np.testing.assert_array_equal(rep.labels, sync.labels)
    assert rep.n_rounds == sync.n_rounds == want.n_rounds
    return want, rep


# ------------------------------------------------------------ label parity --
@pytest.mark.parametrize("espec", [
    # the pipelined default: scratch + LRU + depth-2 ring
    EngineSpec(engine="streamed", n_shards=5),
    # a one-slot ring degenerates to the synchronous order
    EngineSpec(engine="streamed", n_shards=5, prefetch_depth=1),
    # a deeper ring than shards
    EngineSpec(engine="streamed", n_shards=5, prefetch_depth=7),
    # cache without prefetch, prefetch without cache, scratch alone
    EngineSpec(engine="streamed", n_shards=5, prefetch_depth=0),
    EngineSpec(engine="streamed", n_shards=5, cache_bytes=0,
               scratch_dir=None),
    EngineSpec(engine="streamed", n_shards=5, cache_bytes=0,
               prefetch_depth=0),
], ids=["pipelined", "depth1", "depth7", "cache_only", "prefetch_only",
        "scratch_only"])
@pytest.mark.parametrize("exhaustive", [False, True])
def test_pipeline_parity(blobs, cfg, reference, jax_exhaustive, espec,
                         exhaustive):
    """Every pipeline configuration gives the replicated fit's labels: the
    JAX package's canonically (n_rounds equal, densities within rtol
    1e-6), the port's bit for bit; and takes no fallback: no retry,
    corruption, tier fallback or reader death, and with the reader on,
    the reader produced every shard (the pipelined path gave the labels,
    not the inline one)."""
    want, rep = reference
    if exhaustive:
        want, rep = jax_exhaustive, None
    engine = make_engine(espec, device="cpu")
    try:
        res = fit(blobs.points,
                  cfg._replace(spec=espec, exhaustive=exhaustive),
                  trandom.PRNGKey(0), engine=engine)
        prefetched = espec.prefetch_depth > 0
        assert engine.stats.fallbacks(prefetched=prefetched) == {}
        assert engine.stats.shards_prefetched == (
            engine.stats.shards_streamed if prefetched else 0)
    finally:
        engine.close()
    np.testing.assert_array_equal(canonical_labels(res.labels),
                                  canonical_labels(want.labels))
    np.testing.assert_allclose(np.sort(res.densities),
                               np.sort(want.densities), rtol=1e-6)
    assert res.n_rounds == want.n_rounds
    if rep is not None:
        np.testing.assert_array_equal(res.labels, rep.labels)


def test_forced_eviction_exact_labels(blobs, cfg, reference):
    """cache_bytes below ONE shard: every put is refused, every fetch goes
    to scratch, and the labels are still exact."""
    espec = EngineSpec(engine="streamed", n_shards=5, cache_bytes=64)
    engine = make_engine(espec, device="cpu")
    res = fit(blobs.points, cfg._replace(spec=espec), trandom.PRNGKey(0),
              engine=engine)
    try:
        np.testing.assert_array_equal(reference[1].labels, res.labels)
        assert engine.stats.cache_hits == 0
        assert len(engine._pipeline.cache) == 0
        assert engine.stats.scratch_reads == engine.stats.shards_streamed
    finally:
        engine.close()


# ------------------------------------------------------- scratch + bundles --
@pytest.fixture()
def store(blobs, cfg, tmp_path):
    src = CountingSource(InMemorySource(blobs.points))
    st = build_store_streamed(src, cfg.lsh, trandom.PRNGKey(3), n_shards=5,
                              scratch_dir=str(tmp_path))
    yield st
    st.scratch.close()


def test_scratch_slab_matches_source_gather(store):
    """The persisted slab is byte for byte the re-gather `shard_points`
    would do without scratch."""
    assert isinstance(store.scratch, ScratchShards)
    for s in range(store.n_shards):
        m = store.shard_count(s)
        expect = np.zeros((store.shard_cap, store.dim), np.float32)
        expect[:m] = store.source.sample(store.global_idx[s, :m])
        got = store.scratch.read(s)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, expect)
        assert got.base is None          # an owned copy, not a memmap view


def test_lru_hit_is_bit_identical_and_skips_io(store):
    pipe = ShardPipeline(store, cache_bytes=1 << 30)
    first = pipe.fetch_bundle(2)
    src = store.source
    src.reset()
    again = pipe.fetch_bundle(2)
    assert src.sample_calls == 0 and src.chunk_calls == 0
    assert pipe.stats.cache_hits == 1
    for a, b in zip(first, again):
        assert a is b                    # the very same arrays
        np.testing.assert_array_equal(a, b)


def test_lru_budget_evicts_least_recent(store):
    shard_nbytes = store.scratch.read(0).nbytes
    cache = ShardBundleCache(budget_bytes=2 * shard_nbytes)
    pipe = ShardPipeline(store, cache_bytes=0)
    for s in (0, 1):
        cache.put(s, pipe.fetch_bundle(s))
    assert cache.get(0) is not None      # 0 becomes the most recent
    cache.put(2, pipe.fetch_bundle(2))   # evicts 1, the least recent
    assert cache.get(1) is None
    assert cache.get(0) is not None and cache.get(2) is not None
    assert cache.nbytes <= 2 * shard_nbytes
    small = ShardBundleCache(budget_bytes=shard_nbytes - 1)
    small.put(3, pipe.fetch_bundle(3))
    assert len(small) == 0               # larger than the whole budget


def test_shard_mutation_invalidates_cached_bundle(store):
    """A bundle cached before `update_shard_points` is not served after
    it: the generation mismatch drops it and the fetch reads the new
    bytes."""
    pipe = ShardPipeline(store, cache_bytes=1 << 30)
    before = pipe.fetch_bundle(1)
    rows = before[0].copy()
    rows[0, 0] += 5.0
    gen = update_shard_points(store, 1, rows)
    assert gen == 1 and store.generations[1] == 1
    after = pipe.fetch_bundle(1)
    assert after[0] is not before[0]
    np.testing.assert_array_equal(after[0], rows)
    assert pipe.stats.cache_stale == 1
    assert pipe.cache.stale_evictions == 1
    assert pipe.fetch_bundle(1)[0] is after[0]
    assert pipe.stats.cache_hits == 1
    assert pipe.fetch_bundle(0) is pipe.fetch_bundle(0)


def test_update_shard_points_requires_scratch(blobs, cfg, store):
    st = build_store_streamed(InMemorySource(blobs.points), cfg.lsh,
                              trandom.PRNGKey(3), n_shards=5,
                              scratch_dir=None)
    rows = np.zeros((st.shard_cap, st.dim), np.float32)
    with pytest.raises(ValueError, match="scratch"):
        update_shard_points(st, 0, rows)
    with pytest.raises(ValueError, match="slab"):
        update_shard_points(store, 0, rows[:1])
    assert store.generations[0] == 0


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_stream_order_and_bytes(store, depth):
    """Streaming yields (pos, shard, device bundle) in routed order with
    exactly the host bundle's bytes (keys as int64 uint32 values, the
    maps as int64)."""
    pipe = ShardPipeline(store, cache_bytes=0, prefetch_depth=depth)
    routed = [3, 0, 4]
    seen = []
    for pos, s, dev in pipe.stream(routed):
        seen.append((pos, s))
        host = pipe.fetch_bundle(s)
        for d_t, h in zip(dev, host):
            assert d_t.dtype == (torch.float32 if h.dtype == np.float32
                                 else torch.int64)
            np.testing.assert_array_equal(d_t.numpy(), h.astype(
                np.float32 if h.dtype == np.float32 else np.int64))
    assert seen == [(0, 3), (1, 0), (2, 4)]
    assert pipe.stats.shards_streamed == 3
    assert pipe.stats.shards_prefetched == (3 if depth else 0)
    assert pipe.stats.fallbacks(prefetched=depth > 0) == {}


def test_prefetch_propagates_reader_errors(store):
    pipe = ShardPipeline(store, cache_bytes=0, prefetch_depth=2)
    with pytest.raises(IndexError):
        list(pipe.stream([0, store.n_shards + 17]))


# -------------------------------------------------- steady-state I/O + close --
def test_steady_state_reads_source_only_at_build(blobs, cfg):
    """With scratch + LRU, the source serves the build and the per-round
    seed and support rows, never a steady-state shard re-read."""
    src = CountingSource(InMemorySource(blobs.points))
    espec = EngineSpec(engine="streamed", n_shards=5)
    engine = make_engine(espec, device="cpu")
    try:
        res = fit(src, cfg._replace(spec=espec), trandom.PRNGKey(0),
                  engine=engine)
        assert res.n_clusters > 0
        assert engine.stats.source_reads == 0
        assert engine.stats.scratch_reads <= 5   # at most once a shard
        assert engine.stats.cache_hits > 0
        n = blobs.points.shape[0]
        assert src.sample_rows - (n + 512) < res.n_rounds * 3 * cfg.cap
        st = engine.stats
        executed = st.seed_prefetch_hits + st.seed_prefetch_misses
        assert res.n_rounds - 1 <= executed <= res.n_rounds
        assert st.rounds_speculated == executed
        assert st.seed_prefetch_misses <= 1 + st.rounds_resampled
    finally:
        engine.close()


def test_close_releases_device_state_and_scratch(blobs, cfg, tmp_path):
    espec = EngineSpec(engine="streamed", n_shards=5,
                       scratch_dir=str(tmp_path))
    engine = make_engine(espec, device="cpu")
    fit(blobs.points, cfg._replace(spec=espec), trandom.PRNGKey(0),
        engine=engine)
    scratch_path = engine._store.scratch.path
    assert os.path.exists(scratch_path)
    assert len(engine._pipeline.cache) > 0
    engine.close()
    assert not os.path.exists(scratch_path)      # the memmap unlinked
    assert engine._pipeline._slots == [None, None]
    assert len(engine._pipeline.cache) == 0
    assert engine._prepared == [] and engine._executor is None
    engine.close()                               # idempotent


def test_fit_closes_its_own_engine(blobs, cfg, monkeypatch):
    closed = []
    orig = StreamedEngine.close
    monkeypatch.setattr(StreamedEngine, "close",
                        lambda self: (closed.append(True), orig(self)))
    fit(blobs.points,
        cfg._replace(spec=EngineSpec(engine="streamed", n_shards=5)),
        trandom.PRNGKey(0), device="cpu")
    assert closed == [True]
