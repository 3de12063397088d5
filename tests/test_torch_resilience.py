"""The port's fault tolerance, mirroring tests/test_resilience.py:
RetryPolicy schedules, resilient source wrapping, FaultySource transient
faults, checksum-guarded tiers (cache / scratch / source fallback),
reader-death inline fallback, bounded reader joins and round-level
checkpoint resume. Every chaos arm lands on labels BIT-IDENTICAL to the
clean run. A fit checkpoint written by the JAX package's `fit` resumes in
the port, and one written by the port resumes in the JAX package, with the
uninterrupted run's labels.
"""

import threading

import jax
import numpy as np
import torch
import pytest

from repro.core.alid import ALIDConfig as JALIDConfig, EngineSpec as JSpec
from repro.core import resilience as jres
from repro.core.engine import fit as jfit
from repro.data import auto_lsh_params, make_blobs_with_noise
from repro.utils import canonical_labels
from repro_torch import random as trandom
from repro_torch.core.alid import ALIDConfig, EngineSpec
from repro_torch.core.engine import fit, make_engine
from repro_torch.core.pipeline import ShardPipeline
from repro_torch.core.resilience import (CorruptionError, FaultySource,
                                         InjectedFault, PipelineFaults,
                                         ReaderKilled, ResilientSource,
                                         RetryPolicy, resilient)
from repro_torch.core.source import CountingSource, InMemorySource
from repro_torch.core.store import build_store_streamed, update_shard_points
from repro_torch.lsh.pstable import LSHParams

# zero-delay policy: the same retry semantics, no wall clock in the tests
FAST_RETRY = RetryPolicy(attempts=4, base_delay=0.0, jitter=0.0)


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
    return auto_lsh_params(blobs.points, probe=128)


@pytest.fixture(scope="module")
def cfg(lshp):
    # exhaustive: the loop peels noise too (several rounds on this data), so
    # a crash at round 2 or 3 lands mid-run with checkpoints on disk
    return ALIDConfig(a_cap=48, delta=48, lsh=LSHParams(*lshp),
                      seeds_per_round=16, max_rounds=20, exhaustive=True)


@pytest.fixture(scope="module")
def jcfg(lshp):
    return JALIDConfig(a_cap=48, delta=48, lsh=lshp, seeds_per_round=16,
                       max_rounds=20, exhaustive=True,
                       spec=JSpec(backend="ref"))


@pytest.fixture(scope="module")
def jax_reference(blobs, jcfg):
    return jfit(blobs.points, jcfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def reference(blobs, cfg):
    res = fit(blobs.points, cfg, trandom.PRNGKey(0), device="cpu")
    assert res.n_rounds > 3          # a crash at round 2 or 3 is mid-run
    return res


# ------------------------------------------------------------ RetryPolicy --
def test_retry_schedule_is_deterministic_and_bounded():
    p = RetryPolicy(attempts=5, base_delay=0.1, max_delay=0.35, jitter=0.25,
                    seed=3)
    d1, d2 = p.delays(), p.delays()
    assert d1 == d2 and len(d1) == 4
    for got, cap in zip(d1, [0.1, 0.2, 0.35, 0.35]):
        assert cap * 0.75 <= got <= cap * 1.25
    # the JAX package's schedule, draw for draw
    assert d1 == jres.RetryPolicy(attempts=5, base_delay=0.1, max_delay=0.35,
                                  jitter=0.25, seed=3).delays()


def test_retry_call_retries_transient_then_succeeds():
    p = RetryPolicy(attempts=4, base_delay=0.1, jitter=0.25, seed=0)
    calls, sleeps, retries = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return 42

    assert p.call(flaky, on_retry=lambda a, e: retries.append(a),
                  sleep=sleeps.append) == 42
    assert len(calls) == 3 and retries == [0, 1]
    assert sleeps == p.delays()[:2]


def test_retry_call_exhausts_and_raises():
    calls = []

    def dead():
        calls.append(1)
        raise OSError("persistent")

    with pytest.raises(OSError, match="persistent"):
        FAST_RETRY.call(dead, sleep=lambda d: None)
    assert len(calls) == FAST_RETRY.attempts


def test_retry_call_never_masks_bugs():
    calls = []

    def bug():
        calls.append(1)
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        FAST_RETRY.call(bug, sleep=lambda d: None)
    assert len(calls) == 1


def test_resilient_wrap_is_idempotent(blobs):
    src = InMemorySource(blobs.points)
    wrapped = resilient(src, FAST_RETRY)
    assert isinstance(wrapped, ResilientSource)
    assert resilient(wrapped, FAST_RETRY) is wrapped
    assert resilient(src, None) is src
    np.testing.assert_array_equal(wrapped.get_chunk(3, 5),
                                  src.get_chunk(3, 5))
    np.testing.assert_array_equal(wrapped.sample(np.array([1, 7, 2])),
                                  src.sample(np.array([1, 7, 2])))


# ------------------------------------------------------------ FaultySource --
def test_faulty_source_budget_guarantees_success(blobs):
    faulty = FaultySource(InMemorySource(blobs.points), rate=1.0, seed=0,
                          fail_times=2)
    wrapped = ResilientSource(faulty, FAST_RETRY, sleep=lambda d: None)
    np.testing.assert_array_equal(wrapped.get_chunk(0, 8), blobs.points[:8])
    assert faulty.injected == 2 and wrapped.retries == 2


def test_faulty_source_schedule_is_seeded(blobs):
    def run(pkg, seed):
        f = pkg.FaultySource(InMemorySource(blobs.points), rate=0.5,
                             seed=seed)
        hits = []
        for i in range(20):
            try:
                f.get_chunk(i, 4)
                hits.append(0)
            except OSError as exc:
                assert isinstance(exc, (InjectedFault, jres.InjectedFault))
                hits.append(1)
        return hits

    from repro_torch.core import resilience as tres
    assert run(tres, 1) == run(tres, 1) == run(jres, 1)
    assert run(tres, 1) != run(tres, 2)


def test_streamed_fit_under_transient_faults_is_bit_identical(
        blobs, cfg, reference):
    espec = EngineSpec(engine="streamed", n_shards=5)
    faulty = FaultySource(InMemorySource(blobs.points), rate=0.1, seed=1)
    res = fit(faulty, cfg._replace(spec=espec), trandom.PRNGKey(0),
              retry_policy=FAST_RETRY, device="cpu")
    np.testing.assert_array_equal(reference.labels, res.labels)
    np.testing.assert_allclose(reference.densities, res.densities, rtol=1e-6)
    assert res.n_rounds == reference.n_rounds
    assert faulty.injected > 0


# ------------------------------------------------- checksum + tier chain --
@pytest.fixture()
def store(blobs, cfg, tmp_path):
    src = CountingSource(InMemorySource(blobs.points))
    st = build_store_streamed(src, cfg.lsh, trandom.PRNGKey(3), n_shards=5,
                              scratch_dir=str(tmp_path))
    yield st
    st.scratch.close()


def test_scratch_corruption_falls_back_to_source_and_heals(store):
    pipe = ShardPipeline(store, cache_bytes=0, retry=FAST_RETRY)
    clean = pipe.fetch_bundle(2)[0].copy()
    store.scratch.corrupt(2)
    with pytest.raises(CorruptionError):
        store.scratch.read(2)
    np.testing.assert_array_equal(pipe.fetch_bundle(2)[0], clean)
    assert pipe.stats.corruptions == 1
    assert pipe.stats.tier_fallbacks == 1
    assert pipe.stats.source_reads == 1
    pipe.fetch_bundle(2)                 # the slab was healed
    assert pipe.stats.corruptions == 1
    np.testing.assert_array_equal(store.scratch.read(2), clean)


def test_cache_corruption_drops_entry_and_refetches(store):
    pipe = ShardPipeline(store, cache_bytes=1 << 30, retry=FAST_RETRY)
    first = pipe.fetch_bundle(1)
    entry = pipe.cache._entries[1][2][0]
    entry[0, 0] = np.float32(np.float64(entry[0, 0]) + 1.0) \
        if entry[0, 0] < 1e6 else 0.0
    again = pipe.fetch_bundle(1)
    assert again is not first
    assert pipe.cache.corrupt_evictions == 1
    assert pipe.stats.corruptions == 1
    m = store.shard_count(1)
    np.testing.assert_array_equal(
        again[0][:m], store.source.sample(store.global_idx[1, :m]))


def test_mutated_shard_corruption_is_unrecoverable(store):
    pipe = ShardPipeline(store, cache_bytes=0, retry=FAST_RETRY)
    rows = pipe.fetch_bundle(1)[0].copy()
    rows[0, 0] += 5.0
    update_shard_points(store, 1, rows)
    store.scratch.corrupt(1)
    with pytest.raises(CorruptionError, match="no clean tier"):
        pipe.fetch_bundle(1)


def test_fit_with_forced_scratch_corruption_is_bit_identical(
        blobs, cfg, reference):
    espec = EngineSpec(engine="streamed", n_shards=5, cache_bytes=0)
    engine = make_engine(espec, device="cpu")
    engine.faults = PipelineFaults(corrupt_rate=0.3, seed=2)
    try:
        res = fit(blobs.points, cfg._replace(spec=espec), trandom.PRNGKey(0),
                  engine=engine, retry_policy=FAST_RETRY)
        np.testing.assert_array_equal(reference.labels, res.labels)
        assert res.n_rounds == reference.n_rounds
        assert engine.faults.corrupted > 0
        assert engine.stats.corruptions == engine.faults.corrupted
        assert engine.stats.tier_fallbacks == engine.faults.corrupted
    finally:
        engine.close()


# ------------------------------------------------------ prefetch reader --
def test_reader_death_falls_back_inline_bit_identical(store):
    faults = PipelineFaults(kill_reader_at=1)
    pipe = ShardPipeline(store, cache_bytes=0, prefetch_depth=2,
                         retry=FAST_RETRY, faults=faults)
    sync = ShardPipeline(store, cache_bytes=0, retry=FAST_RETRY)
    routed = [3, 0, 4, 2]
    seen = []
    for pos, s, dev in pipe.stream(routed):
        seen.append((pos, s))
        np.testing.assert_array_equal(dev[0].numpy(),
                                      sync.fetch_bundle(s)[0])
    assert seen == list(enumerate(routed))
    assert faults.reader_kills == 1
    assert pipe.stats.reader_deaths == 1
    assert pipe.stats.shards_streamed == len(routed)
    # the reader produced bundle 0 and died at bundle 1: 3 shards inline
    assert pipe.stats.shards_prefetched == 1
    assert pipe.stats.fallbacks(prefetched=True) == {
        "reader_deaths": 1, "shards_inline": len(routed) - 1}
    with pytest.raises(ReaderKilled):
        PipelineFaults(kill_reader_at=0).on_produce()


def test_reader_death_does_not_mask_real_errors(store):
    pipe = ShardPipeline(store, cache_bytes=0, prefetch_depth=2,
                         retry=FAST_RETRY)
    with pytest.raises(IndexError):
        list(pipe.stream([0, store.n_shards + 17]))


def test_fit_with_reader_kill_is_bit_identical(blobs, cfg, reference):
    espec = EngineSpec(engine="streamed", n_shards=5, cache_bytes=0,
                       prefetch_depth=2)
    engine = make_engine(espec, device="cpu")
    engine.faults = PipelineFaults(kill_reader_at=3)
    try:
        res = fit(blobs.points, cfg._replace(spec=espec), trandom.PRNGKey(0),
                  engine=engine, retry_policy=FAST_RETRY)
        np.testing.assert_array_equal(reference.labels, res.labels)
        assert res.n_rounds == reference.n_rounds
        assert engine.faults.reader_kills == 1
        assert engine.stats.reader_deaths == 1
    finally:
        engine.close()


def test_wedged_reader_join_is_bounded(store):
    pipe = ShardPipeline(store, cache_bytes=0, prefetch_depth=2,
                         retry=FAST_RETRY, join_timeout=0.2)
    release = threading.Event()
    orig = pipe.fetch_bundle

    def wedged(s):
        if s == 1:
            release.wait(30.0)       # the producer stalls on shard 1
        return orig(s)

    pipe.fetch_bundle = wedged
    try:
        gen = pipe.stream([0, 1, 2])
        next(gen)
        with pytest.warns(RuntimeWarning, match="abandon"):
            gen.close()
        assert pipe.stats.readers_abandoned == 1
    finally:
        release.set()


# ------------------------------------------------------- crash + resume --
@pytest.mark.parametrize("engine,crash", [("replicated", 2),
                                          ("sharded", 2), ("streamed", 3)])
def test_crash_then_resume_is_bit_identical(blobs, cfg, reference, tmp_path,
                                            engine, crash):
    scfg = cfg._replace(spec=EngineSpec(engine=engine, n_shards=5))
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match=f"injected crash at round "
                                           f"{crash}"):
        fit(blobs.points, scfg, trandom.PRNGKey(0), checkpoint_dir=ckpt,
            crash_at_round=crash, device="cpu")
    res = fit(blobs.points, scfg, trandom.PRNGKey(0), checkpoint_dir=ckpt,
              resume=True, device="cpu")
    np.testing.assert_array_equal(reference.labels, res.labels)
    np.testing.assert_allclose(reference.densities, res.densities, rtol=1e-6)
    assert res.n_rounds == reference.n_rounds
    assert res.n_clusters == reference.n_clusters


def test_resume_with_empty_dir_runs_from_scratch(blobs, cfg, reference,
                                                 tmp_path):
    res = fit(blobs.points, cfg, trandom.PRNGKey(0),
              checkpoint_dir=str(tmp_path / "none"), resume=True,
              device="cpu")
    np.testing.assert_array_equal(reference.labels, res.labels)
    assert res.n_rounds == reference.n_rounds


def test_resume_requires_checkpoint_dir(blobs, cfg):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        fit(blobs.points, cfg, trandom.PRNGKey(0), resume=True, device="cpu")


def test_resume_rejects_mismatched_dataset(blobs, cfg, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="injected crash"):
        fit(blobs.points, cfg, trandom.PRNGKey(0), checkpoint_dir=ckpt,
            crash_at_round=2, device="cpu")
    with pytest.raises(ValueError, match="n="):
        fit(blobs.points[:-3], cfg, trandom.PRNGKey(0), checkpoint_dir=ckpt,
            resume=True, device="cpu")


def test_corrupt_checkpoint_falls_back_to_previous_step(blobs, cfg,
                                                        reference, tmp_path):
    from repro_torch.checkpoint.manager import list_checkpoints
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="injected crash"):
        fit(blobs.points, cfg, trandom.PRNGKey(0), checkpoint_dir=ckpt,
            crash_at_round=3, device="cpu")
    steps = list_checkpoints(ckpt)
    assert len(steps) >= 2
    npz = tmp_path / "ckpt" / f"step_{steps[-1]:08d}" / "arrays.npz"
    with np.load(str(npz)) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    arrays["labels"][0] ^= 1
    np.savez(str(npz), **arrays)
    with pytest.warns(RuntimeWarning, match="unusable"):
        res = fit(blobs.points, cfg, trandom.PRNGKey(0), checkpoint_dir=ckpt,
                  resume=True, device="cpu")
    np.testing.assert_array_equal(reference.labels, res.labels)
    assert res.n_rounds == reference.n_rounds


# ---------------------------------------------- across the two packages --
@pytest.mark.parametrize("engine", ["replicated", "streamed"])
def test_jax_fit_checkpoint_resumes_in_port(blobs, cfg, jcfg, reference,
                                            jax_reference, tmp_path, engine):
    """The JAX package's fit crashes at round 3; the port resumes from its
    checkpoint and lands on the uninterrupted fit's clustering. (Label
    NUMBERS follow the winning seed rows, which each package picks among
    its own density near-ties, so the labels are compared canonically.)"""
    want = jax_reference
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="injected crash"):
        jfit(blobs.points, jcfg, jax.random.PRNGKey(0), checkpoint_dir=ckpt,
             crash_at_round=3)
    res = fit(blobs.points, cfg._replace(spec=EngineSpec(
        engine=engine, n_shards=5)), trandom.PRNGKey(0),
        checkpoint_dir=ckpt, resume=True, device="cpu")
    np.testing.assert_array_equal(canonical_labels(res.labels),
                                  canonical_labels(want.labels))
    np.testing.assert_array_equal(canonical_labels(res.labels),
                                  canonical_labels(reference.labels))
    assert res.n_rounds == want.n_rounds
    np.testing.assert_allclose(np.sort(res.densities),
                               np.sort(want.densities), rtol=1e-6)


def test_port_fit_checkpoint_resumes_in_jax(blobs, cfg, jcfg, jax_reference,
                                            tmp_path):
    """The reverse: the port's fit crashes at round 3, the JAX package
    resumes from its checkpoint and lands on its own uninterrupted
    labels."""
    want = jax_reference
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="injected crash"):
        fit(blobs.points, cfg, trandom.PRNGKey(0), checkpoint_dir=ckpt,
            crash_at_round=3, device="cpu")
    res = jfit(blobs.points, jcfg, jax.random.PRNGKey(0),
               checkpoint_dir=ckpt, resume=True)
    np.testing.assert_array_equal(canonical_labels(res.labels),
                                  canonical_labels(want.labels))
    assert res.n_rounds == want.n_rounds
    np.testing.assert_allclose(np.sort(res.densities),
                               np.sort(want.densities), rtol=1e-6)
