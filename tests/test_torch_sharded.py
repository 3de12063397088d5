"""The port's sharded engine, mirroring tests/test_sharded.py.

Shards share the monolithic LSH projections and partition the dataset, so
chunked retrieval is a re-chunking of replicated retrieval. With probe >=
the largest bucket the two are candidate for candidate identical, and
whole fits agree label for label. The JAX package's own sharded label
test fails on jax 0.9.0 (its mesh entry points raise, ROADMAP C), so the
sharded fit is held to the port's replicated fit and to the JAX package's
replicated fit (backend="ref").
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.alid import ALIDConfig as JALIDConfig
from repro.core.engine import fit as jfit
from repro.data import auto_lsh_params, make_blobs_with_noise
from repro.utils import canonical_labels as canonical
from repro_torch import random as trandom
from repro_torch.core.affinity import estimate_k
from repro_torch.core.alid import ALIDConfig, EngineSpec
from repro_torch.core.civs import civs_update
from repro_torch.core.engine import fit
from repro_torch.core.lid import init_state, lid_solve
from repro_torch.core.roi import ROI, estimate_roi
from repro_torch.core.store import (ShardedStore, build_store,
                                    global_bucket_sizes, take)
from repro_torch.lsh.pstable import (LSHParams, bucket_sizes, build_lsh)
from repro_torch.utils import avg_f1_score


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
    return make_blobs_with_noise(n_clusters=5, cluster_size=24, n_noise=110,
                                 d=10, seed=3)


@pytest.fixture(scope="module")
def lshp(blobs):
    # probe >= max bucket size: no probe-window truncation, so sharded and
    # monolithic retrieval must agree EXACTLY
    return LSHParams(*auto_lsh_params(blobs.points, probe=128))


@pytest.fixture(scope="module")
def pts(blobs):
    return torch.tensor(blobs.points)


@pytest.fixture(scope="module")
def store(pts, lshp):
    return build_store(pts, lshp, trandom.PRNGKey(42), n_shards=5)


def test_store_partitions_dataset(blobs, store):
    n = blobs.points.shape[0]
    gidx = store.global_idx.numpy()
    valid = store.valid.numpy()
    assert np.array_equal(np.sort(gidx[valid]), np.arange(n))
    assert np.array_equal(gidx[store.shard_of.numpy(),
                               store.slot_of.numpy()], np.arange(n))
    assert (gidx[~valid] == -1).all()
    idx = np.arange(0, n, 7)
    np.testing.assert_array_equal(take(store, torch.tensor(idx)).numpy(),
                                  blobs.points[idx])


def test_store_bounding_balls_cover_members(blobs, store):
    gidx, valid = store.global_idx.numpy(), store.valid.numpy()
    centers, radii = store.centers.numpy(), store.radii.numpy()
    for s in range(store.n_shards):
        p = blobs.points[gidx[s][valid[s]]]
        dist = np.linalg.norm(p - centers[s], axis=1)
        assert (dist <= radii[s] + 1e-5).all(), s


def test_global_bucket_sizes_match_monolithic(pts, lshp, store):
    tables = build_lsh(pts, lshp, trandom.PRNGKey(42))
    np.testing.assert_array_equal(bucket_sizes(tables).numpy(),
                                  global_bucket_sizes(store).numpy())


def test_chunked_retrieval_matches_monolithic(blobs, pts, lshp, store):
    """The per-shard top-delta merge returns the candidate set of one
    monolithic query + filter + top_k, for a batch of three seeds."""
    k = estimate_k(pts)
    tables = build_lsh(pts, lshp, trandom.PRNGKey(42))
    cfg = ALIDConfig(a_cap=32, delta=96, lsh=lshp)
    active = torch.ones(pts.shape[0], dtype=torch.bool)
    seeds = torch.tensor([int(np.where(blobs.labels == c)[0][0])
                          for c in (0, 2, 4)], dtype=torch.int32)
    state = lid_solve(init_state(pts, seeds, cfg.cap), k, max_iters=50)
    roi = estimate_roi(state.v_beta, state.beta_idx, state.beta_mask,
                       state.x, k, torch.tensor([1, 2, 3]))
    mono = civs_update(state, roi, pts, active, tables, lshp, k,
                       a_cap=cfg.a_cap, delta=cfg.delta)
    shrd = civs_update(state, roi, store, active, None, lshp, k,
                       a_cap=cfg.a_cap, delta=cfg.delta)
    assert (mono.n_candidates < cfg.delta).all()
    np.testing.assert_array_equal(mono.n_candidates.numpy(),
                                  shrd.n_candidates.numpy())
    for b in range(3):
        pm, mm = mono.state.beta_idx[b].numpy(), mono.state.beta_mask[b]
        ps, ms = shrd.state.beta_idx[b].numpy(), shrd.state.beta_mask[b]
        assert set(pm[cfg.a_cap:][mm[cfg.a_cap:].numpy()].tolist()) == \
            set(ps[cfg.a_cap:][ms[cfg.a_cap:].numpy()].tolist())
    np.testing.assert_array_equal(mono.infective_found.numpy(),
                                  shrd.infective_found.numpy())


def test_civs_dispatch_is_type_driven(pts, lshp, store):
    """civs_update keeps ONE signature; the points operand picks the
    substrate (tensor = replicated, ShardedStore = out of core)."""
    assert isinstance(store, ShardedStore)
    k = estimate_k(pts)
    cfg = ALIDConfig(a_cap=16, delta=32, lsh=lshp)
    state = init_state(pts, torch.tensor([0], dtype=torch.int32), cfg.cap)
    roi = estimate_roi(state.v_beta, state.beta_idx, state.beta_mask,
                       state.x, k, torch.tensor([1]))
    out = civs_update(state, roi, store, torch.ones(pts.shape[0],
                                                    dtype=torch.bool),
                      None, lshp, k, a_cap=cfg.a_cap, delta=cfg.delta)
    assert out.state.x.shape == (1, cfg.cap)


@pytest.fixture(scope="module")
def replicated(blobs, lshp):
    """The port's and the JAX package's replicated fits (backend="ref")."""
    cfg = ALIDConfig(a_cap=48, delta=48, lsh=lshp, seeds_per_round=16,
                     max_rounds=20)
    ser = fit(blobs.points, cfg, trandom.PRNGKey(0), device="cpu")
    want = jfit(blobs.points, JALIDConfig(
        a_cap=48, delta=48, lsh=auto_lsh_params(blobs.points, probe=128),
        seeds_per_round=16, max_rounds=20)._replace(
            spec=JALIDConfig().spec._replace(backend="ref")),
        jax.random.PRNGKey(0))
    return cfg, ser, want


@pytest.mark.parametrize("n_shards", [1, 5, 9])
def test_sharded_label_parity(blobs, replicated, n_shards):
    """The sharded fit gives the replicated fit's clustering (the port's
    and the JAX package's): same rng consumption, same seeding statistics,
    exact retrieval."""
    cfg, ser, want = replicated
    shd = fit(blobs.points, cfg._replace(spec=EngineSpec(
        engine="sharded", n_shards=n_shards)), trandom.PRNGKey(0),
        device="cpu")
    assert ser.n_clusters > 0
    np.testing.assert_array_equal(canonical(ser.labels), canonical(shd.labels))
    np.testing.assert_array_equal(canonical(want.labels),
                                  canonical(shd.labels))
    assert shd.n_rounds == ser.n_rounds == want.n_rounds
    np.testing.assert_allclose(np.sort(ser.densities), np.sort(shd.densities),
                               rtol=1e-6)


def test_global_probe_budget_on_oversized_bucket():
    """One `probe`-wide budget is split across shards, so a bucket LARGER
    than probe that spans several shards yields min(bucket, probe)
    candidates, the replicated engine's sample size, not up to S * probe."""
    rng = np.random.default_rng(0)
    cluster = rng.normal(0, 0.05, size=(100, 8)).astype(np.float32)
    noise = rng.uniform(-30, 30, size=(40, 8)).astype(np.float32)
    perm = rng.permutation(140)
    pts = torch.tensor(np.concatenate([cluster, noise])[perm])
    lshp = LSHParams(n_tables=1, n_projections=4, seg_len=4.0, probe=8)
    key = trandom.PRNGKey(42)
    tables = build_lsh(pts, lshp, key)
    assert int(bucket_sizes(tables).max()) >= 100          # oversized
    store4 = build_store(pts, lshp, key, n_shards=4)
    k = estimate_k(pts)
    cfg = ALIDConfig(a_cap=16, delta=64, lsh=lshp)
    seed = int(np.where(perm == 0)[0][0])                   # a cluster member
    state = init_state(pts, torch.tensor([seed], dtype=torch.int32), cfg.cap)
    roi = ROI(center=torch.tensor(cluster.mean(0))[None],
              radius=torch.tensor([5.0]), r_in=torch.tensor([0.0]),
              r_out=torch.tensor([10.0]), pi=torch.tensor([0.0]))
    active = torch.ones(pts.shape[0], dtype=torch.bool)
    mono = civs_update(state, roi, pts, active, tables, lshp, k,
                       a_cap=cfg.a_cap, delta=cfg.delta)
    shrd = civs_update(state, roi, store4, active, None, lshp, k,
                       a_cap=cfg.a_cap, delta=cfg.delta)
    n_mono, n_shrd = int(mono.n_candidates[0]), int(shrd.n_candidates[0])
    assert n_shrd <= lshp.probe and n_mono <= lshp.probe
    # the engines sample the bucket in different orders, so the query point
    # itself (a support member, excluded) may fall in only one window
    assert abs(n_shrd - n_mono) <= 1
    assert n_shrd >= lshp.probe - 1


def test_sharded_quality_with_default_probe(blobs):
    """With the default (truncating) probe the engines may retrieve other
    candidates, but the sharded engine still clusters well."""
    lshp = LSHParams(*auto_lsh_params(blobs.points))        # probe 16
    cfg = ALIDConfig(a_cap=48, delta=48, lsh=lshp, seeds_per_round=16,
                     max_rounds=20,
                     spec=EngineSpec(engine="sharded", n_shards=4))
    res = fit(blobs.points, cfg, trandom.PRNGKey(1), device="cpu")
    assert avg_f1_score(blobs.labels, res.labels) > 0.6
