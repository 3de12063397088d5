"""The port's out-of-core stores (`repro_torch.core.store`) and the global
probe windows (`repro_torch.lsh.pstable`) against the JAX package's, on
the blobs fixture of tests/test_sharded.py.

Integer outputs are equal: the shard order, global indices, validity, the
inverse maps, per-shard sorted keys and permutations, bucket sizes and the
probe windows. The shard order sorts a spatial score that the port sums in
the pinned order (`pstable.spatial_score`) and XLA in its own, with
projections that agree to a few ulps (tests/test_torch_random.py): the two
orders may part only between points whose scores lie within the rounding
of an f32 dot, which `_assert_order_rule` states; on this data they do not
part at all. Centres and radii are f32 / f64 metadata, compared to
rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import store as jstore
from repro.core.affinity import estimate_k
from repro.core.alid import ALIDConfig
from repro.core.civs import civs_update as jcivs_update
from repro.core.lid import init_state, lid_solve
from repro.core.roi import estimate_roi
from repro.core.source import InMemorySource as JInMemorySource
from repro.data import auto_lsh_params, make_blobs_with_noise
from repro.lsh import pstable as jp
from repro_torch import random as trandom
from repro_torch.convert import lid_state_from_numpy, sharded_store_from_numpy
from repro_torch.core import store as tstore
from repro_torch.core.civs import civs_update
from repro_torch.core.roi import ROI
from repro_torch.core.source import InMemorySource
from repro_torch.lsh import pstable as tp

KEY = 42


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
    return auto_lsh_params(blobs.points, probe=128)


@pytest.fixture(scope="module")
def jax_store(blobs, lshp):
    return jstore.build_store(jnp.asarray(blobs.points), lshp,
                              jax.random.PRNGKey(KEY), n_shards=5,
                              backend="ref")


@pytest.fixture(scope="module")
def port_store(blobs, lshp):
    return tstore.build_store(torch.tensor(blobs.points), tp.LSHParams(*lshp),
                              trandom.PRNGKey(KEY), n_shards=5)


def _assert_order_rule(points, direction, got, want):
    """Where two shard orders part, the scores of the points they put at
    that position agree within an f32 dot's rounding bound."""
    p64 = points.astype(np.float64)
    w64 = np.asarray(direction, np.float64)
    s64 = p64 @ w64
    bound = 8 * np.finfo(np.float32).eps * (np.abs(p64) @ np.abs(w64))
    off = np.flatnonzero(got != want)
    assert (np.abs(s64[got[off]] - s64[want[off]])
            <= bound[got[off]] + bound[want[off]]).all()


def test_build_store_matches_jax(blobs, jax_store, port_store):
    j, t = jax_store, port_store
    n = blobs.points.shape[0]
    jg = np.asarray(j.global_idx)
    tg = t.global_idx.numpy()
    jproj = np.asarray(j.tables.proj)
    _assert_order_rule(blobs.points, jproj[0, 0], tg.reshape(-1)[:n],
                       jg.reshape(-1)[:n])
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.shard_of.numpy(), np.asarray(j.shard_of))
    np.testing.assert_array_equal(t.slot_of.numpy(), np.asarray(j.slot_of))
    np.testing.assert_array_equal(
        t.tables.sorted_keys.numpy(),
        np.asarray(j.tables.sorted_keys).astype(np.int64))
    np.testing.assert_array_equal(t.tables.perm.numpy(),
                                  np.asarray(j.tables.perm))
    np.testing.assert_array_equal(t.shards.numpy(), np.asarray(j.shards))
    np.testing.assert_allclose(t.centers.numpy(), np.asarray(j.centers),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.radii.numpy(), np.asarray(j.radii),
                               rtol=1e-4)


def test_spatial_score_does_not_depend_on_the_chunk():
    """A row's shard-order score is bit-equal in chunks of 1, 7, 37, 32,768
    and n rows (trouble spot of a batch-dependent matmul)."""
    rng = np.random.default_rng(0)
    pts = torch.tensor(rng.normal(0, 50, (40_000, 24)).astype(np.float32))
    w = torch.tensor(rng.normal(0, 1, 24).astype(np.float32))
    whole = tp.spatial_score(pts, w)
    for chunk in (1, 7, 37, 32_768, pts.shape[0]):
        rows = pts[:2_000] if chunk < 40 else pts
        got = torch.cat([tp.spatial_score(rows[i:i + chunk], w)
                         for i in range(0, rows.shape[0], chunk)])
        assert torch.equal(got.view(torch.int32),
                           whole[:rows.shape[0]].view(torch.int32)), chunk


@pytest.mark.parametrize("chunk_size", [37, 0])
def test_build_store_streamed_matches_jax_and_sharded(blobs, lshp,
                                                      port_store,
                                                      chunk_size):
    want = jstore.build_store_streamed(
        JInMemorySource(blobs.points), lshp, jax.random.PRNGKey(KEY),
        n_shards=5, chunk_size=chunk_size, backend="ref")
    got = tstore.build_store_streamed(
        InMemorySource(blobs.points), tp.LSHParams(*lshp),
        trandom.PRNGKey(KEY), n_shards=5, chunk_size=chunk_size)
    for leaf in ("order", "global_idx", "valid", "sorted_keys", "perm",
                 "bucket_sizes"):
        np.testing.assert_array_equal(getattr(got, leaf),
                                      getattr(want, leaf), err_msg=leaf)
        assert getattr(got, leaf).dtype == getattr(want, leaf).dtype, leaf
    np.testing.assert_allclose(got.centers, want.centers, rtol=1e-12)
    np.testing.assert_allclose(got.radii, want.radii, rtol=1e-12)
    # the streamed store is the sharded store's layout
    n = blobs.points.shape[0]
    np.testing.assert_array_equal(
        got.order, port_store.global_idx.numpy().reshape(-1)[:n])
    np.testing.assert_array_equal(got.global_idx,
                                  port_store.global_idx.numpy())
    np.testing.assert_array_equal(got.sorted_keys,
                                  port_store.tables.sorted_keys.numpy())
    np.testing.assert_array_equal(got.perm, port_store.tables.perm.numpy())
    np.testing.assert_array_equal(
        got.bucket_sizes, tstore.global_bucket_sizes(port_store).numpy())


def test_global_bucket_sizes_match_monolithic(blobs, lshp, jax_store,
                                              port_store):
    tables = tp.build_lsh(torch.tensor(blobs.points), tp.LSHParams(*lshp),
                          trandom.PRNGKey(KEY))
    got = tstore.global_bucket_sizes(port_store).numpy()
    np.testing.assert_array_equal(got, tp.bucket_sizes(tables).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jstore.global_bucket_sizes(jax_store)))


@pytest.mark.parametrize("probe", [3, 8, 128])
def test_shard_bucket_windows_equal_jax_and_host(blobs, lshp, jax_store,
                                                 probe):
    """The device windows, their host mirror and JAX's, integer for integer,
    on the store's queries and on salts spanning the whole uint32 range."""
    sk = np.asarray(jax_store.tables.sorted_keys)
    keys, salts = jp.hash_queries(jnp.asarray(blobs.points[:60]),
                                  jax_store.tables.proj,
                                  jax_store.tables.bias, lshp.seg_len,
                                  backend="ref")
    keys = np.asarray(keys)
    rng = np.random.default_rng(probe)
    for salts_np in (np.asarray(salts),
                     rng.integers(0, 2**32, keys.shape, dtype=np.uint64)
                     .astype(np.uint32)):
        want = jp.shard_bucket_windows(jnp.asarray(sk), jnp.asarray(keys),
                                       jnp.asarray(salts_np), probe)
        host = tp.shard_bucket_windows_host(sk, keys, salts_np, probe)
        dev = tp.shard_bucket_windows(
            torch.tensor(sk.astype(np.int64)),
            torch.tensor(keys.astype(np.int64)),
            torch.tensor(salts_np.astype(np.int64)), probe)
        for w, h, d in zip(want, host, dev):
            np.testing.assert_array_equal(h, np.asarray(w))
            np.testing.assert_array_equal(d.numpy(), np.asarray(w))
        jwant = jp.shard_bucket_windows_host(sk, keys, salts_np, probe)
        for w, h in zip(jwant, host):
            np.testing.assert_array_equal(h, w)


def test_probe_tables_window_equal_jax(blobs, lshp, jax_store):
    sk = np.asarray(jax_store.tables.sorted_keys)
    pm = np.asarray(jax_store.tables.perm)
    keys, salts = jp.hash_queries(jnp.asarray(blobs.points[:30]),
                                  jax_store.tables.proj,
                                  jax_store.tables.bias, lshp.seg_len,
                                  backend="ref")
    starts, lo, hi = jp.shard_bucket_windows(jnp.asarray(sk), keys, salts, 8)
    for s in range(sk.shape[0]):
        want = jp.probe_tables_window(jnp.asarray(sk[s]), jnp.asarray(pm[s]),
                                      keys, starts[s], lo[s], hi[s], 8)
        got = tp.probe_tables_window(
            *(torch.tensor(np.asarray(a).astype(np.int64))
              for a in (sk[s], pm[s], keys, starts[s], lo[s], hi[s])), 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sharded_retrieval_matches_jax_on_a_store_carried_across(
        blobs, lshp, jax_store):
    """`retrieve_chunk` folded over the shards (civs_update on a
    ShardedStore) against JAX's retrieval on the same store: psi sets,
    candidate counts and the infective flag equal."""
    pts = jnp.asarray(blobs.points)
    k = estimate_k(pts, backend="ref")
    cfg = ALIDConfig(a_cap=32, delta=96, lsh=lshp)
    active = jnp.ones(pts.shape[0], bool)
    j = jax_store
    store = sharded_store_from_numpy(
        j.shards, j.valid, j.global_idx, j.shard_of, j.slot_of, j.centers,
        j.radii, j.tables.proj, j.tables.bias, j.tables.sorted_keys,
        j.tables.perm, device="cpu")
    for cluster, c_outer in [(0, 1), (2, 2), (4, 3)]:
        seed = int(np.where(blobs.labels == cluster)[0][0])
        st = lid_solve(init_state(pts, jnp.int32(seed), cfg.cap), k,
                       max_iters=50, backend="ref")
        roi = estimate_roi(st.v_beta, st.beta_idx, st.beta_mask, st.x, k,
                           jnp.int32(c_outer), backend="ref")
        want = jcivs_update(st, roi, j, active, None, lshp, k,
                            a_cap=cfg.a_cap, delta=cfg.delta, backend="ref")
        tstate = lid_state_from_numpy(*(np.asarray(a) for a in st),
                                      device="cpu")
        troi = ROI(*(torch.tensor(np.asarray(a))[None] for a in roi))
        got = civs_update(tstate, troi, store, torch.ones(pts.shape[0],
                                                          dtype=torch.bool),
                          None, tp.LSHParams(*lshp), float(k),
                          a_cap=cfg.a_cap, delta=cfg.delta)
        assert int(got.n_candidates[0]) == int(want.n_candidates)
        assert bool(got.infective_found[0]) == bool(want.infective_found)
        wi, wm = np.asarray(want.state.beta_idx), np.asarray(
            want.state.beta_mask)
        gi, gm = got.state.beta_idx[0].numpy(), got.state.beta_mask[0].numpy()
        assert set(gi[cfg.a_cap:][gm[cfg.a_cap:]].tolist()) == \
            set(wi[cfg.a_cap:][wm[cfg.a_cap:]].tolist())
        np.testing.assert_array_equal(gi, wi)
