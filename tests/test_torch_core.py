"""The port's ALID core (`repro_torch.core`: affinity, lid, roi, civs, alid,
the claim reducer) against the JAX package's `backend="ref"` path, on the
blobs/cfg fixtures of tests/test_engine.py.

Both packages get identical inputs: states, ROIs and LSH tables are carried
across with `repro_torch.convert`, so every comparison isolates one
function. Tolerances:

- Integer outputs are equal: `compact_support`'s order, candidate and
  top-delta ids, seeds, claims, support sets, round and iteration counts of
  a whole ALID run.
- f32 outputs agree to rtol 1e-5 (atol 1e-5 on quantities of order 1):
  the p=2 distances go through the |q|^2 + |c|^2 - 2 q.c expansion, whose
  d-sums the port takes in its pinned order and XLA in its own, and on
  this data (|v| ~ 50) its cancellation error is ~1e-6 relative.
- A converged LID state is compared by its support set (equal), density
  (rtol 1e-5) and weights (atol 1e-5): the step sequences of the two
  packages may part at an argmax near-tie of |r| (see
  tests/test_torch_kernels.py) and still reach the same fixed point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alid as jalid
from repro.core import civs as jcivs
from repro.core import engine as jengine
from repro.core import lid as jlid
from repro.core import roi as jroi
from repro.core.affinity import estimate_k as jestimate_k
from repro.core.alid import ALIDConfig
from repro.data import auto_lsh_params, make_blobs_with_noise
from repro.lsh import pstable as jp
from repro_torch import random as trandom
from repro_torch.convert import lid_state_from_numpy, lsh_tables_from_numpy
from repro_torch.core import alid as talid
from repro_torch.core import civs as tcivs
from repro_torch.core import engine as tengine
from repro_torch.core import lid as tlid
from repro_torch.core import roi as troi
from repro_torch.core.affinity import estimate_k as port_estimate_k
from repro_torch.lsh.pstable import LSHParams

SEEDS = (0, 30, 77, 101, 150)


@pytest.fixture(scope="module")
def blobs():
    return make_blobs_with_noise(n_clusters=4, cluster_size=25, n_noise=80,
                                 d=10, seed=7, overlap_pairs=0)


@pytest.fixture(scope="module")
def cfg(blobs):
    lshp = auto_lsh_params(blobs.points, probe=128)
    return ALIDConfig(a_cap=48, delta=48, lsh=lshp, seeds_per_round=16,
                      max_rounds=20, spec=jalid.EngineSpec(backend="ref"))


@pytest.fixture(scope="module")
def tcfg(cfg):
    return talid.ALIDConfig(a_cap=cfg.a_cap, delta=cfg.delta,
                            lsh=LSHParams(*cfg.lsh),
                            seeds_per_round=cfg.seeds_per_round,
                            max_rounds=cfg.max_rounds)


@pytest.fixture(scope="module")
def world(blobs, cfg):
    """The JAX package's k and tables, and the port's copies of them."""
    pts = jnp.asarray(blobs.points)
    k = jestimate_k(pts, backend="ref")
    tables = jp.build_lsh(pts, cfg.lsh, jax.random.PRNGKey(1), backend="ref")
    ttables = lsh_tables_from_numpy(*(np.asarray(a) for a in tables),
                                    device="cpu")
    return dict(pts=pts, k=k, tables=tables, tpts=torch.tensor(blobs.points),
                ttables=ttables, tk=float(k))


def _tstate(states):
    """JAX LIDStates (one per seed) -> one batched port LIDState."""
    fields = [np.stack([np.asarray(getattr(s, f)) for s in states])
              for f in jlid.LIDState._fields]
    return lid_state_from_numpy(*fields, device="cpu")


def _solve(st, k, cfg):
    return jlid.lid_solve(st, k, max_iters=cfg.t_lid, backend="ref",
                          sweep_steps=cfg.sweep_steps)


def _after_one_civs(world, cfg, seed):
    """A JAX state one ALID iteration in (lid, roi c=1, civs, lid) and its
    ROI at c=2: a multi-member support with live candidates."""
    k, pts, tables = world["k"], world["pts"], world["tables"]
    active = jnp.ones(pts.shape[0], bool)
    st = _solve(jlid.init_state(pts, jnp.int32(seed), cfg.cap), k, cfg)
    roi = jroi.estimate_roi(st.v_beta, st.beta_idx, st.beta_mask, st.x, k,
                            jnp.int32(1), backend="ref")
    st = jcivs.civs_update(st, roi, pts, active, tables, cfg.lsh, k,
                           a_cap=cfg.a_cap, delta=cfg.delta,
                           backend="ref").state
    st = _solve(st, k, cfg)
    roi = jroi.estimate_roi(st.v_beta, st.beta_idx, st.beta_mask, st.x, k,
                            jnp.int32(2), backend="ref")
    return st, roi


def _troi(rois):
    return troi.ROI(*(torch.tensor(np.stack([np.asarray(getattr(r, f))
                                             for r in rois]))
                      for f in jroi.ROI._fields))


# ------------------------------------------------------------- affinity --
def test_estimate_k(blobs):
    want = float(jestimate_k(jnp.asarray(blobs.points), backend="ref"))
    got = port_estimate_k(torch.tensor(blobs.points))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_estimate_k_full_width_matches_jax():
    """On the full-width configuration's data (1,000,000 x 128, made here
    in numpy; only the 512 strided rows that both engines draw reach
    estimate_k) both packages pick the same k. With 5,000 blobs of 80
    among 1M points, almost no sampled row has its nearest sampled
    neighbour in its own blob, so the 10th-percentile NN distance that
    sets k is a between-blob or noise distance."""
    from repro.core.source import strided_sample_indices as jstrided
    from repro_torch.core.source import strided_sample_indices
    from repro_torch.data import make_blobs_with_noise as port_blobs
    from repro_torch.launch import full_width
    spec = port_blobs(**full_width.DATA)
    idx = strided_sample_indices(spec.points.shape[0], 512)
    np.testing.assert_array_equal(idx, jstrided(spec.points.shape[0], 512))
    sample, labels = spec.points[idx], spec.labels[idx]
    del spec
    want = float(jestimate_k(jnp.asarray(sample), backend="ref"))
    got = port_estimate_k(torch.tensor(sample))
    d2 = ((sample[:, None, :].astype(np.float64) - sample[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nn = d2.argmin(1)
    same = float(np.mean((labels >= 0) & (labels[nn] == labels)))
    print(f"full-width estimate_k: jax={want!r} port={got!r} "
          f"rows_with_same_blob_nn={same}")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert same < 0.1


# ------------------------------------------------------------------- LID --
@pytest.mark.parametrize("sweep_steps", [1, 3, 8, 200])
def test_lid_solve_fixed_point_matches_jax(world, cfg, sweep_steps):
    """Seeds as lanes through the port's lid_solve against the JAX
    package's, per sweep chunk size; the port's result does not depend on
    the chunk size at all (bitwise)."""
    k = world["k"]
    starts = []
    for first in (0, 30, 77):
        # a full range: the cap points from `first` on, x at `first`
        window = jnp.arange(cfg.cap, dtype=jnp.int32) + first
        st = jlid.init_state(world["pts"], jnp.int32(first), cfg.cap)
        st = st._replace(beta_idx=window, beta_mask=jnp.ones(cfg.cap, bool),
                         v_beta=world["pts"][window])
        starts.append(jlid.refresh_ax(st, k, backend="ref"))
    got = tlid.lid_solve(_tstate(starts), world["tk"], max_iters=200,
                         sweep_steps=sweep_steps)
    ref200 = tlid.lid_solve(_tstate(starts), world["tk"], max_iters=200,
                            sweep_steps=200)
    for a, b in zip(got, ref200):
        assert torch.equal(a, b), "chunk size changed the port's result"
    dens = tlid.density(got).numpy()
    for b, st in enumerate(starts):
        want = jlid.lid_solve(st, k, max_iters=200, sweep_steps=sweep_steps,
                              backend="ref")
        assert int(want.n_iters) > 2
        np.testing.assert_array_equal(got.x[b].numpy() > 1e-6,
                                      np.asarray(want.x) > 1e-6)
        np.testing.assert_allclose(dens[b], float(jlid.density(want)),
                                   rtol=1e-5)
        np.testing.assert_allclose(got.x[b].numpy(), np.asarray(want.x),
                                   atol=1e-5)
        assert bool(got.converged[b]) == bool(want.converged)


def test_init_state_and_refresh_ax(world, cfg):
    st, _ = _after_one_civs(world, cfg, SEEDS[1])
    tst = _tstate([st])
    want = jlid.refresh_ax(st, world["k"], backend="ref")
    got = tlid.refresh_ax(tst, world["tk"])
    np.testing.assert_allclose(got.ax[0].numpy(), np.asarray(want.ax),
                               rtol=1e-5, atol=1e-6)
    j0 = jlid.init_state(world["pts"], jnp.int32(7), cfg.cap)
    t0 = tlid.init_state(world["tpts"], torch.tensor([7, 9]), cfg.cap)
    for f in jlid.LIDState._fields:
        np.testing.assert_array_equal(getattr(t0, f)[0].numpy(),
                                      np.asarray(getattr(j0, f)))
    assert int(t0.beta_idx[1, 0]) == 9


# ------------------------------------------------------------------- ROI --
def test_estimate_roi(world, cfg):
    pairs = [_after_one_civs(world, cfg, s) for s in SEEDS[:3]]
    tst = _tstate([p[0] for p in pairs])
    c = torch.tensor([2, 1, 5], dtype=torch.int32)
    got = troi.estimate_roi(tst.v_beta, tst.beta_idx, tst.beta_mask, tst.x,
                            world["tk"], c)
    for b, (st, _) in enumerate(pairs):
        want = jroi.estimate_roi(st.v_beta, st.beta_idx, st.beta_mask, st.x,
                                 world["k"], jnp.int32(int(c[b])),
                                 backend="ref")
        for f in jroi.ROI._fields:
            np.testing.assert_allclose(getattr(got, f)[b].numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-5, atol=1e-5, err_msg=f)


# ------------------------------------------------------------------ CIVS --
def test_compact_support_order(world, cfg):
    pairs = [_after_one_civs(world, cfg, s) for s in SEEDS]
    tst = _tstate([p[0] for p in pairs])
    got = tcivs.compact_support(tst, cfg.a_cap, cfg.support_eps)
    for b, (st, _) in enumerate(pairs):
        want = jcivs.compact_support(st, cfg.a_cap, cfg.support_eps)
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2][b].numpy(), np.asarray(want[2]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got[3][b].numpy(), np.asarray(want[3]))
        assert bool(got[4][b]) == bool(want[4])


def test_retrieve_and_civs_update(world, cfg):
    """Candidates, top-delta ids and the rebuilt state from identical
    states, ROIs and tables."""
    pairs = [_after_one_civs(world, cfg, s) for s in SEEDS]
    tst = _tstate([p[0] for p in pairs])
    troi_ = _troi([p[1] for p in pairs])
    n = world["pts"].shape[0]
    active = np.ones(n, bool)
    active[::7] = False                # some peeled points
    sup = tcivs.compact_support(tst, cfg.a_cap, cfg.support_eps)
    got = tcivs._retrieve_replicated(
        troi_, world["tpts"], torch.tensor(active), world["ttables"],
        LSHParams(*cfg.lsh), sup[0], sup[1], sup[3], cfg.delta, 2.0)
    res = tcivs.civs_update(tst, troi_, world["tpts"], torch.tensor(active),
                            world["ttables"], LSHParams(*cfg.lsh),
                            world["tk"], cfg.a_cap, cfg.delta)
    assert int((got[3] > 0).sum()) >= 3, "too few candidates: vacuous"
    for b, (st, roi) in enumerate(pairs):
        jsup = jcivs.compact_support(st, cfg.a_cap, cfg.support_eps)
        want = jcivs._retrieve_replicated(
            roi, world["pts"], jnp.asarray(active), world["tables"], cfg.lsh,
            jsup[0], jsup[1], jsup[3], cfg.delta, 2.0, backend="ref")
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(want[1]))
        assert int(got[3][b]) == int(want[3])
        wres = jcivs.civs_update(st, roi, world["pts"], jnp.asarray(active),
                                 world["tables"], cfg.lsh, world["k"],
                                 a_cap=cfg.a_cap, delta=cfg.delta,
                                 backend="ref")
        np.testing.assert_array_equal(res.state.beta_idx[b].numpy(),
                                      np.asarray(wres.state.beta_idx))
        np.testing.assert_array_equal(res.state.beta_mask[b].numpy(),
                                      np.asarray(wres.state.beta_mask))
        np.testing.assert_allclose(res.state.ax[b].numpy(),
                                   np.asarray(wres.state.ax),
                                   rtol=1e-5, atol=1e-6)
        assert bool(res.infective_found[b]) == bool(wres.infective_found)
        assert bool(res.overflow[b]) == bool(wres.overflow)


# ------------------------------------------------------------------ ALID --
def test_alid_from_seed_lanes_match_jax(world, cfg, tcfg):
    """A batch of complete ALID runs (the engines' map phase) against the
    JAX package's vmapped `_map_round`: equal supports and outer counts."""
    n = world["pts"].shape[0]
    seeds = np.array([3, 17, 60, 99, 120, 170], np.int32)
    active = np.ones(n, bool)
    active[5::11] = False
    want = jengine._map_round(world["pts"], jnp.asarray(active),
                              world["tables"], jnp.asarray(seeds),
                              world["k"], cfg)
    got = talid.alid_from_seed(world["tpts"], torch.tensor(active),
                               world["ttables"], torch.tensor(seeds),
                               world["tk"], tcfg)
    np.testing.assert_array_equal(got.member_mask.numpy(),
                                  np.asarray(want.member_mask))
    np.testing.assert_array_equal(got.member_idx.numpy(),
                                  np.asarray(want.member_idx))
    np.testing.assert_array_equal(got.n_outer.numpy(),
                                  np.asarray(want.n_outer))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    np.testing.assert_allclose(got.density.numpy(), np.asarray(want.density),
                               rtol=1e-5)
    np.testing.assert_allclose(got.member_w.numpy(),
                               np.asarray(want.member_w), atol=1e-5)


def test_sample_seeds_equal(world, cfg, tcfg):
    n = world["pts"].shape[0]
    bsizes = jp.bucket_sizes(world["tables"])
    rng = np.random.default_rng(0)
    for trial in range(3):
        active = rng.random(n) < (0.9, 0.3, 0.05)[trial]
        key = jax.random.PRNGKey(trial)
        ws, wv, we = jalid._sample_seeds(jnp.asarray(active), bsizes, key, cfg)
        gs, gv, ge = talid._sample_seeds(torch.tensor(active),
                                         torch.tensor(np.asarray(bsizes)),
                                         trandom.PRNGKey(trial), tcfg)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        assert ge == bool(we)


def test_resolve_claims_equal():
    """Claims with exact density ties (the larger row wins), invalid seeds
    and -1 pads."""
    rng = np.random.default_rng(5)
    s, cap, n = 12, 20, 90
    idx = rng.integers(-1, n, size=(s, cap)).astype(np.int32)
    mask = rng.random((s, cap)) < 0.8
    dens = rng.choice(np.array([0.8, 0.85, 0.9], np.float32), size=s)
    valid = rng.random(s) < 0.85
    want = jengine.resolve_claims(jnp.asarray(idx), jnp.asarray(mask),
                                  jnp.asarray(dens), jnp.asarray(valid), n=n)
    got = tengine.resolve_claims(torch.tensor(idx), torch.tensor(mask),
                                 torch.tensor(dens), torch.tensor(valid), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
