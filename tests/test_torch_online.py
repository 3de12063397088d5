"""The port's online updates (`repro_torch.core.online`,
`repro_torch.serve.live`, `run_palid --online`) against the JAX package's
(`repro.core.online` with backend="ref"), on tests/test_online.py's
fixture: every behaviour of that file runs on one JAX and one port
`OnlineClustering`, built from the same base (the JAX fit, carried across
with `convert.clustering_from_dict`) and given the same deltas.

Labels, supports' indices, live and alive flags and the `OnlineStats`
counters must be equal; densities agree to rtol 1e-5 and support weights
to atol 5e-4 (the port sums in its pinned order, XLA in its own; LID stops
once every |r_i| <= tol, which pins x only to O(tol / l): see
tests/test_torch_engine.py's docstring). A flush's new clusters have equal
canonical labels. Round trips (delete→insert, commit/rollback) are bitwise
within each package, and epochs cross between the packages bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import online as jonline
from repro.core.alid import ALIDConfig as JConfig, EngineSpec as JSpec
from repro.core.engine import fit as jfit
from repro.data import auto_lsh_params, make_blobs_with_noise
from repro.serve import ClusterServer as JServer, LiveServing as JLive
from repro.utils import canonical_labels
from repro_torch import random as trandom
from repro_torch.convert import clustering_from_dict
from repro_torch.core import online as tonline
from repro_torch.core.alid import ALIDConfig, EngineSpec
from repro_torch.kernels import ops
from repro_torch.launch import run_palid
from repro_torch.lsh.pstable import LSHParams
from repro_torch.serve import ClusterServer, LiveServing

ARRAYS = ("points", "alive", "labels", "sup_idx", "sup_w", "sup_v",
          "densities", "live")


@pytest.fixture(scope="module")
def blobs():
    return make_blobs_with_noise(n_clusters=3, cluster_size=40, n_noise=80,
                                 d=16, seed=7, overlap_pairs=0)


@pytest.fixture(scope="module")
def jcfg(blobs):
    return JConfig(a_cap=56, delta=64,
                   lsh=auto_lsh_params(blobs.points, probe=128),
                   seeds_per_round=16, max_rounds=24, exhaustive=True,
                   spec=JSpec(backend="ref"))


@pytest.fixture(scope="module")
def tcfg(jcfg):
    return ALIDConfig(a_cap=jcfg.a_cap, delta=jcfg.delta,
                      lsh=LSHParams(*jcfg.lsh),
                      seeds_per_round=jcfg.seeds_per_round,
                      max_rounds=jcfg.max_rounds, exhaustive=True)


@pytest.fixture(scope="module")
def jbase(blobs, jcfg):
    res = jfit(blobs.points, jcfg, jax.random.PRNGKey(0))
    assert res.n_clusters > 0
    return res


@pytest.fixture
def make(blobs, jcfg, tcfg, jbase, tmp_path):
    """make(**kw) -> (JAX OnlineClustering, port OnlineClustering) over the
    same base, points, rng and options."""
    tbase = clustering_from_dict(jbase.to_dict())

    def build(**kw):
        j = jonline.OnlineClustering(jbase, blobs.points, jcfg,
                                     rng=jax.random.PRNGKey(5),
                                     ckpt_dir=str(tmp_path / "jax"), **kw)
        t = tonline.OnlineClustering(tbase, blobs.points, tcfg,
                                     rng=trandom.PRNGKey(5),
                                     ckpt_dir=str(tmp_path / "port"),
                                     device="cpu", **kw)
        return j, t
    return build


def _state(oc) -> dict:
    return {k: np.array(getattr(oc, k)) for k in ARRAYS}


def _assert_same(j, t):
    """The port's state against the JAX package's, to the stated rules."""
    for k in ("points", "alive", "labels", "sup_idx", "sup_v", "live"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                      err_msg=k)
    np.testing.assert_allclose(t.densities, j.densities, rtol=1e-5)
    np.testing.assert_allclose(t.sup_w, j.sup_w, rtol=0, atol=5e-4)
    assert t.stats.snapshot() == j.stats.snapshot()
    assert t.outliers == j.outliers and t._free == j._free
    assert t.epoch_id == j.epoch_id and t.epochs() == j.epochs()
    assert t.verify() == [] and j.verify() == []


def _jitter(oc, n, seed):
    target = int(np.argmax(oc.densities))
    members = oc.sup_idx[target][oc.sup_w[target] > 0]
    rng = np.random.default_rng(seed)
    delta = (oc.points[members[:n]]
             + 0.01 * rng.standard_normal((n, oc.d))).astype(np.float32)
    return target, members, delta


def _outside_every_ball(oc) -> np.ndarray:
    """tests/test_online.py's helper: alive, unlabeled ids strictly outside
    every live ball, with a margin that keeps them clear of the edge."""
    oc._refresh_rois()
    live = np.flatnonzero(oc.live)
    cen = oc._roi_center[live]
    rad = oc._roi_radius[live]
    ids = np.flatnonzero((oc.labels < 0) & oc.alive)
    dist = np.sqrt(((oc.points[ids].astype(np.float64)[:, None]
                     - cen[None]) ** 2).sum(-1))
    return ids[(dist > rad[None] * 1.05 + 0.5).all(axis=1)]


# ----------------------------------------------------------------- baseline --
def test_baseline_commits_epoch_zero_and_verifies(make, jbase):
    j, t = make()
    assert t.epoch_id == 0 and t.epochs() == [0]
    np.testing.assert_array_equal(t.labels, jbase.labels)
    _assert_same(j, t)
    served, want = t.to_clustering(), j.to_clustering()
    assert served.n_clusters == want.n_clusters == jbase.n_clusters
    np.testing.assert_array_equal(served.labels, want.labels)
    np.testing.assert_array_equal(served.support_v, want.support_v)
    # the routing balls: centres (a weighted f32 sum of <= 56 rows, in two
    # orders: within 56 f32 ulps of the largest term) and radii to rtol 1e-5
    t._refresh_rois()
    j._refresh_rois()
    scale = np.abs(t._roi_center).max()
    np.testing.assert_allclose(t._roi_center, j._roi_center, rtol=0,
                               atol=56 * np.finfo(np.float32).eps * scale)
    np.testing.assert_allclose(t._roi_radius, j._roi_radius, rtol=1e-5)


# ------------------------------------------------------------------ inserts --
def test_insert_routed_jitter_absorbs_locally(make, blobs):
    j, t = make(auto_flush=False)
    target, _, delta = _jitter(t, 4, seed=0)
    before = _state(t)
    ids = t.insert(delta)
    j.insert(delta)
    assert t.stats.routed == 4 and t.stats.buffered == 0
    for c in np.flatnonzero(before["live"]):
        if c == target:
            continue
        np.testing.assert_array_equal(t.sup_w[c], before["sup_w"][c])
        np.testing.assert_array_equal(t.sup_idx[c], before["sup_idx"][c])
        assert t.densities[c] == before["densities"][c]
    others = (before["labels"] >= 0) & (before["labels"] != target)
    np.testing.assert_array_equal(t.labels[:len(blobs.points)][others],
                                  before["labels"][others])
    assert set(np.unique(t.labels[ids])) <= {-1, target}
    assert t.stats.absorbed > 0
    _assert_same(j, t)


def test_insert_far_points_buffer_not_clusters(make):
    j, t = make(outlier_min=64, auto_flush=True)
    before = _state(t)
    far = np.full((3, t.d), 200.0, np.float32)
    ids = t.insert(far)
    j.insert(far)
    assert t.stats.buffered == 3 and t.stats.routed == 0
    assert sorted(t.outliers) == sorted(int(i) for i in ids)
    for k in ("sup_idx", "sup_w", "sup_v", "densities", "live"):
        np.testing.assert_array_equal(getattr(t, k), before[k])
    _assert_same(j, t)


def test_insert_seconds_split_the_insert_by_part(make):
    _, t = make(auto_flush=False)
    assert t.insert_seconds == {}
    _, _, delta = _jitter(t, 4, seed=1)
    t.insert(delta)
    secs = t.insert_seconds
    parts = ("alloc", "refresh", "routing", "reconverge")
    assert set(secs) == set(parts) | {"total"}
    assert all(secs[p] >= 0.0 for p in parts)
    assert secs["reconverge"] > 0.0
    assert sum(secs[p] for p in parts) <= secs["total"]


def test_disjoint_roi_insert_flushes_new_clusters(make, blobs, jbase):
    """A batch whose ROIs are disjoint from every cluster buffers, then
    flushes through a fit on the port's replicated engine at the resident
    k: every earlier label stays bit-identical, and the new clusters are
    JAX's (equal canonical labels, densities within rtol 1e-5)."""
    rng = np.random.default_rng(2)
    offs = np.full((16,), 60.0, np.float32)
    batch = np.concatenate([
        offs + 0.3 * rng.standard_normal((40, 16)).astype(np.float32),
        -offs + 0.3 * rng.standard_normal((40, 16)).astype(np.float32)])
    j, t = make(outlier_min=len(batch))
    pre = t.labels.copy()
    ids = t.insert(batch)
    j.insert(batch)
    assert t.stats.flushes == 1 and t.stats.new_clusters > 0
    assert t.stats.snapshot() == j.stats.snapshot()
    np.testing.assert_array_equal(t.labels[:len(blobs.points)], pre)
    np.testing.assert_array_equal(canonical_labels(t.labels[ids]),
                                  canonical_labels(j.labels[ids]))
    assert t.verify() == [] and j.verify() == []
    new = np.flatnonzero(t.live)[np.flatnonzero(t.live) >= jbase.n_clusters]
    assert new.size and t.live.shape == j.live.shape
    id_set = set(int(i) for i in ids)
    for c in new:
        assert set(int(i) for i in t.sup_idx[c][t.sup_idx[c] >= 0]) <= id_set
    # new cluster c of one package holds the points of the other's c'
    for c in new:
        pts = set(np.flatnonzero(t.labels == c).tolist())
        (cj,) = set(j.labels[sorted(pts)].tolist())
        assert set(np.flatnonzero(j.labels == cj).tolist()) == pts
        np.testing.assert_allclose(t.densities[c], j.densities[cj],
                                   rtol=1e-5)


def test_delete_insert_roundtrip_is_bit_identical(make):
    j, t = make(auto_flush=False)
    sel = _outside_every_ball(t)[:5]
    assert sel.size == 5, "fixture needs >= 5 far noise points"
    np.testing.assert_array_equal(_outside_every_ball(j)[:5], sel)
    rows = t.points[sel].copy()
    before = _state(t)
    for oc in (j, t):
        oc.delete(sel)
    assert not t.alive[sel].any() and (t.labels[sel] == -1).all()
    back = t.insert(rows)
    j.insert(rows)
    np.testing.assert_array_equal(back, sel)
    after = _state(t)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    _assert_same(j, t)


def test_delete_support_member_reconverges_only_owners(make):
    j, t = make(auto_flush=False)
    _, members, _ = _jitter(t, 1, seed=0)
    victim = int(members[0])
    before = _state(t)
    t.delete([victim])
    j.delete([victim])
    assert t.stats.reconverges >= 1
    assert not t.alive[victim] and t.labels[victim] == -1
    for c in np.flatnonzero(before["live"]):
        if victim in set(int(i) for i in before["sup_idx"][c]):
            continue
        np.testing.assert_array_equal(t.sup_w[c], before["sup_w"][c])
        assert t.densities[c] == before["densities"][c]
    _assert_same(j, t)


# ------------------------------------------------------------------- epochs --
def test_commit_rollback_restores_bit_identical_state(make):
    j, t = make(auto_flush=False)
    snap = _state(t)
    _, members, delta = _jitter(t, 3, seed=1)
    for oc in (j, t):
        oc.insert(delta)
        oc.delete([int(members[1])])
    ep = t.commit({"note": "delta"})
    j.commit({"note": "delta"})
    assert ep.id == 1 and t.epoch_id == 1
    mutated = _state(t)
    _assert_same(j, t)

    assert t.rollback(0) == 0 == j.rollback(0) and t.epoch_id == 0
    for k, v in snap.items():
        np.testing.assert_array_equal(getattr(t, k), v, err_msg=k)
    _assert_same(j, t)
    # roll FORWARD again to the retained epoch 1
    t.rollback(1)
    j.rollback(1)
    for k, v in mutated.items():
        np.testing.assert_array_equal(getattr(t, k), v, err_msg=k)
    _assert_same(j, t)


def test_commit_verify_failure_rolls_back_and_raises(make):
    j, t = make(auto_flush=False)
    c0 = int(np.flatnonzero(t.live)[0])
    good_w = t.sup_w[c0].copy()
    for oc, err in ((j, jonline.EpochVerifyError),
                    (t, tonline.EpochVerifyError)):
        oc.sup_w[c0] = oc.sup_w[c0] * 2.0        # off the simplex
        with pytest.raises(err) as ei:
            oc.commit()
        assert ei.value.problems
        assert oc.epoch_id == 0 and oc.epochs() == [0]
    np.testing.assert_array_equal(t.sup_w[c0], good_w)
    _assert_same(j, t)


def test_epoch_transaction_commits_or_rolls_back(make):
    j, t = make(auto_flush=False)
    n0 = t.n_points
    for oc in (j, t):
        with oc.epoch({"t": 1}) as txn:
            oc.insert(np.full((2, oc.d), 300.0, np.float32))
        assert txn.epoch is not None and txn.epoch.id == 1
        assert oc.epoch_id == 1 and oc.n_points == n0 + 2
        with pytest.raises(RuntimeError, match="boom"):
            with oc.epoch({"t": 2}):
                oc.insert(np.full((4, oc.d), 400.0, np.float32))
                raise RuntimeError("boom")
        assert oc.epoch_id == 1 and oc.n_points == n0 + 2
    _assert_same(j, t)


def test_keep_bounds_retained_epochs(make):
    j, t = make(auto_flush=False, keep=3)
    for oc in (j, t):
        for i in range(5):
            oc.insert(np.full((1, oc.d), 300.0 + i, np.float32))
            oc.commit()
        assert oc.epochs() == [3, 4, 5]
        with pytest.raises(KeyError):
            oc.rollback(0)
    _assert_same(j, t)


def test_epochs_cross_between_the_packages(make, tmp_path):
    """An epoch committed by either package restores bitwise through the
    other's rollback (the rng leaf as uint32 words, k as float64), and both
    go on from it alike."""
    j, t = make(auto_flush=False)
    _, members, delta = _jitter(t, 3, seed=4)
    j.insert(delta)
    j.delete([int(members[2])])
    j.commit()
    # the port restores the JAX package's epoch 1 from its directory
    t2 = tonline.OnlineClustering(t.to_clustering(), t.points, t.cfg,
                                  ckpt_dir=j.ckpt_dir, device="cpu",
                                  keep=8)
    assert t2.epochs() == [0, 1, 2]
    t2.rollback(1)
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(t2, k), getattr(j, k),
                                      err_msg=k)
    assert t2.outliers == j.outliers and t2._free == j._free
    assert np.asarray(t2._rng).tolist() == np.asarray(j._rng).tolist()
    assert t2.k == j.k

    # and the JAX package restores the port's
    t.insert(delta)
    t.flush_outliers()
    t.commit()
    j2 = jonline.OnlineClustering(j.to_clustering(), j.points, j.cfg,
                                  ckpt_dir=t.ckpt_dir, keep=8)
    j2.rollback(1)
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(j2, k), getattr(t, k),
                                      err_msg=k)
    assert np.asarray(j2._rng).dtype == np.uint32
    assert np.asarray(j2._rng).tolist() == np.asarray(t._rng).tolist()
    assert j2.k == t.k
    # both go on alike from the carried state
    far = np.full((2, t.d), 250.0, np.float32)
    j2.insert(far)
    t.insert(far)
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(j2, k), getattr(t, k),
                                      err_msg=k)


# --------------------------------------------------------- one-lane guard --
def test_noop_guard_keeps_the_lane_bitwise(make):
    """One lane of refresh_ax + lid_solve: a stored support with a far
    candidate at weight 0 takes no step, so x comes back bit for bit (the
    no-op guard's premise); with a jittered member as candidate it moves,
    to JAX's weights within atol 5e-4 and its density within rtol 1e-5."""
    j, t = make(auto_flush=False)
    cfg = t.cfg
    c = int(np.argmax(t.densities))
    idx, w, v = t.sup_idx[c].copy(), t.sup_w[c].copy(), t.sup_v[c].copy()
    slot = int(np.flatnonzero(idx < 0)[0])
    for cand, noop in ((np.full(t.d, 200.0, np.float32), True),
                       (v[np.argmax(w)] + 0.01, False)):
        idx[slot], v[slot] = 10_000, cand
        mask = idx >= 0
        x, _, dens = tonline._warm_lid(
            torch.tensor(idx), torch.tensor(mask), torch.tensor(v),
            torch.tensor(w), t.k, cfg.t_lid, cfg.tol, cfg.p,
            cfg.support_eps, "auto", cfg.sweep_steps, cfg.refresh_every)
        jx, _, jdens = jonline._warm_lid(
            idx, mask, v, w, np.float32(j.k), cfg.t_lid, cfg.tol, cfg.p,
            cfg.support_eps, "ref", "float32", cfg.sweep_steps,
            cfg.refresh_every)
        x = x.numpy()
        assert np.array_equal(x, w) == noop
        assert np.array_equal(np.asarray(jx), w) == noop
        np.testing.assert_allclose(x, np.asarray(jx), rtol=0, atol=5e-4)
        np.testing.assert_allclose(float(dens), float(jdens), rtol=1e-5)


def test_warm_start_steps_on_the_same_supports_as_jax(make):
    """A stored support re-converges with no candidate wherever a member's
    |Ax - pi| exceeds tol after the exact Ax refresh (the fit stores x as
    its last sweep left it, Ax updated incrementally): the clusters whose
    warm LID takes no step, and so keep the no-op guard, are the JAX
    package's."""
    j, t = make(auto_flush=False)
    cfg = t.cfg
    noop = {}
    for name, oc in (("jax", j), ("port", t)):
        noop[name] = []
        for c in np.flatnonzero(oc.live):
            idx, w, v = oc.sup_idx[c], oc.sup_w[c], oc.sup_v[c]
            if name == "jax":
                x = np.asarray(jonline._warm_lid(
                    idx, idx >= 0, v, w, np.float32(oc.k), cfg.t_lid,
                    cfg.tol, cfg.p, cfg.support_eps, "ref", "float32",
                    cfg.sweep_steps, cfg.refresh_every)[0])
            else:
                x = tonline._warm_lid(
                    torch.tensor(idx), torch.tensor(idx >= 0),
                    torch.tensor(v), torch.tensor(w), oc.k, cfg.t_lid,
                    cfg.tol, cfg.p, cfg.support_eps, "auto",
                    cfg.sweep_steps, cfg.refresh_every)[0].numpy()
            noop[name].append(bool(np.array_equal(x, w)))
    assert noop["port"] == noop["jax"]
    assert any(noop["port"])


# ------------------------------------------------------------ refusals --
def test_bf16_and_missing_card_refused(jbase, blobs, tcfg, tmp_path):
    """bf16 storage (ROADMAP B P1) runs: a bf16 `OnlineClustering` commits
    its baseline, and its routing balls are measured on the support rows
    cast to bf16 (tests/test_torch_bf16.py holds its updates to the JAX
    package's). Without a card the default device is refused."""
    base = clustering_from_dict(jbase.to_dict())
    bf16 = tcfg._replace(spec=EngineSpec(dtype="bfloat16"))
    oc = tonline.OnlineClustering(base, blobs.points, bf16, device="cpu",
                                  ckpt_dir=str(tmp_path / "a"))
    assert oc.epoch_id == 0 and oc.verify() == []
    oc._refresh_rois()
    c = int(np.flatnonzero(oc.live)[0])
    center, r_out = tonline._roi_of_support(
        ops.to_storage(torch.tensor(oc.sup_v[c]), "bfloat16").float(),
        torch.tensor(oc.sup_idx[c]), torch.tensor(oc.sup_w[c]), oc.k,
        bf16.r0, bf16.p, bf16.support_eps, "auto")
    np.testing.assert_array_equal(oc._roi_center[c],
                                  center.numpy().astype(np.float64))
    assert oc._roi_radius[c] == float(r_out)
    if torch.cuda.is_available():
        oc = tonline.OnlineClustering(base, blobs.points, tcfg,
                                      ckpt_dir=str(tmp_path / "b"))
        assert oc.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tonline.OnlineClustering(base, blobs.points, tcfg,
                                 ckpt_dir=str(tmp_path / "b"))


def test_other_norms_route_to_every_cluster(jbase, blobs, jcfg, tcfg,
                                            tmp_path, monkeypatch):
    """p != 2: on the plain path a point routes to every cluster, as in the
    JAX package; where the kernels would run, the first kernel call raises
    (ops.check_norm) before any state changes."""
    base = clustering_from_dict(jbase.to_dict())
    j = jonline.OnlineClustering(jbase, blobs.points,
                                 jcfg._replace(p=1.0), auto_flush=False,
                                 ckpt_dir=str(tmp_path / "j"))
    t = tonline.OnlineClustering(base, blobs.points, tcfg._replace(p=1.0),
                                 auto_flush=False, device="cpu",
                                 ckpt_dir=str(tmp_path / "t"))
    far = np.full((2, t.d), 200.0, np.float32)
    j.insert(far)
    t.insert(far)
    assert t.stats.routed == 2 and t.stats.buffered == 0
    assert t.stats.snapshot() == j.stats.snapshot()
    np.testing.assert_array_equal(t.labels, j.labels)
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, x: "kernel")
    t._roi_dirty.add(int(np.flatnonzero(t.live)[0]))
    before = _state(t)
    with pytest.raises(NotImplementedError, match="p=1.0"):
        t.insert(far)
    for k in ("sup_idx", "sup_w", "densities", "live"):
        np.testing.assert_array_equal(getattr(t, k), before[k])


# ------------------------------------------------------------- live serving --
def test_live_serving_swap_rollback_and_stats(make, jbase):
    j, t = make(auto_flush=False)
    pre_labels = t.labels.copy()
    _, members, delta = _jitter(t, 3, seed=0)
    probe = t.points[int(members[0])]
    served = {}
    for oc, server, live_cls in (
            (j, JServer(batch_slots=16, queue_limit=64, policy="block"),
             JLive),
            (t, ClusterServer(batch_slots=16, queue_limit=64,
                              policy="block", device="cpu"), LiveServing)):
        with server:
            live = live_cls(server, oc, name="online", keep_versions=2)
            t0 = live.publish()
            assert (t0.version, t0.epoch) == (0, 0)
            lab_pre = live.submit(probe).result(timeout=30)
            oc.insert(delta)
            ep, t1 = live.commit_and_publish({"delta": 3})
            assert (t1.version, t1.epoch) == (1, ep.id) and ep.id == 1
            eid, t2 = live.rollback_and_publish(0)
            assert eid == 0 and (t2.version, t2.epoch) == (2, 0)
            np.testing.assert_array_equal(oc.labels, pre_labels)
            lab_post = live.submit(probe).result(timeout=30)
            assert lab_post == lab_pre
            s = server.stats.snapshot()
            assert s["version_swaps"] == 2 and s["rollbacks"] == 1
            rows = live.info()
            assert [r["version"] for r in rows] == [1, 2]
            active = [r for r in rows if r["active"]]
            assert len(active) == 1 and active[0]["epoch"] == 0
            assert active[0]["n_clusters"] == jbase.n_clusters
            served[live_cls] = (lab_pre, lab_post)
    assert served[LiveServing] == served[JLive]
    _assert_same(j, t)


def test_run_palid_online_cli(capsys):
    run_palid.main(["--online", "--quick", "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[palid] online")]
    assert len(line) == 1
    assert "bit-identical=True" in line[0]
    assert line[0].endswith("versions=[1, 2] active_epoch=0 swaps=2 "
                            "rollbacks=1")
