"""Online clustering: localized insert/delete updates with versioned epochs.

Every data change would otherwise force a full `fit`. This module exploits
the paper's core locality property instead: LID converges inside a bounded
ROI (Sec. 4.2, Prop. 1: every point outside R_out is GUARANTEED
non-infective), so a point-level perturbation can only disturb the clusters
whose outer ROI ball it intersects:

  * `insert(points)` routes each new point against the per-cluster outer
    balls (center = w·V of the stored weighted support, radius = R_out
    recomputed from the support through `estimate_roi`, the path `fit`
    uses). Affected clusters warm-start LID from their STORED weighted
    support with the routed points as zero-weight candidates (`refresh_ax`
    + `lid_solve`: the `affinity_matvec` and `lid_sweep` kernels on the
    card, one lane a call) and absorb / peel as the KKT point moves; points
    intersecting no ball accumulate in an outlier buffer that periodically
    seeds fresh LID runs (a bounded `engine.fit` over the buffer alone).
  * `delete(ids)` removes points from the supports that contain them and
    re-converges only those clusters; a point in no support leaves without
    touching any cluster: exact, since only support members carry weight in
    the KKT conditions.
  * a no-op guard keeps non-infective inserts EXACT: when the warm-started
    LID takes no step (every routed candidate is immune at tol) the stored
    support, density, and labels are left untouched bit for bit, the basis
    of the delete→insert round trip's bit identity.

Versioned lifecycle: the working state advances through `Epoch`s with
apply → verify → commit-or-rollback semantics. `commit()` runs the
invariant suite (`verify`) and persists an atomic tmp-then-rename snapshot
through `repro_torch.checkpoint.manager` (manifest + npz, bounded `keep`,
the JAX package's layout: either package restores the other's epochs);
`rollback(epoch)` restores any retained snapshot bit for bit. The paired
serving layer (`repro_torch.serve.live.LiveServing`) hot-swaps committed
epochs into a `ClusterServer` tenant registry between batches.

Host state is numpy, as in the JAX package; each re-convergence and ROI
refresh puts its one support on `device` (the card unless the caller asks
for the CPU) for the call.

Label contract (inherited from `fit`): a point is labeled c iff it sits in
cluster c's support with weight > 0; everything else is -1. Online
updates preserve that invariant; `verify()` checks it.
"""

from __future__ import annotations

import tempfile
import threading
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.checkpoint.manager import (latest_step, list_checkpoints,
                                            restore_checkpoint_tree,
                                            save_checkpoint)
from repro_torch.core.alid import (ALIDConfig, Clustering, EngineSpec,
                                   resolve_device)
from repro_torch.core.civs import _ROUTE_EPS
from repro_torch.core.engine import fit
from repro_torch.core.lid import LIDState, density, lid_solve, refresh_ax
from repro_torch.core.roi import estimate_roi
from repro_torch.core.source import as_source, is_data_source
from repro_torch.kernels import ops

__all__ = ["OnlineClustering", "Epoch", "EpochVerifyError", "OnlineStats",
           "EpochTransaction"]


class Epoch(NamedTuple):
    """One committed, persisted snapshot of the online clustering state."""
    id: int
    path: str
    n_points: int        # live points at commit time
    n_clusters: int      # live clusters at commit time
    metadata: dict


class EpochVerifyError(RuntimeError):
    """commit() found invariant violations; the working state was rolled
    back to the last committed epoch (commit-or-rollback)."""

    def __init__(self, problems: list[str]):
        super().__init__("epoch verify failed: " + "; ".join(problems))
        self.problems = problems


class OnlineStats:
    """Counters for the online-update path."""

    _FIELDS = ("inserted", "deleted", "routed", "buffered", "flushes",
               "reconverges", "noop_reconverges", "absorbed", "dropped",
               "dissolved", "new_clusters", "overflowed", "commits",
               "rollbacks")

    def __init__(self) -> None:
        for f in self._FIELDS:
            setattr(self, f, 0)
        self._lock = threading.Lock()

    def add(self, field: str, amount: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + amount)

    def snapshot(self) -> dict:
        return {f: int(getattr(self, f)) for f in self._FIELDS}

    def report(self) -> str:
        s = self.snapshot()
        return ("online: "
                f"inserted={s['inserted']} deleted={s['deleted']} "
                f"routed={s['routed']} buffered={s['buffered']} "
                f"flushes={s['flushes']} (+{s['new_clusters']} clusters) | "
                f"reconverges={s['reconverges']} "
                f"(noop={s['noop_reconverges']}) absorbed={s['absorbed']} "
                f"dropped={s['dropped']} dissolved={s['dissolved']} | "
                f"commits={s['commits']} rollbacks={s['rollbacks']}")


# ---------------------------------------------------------- one-lane ops --
def _warm_lid(beta_idx, beta_mask, v_beta, x, k: float, t_lid: int,
              tol: float, p: float, support_eps: float, backend: str,
              sweep_steps: int = 8, refresh_every: int = 0,
              dtype: str = "float32"):
    """Warm-started LID re-convergence over one (cap,) support buffer: one
    lane (B = 1) of the batched `refresh_ax` then `lid_solve`.

    The buffer holds the stored support (weights = stored w) plus routed
    candidates (weight 0). `refresh_ax` rebuilds Ax exactly from the current
    weights (candidates get their payoff row too, since they sit inside
    beta_mask), then `lid_solve` runs the infection-immunization dynamics:
    an infective candidate (payoff > pi + tol) is invaded (absorbed), an
    over-weighted member is immunized (peeled). A lane that takes no step
    comes back with x unchanged, bit for bit. `dtype` casts the host-f32
    support rows to the engine's storage dtype (exact for rows already
    rounded), so the re-convergence runs the fit's mixed-precision path.
    Returns (x, ax, density)."""
    dev = x.device
    v_beta = ops.to_storage(v_beta, dtype)
    state = LIDState(beta_idx=beta_idx[None], beta_mask=beta_mask[None],
                     v_beta=v_beta[None], x=x[None],
                     ax=torch.zeros_like(x)[None],
                     n_iters=torch.zeros(1, dtype=torch.int32, device=dev),
                     converged=torch.zeros(1, dtype=torch.bool, device=dev))
    state = refresh_ax(state, k, p=p, support_eps=support_eps,
                       backend=backend)
    state = lid_solve(state, k, max_iters=t_lid, tol=tol, p=p,
                      backend=backend, sweep_steps=sweep_steps,
                      refresh_every=refresh_every, support_eps=support_eps)
    return state.x[0], state.ax[0], density(state)[0]


def _roi_of_support(sup_v, sup_idx, sup_w, k: float, r0: float, p: float,
                    support_eps: float, backend: str,
                    dtype: str = "float32"):
    """(center, R_out) of one stored support, the routing ball: one lane of
    `estimate_roi` at c = 1000. theta(c) saturates to 1 for large c, so
    radius == r_out: the OUTER guarantee ball of Prop. 1 (no point beyond it
    can be infective for this cluster). The host-f32 support rows are cast
    to the storage dtype first, as `_warm_lid` casts them, so the ball is
    measured on the rows the kernels read."""
    sup_v = ops.to_storage(sup_v, dtype)
    c = torch.full((1,), 1000, dtype=torch.int32, device=sup_v.device)
    roi = estimate_roi(sup_v[None], sup_idx[None], (sup_idx >= 0)[None],
                       sup_w[None], k, c, r0=r0, p=p,
                       support_eps=support_eps, backend=backend)
    return roi.center[0], roi.r_out[0]


# ------------------------------------------------------------ the subsystem --
class OnlineClustering:
    """Mutable `Clustering` + point store with localized delta updates and a
    versioned snapshot-and-rollback lifecycle.

        oc = OnlineClustering(fit(points, cfg, rng), points, cfg)
        ids = oc.insert(new_points)          # localized: ROI-routed updates
        oc.delete(ids[:3])                   # only containing supports move
        epoch = oc.commit()                  # verify + atomic snapshot
        oc.rollback(epoch.id - 1)            # bit-identical restore
        served = oc.to_clustering()          # snapshot for Tenant / predict

    or transactionally (apply → verify → commit-or-rollback):

        with oc.epoch() as txn:
            oc.insert(batch); oc.delete(stale)
        print(txn.epoch.id)

    Point ids are stable handles: deletes free ids, inserts RECYCLE freed
    ids (ascending) before growing the arrays, so a delete→insert round trip
    of the same rows restores the exact label array. Cluster ids are stable
    too: a dissolved cluster leaves a dead slot (`live=False`) so surviving
    labels never renumber; `to_clustering()` compacts live clusters for
    serving.

    Construction auto-commits epoch 0 (the baseline snapshot), so a
    rollback target always exists; `ckpt_dir=None` uses a fresh temp dir
    (exposed as `.ckpt_dir`). `rng` is a `repro_torch.random` key (default
    PRNGKey(17)); it seeds the outlier flushes' fits. Re-convergences, ROI
    refreshes and flushes run on `device`: the card unless the caller asks
    for the CPU. `insert_seconds` holds the last insert's host seconds by
    part: "alloc" (ids, growing the point store), "refresh" (the dirty
    balls), "routing" (the ball test), "reconverge" (the loop over the
    hit clusters: candidates, warm LIDs, relabels) and "total" (with an
    automatic flush).
    """

    def __init__(self, base: Clustering, points,
                 cfg: ALIDConfig = ALIDConfig(), *, rng=None,
                 ckpt_dir: Optional[str] = None, keep: int = 8,
                 outlier_min: int = 64, auto_flush: bool = True,
                 device="cuda"):
        if base.support_idx is None:
            raise ValueError("OnlineClustering needs a Clustering with "
                             "stored supports (produced by "
                             "repro_torch.core.engine.fit)")
        ops.storage_dtype(cfg.spec.dtype)   # validate the knob up front
        self.device = resolve_device(device)
        if is_data_source(points):
            src = as_source(points)
            points = src.get_chunk(0, src.n)
        self.cfg = cfg
        self.k = float(base.k)
        self.stats = OnlineStats()
        self.points = np.array(np.atleast_2d(points), np.float32)
        n, d = self.points.shape
        if base.labels.shape != (n,):
            raise ValueError(f"labels of shape {base.labels.shape} for {n} "
                             "points")
        self.d = d
        self.cap = int(base.support_idx.shape[1])
        if self.cap != cfg.cap:
            raise ValueError(
                f"support cap {self.cap} != cfg.cap {cfg.cap}: the online "
                "config must match the one the base Clustering was fitted "
                "with (outlier flushes append supports at cfg.cap)")
        self.alive = np.ones((n,), bool)
        self.labels = np.array(base.labels, np.int32)
        self.sup_idx = np.array(base.support_idx, np.int32).reshape(-1,
                                                                    self.cap)
        self.sup_w = np.array(base.support_w, np.float32).reshape(-1,
                                                                  self.cap)
        self.sup_v = np.array(base.support_v, np.float32).reshape(
            -1, self.cap, d)
        self.densities = np.array(base.densities, np.float32).reshape(-1)
        c = self.densities.shape[0]
        self.live = np.ones((c,), bool)
        self.outliers: list[int] = []
        self._free: list[int] = []          # dead ids, ascending, recycled
        self.outlier_min = int(outlier_min)
        self.auto_flush = bool(auto_flush)
        self._rng = (trandom.PRNGKey(17) if rng is None
                     else torch.as_tensor(np.asarray(rng).astype(np.int64)))
        # routing-ball cache, recomputed lazily for dirty clusters only
        self._roi_center = np.zeros((c, d), np.float64)
        self._roi_radius = np.zeros((c,), np.float64)
        self._roi_dirty: set[int] = set(range(c))
        self.insert_seconds: dict[str, float] = {}
        # epochs
        self.ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="alid_epochs_")
        self.keep = int(keep)
        self._epoch = -1
        self.commit(metadata={"baseline": True})

    def _on(self, a) -> torch.Tensor:
        """A copy of host array `a` on the device."""
        return torch.tensor(np.asarray(a), device=self.device)

    # ---------------------------------------------------------- properties
    @property
    def epoch_id(self) -> int:
        """Last committed epoch id (rollbacks move it backwards)."""
        return self._epoch

    @property
    def n_points(self) -> int:
        return int(self.alive.sum())

    @property
    def n_clusters(self) -> int:
        return int(self.live.sum())

    def epochs(self) -> list[int]:
        """Retained (restorable) epoch ids, ascending."""
        return list_checkpoints(self.ckpt_dir)

    # ------------------------------------------------------------- inserts
    def insert(self, pts) -> np.ndarray:
        """Apply a batch of new points; returns their stable ids.

        Each point is routed against the live clusters' outer ROI balls.
        Points inside at least one ball become candidates of those clusters'
        warm-started LID re-convergences (highest-density cluster first, the
        `resolve_claims` order, so a point absorbed twice goes to the denser
        cluster); points inside no ball are GUARANTEED non-infective for
        every cluster (Prop. 1) and go to the outlier buffer, which flushes
        into fresh LID runs once it holds `outlier_min` points."""
        t0 = time.perf_counter()
        pts = np.atleast_2d(np.asarray(pts, np.float32))
        if pts.shape[1] != self.d:
            raise ValueError(f"expected (m, {self.d}) points, got {pts.shape}")
        ids = self._alloc_ids(pts.shape[0])
        self.points[ids] = pts
        self.alive[ids] = True
        self.labels[ids] = -1
        self.stats.add("inserted", len(ids))
        self.insert_seconds = dict.fromkeys(
            ("refresh", "routing", "reconverge"), 0.0)
        self.insert_seconds["alloc"] = time.perf_counter() - t0
        self._route_and_update(ids, pts)
        if self.auto_flush and len(self.outliers) >= self.outlier_min:
            self.flush_outliers()
        self.insert_seconds["total"] = time.perf_counter() - t0
        return ids

    def _alloc_ids(self, m: int) -> np.ndarray:
        """Stable id allocation: recycle freed (dead) ids ascending, then
        grow the point arrays. Recycling is what makes a delete→insert
        round trip restore the exact label array."""
        take = min(m, len(self._free))
        ids = self._free[:take]
        self._free = self._free[take:]
        grow = m - take
        if grow:
            start = self.points.shape[0]
            self.points = np.concatenate(
                [self.points, np.zeros((grow, self.d), np.float32)])
            self.alive = np.concatenate([self.alive, np.zeros((grow,), bool)])
            self.labels = np.concatenate(
                [self.labels, np.full((grow,), -1, np.int32)])
            ids = ids + list(range(start, start + grow))
        return np.asarray(ids, np.int64)

    def _route_and_update(self, ids: np.ndarray, pts: np.ndarray) -> None:
        live = np.flatnonzero(self.live)
        if live.size == 0:
            self.outliers.extend(int(i) for i in ids)
            self.stats.add("buffered", len(ids))
            return
        t0 = time.perf_counter()
        self._refresh_rois()
        t1 = time.perf_counter()
        if self.cfg.p == 2.0:
            cen = self._roi_center[live]                       # (L, d)
            rad = self._roi_radius[live]                       # (L,)
            dist = np.sqrt(((pts.astype(np.float64)[:, None, :]
                             - cen[None]) ** 2).sum(-1))       # (m, L)
            hits = dist <= rad[None] + _ROUTE_EPS * (1.0 + rad[None])
        else:
            # non-Euclidean p: no ball test, conservatively route to all
            hits = np.ones((pts.shape[0], live.size), bool)

        unrouted = ids[~hits.any(axis=1)]
        self.outliers.extend(int(i) for i in unrouted)
        self.stats.add("buffered", len(unrouted))
        self.stats.add("routed", int(len(ids) - len(unrouted)))

        # densest cluster first (ties to the larger cluster id, mirroring
        # resolve_claims' larger-row tie-break); a candidate absorbed by an
        # earlier cluster is withheld from later ones
        order = live[np.lexsort((-live, -self.densities[live]))]
        t2 = time.perf_counter()
        taken: set[int] = set()
        for c in order:
            col = np.flatnonzero(live == c)[0]
            cand = [int(i) for i, h in zip(ids, hits[:, col])
                    if h and int(i) not in taken]
            if not cand:
                continue
            taken |= self._reconverge(int(c), candidates=cand)
        self.insert_seconds.update(refresh=t1 - t0, routing=t2 - t1,
                                   reconverge=time.perf_counter() - t2)

    # ------------------------------------------------------------- deletes
    def delete(self, ids: Sequence[int]) -> None:
        """Remove points; only clusters whose SUPPORT contains a removed
        point re-converge (a weightless point does not enter any cluster's
        KKT conditions, so removing it is exact for every cluster)."""
        ids = np.unique(np.asarray(ids, np.int64))
        if ids.size == 0:
            return
        bad = ids[(ids < 0) | (ids >= self.points.shape[0])
                  | ~self.alive[np.clip(ids, 0, self.points.shape[0] - 1)]]
        if bad.size:
            raise KeyError(f"delete of unknown/dead ids {bad.tolist()}")
        removed = set(int(i) for i in ids)
        affected = [c for c in np.flatnonzero(self.live)
                    if np.isin(self.sup_idx[c], ids).any()]
        self.alive[ids] = False
        self.labels[ids] = -1
        self.points[ids] = 0.0
        self.outliers = [i for i in self.outliers if i not in removed]
        self._free = sorted(set(self._free) | removed)
        # densest first, as in insert, for deterministic relabel cascades
        affected.sort(key=lambda c: (-self.densities[c], -c))
        for c in affected:
            self._reconverge(int(c), removed=ids)
        self.stats.add("deleted", len(ids))

    # -------------------------------------------------- local re-converge --
    def _reconverge(self, c: int, candidates: Sequence[int] = (),
                    removed: Optional[np.ndarray] = None) -> set[int]:
        """Warm-start LID for ONE cluster from its stored weighted support,
        with `candidates` packed into the free buffer slots at weight 0
        and/or `removed` members zeroed out. Returns the set of candidate
        ids absorbed into the support.

        Insert-only no-op guard: when LID takes no step (the stored support
        is already immune against every candidate at tol), the stored state
        is left untouched BIT FOR BIT: density, weights, labels, ROI cache
        all keep their exact values."""
        idx = self.sup_idx[c].copy()
        w = self.sup_w[c].copy()
        v = self.sup_v[c].copy()
        removing = removed is not None and np.isin(idx, removed).any()
        if removing:
            gone = np.isin(idx, removed)
            idx[gone], w[gone], v[gone] = -1, 0.0, 0.0
            total = float(w.sum())
            if (idx >= 0).sum() < 2 or total <= 0.0:
                self._dissolve(c)
                return set()
            w = w / total                  # back onto the simplex

        free = np.flatnonzero(idx < 0)
        cand = sorted(int(i) for i in candidates)
        if len(cand) > free.size:
            self.stats.add("overflowed", len(cand) - free.size)
            cand = cand[:free.size]
        slots = free[:len(cand)]
        if len(cand):
            idx[slots] = np.asarray(cand, np.int32)
            v[slots] = self.points[cand]
        mask = idx >= 0

        self.stats.add("reconverges")
        x_new, _, dens = _warm_lid(
            self._on(idx), self._on(mask), self._on(v), self._on(w), self.k,
            self.cfg.t_lid, self.cfg.tol, self.cfg.p, self.cfg.support_eps,
            self.cfg.backend, self.cfg.sweep_steps, self.cfg.refresh_every,
            dtype=self.cfg.spec.dtype)
        x_new = x_new.cpu().numpy()
        dens = np.float32(dens.item())

        if not removing and np.array_equal(x_new, w):
            # immune against every candidate: nothing moved, keep the
            # stored state exactly (candidates never entered the support)
            self.stats.add("noop_reconverges")
            return set()

        eps = self.cfg.support_eps
        member = mask & (x_new > eps)
        absorbed = {int(i) for i in idx[member] if int(i) in set(cand)}
        was_member = self.sup_idx[c] >= 0
        dropped = [int(i) for i in self.sup_idx[c][was_member]
                   if i not in set(int(j) for j in idx[member])]
        if removed is not None:
            dropped = [i for i in dropped
                       if i not in set(int(j) for j in removed)]

        if int(member.sum()) < 2 or float(dens) < self.cfg.density_min:
            self._dissolve(c)
            for i in absorbed:
                self.labels[i] = -1
            return set()

        # store the new support in fit's convention: members only, weights
        # renormalized onto the simplex, non-members zeroed/-1
        w_store = np.where(member, x_new, 0.0).astype(np.float32)
        w_store /= max(float(w_store.sum()), 1e-12)
        self.sup_idx[c] = np.where(member, idx, -1).astype(np.int32)
        self.sup_w[c] = w_store
        self.sup_v[c] = v * member[:, None]
        self.densities[c] = dens
        self._roi_dirty.add(c)

        for i in absorbed:
            self.labels[i] = c
        for i in dropped:
            if self.labels[i] == c:
                self.labels[i] = self._best_owner(i, exclude=c)
        self.stats.add("absorbed", len(absorbed))
        self.stats.add("dropped", len(dropped))
        return absorbed

    def _dissolve(self, c: int) -> None:
        """Retire cluster c in place (labels of other clusters never
        renumber): members relabel to their best other owner or -1."""
        members = self.sup_idx[c][self.sup_idx[c] >= 0]
        self.live[c] = False
        self.sup_idx[c] = -1
        self.sup_w[c] = 0.0
        self.sup_v[c] = 0.0
        self.densities[c] = 0.0
        self._roi_dirty.discard(c)
        for i in members:
            if self.labels[i] == c:
                self.labels[i] = self._best_owner(int(i), exclude=c)
        self.stats.add("dissolved")

    def _best_owner(self, i: int, exclude: int = -1) -> int:
        """Densest live cluster whose support holds point i (claim rule)."""
        best, best_dens = -1, -np.inf
        for c in np.flatnonzero(self.live):
            if c == exclude:
                continue
            slot = np.flatnonzero(self.sup_idx[c] == i)
            # stored weights are zeroed off-support, so membership is w > 0
            # (renormalization can nudge a member's weight just under
            # support_eps without it leaving the support)
            if slot.size and self.sup_w[c][slot[0]] > 0:
                if self.densities[c] > best_dens:
                    best, best_dens = int(c), float(self.densities[c])
        return best

    # ------------------------------------------------------------ outliers
    def flush_outliers(self) -> int:
        """Seed fresh LID runs over the outlier buffer: a bounded `fit` on
        the replicated engine over the buffered points alone, at the
        resident k (they intersect no existing outer ball, so by Prop. 1
        the existing clusters cannot claim them and they cannot perturb the
        existing clusters: the two problems are exactly separable). New
        clusters append after the existing ones; buffered points that stay
        unclaimed become plain noise (one fresh chance per flush, no
        re-buffering loops). Returns the number of new clusters."""
        buf = [i for i in self.outliers if self.alive[i]
               and self.labels[i] == -1]
        self.outliers = []
        if len(buf) < 2:
            return 0
        self.stats.add("flushes")
        buf_ids = np.asarray(buf, np.int64)
        pts = self.points[buf_ids]
        cfg = self.cfg._replace(
            k=self.k,        # the resident Laplacian scale, never re-estimated
            spec=EngineSpec(engine="replicated", backend=self.cfg.backend))
        keys = trandom.split(self._rng)
        self._rng, kf = keys[0], keys[1]
        res = fit(pts, cfg, kf, device=self.device)
        if res.n_clusters == 0:
            return 0
        c0 = self.densities.shape[0]
        remap = c0 + np.arange(res.n_clusters, dtype=np.int32)
        # local -> global support indices; fresh supports are already in
        # fit's storage convention
        sup_idx = np.where(res.support_idx >= 0,
                           buf_ids[np.clip(res.support_idx, 0,
                                           len(buf_ids) - 1)], -1)
        self.sup_idx = np.concatenate([self.sup_idx,
                                       sup_idx.astype(np.int32)])
        self.sup_w = np.concatenate([self.sup_w, res.support_w])
        self.sup_v = np.concatenate([self.sup_v, res.support_v])
        self.densities = np.concatenate([self.densities, res.densities])
        self.live = np.concatenate([self.live,
                                    np.ones((res.n_clusters,), bool)])
        self._roi_center = np.concatenate(
            [self._roi_center, np.zeros((res.n_clusters, self.d))])
        self._roi_radius = np.concatenate(
            [self._roi_radius, np.zeros((res.n_clusters,))])
        self._roi_dirty |= set(range(c0, c0 + res.n_clusters))
        labeled = res.labels >= 0
        self.labels[buf_ids[labeled]] = remap[res.labels[labeled]]
        self.stats.add("new_clusters", res.n_clusters)
        return res.n_clusters

    # ------------------------------------------------------------- routing
    def _refresh_rois(self) -> None:
        """Recompute (center, R_out) for clusters whose support moved since
        the last routing pass: one single-lane call per dirty cluster,
        through the `estimate_roi` path `fit` uses. One call each, not one
        batch: the centre's einsum is not bitwise batch-invariant, and the
        set of dirty clusters differs between a run and its rollback."""
        for c in sorted(self._roi_dirty):
            if not self.live[c]:
                continue
            center, r_out = _roi_of_support(
                self._on(self.sup_v[c]), self._on(self.sup_idx[c]),
                self._on(self.sup_w[c]), self.k, self.cfg.r0, self.cfg.p,
                self.cfg.support_eps, self.cfg.backend, self.cfg.spec.dtype)
            self._roi_center[c] = center.cpu().numpy().astype(np.float64)
            self._roi_radius[c] = float(r_out)
        self._roi_dirty.clear()

    # ------------------------------------------------------------- epochs --
    def verify(self) -> list[str]:
        """Invariant suite gating commit(); returns human-readable
        violations (empty = consistent)."""
        problems: list[str] = []
        n = self.points.shape[0]
        for c in np.flatnonzero(self.live):
            idx = self.sup_idx[c]
            mask = idx >= 0
            cnt = int(mask.sum())
            if cnt < 2:
                problems.append(f"cluster {c}: support size {cnt} < 2")
                continue
            w = self.sup_w[c]
            if (w[mask] <= 0).any() or abs(float(w.sum()) - 1.0) > 1e-3:
                problems.append(f"cluster {c}: weights off the simplex "
                                f"(sum={float(w.sum()):.6f})")
            if (w[~mask] != 0).any():
                problems.append(f"cluster {c}: weight on a pad slot")
            members = idx[mask]
            if (members >= n).any() or not self.alive[members].all():
                problems.append(f"cluster {c}: dead point in support")
            elif not np.array_equal(self.sup_v[c][mask],
                                    self.points[members]):
                problems.append(f"cluster {c}: support_v out of sync "
                                "with the point store")
            if self.densities[c] < self.cfg.density_min:
                problems.append(
                    f"cluster {c}: density {self.densities[c]:.4f} < "
                    f"density_min {self.cfg.density_min}")
        for c in np.flatnonzero(~self.live):
            if (self.sup_idx[c] >= 0).any():
                problems.append(f"dead cluster {c} still holds a support")
        labeled = np.flatnonzero(self.labels >= 0)
        for i in labeled:
            c = int(self.labels[i])
            if c >= self.live.shape[0] or not self.live[c]:
                problems.append(f"point {i} labeled to dead cluster {c}")
            elif not ((self.sup_idx[c] == i) & (self.sup_w[c] > 0)).any():
                problems.append(f"point {i} labeled {c} but not in its "
                                "support")
            if not self.alive[i]:
                problems.append(f"dead point {i} still labeled {c}")
        if np.setdiff1d(np.flatnonzero(~self.alive),
                        np.asarray(self._free, np.int64)).size:
            problems.append("dead ids missing from the free list")
        for i in self.outliers:
            if not self.alive[i] or self.labels[i] != -1:
                problems.append(f"outlier buffer holds labeled/dead id {i}")
        return problems

    def _to_tree(self) -> dict:
        """The snapshot, in the JAX package's leaves and dtypes: the key as
        uint32 words (jax's raw PRNGKey), k as float64."""
        return {
            "points": self.points, "alive": self.alive,
            "labels": self.labels, "sup_idx": self.sup_idx,
            "sup_w": self.sup_w, "sup_v": self.sup_v,
            "densities": self.densities, "live": self.live,
            "outliers": np.asarray(self.outliers, np.int64),
            "free": np.asarray(self._free, np.int64),
            "rng": np.asarray(self._rng).astype(np.uint32),
            "k": np.float64(self.k),
        }

    def _from_tree(self, tree: dict) -> None:
        self.points = np.array(tree["points"], np.float32)
        self.alive = np.array(tree["alive"], bool)
        self.labels = np.array(tree["labels"], np.int32)
        self.sup_idx = np.array(tree["sup_idx"], np.int32)
        self.sup_w = np.array(tree["sup_w"], np.float32)
        self.sup_v = np.array(tree["sup_v"], np.float32)
        self.densities = np.array(tree["densities"], np.float32)
        self.live = np.array(tree["live"], bool)
        self.outliers = [int(i) for i in tree["outliers"]]
        self._free = [int(i) for i in tree["free"]]
        self._rng = torch.as_tensor(np.asarray(tree["rng"]).astype(np.int64))
        self.k = float(tree["k"])
        c = self.densities.shape[0]
        self._roi_center = np.zeros((c, self.d), np.float64)
        self._roi_radius = np.zeros((c,), np.float64)
        self._roi_dirty = set(int(i) for i in np.flatnonzero(self.live))

    def commit(self, metadata: Optional[dict] = None) -> Epoch:
        """Verify, then persist the working state as the next epoch
        (atomic tmp-then-rename through checkpoint.manager, `keep` retained
        snapshots). On a verify failure the working state ROLLS BACK to the
        last committed epoch and EpochVerifyError carries the violations."""
        problems = self.verify()
        if problems:
            if self._epoch >= 0:
                self.rollback(self._epoch)
            raise EpochVerifyError(problems)
        prev = latest_step(self.ckpt_dir)
        eid = 0 if prev is None else prev + 1
        meta = {"epoch": eid, "n_points": self.n_points,
                "n_clusters": self.n_clusters, "parent": self._epoch,
                **(metadata or {})}
        path = save_checkpoint(self.ckpt_dir, eid, self._to_tree(),
                               metadata=meta, keep=self.keep)
        self._epoch = eid
        self.stats.add("commits")
        return Epoch(id=eid, path=path, n_points=self.n_points,
                     n_clusters=self.n_clusters, metadata=meta)

    def rollback(self, epoch: Optional[int] = None) -> int:
        """Restore the working state from a retained snapshot (default: the
        last committed epoch); arrays come back bit-identical."""
        steps = self.epochs()
        if not steps:
            raise KeyError("no committed epochs to roll back to")
        target = steps[-1] if epoch is None else int(epoch)
        if target not in steps:
            raise KeyError(f"epoch {target} not retained (have {steps})")
        _, tree = restore_checkpoint_tree(self.ckpt_dir, target)
        self._from_tree(tree)
        self._epoch = target
        self.stats.add("rollbacks")
        return target

    def epoch(self, metadata: Optional[dict] = None) -> "EpochTransaction":
        """Transactional update block: mutations inside the `with` apply to
        the working state; a clean exit commits (verify-gated), any
        exception (a verify failure too) rolls back to the last committed
        epoch."""
        return EpochTransaction(self, metadata)

    # ------------------------------------------------------------- serving
    def to_clustering(self) -> Clustering:
        """Materialize the current state as an immutable `Clustering` for
        serving (Tenant upload / predict / save). Live clusters compact;
        labels remap accordingly (identity while nothing ever dissolved)."""
        live = np.flatnonzero(self.live)
        c = self.densities.shape[0]
        remap = np.full((max(c, 1),), -1, np.int32)
        remap[live] = np.arange(live.size, dtype=np.int32)
        labels = np.where(self.labels >= 0,
                          remap[np.clip(self.labels, 0, max(c - 1, 0))],
                          -1).astype(np.int32)
        return Clustering(
            labels=labels,
            densities=self.densities[live],
            n_rounds=0,
            k=self.k,
            support_idx=self.sup_idx[live],
            support_w=self.sup_w[live],
            support_v=self.sup_v[live],
        )


class EpochTransaction:
    """Context manager wrapping apply → verify → commit-or-rollback; the
    committed `Epoch` is available as `.epoch` after a clean exit."""

    def __init__(self, oc: OnlineClustering, metadata: Optional[dict]):
        self._oc = oc
        self._metadata = metadata
        self.epoch: Optional[Epoch] = None

    def __enter__(self) -> "EpochTransaction":
        self._base = self._oc.epoch_id
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            if self._base >= 0:
                self._oc.rollback(self._base)
            return False
        self.epoch = self._oc.commit(self._metadata)
        return False
