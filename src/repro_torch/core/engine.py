"""The fit driver: ONE host peel-reduce loop over the replicated engine.

`fit` runs the host-level peeling loop of paper Sec. 4.4: rounds of batched
seeds, each resolved by the PALID reducer (Sec. 4.6): a point belongs to the
claiming instance of maximum density, exact ties broken toward the larger
seed row id. That reducer exists once (`resolve_claims`). The random stream
is consumed as the JAX package consumes it (one split for the LSH build, one
per round for seeding, drawn a round ahead), so on tie-free data the port
and the JAX package find the same clusters.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`), which then runs every op's plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core.affinity import estimate_k
from repro_torch.core.alid import (ALIDConfig, Clustering, EngineSpec,
                                   _sample_seeds, alid_from_seed,
                                   resolve_device)
from repro_torch.core.source import (DataSource, as_source,
                                     strided_sample_indices)
from repro_torch.kernels import ops
from repro_torch.lsh.pstable import bucket_sizes, build_lsh

__all__ = ["EngineSpec", "Clustering", "fit", "make_engine",
           "resolve_claims", "ReplicatedEngine"]

# rows drawn for k estimation when cfg.k is None (estimate_k's default)
_K_SAMPLE = 512

# engines of the JAX package that this port does not have yet
_NOT_PORTED = {"sharded": "A10", "mesh": "A13", "streamed": "A11"}


def resolve_claims(member_idx: torch.Tensor, member_mask: torch.Tensor,
                   dens: torch.Tensor, seed_valid: torch.Tensor, n: int):
    """THE claim reducer (paper Sec. 4.6): segment-max over all (seed row,
    member) claims; each point goes to the claiming instance of maximum
    density, exact ties (within 1e-9) to the larger seed row id.

    member_idx/member_mask: (s, cap); dens/seed_valid: (s,).
    Returns (claimed (n,) bool, best_row (n,) int32, best_dens (n,) f32)."""
    s_batch, cap = member_idx.shape
    dev = member_idx.device
    flat_idx = member_idx.reshape(-1).long()
    flat_valid = member_mask.reshape(-1) & (flat_idx >= 0)
    flat_valid &= seed_valid.repeat_interleave(cap)
    flat_dens = dens.float().repeat_interleave(cap)
    safe = torch.clamp(flat_idx, 0, n - 1)

    best_dens = torch.full((n,), float("-inf"), device=dev).scatter_reduce(
        0, safe, torch.where(flat_valid, flat_dens, float("-inf")), "amax")
    flat_row = torch.arange(s_batch, dtype=torch.int32,
                            device=dev).repeat_interleave(cap)
    is_winner = flat_valid & (flat_dens >= best_dens[safe] - 1e-9)
    best_row = torch.full((n,), -1, dtype=torch.int32,
                          device=dev).scatter_reduce(
        0, safe, torch.where(is_winner, flat_row, -1), "amax")
    return best_row >= 0, best_row, best_dens


class ReplicatedEngine:
    """Full dataset + monolithic LSH tables in one device's memory."""

    def __init__(self, spec: EngineSpec = EngineSpec(), device="cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.k: Optional[float] = None
        self._cfg: Optional[ALIDConfig] = None
        self._n = 0

    def build_source(self, source: DataSource, cfg: ALIDConfig,
                     rng: torch.Tensor) -> None:
        """Sample k from the source, then materialize it on the device and
        build the LSH tables (consuming rng once)."""
        self._cfg = cfg
        self._n = source.n
        if cfg.k is not None:
            self.k = float(np.float32(cfg.k))
        else:
            idx = strided_sample_indices(source.n, _K_SAMPLE)
            self.k = estimate_k(torch.as_tensor(source.sample(idx),
                                                device=self.device),
                                backend=cfg.backend)
        self.points = torch.as_tensor(source.get_chunk(0, source.n),
                                      dtype=torch.float32,
                                      device=self.device)
        self.tables = build_lsh(self.points, cfg.lsh, rng, cfg.backend)
        self.bucket_sizes = bucket_sizes(self.tables)

    def run_round(self, active: torch.Tensor, seeds: torch.Tensor,
                  seed_valid: torch.Tensor):
        results = alid_from_seed(self.points, active, self.tables, seeds,
                                 self.k, self._cfg)
        claimed, best_row, _ = resolve_claims(
            results.member_idx, results.member_mask, results.density,
            seed_valid, self._n)
        return claimed, best_row, results


def make_engine(spec: EngineSpec, device="cuda") -> ReplicatedEngine:
    """Instantiate the engine an EngineSpec names (unbuilt)."""
    if spec.engine in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {spec.engine!r} is not ported yet (ROADMAP "
            f"{_NOT_PORTED[spec.engine]}); only 'replicated' runs")
    if spec.engine != "replicated":
        raise ValueError(f"unknown engine {spec.engine!r}; expected "
                         "'replicated'")
    if spec.dtype != "float32":
        raise NotImplementedError(
            f"storage dtype {spec.dtype!r} is not ported yet (ROADMAP queue "
            "item 'bf16 storage in the four kernels'); only 'float32' runs")
    return ReplicatedEngine(spec, device)


def fit(data, cfg: ALIDConfig = ALIDConfig(),
        rng: Optional[torch.Tensor] = None,
        engine: Optional[ReplicatedEngine] = None, *,
        device="cuda") -> Clustering:
    """Dominant-cluster detection: THE host peel-reduce loop (Sec. 4.4).

    `data` is a DataSource or an (n, d) array. Rounds of batched seeds
    (sampled from large LSH buckets) run on the engine; claims resolve
    through `resolve_claims`; claimed points + seeds are peeled until no
    dominant-cluster candidate remains (or, with cfg.exhaustive, no active
    point at all). `rng` is a `repro_torch.random.PRNGKey`."""
    source = as_source(data)
    rng = trandom.PRNGKey(0) if rng is None else rng
    if engine is None:
        engine = make_engine(cfg.spec, device)
    # refuse a norm the kernels do not compute before building anything
    ops.check_norm(ops.resolve_backend(
        cfg.backend, torch.empty(0, device=engine.device)), cfg.p, "fit")
    keys = trandom.split(rng)
    rng, kb = keys[0], keys[1]
    engine.build_source(source, cfg, kb)
    return _fit_loop(source, cfg, rng, engine)


def _fit_loop(source: DataSource, cfg: ALIDConfig, rng: torch.Tensor,
              engine: ReplicatedEngine) -> Clustering:
    n = source.n
    dev = engine.device
    bsizes = engine.bucket_sizes
    bsizes_np = bsizes.cpu().numpy()
    cap, d = cfg.cap, source.dim

    active_np = np.ones((n,), bool)
    active = torch.as_tensor(active_np, device=dev)
    labels = np.full((n,), -1, np.int32)
    densities, sup_idx, sup_w, sup_v = [], [], [], []
    next_label = 0

    keys = trandom.split(rng)
    rng, kr = keys[0], keys[1]
    seeds, seed_valid, any_eligible = _sample_seeds(active, bsizes, kr, cfg)
    rounds = 0

    for rounds in range(1, cfg.max_rounds + 1):
        valid_np = seed_valid.cpu().numpy()
        if not valid_np.any():
            break
        if not cfg.exhaustive and not any_eligible:
            break
        seeds_np = seeds.cpu().numpy()
        peeled_seeds = seeds_np[valid_np]

        # speculative round r+1 sampling, drawn BEFORE round r runs: the
        # seeds themselves are sure to peel, claims are checked below
        keys = trandom.split(rng)
        rng, kr_next = keys[0], keys[1]
        spec_active = active.clone()
        spec_active[torch.as_tensor(peeled_seeds, device=dev).long()] = False
        spec_seeds, spec_valid, _ = _sample_seeds(spec_active, bsizes,
                                                  kr_next, cfg)

        claimed, best_row, results = engine.run_round(active, seeds,
                                                      seed_valid)

        claimed_np = claimed.cpu().numpy()
        row_np = best_row.cpu().numpy()
        dens_np = results.density.cpu().numpy()
        member_np = results.member_idx.cpu().numpy()
        weight_np = results.member_w.cpu().numpy()
        # peel everything claimed + the seeds themselves
        new_inactive = claimed_np.copy()
        new_inactive[peeled_seeds] = True
        active_np &= ~new_inactive
        active = torch.as_tensor(active_np, device=dev)

        # the speculation is exact unless a speculated winner was claimed
        spec_np = spec_seeds.cpu().numpy()[spec_valid.cpu().numpy()]
        if claimed_np[spec_np].any():
            spec_seeds, spec_valid, _ = _sample_seeds(active, bsizes,
                                                      kr_next, cfg)
        seeds, seed_valid = spec_seeds, spec_valid
        any_eligible = bool((active_np & (bsizes_np > cfg.min_bucket)).any())

        # labels for winning rows that clear the density threshold, in one
        # segment pass (rows in ascending order)
        claimed_pts = np.where(claimed_np)[0]
        grp = np.argsort(row_np[claimed_pts], kind="stable")
        sorted_pts = claimed_pts[grp]
        uniq_rows, counts = np.unique(row_np[claimed_pts],
                                      return_counts=True)
        keep = (dens_np[uniq_rows] >= cfg.density_min) & (counts > 1)
        lab = np.full(uniq_rows.shape[0], -1, np.int32)
        lab[keep] = next_label + np.arange(int(keep.sum()), dtype=np.int32)
        labels[sorted_pts] = np.repeat(lab, counts)
        for row in uniq_rows[keep]:
            densities.append(float(dens_np[row]))
            midx, mw = member_np[row], weight_np[row]
            valid = (midx >= 0) & (mw > 0)
            w = np.where(valid, mw, 0.0).astype(np.float32)
            w /= max(float(w.sum()), 1e-12)
            sup_idx.append(np.where(valid, midx, -1).astype(np.int32))
            sup_w.append(w)
            sup_v.append(np.asarray(
                source.sample(np.clip(midx, 0, n - 1)), np.float32)
                * valid[:, None])
        next_label += int(keep.sum())
        if not active_np.any():
            break

    return Clustering(
        labels=labels,
        densities=np.asarray(densities, np.float32),
        n_rounds=rounds,
        k=float(engine.k),
        support_idx=(np.stack(sup_idx) if sup_idx
                     else np.zeros((0, cap), np.int32)),
        support_w=(np.stack(sup_w) if sup_w
                   else np.zeros((0, cap), np.float32)),
        support_v=(np.stack(sup_v).astype(np.float32) if sup_v
                   else np.zeros((0, cap, d), np.float32)),
    )
