"""Generate the golden fixtures of `tests/golden_torch/` from the JAX
package, the reference the port is held to where JAX cannot run (the card's
host has none): `repro_torch.utils.golden` reads them with numpy alone.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden_gen.py

writes three files (the JAX package's backend="ref" on the CPU):

- ops.npz: every case of `repro.analysis.contracts.OP_CASES`, its inputs
  and its outputs;
- fit_small.npz: one fit of tests/test_engine.py's fixture (4 blobs of 25
  and 80 noise points in d = 10, seed 7; a_cap 48, delta 48, probe 128, 16
  seeds a round, 20 rounds) and `predict` of its points and of 40 rows
  around them, points stored;
- fit_parity.npz: one fit at chip_smoke.py phase 3b's data (200 blobs of
  40 and 12,000 noise points in d = 128, seed 0; auto_lsh_params at probe
  128 and seg_scale 1, so that probe 128 covers every bucket; a_cap 72,
  delta 128, 32 seeds a round, 64 rounds). The points are not stored:
  both packages make them with numpy from the seed, and the fixture keeps
  their sha256, so a drift in the generator fails loudly.

Each file records the jax version and the seed it was made with.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden_gen.py \
        --tie-probe

re-runs fit_parity's reference fit with its distance rounded two other
ways and prints how far each lands from the fixture, and

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden_gen.py \
        --round-diff <scratch dir>

runs the reference's and the port's fit there with a checkpoint every
round and prints, round by round, where they part; `--seed-trace <scratch
dir> <round>` then replays the round after it from the reference's
checkpoint in both packages and finds the seed and the LID step where
they part (ROADMAP C4). Not a
test module (no `test_` prefix): tests/test_torch_golden.py calls
`generate` and compares a fresh run with the committed files.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import jax
import numpy as np

from repro.analysis.contracts import OP_CASES
from repro.core.alid import ALIDConfig, EngineSpec
from repro.core.engine import fit
from repro.data import auto_lsh_params, make_blobs_with_noise
from repro.kernels import ops
from repro.utils import canonical_labels

OUT_DIR = Path(__file__).resolve().parent / "golden_torch"
SEED = 0
# tests/test_engine.py's fixture
SMALL_DATA = dict(n_clusters=4, cluster_size=25, n_noise=80, d=10, seed=7,
                  overlap_pairs=0)
SMALL_CFG = dict(a_cap=48, delta=48, seeds_per_round=16, max_rounds=20)
SMALL_PROBE = 128
# chip_smoke.py phase 3b's data and configuration
PARITY_DATA = dict(n_clusters=200, cluster_size=40, n_noise=12_000, d=128,
                   seed=0)
PARITY_LSH = dict(probe=128, seg_scale=1.0)
PARITY_CFG = dict(a_cap=72, delta=128, seeds_per_round=32, max_rounds=64)


def points_sha256(points: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(points, np.float32).tobytes()).hexdigest()


def _meta(**kw) -> np.ndarray:
    return np.asarray(json.dumps({"jax": jax.__version__, "seed": SEED,
                                  **kw}, sort_keys=True))


def gen_ops() -> dict:
    """Each case's positional arguments (arrays as they are, Python scalars
    as 0-d float64 arrays, listed in the meta) and its outputs."""
    out, cases = {}, {}
    for case in OP_CASES:
        args, kwargs = case.make()
        scalars = [i for i, a in enumerate(args)
                   if not isinstance(a, np.ndarray)]
        for i, a in enumerate(args):
            out[f"{case.name}__arg{i}"] = np.asarray(a)
        res = getattr(ops, case.name)(*args, backend="ref", **kwargs)
        res = tuple(res) if isinstance(res, (tuple, list)) else (res,)
        for j, r in enumerate(res):
            out[f"{case.name}__out{j}"] = np.asarray(r)
        cases[case.name] = {"n_args": len(args), "scalars": scalars,
                            "n_outs": len(res), "kwargs": kwargs}
    out["meta"] = _meta(cases=cases)
    return out


def _fit_arrays(res) -> dict:
    return {"labels": canonical_labels(res.labels).astype(np.int32),
            "densities": np.sort(np.asarray(res.densities, np.float32)),
            "n_rounds": np.asarray(res.n_rounds, np.int32),
            "k": np.asarray(res.k, np.float64)}


def _cfg(lshp, **kw) -> ALIDConfig:
    return ALIDConfig(lsh=lshp, spec=EngineSpec(backend="ref"), **kw)


def gen_fit_small() -> dict:
    spec = make_blobs_with_noise(**SMALL_DATA)
    lshp = auto_lsh_params(spec.points, probe=SMALL_PROBE)
    res = fit(spec.points, _cfg(lshp, **SMALL_CFG), jax.random.PRNGKey(SEED))
    rng = np.random.default_rng(SEED)
    queries = np.concatenate([
        spec.points,
        spec.points[rng.integers(0, spec.points.shape[0], 40)]
        + rng.normal(0.0, 0.5, (40, spec.points.shape[1]))
    ]).astype(np.float32)
    # predict's labels in the fit's canonical numbering: every cluster id
    # appears in the fit's labels first
    both = canonical_labels(np.concatenate(
        [res.labels, res.predict(queries, backend="ref")]))
    return {"points": spec.points, "queries": queries,
            "predict": both[spec.points.shape[0]:].astype(np.int32),
            **_fit_arrays(res),
            "meta": _meta(data=SMALL_DATA, probe=SMALL_PROBE, cfg=SMALL_CFG,
                          lsh=list(lshp))}


def gen_fit_parity() -> dict:
    spec = make_blobs_with_noise(**PARITY_DATA)
    lshp = auto_lsh_params(spec.points, **PARITY_LSH)
    res = fit(spec.points, _cfg(lshp, **PARITY_CFG),
              jax.random.PRNGKey(SEED))
    return {**_fit_arrays(res),
            "meta": _meta(data=PARITY_DATA, lsh_args=PARITY_LSH,
                          cfg=PARITY_CFG, lsh=list(lshp),
                          points_sha256=points_sha256(spec.points))}


GENERATORS = {"ops": gen_ops, "fit_small": gen_fit_small,
              "fit_parity": gen_fit_parity}


def _direct_distance(q, c, p=2.0):
    """||q_i - c_j|| in the direct form sqrt(sum((q - c)^2)), f32: no
    cancellation of |q|^2 + |c|^2 against 2 q.c."""
    import jax.numpy as jnp
    q32, c32 = q.astype(jnp.float32), c.astype(jnp.float32)
    return jnp.concatenate(
        [jnp.sqrt(jnp.sum((q32[i:i + 256, None] - c32[None]) ** 2, -1))
         for i in range(0, q32.shape[0], 256)], 0)


def _f64_distance(q, c, p=2.0):
    """The expansion taken in float64 on the host and rounded once to
    f32."""
    def host(q, c):
        q64, c64 = np.asarray(q, np.float64), np.asarray(c, np.float64)
        d2 = ((q64 * q64).sum(-1)[:, None] + (c64 * c64).sum(-1)[None]
              - 2.0 * (q64 @ c64.T))
        return np.sqrt(np.maximum(d2, 0.0)).astype(np.float32)
    return jax.pure_callback(host, jax.ShapeDtypeStruct(
        (q.shape[0], c.shape[0]), np.float32), q, c,
        vmap_method="sequential")


def tie_probe() -> None:
    """The reference's fit at fit_parity's data again, with its one
    distance (`repro.kernels.ref.pairwise_distance_ref`, which every ref op
    computes through) rounded another way: the direct form in f32, and the
    expansion in f64. Prints each fit's clusters, rounds, k and the points
    whose canonical label differs from the committed fixture's. Nothing in
    the JAX package is edited: the module attribute is swapped in this
    process and the jit caches cleared around each run."""
    import repro.kernels.ref as jref
    want = np.load(OUT_DIR / "fit_parity.npz")
    spec = make_blobs_with_noise(**PARITY_DATA)
    lshp = auto_lsh_params(spec.points, **PARITY_LSH)
    plain = jref.pairwise_distance_ref
    for name, dist in (("as committed", plain),
                       ("direct f32", _direct_distance),
                       ("f64 expansion", _f64_distance)):
        jref.pairwise_distance_ref = dist
        jax.clear_caches()
        try:
            res = fit(spec.points, _cfg(lshp, **PARITY_CFG),
                      jax.random.PRNGKey(SEED))
        finally:
            jref.pairwise_distance_ref = plain
            jax.clear_caches()
        diff = int((canonical_labels(res.labels) != want["labels"]).sum())
        print(f"[tie-probe] {name}: clusters={res.n_clusters} "
              f"rounds={res.n_rounds} k={float(res.k)!r} "
              f"labels differing from the fixture: {diff}")


def generate(name: str) -> dict:
    return GENERATORS[name]()


def round_diff(ckpt_root: str) -> None:
    """Where the port's fit and the reference's part at fit_parity's data:
    both fits run on the CPU with a fit checkpoint every round (all kept,
    under `ckpt_root`), and each round's peeled clusters (as sets of
    points) and active masks are compared."""
    import torch

    import repro.checkpoint.manager as jmanager
    import repro_torch.checkpoint.manager as tmanager
    from repro_torch.core.engine import fit as tfit
    from repro_torch.random import PRNGKey
    from repro_torch.utils import golden
    spec = make_blobs_with_noise(**PARITY_DATA)
    lshp = auto_lsh_params(spec.points, **PARITY_LSH)
    keep = (jmanager._gc, tmanager._gc)
    jmanager._gc = tmanager._gc = lambda *a, **k: None   # every round kept
    try:
        fit(spec.points, _cfg(lshp, **PARITY_CFG), jax.random.PRNGKey(SEED),
            checkpoint_dir=f"{ckpt_root}/jax", checkpoint_every=1)
        points, cfg, _ = golden.fit_data("fit_parity")
        tfit(points, cfg, PRNGKey(SEED), device="cpu",
             checkpoint_dir=f"{ckpt_root}/port", checkpoint_every=1)
    finally:
        jmanager._gc, tmanager._gc = keep
    for step in tmanager.list_checkpoints(f"{ckpt_root}/jax"):
        states = [tmanager.restore_checkpoint_tree(f"{ckpt_root}/{side}",
                                                   step)[1]
                  for side in ("jax", "port")]
        peeled = [{frozenset(np.where(np.asarray(s["labels"]) == c)[0])
                   for c in range(len(s["densities"]))} for s in states]
        active = [np.asarray(s["active"]) for s in states]
        only = [sorted(len(m) for m in a - b)
                for a, b in ((peeled[0], peeled[1]), (peeled[1], peeled[0]))]
        moved = active[0] != active[1]
        noise = [np.asarray(s["labels"]) < 0 for s in states]
        print(f"[round-diff] round {step}: clusters {len(peeled[0])} / "
              f"{len(peeled[1])}, only the reference's (sizes) {only[0]}, "
              f"only the port's {only[1]}; points active in one fit only: "
              f"{int(moved.sum())} (labelled noise in both: "
              f"{int((moved & noise[0] & noise[1]).sum())})")


def seed_trace(ckpt_root: str, step: int) -> None:
    """Round `step` + 1 of both fits again from the reference's checkpoint
    of round `step` (left by `round_diff`), on both packages' replicated
    engines at one k (the fixture's): each seed whose support differs; for
    the first of them, its outer loop replayed in both packages (equal
    candidate sets at its end) and its final LID (the polish) replayed
    from there a few steps at a time."""
    import jax.numpy as jnp
    import torch

    import repro.core.civs as jcivs
    import repro.core.lid as jlid
    import repro.core.roi as jroi
    import repro_torch.core.alid as talid
    import repro_torch.core.civs as tcivs
    import repro_torch.core.lid as tlid
    import repro_torch.core.roi as troi
    from repro.core.engine import make_engine
    from repro_torch.checkpoint.manager import restore_checkpoint_tree
    from repro_torch.core.engine import make_engine as tmake_engine
    from repro_torch.core.source import as_source
    from repro_torch.lsh.pstable import LSHParams
    from repro_torch.random import PRNGKey, split
    spec = make_blobs_with_noise(**PARITY_DATA)
    lshp = auto_lsh_params(spec.points, **PARITY_LSH)
    k = float(np.load(OUT_DIR / "fit_parity.npz")["k"])
    jcfg = _cfg(lshp, k=k, **PARITY_CFG)
    tcfg = talid.ALIDConfig(lsh=LSHParams(*lshp), k=k, **PARITY_CFG)
    jeng = make_engine(jcfg.spec)
    jeng.build_source(as_source(spec.points), jcfg,
                      jax.random.split(jax.random.PRNGKey(SEED))[1])
    teng = tmake_engine(tcfg.spec, device="cpu")
    teng.build_source(as_source(spec.points), tcfg, split(PRNGKey(SEED))[1])
    state = restore_checkpoint_tree(f"{ckpt_root}/jax", step)[1]
    active = np.asarray(state["active"])
    seeds = np.asarray(state["seeds"], np.int32)
    valid = np.asarray(state["seed_valid"])
    jact, tact = jnp.asarray(active), torch.as_tensor(active)
    _, _, jres = jeng.run_round(jact, jnp.asarray(seeds),
                                jnp.asarray(valid))
    _, _, tres = teng.run_round(tact, torch.as_tensor(seeds),
                                torch.as_tensor(valid))
    parted = []
    for s in range(seeds.size):
        a = np.asarray(jres.member_idx)[s][np.asarray(jres.member_mask)[s]]
        b = tres.member_idx[s][tres.member_mask[s]].numpy()
        if set(a.tolist()) != set(b.tolist()):
            parted.append(s)
            print(f"[seed-trace] round {step + 1} seed row {s} (point "
                  f"{seeds[s]}): support {a.size} / {b.size}, density "
                  f"{float(np.asarray(jres.density)[s])!r} / "
                  f"{float(tres.density[s])!r}, outer iterations "
                  f"{int(np.asarray(jres.n_outer)[s])} / "
                  f"{int(tres.n_outer[s])}")
    if not parted:
        return
    seed = int(seeds[parted[0]])
    solve = dict(max_iters=jcfg.t_lid, tol=jcfg.tol, p=jcfg.p,
                 backend="ref", sweep_steps=jcfg.sweep_steps,
                 refresh_every=jcfg.refresh_every,
                 support_eps=jcfg.support_eps)
    jst = jlid.init_state(jeng._points, jnp.int32(seed), jcfg.cap)
    tst = tlid.init_state_from(teng.points[torch.tensor([seed])],
                               torch.tensor([seed], dtype=torch.int32),
                               tcfg.cap)

    def support(js, ts):
        return (set(np.asarray(js.beta_idx)[np.asarray(js.beta_mask) & (
                    np.asarray(js.x) > jcfg.support_eps)].tolist()),
                set(ts.beta_idx[0][ts.beta_mask[0] & (
                    ts.x[0] > tcfg.support_eps)].numpy().tolist()))

    # the outer loop in lockstep (Alg. 2, then its final polish as one more
    # LID) until the two packages' supports part
    for c in range(1, jcfg.c_outer + 2):
        entry = int(jst.n_iters)
        j2 = jlid.lid_solve(jst, jeng.k, **solve)
        t2 = tlid.lid_solve(tst, teng.k, **solve)
        a, b = support(j2, t2)
        if a != b:
            print(f"[seed-trace] point {seed}: the LID of outer iteration "
                  f"{c} parts (equal candidates at entry: "
                  f"{int(np.asarray(jst.beta_mask).sum())}; LID steps "
                  f"{entry} at entry, {int(j2.n_iters)} / "
                  f"{int(t2.n_iters[0])} at exit of t_lid {jcfg.t_lid}, "
                  f"converged {bool(j2.converged)} / "
                  f"{bool(t2.converged[0])})")
            for more in range(1, int(j2.n_iters) - entry + 1):
                kw = dict(solve, max_iters=entry + more)
                j3 = jlid.lid_solve(jst, jeng.k, **kw)
                t3 = tlid.lid_solve(tst, teng.k, **kw)
                a, b = support(j3, t3)
                dx = float(np.abs(np.asarray(j3.x) - t3.x[0].numpy()).max())
                print(f"[seed-trace]   + {more} steps: support {len(a)} / "
                      f"{len(b)}, max |x - x'| {dx!r}")
                if a != b:
                    break
            return
        jst, tst = j2, t2
        jr = jroi.estimate_roi(jst.v_beta, jst.beta_idx, jst.beta_mask,
                               jst.x, jeng.k, jnp.int32(c), r0=jcfg.r0,
                               p=jcfg.p, support_eps=jcfg.support_eps,
                               backend="ref")
        tr = troi.estimate_roi(tst.v_beta, tst.beta_idx, tst.beta_mask,
                               tst.x, teng.k,
                               torch.tensor([c], dtype=torch.int32),
                               r0=tcfg.r0, p=tcfg.p,
                               support_eps=tcfg.support_eps, backend="ref")
        civs = dict(a_cap=jcfg.a_cap, delta=jcfg.delta, tol=jcfg.tol,
                    support_eps=jcfg.support_eps, p=jcfg.p, backend="ref")
        jst = jcivs.civs_update(jst, jr, jeng._points, jact, jeng._tables,
                                jcfg.lsh, jeng.k, **civs).state
        tst = tcivs.civs_update(tst, tr, teng.points, tact, teng.tables,
                                tcfg.lsh, teng.k, **civs).state


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(GENERATORS)
    if names == ["--tie-probe"]:
        tie_probe()
        return 0
    if names[:1] == ["--round-diff"]:
        round_diff(names[1])
        return 0
    if names[:1] == ["--seed-trace"]:
        seed_trace(names[1], int(names[2]))
        return 0
    OUT_DIR.mkdir(exist_ok=True)
    for name in names:
        np.savez_compressed(OUT_DIR / f"{name}.npz", **generate(name))
        print(f"wrote {OUT_DIR / name}.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
