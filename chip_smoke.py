"""Drive the PyTorch port of ALID on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of `src/repro_torch/csrc/` (nvcc, at
first use), then runs, in order, failing with a non-zero exit on any error:

1. environment: torch / CUDA versions, the kernel build time, the card's
   name and power limit (nvidia-smi);
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the main path (lsh_hash at 1,000,000 x 128; roi_filter,
   affinity_matvec and lid_sweep over 32 seeds), including a lid_sweep
   block past the 227 KB of shared memory, ragged tails and NaN-poisoned
   padded slots; each with its error, its device time (25 calls replayed
   from a CUDA graph) and per-call time (CUDA events, median of 25 after
   warm-up), the plain version's device time from a CUDA graph (per call
   for lid_sweep's, which checks its lanes on the host every step), and
   the card's bound;
3. end-to-end parity: one fit through the kernels and one through the plain
   versions, both on the card, at n = 20,000 x 128: equal canonical labels
   and round counts, densities within tolerance;
4. the full-width fit, SIFT1M's shape (1,000,000 x 128 f32) in the paper's
   size-limited regime, with every fit kernel's launch count, which must
   be > 0;
5. serving at full width on phase 4's Clustering (2,048 clusters x 240
   supports x 128): the assign kernel against its plain version on 256
   queries of the serving mix (dataset rows, jittered rows, far noise) and
   on a NaN-poisoned, masked 64-slot batch (labels and scores bit-equal);
   its device time for one 64-slot batch, per-call time, the plain
   version's time, the bound, and the device time of the cuBLAS
   composition (matmul expansion, exp, segment sum, argmax) as a
   yardstick the port never calls; then the serving path from launch
   counts at 0: a 4,096-row bulk `predict`, `ClusterService(batch_slots=
   64)` over 1,024 queries, and `run_palid._serve_bench` (ClusterServer +
   open-loop traffic at 2,000 requests/s), whose labels must equal
   per-query assignment and whose `assign` launches must be > 0;
6. the full-matrix path (estimate_k, affinity_matrix through the affinity
   kernel, IID / DS peeling, the paper's baselines): (a) the affinity
   kernel bit-equal to its plain version on rows of the full-width
   40,000 x 40,000 x 128 block (symmetric bitwise), on LID columns, ragged
   shapes, NaN rows and a call past 2**31 entries, with its device time,
   per-call time, plain time, bound and the cuBLAS composition's time;
   (b) `lid_solve_unfused` (affinity kernel) bit-equal to `lid_solve`
   (lid_sweep kernel); (c) IID and DS peels at n = 4,000 equal on the
   kernel's and the plain version's matrices, and one IID solve from CUDA
   graphs equal to the eager loop, with the time of each; (d) the
   full-width IID run, `launch/full_matrix.py` at 40,000 x 128, whose
   `affinity` launches must be > 0; (e) every baseline on the CPU tests'
   `easy` data, each above its AVG-F floor;

then prints the kernel table as one JSON line, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Without a CUDA
device, or without the repository's `src/` beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# published peaks of one H100 SXM (dense, 700 W): HBM3 bytes/s, f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TIMED_RUNS = 25
# the size of the parity fits (the full-width fit's configuration is
# repro_torch.launch.full_width)
PARITY_N = 20_000
DEVICE = "cuda:0"

# the JAX package's Pallas kernels the six CUDA kernels replace
REPLACES = {
    "lsh_hash": "src/repro/kernels/lsh_hash.py:41",
    "roi_filter": "src/repro/kernels/roi_filter.py:46",
    "affinity_matvec": "src/repro/kernels/affinity_matvec.py:50",
    "lid_sweep": "src/repro/kernels/lid_sweep.py:149",
    "assign": "src/repro/kernels/assign.py:52",
    "affinity": "src/repro/kernels/affinity.py:34",
}
# the kernels of the fit (phase 4); serving and the full-matrix path run
# the others
FIT_KERNELS = ("lsh_hash", "roi_filter", "affinity_matvec", "lid_sweep")
# serving: run_palid's defaults, and the bulk predict's rows
SERVE_RATE = 2000.0
BULK_ROWS = 4096


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def call_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median time of one call of fn() as the card sees it: CUDA events
    around each call, after two warm-up calls. For a small kernel this is
    set by the host's time to enqueue the call, not by the kernel."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, runs: int = TIMED_RUNS, replays: int = 5) -> float:
    """Device time of one call of fn(): `runs` calls captured in one CUDA
    graph, replayed `replays` times between CUDA events; the median replay
    over `runs`. Without the host's enqueue this is the time of the call's
    launches on the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return statistics.median(times)


def timings(kernel, plain, plain_in_graph: bool = True,
            plain_runs: int = TIMED_RUNS) -> dict:
    """The kernel's device time (CUDA graph) and per-call time, and the
    plain version's time measured as the kernel's device time is, from a
    CUDA graph (of `plain_runs` calls); per call (CUDA events, the host's
    enqueue included) only where the plain version waits on the host
    inside a call, as lid_sweep's does after every step, so that no graph
    can hold it."""
    return dict(ms=graph_ms(kernel), call_ms=call_ms(kernel),
                plain_ms=graph_ms(plain, runs=plain_runs) if plain_in_graph
                else call_ms(plain), plain_in_graph=plain_in_graph)


def time_line(t: dict) -> str:
    how = ("device time, CUDA graph" if t["plain_in_graph"] else
           "per call incl. the host's enqueue and its per-step host "
           "checks, CUDA events: it cannot be captured in a graph")
    return (f"kernel_ms={t['ms']:.4f} (device time, CUDA graph) "
            f"kernel_call_ms={t['call_ms']:.4f} (per call incl. the host's "
            f"enqueue, CUDA events) plain_ms={t['plain_ms']:.4f} ({how})")


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take (ms) and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernels ----
def live_states(bsz, cap, d, dev, seed=0, n_valid=None):
    """A batch of full-range LID states with an exact Ax, so the sweep
    iterates: clustered rows, x = the seed slot, Ax refreshed."""
    from repro_torch.core.lid import LIDState, refresh_ax
    rng = np.random.default_rng(seed)
    n_valid = cap if n_valid is None else n_valid
    centers = rng.normal(size=(bsz, 4, d)) * 3.0
    pts = centers[:, rng.integers(0, 4, cap)] + rng.normal(size=(bsz, cap, d))
    v = torch.tensor(pts, dtype=torch.float32, device=dev)
    mask = torch.zeros((bsz, cap), dtype=torch.bool, device=dev)
    mask[:, :n_valid] = True
    v = torch.where(mask[..., None], v, 0.0)
    idx = torch.where(mask, torch.arange(cap, device=dev,
                                         dtype=torch.int32)[None], -1)
    x = torch.zeros((bsz, cap), dtype=torch.float32, device=dev)
    x[:, 0] = 1.0
    st = LIDState(idx.to(torch.int32), mask, v, x, torch.zeros_like(x),
                  torch.zeros(bsz, dtype=torch.int32, device=dev),
                  torch.zeros(bsz, dtype=torch.bool, device=dev))
    return refresh_ax(st, k_for(d), backend="ref")


def k_for(d: int) -> float:
    # cluster-scale NN distances of the blobs above are ~sqrt(2 d)
    return float(np.float32(np.log(1 / 0.95) / np.sqrt(2.0 * d) * 4))


def check_lsh_hash(dev, out, data):
    """On the full-width fit's own points, projections and seg_len."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lsh_hash import key_flips, lsh_hash_cuda
    from repro_torch.lsh.pstable import make_projections
    from repro_torch.random import PRNGKey, split
    points, lshp = data
    x = torch.as_tensor(points, device=dev)
    n, d = x.shape
    n_tables, n_proj, seg = lshp.n_tables, lshp.n_projections, lshp.seg_len
    proj, bias = make_projections(split(PRNGKey(0))[1], lshp, d, dev)
    got = lsh_hash_cuda(x, proj, bias, seg)
    want = ref.lsh_hash_ref(x, proj, bias, seg)
    torch.cuda.synchronize()
    n_flip, near = key_flips(x, proj, bias, seg, got, want)
    agree = 1.0 - n_flip / float(n * n_tables)
    print(f"[kernel] lsh_hash n={n} d={d} L={n_tables} m={n_proj}: "
          f"flips={n_flip} agree={agree:.7f} flips_near_integer={near}")
    need(agree >= 0.99999, "lsh_hash agrees on < 99.999% of pairs")
    need(near, "lsh_hash flipped a key whose z/seg_len is not within 1e-4 "
         "of an integer")
    # ragged tail + NaN rows: valid rows unchanged
    clean = torch.cat([x[:1000], torch.zeros((7, d), device=dev)])
    dirty = clean.clone()
    dirty[1000:] = float("nan")
    need(torch.equal(lsh_hash_cuda(clean, proj, bias, seg)[:1000],
                     lsh_hash_cuda(dirty, proj, bias, seg)[:1000]),
         "lsh_hash: NaN pad rows changed valid keys")
    t = timings(lambda: lsh_hash_cuda(x, proj, bias, seg),
                lambda: ref.lsh_hash_ref(x, proj, bias, seg))
    lm = n_tables * n_proj
    b_ms, b_by = bound(4 * (n * d + lm * d + lm + n * n_tables),
                       2 * n * lm * d)
    out["lsh_hash"] = dict(t, max_abs_err=n_flip / float(n * n_tables),
                           bound_ms=b_ms, bound_by=b_by)
    print(f"[kernel] lsh_hash {time_line(t)} bound_ms={b_ms:.4f} ({b_by}) "
          "library_ms=null (no single PyTorch call computes projection + "
          "floor + fold); max_abs_err is the fraction of flipped keys")


def check_roi_filter(dev, out):
    from repro_torch.kernels import ref
    from repro_torch.kernels.roi_filter import roi_filter_cuda
    bsz, per_seed, d = 32, 112 * 4 * 16, 128
    g = torch.Generator(device="cpu").manual_seed(2)
    vc = torch.randn((bsz, per_seed, d), generator=g).to(dev)
    center = torch.randn((bsz, d), generator=g).to(dev)
    radius = torch.full((bsz,), 0.98 * np.sqrt(2 * d), device=dev)
    valid = (torch.rand((bsz, per_seed), generator=g) < 0.7).to(dev)
    gd, gv, gn = roi_filter_cuda(vc, center, radius, valid)
    wd, wv, wn = ref.roi_filter_ref(vc, center, radius, valid)
    err = float((gd - wd).abs().max())
    # ok may differ only where dist sits within rounding of the radius
    edge = (wd - radius[:, None]).abs() <= 1e-5 * radius[:, None]
    need(err <= 1e-5 * float(wd.abs().max()), f"roi_filter dist err {err}")
    need(bool(((gv == wv) | edge).all()), "roi_filter ok mask differs")
    need(bool(((torch.isinf(gn) == torch.isinf(wn)) | edge).all()),
         "roi_filter -inf sentinels differ")
    # NaN/Inf poison in invalid rows + a ragged batch: valid rows unchanged
    small = vc[:3, :777].clone()
    sval = valid[:3, :777].clone()
    sval[:, 700:] = False
    dirty = small.clone()
    dirty[:, 700:740] = float("nan")
    dirty[:, 740:] = float("inf")
    a = roi_filter_cuda(small, center[:3], radius[:3], sval)
    b = roi_filter_cuda(dirty, center[:3], radius[:3], sval)
    need(all(torch.equal(p[:, :700], q[:, :700]) for p, q in zip(a, b)),
         "roi_filter: poisoned invalid rows changed valid outputs")
    need(bool((~b[1][:, 700:]).all()) and bool(
        (b[2][:, 700:] == float("-inf")).all()),
         "roi_filter: poisoned invalid rows must give ok=False, neg=-inf")
    t = timings(lambda: roi_filter_cuda(vc, center, radius, valid),
                lambda: ref.roi_filter_ref(vc, center, radius, valid))
    rows = bsz * per_seed
    b_ms, b_by = bound(4 * rows * d + 4 * bsz * (d + 1) + rows * (1 + 9),
                       3 * rows * d)
    out["roi_filter"] = dict(t, max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
    same = (torch.equal(gd, wd) and torch.equal(gv, wv)
            and torch.equal(gn, wn))
    print(f"[kernel] roi_filter B={bsz} C={per_seed} d={d}: "
          f"max_abs_err={err:.3e} max_rel_err="
          f"{float(((gd - wd).abs() / wd.clamp_min(1e-30)).max()):.3e} "
          f"bitwise_equal={same} {time_line(t)} bound_ms={b_ms:.4f} "
          f"({b_by}) library_ms=null (no single PyTorch call computes "
          "distance + radius mask + -inf scores)")


def check_affinity_matvec(dev, out):
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity_matvec import affinity_matvec_cuda
    bsz, cap, a_cap, d = 32, 240, 112, 128
    k = k_for(d)
    st = live_states(bsz, cap, d, dev, seed=3)
    g = torch.Generator(device="cpu").manual_seed(3)
    w = torch.rand((bsz, cap), generator=g).to(dev)
    timed = None
    for n_c in (cap, a_cap):
        c, ci, wc = st.v_beta[:, :n_c], st.beta_idx[:, :n_c], w[:, :n_c]
        got = affinity_matvec_cuda(st.v_beta, st.beta_idx, c, ci, wc, k)
        want = ref.affinity_matvec_ref(st.v_beta, st.beta_idx, c, ci, wc, k)
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        print(f"[kernel] affinity_matvec B={bsz} ({cap},{d}) x ({n_c},{d}): "
              f"max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"bitwise_equal={torch.equal(got, want)}")
        need(rel <= 1e-4, f"affinity_matvec rel err {rel}")
        if timed is None:
            timed = (err, c, ci, wc)
    # c-side pad rows with weight 0 and large finite garbage: unchanged
    c = st.v_beta.clone()
    wz = w.clone()
    wz[:, 200:] = 0.0
    base = affinity_matvec_cuda(st.v_beta, st.beta_idx, c, st.beta_idx, wz, k)
    c[:, 200:] = 1e6
    need(torch.equal(base, affinity_matvec_cuda(st.v_beta, st.beta_idx, c,
                                                st.beta_idx, wz, k)),
         "affinity_matvec: weight-0 pad rows changed the output")
    # equal products give the bit-equal tree sum
    a = ref.affinity_ref(st.v_beta[:2, :5], c[:2, :37], k)
    need(torch.equal(ref.tree_matvec(a, w[:2, :37]),
                     ref.tree_matvec(a.clone(), w[:2, :37].clone())),
         "tree_matvec is not deterministic")
    err, c, ci, wc = timed
    t = timings(lambda: affinity_matvec_cuda(st.v_beta, st.beta_idx, c, ci,
                                             wc, k),
                lambda: ref.affinity_matvec_ref(st.v_beta, st.beta_idx, c,
                                                ci, wc, k))
    b_ms, b_by = bound(4 * bsz * (2 * cap * d + 4 * cap),
                       bsz * (2 * cap * cap * d + 4 * cap * d
                              + 8 * cap * cap))
    out["affinity_matvec"] = dict(t, max_abs_err=err, bound_ms=b_ms,
                                  bound_by=b_by)
    print(f"[kernel] affinity_matvec {time_line(t)} bound_ms={b_ms:.4f} "
          f"({b_by}) library_ms=null (no single PyTorch call computes the "
          "masked affinity matvec)")


def _sweep_pair(st, k, **kw):
    from repro_torch.kernels import ref
    from repro_torch.kernels.lid_sweep import lid_sweep_cuda
    args = (st.v_beta, st.beta_idx, st.beta_mask, st.x, st.ax, st.n_iters,
            st.converged, k)
    got = lid_sweep_cuda(*args, **kw)
    want = ref.lid_sweep_ref(*args, kw["n_steps"], kw["max_iters"],
                             kw["tol"], 2.0, kw.get("refresh_every", 0))
    return got, want


def check_lid_sweep(dev, out):
    from repro_torch.kernels import ref
    from repro_torch.kernels.lid_sweep import lid_sweep_cuda, smem_plan
    bsz = 32
    timed = None
    cases = [(240, 128, 0, 8), (240, 256, 0, 8), (240, 256, 4, 8),
             (200, 128, 4, 16)]
    for cap, d, refresh, steps in cases:
        k = k_for(d)
        st = live_states(bsz, cap, d, dev, seed=cap + d)
        kw = dict(n_steps=steps, max_iters=256, tol=1e-5,
                  refresh_every=refresh)
        (gx, gax, git, gcv), (wx, wax, wit, wcv) = _sweep_pair(st, k, **kw)
        err = max(float((gx - wx).abs().max()), float((gax - wax).abs().max()))
        smem, nbytes = smem_plan(cap, d, refresh)
        same = all(torch.equal(a, b) for a, b in
                   zip((gx, gax, git, gcv), (wx, wax, wit, wcv)))
        print(f"[kernel] lid_sweep B={bsz} cap={cap} d={d} refresh_every="
              f"{refresh} n_steps={steps} rows_in_shared={smem} "
              f"dyn_smem={nbytes}B: max_abs_err(x,ax)={err:.3e} "
              f"bitwise_equal={same} iters={int(git.sum())} "
              f"(plain {int(wit.sum())})")
        need(bool(int(wit.min()) > 1), "lid_sweep: the states did not iterate")
        need(torch.equal(git, wit) and torch.equal(gcv, wcv),
             "lid_sweep: n_iters / converged differ from the plain version")
        need(err <= 1e-5, f"lid_sweep: x/ax error {err} > 1e-5")
        if timed is None:
            timed = (st, k, kw, err)
    need(not smem_plan(240, 256, 0)[0], "the d=256 case must exceed 227 KB")
    # masked-off rows poisoned with NaN/Inf (refresh off) or large finite
    # garbage (refresh on, where they are weight-0 terms): valid slots equal
    for refresh, finite in ((0, False), (4, True)):
        st = live_states(4, 96, 128, dev, seed=9, n_valid=70)
        dirty = st.v_beta.clone()
        if finite:
            dirty[:, 70:] = 1e6
        else:
            dirty[:, 70:80] = float("nan")
            dirty[:, 80:] = float("inf")
        args = (st.beta_idx, st.beta_mask, st.x, st.ax, st.n_iters,
                st.converged, k_for(128))
        kw = dict(n_steps=16, max_iters=64, tol=1e-5, refresh_every=refresh)
        a = lid_sweep_cuda(st.v_beta, *args, **kw)
        b = lid_sweep_cuda(dirty, *args, **kw)
        need(int(a[2].min()) >= 2, "lid_sweep poison case did not iterate")
        need(all(torch.equal(p, q) for p, q in zip(a, b)),
             f"lid_sweep: poisoned pad rows changed valid slots "
             f"(refresh_every={refresh})")
    st, k, kw, err = timed
    args = (st.v_beta, st.beta_idx, st.beta_mask, st.x, st.ax, st.n_iters,
            st.converged, k)
    got = lid_sweep_cuda(*args, **kw)
    t = timings(lambda: lid_sweep_cuda(*args, **kw),
                lambda: ref.lid_sweep_ref(*args, kw["n_steps"],
                                          kw["max_iters"], kw["tol"]),
                plain_in_graph=False)
    one = graph_ms(lambda: lid_sweep_cuda(*args, **dict(kw, n_steps=1)))
    print(f"[kernel] lid_sweep device time of a one-step call {one:.4f} ms, "
          f"of a {kw['n_steps']}-step call {t['ms']:.4f} ms: "
          f"~{(t['ms'] - one) / (kw['n_steps'] - 1):.4f} ms per further step")
    # the work this run's data needs: one pass over the rows, and per
    # executed step the pi/score lanes plus one affinity column
    cap, d = st.v_beta.shape[1:]
    steps = float((got[2] - st.n_iters).sum())
    b_ms, b_by = bound(4 * bsz * (cap * d + 4 * cap + 2 * cap) + 8 * bsz,
                       steps * (2 * cap * d + 16 * cap) + bsz * 2 * cap * d)
    out["lid_sweep"] = dict(t, max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
    print(f"[kernel] lid_sweep {time_line(t)} bound_ms={b_ms:.5f} ({b_by}) "
          f"steps={int(steps)} library_ms=null (no PyTorch call runs LID "
          "iterations)")


# ---------------------------------------------------------------- fits ----
def cli_blobs(n: int, d: int, clusters: int = 20):
    """`run_palid`'s synthetic data rule: 40% of the points in `clusters`
    blobs, the rest uniform noise, a_cap = max(64, cluster_size + 32)."""
    from repro_torch.data import auto_lsh_params, make_blobs_with_noise
    cluster_size = max(4, int(n * 0.4) // clusters)
    spec = make_blobs_with_noise(clusters, cluster_size,
                                 n - clusters * cluster_size, d=d, seed=0)
    return spec, auto_lsh_params(spec.points), max(64, cluster_size + 32)


def check_parity_fit(dev):
    from repro_torch.core.alid import ALIDConfig, EngineSpec
    from repro_torch.core.engine import fit
    from repro_torch.random import PRNGKey
    from repro_torch.utils import canonical_labels
    spec, lshp, a_cap = cli_blobs(PARITY_N, 128)
    max_rounds = 64
    res = {}
    for backend in ("auto", "ref"):
        cfg = ALIDConfig(a_cap=a_cap, delta=128, lsh=lshp,
                         seeds_per_round=32, max_rounds=max_rounds,
                         spec=EngineSpec(backend=backend))
        t0 = time.perf_counter()
        res[backend] = fit(spec.points, cfg, PRNGKey(0), device=dev)
        torch.cuda.synchronize()
        print(f"[parity] backend={backend} n={PARITY_N} d=128 a_cap={a_cap} "
              f"max_rounds={max_rounds} (not cut): "
              f"{time.perf_counter() - t0:.2f}s rounds="
              f"{res[backend].n_rounds} clusters={res[backend].n_clusters}")
    a, b = res["auto"], res["ref"]
    same = np.array_equal(canonical_labels(a.labels),
                          canonical_labels(b.labels))
    dens_err = (float(np.max(np.abs(np.sort(a.densities)
                                    - np.sort(b.densities))))
                if a.n_clusters == b.n_clusters and a.n_clusters else 0.0)
    print(f"[parity] labels_equal={same} rounds {a.n_rounds}/{b.n_rounds} "
          f"clusters {a.n_clusters}/{b.n_clusters} "
          f"max_density_diff={dens_err:.3e} (tolerance 1e-4)")
    need(a.n_clusters > 0, "the parity fit found no cluster")
    need(same, "kernel and plain fits gave different canonical labels")
    need(a.n_rounds == b.n_rounds, "kernel and plain fits differ in rounds")
    need(dens_err <= 1e-4, "kernel and plain densities differ > 1e-4")


def full_data():
    from repro_torch.launch import full_width
    t0 = time.perf_counter()
    spec, lshp = full_width.data()
    print(f"[fit] data n={spec.points.shape[0]} d={spec.points.shape[1]} "
          f"made in {time.perf_counter() - t0:.2f}s, {lshp}")
    return spec, lshp


def full_fit(dev, spec, lshp):
    from repro_torch.core.engine import fit
    from repro_torch.kernels import ops
    from repro_torch.launch import full_width
    from repro_torch.random import PRNGKey
    from repro_torch.utils import avg_f1_score
    n = spec.points.shape[0]
    cfg = full_width.config(lshp)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(spec.points, cfg, PRNGKey(0), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    members = int((res.labels >= 0).sum())
    print(f"[fit] SIFT1M shape {n}x128, a_cap={cfg.a_cap} "
          f"delta={cfg.delta} seeds_per_round={cfg.seeds_per_round} "
          f"max_rounds={cfg.max_rounds} (not cut): "
          f"wall={wall:.2f}s k={res.k:.6g} rounds={res.n_rounds} "
          f"clusters={res.n_clusters} members={members} "
          f"AVG-F={avg_f1_score(spec.labels, res.labels):.4f} (reported, "
          "not gated) max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()} launches={counts}")
    need(res.n_clusters > 0, "the full-width fit found no cluster")
    need(np.isfinite(res.densities).all()
         and res.labels.shape == (n,), "full-width fit output")
    for name in FIT_KERNELS:
        need(counts[name] > 0, f"kernel {name} was never launched by the fit")
    return res, counts


# ------------------------------------------------------------- serving ----
def serving_mix(points, n: int, seed: int = 3) -> np.ndarray:
    """benchmarks/serving_latency.py's query mix on this data: dataset rows,
    rows jittered by N(0, 0.05), and far noise (uniform in [-60, 60] + 300),
    in the proportions 7 : 7 : 2, shuffled."""
    rng = np.random.default_rng(seed)
    n_far = n // 8
    n_rows = (n - n_far) // 2
    base = points[rng.integers(0, len(points), size=n - n_far)]
    jitter = rng.normal(scale=0.05, size=base.shape)
    jitter[:n_rows] = 0.0
    far = rng.uniform(-60, 60, size=(n_far, points.shape[1])) + 300.0
    queries = np.concatenate([base + jitter, far]).astype(np.float32)
    rng.shuffle(queries)
    return queries


def composition(q, sup_v, sup_w, dens, k: float, t: float):
    """The assignment as PyTorch library calls (cuBLAS matmul expansion,
    exp, segment sum, argmax, threshold): timed as a yardstick, never
    called by the port."""
    n_c, a_cap, d = sup_v.shape
    s = sup_v.reshape(n_c * a_cap, d)
    d2 = ((q * q).sum(-1)[:, None] + (s * s).sum(-1)[None]
          - 2.0 * torch.matmul(q, s.T))
    aff = torch.exp(-k * torch.sqrt(d2.clamp_min(0.0)))
    score = (aff.view(-1, n_c, a_cap) * sup_w).sum(-1)
    best = score.argmax(-1)
    bscore = score.gather(1, best[:, None])[:, 0]
    return torch.where(bscore >= t * dens[best], best, -1), bscore


def check_assign(dev, out, res, mix):
    """The assign kernel against its plain version at full width."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.assign import assign_cuda, smem_plan
    sup_v, sup_w, dens = (torch.as_tensor(x, device=dev) for x in
                          (res.support_v, res.support_w, res.densities))
    n_c, a_cap, d = sup_v.shape
    k, thr = res.k, 0.5
    q = torch.as_tensor(mix[:256], device=dev)
    got = assign_cuda(q, sup_v, sup_w, dens, k, thr)
    want = ref.assign_ref(q, sup_v, sup_w, dens, k, thr)
    torch.cuda.synchronize()
    err = float((got[1] - want[1]).abs().max())
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    labelled = int((got[0] >= 0).sum())
    print(f"[serve] assign m=256 C={n_c} A={a_cap} d={d} k={k:.6g} "
          f"threshold={thr} smem_plan={smem_plan(d)}: labelled={labelled} "
          f"max_abs_err={err:.3e} bitwise_equal={same}")
    need(same, "assign: labels or scores differ from the plain version")
    need(labelled > 0, "assign: no query of the mix was labelled")
    # a NaN-poisoned, masked 64-slot batch: pads -1 / 0.0, real rows equal
    valid = torch.arange(64, device=dev) < 40
    dirty = q[:64].clone()
    dirty[40:] = float("nan")
    g = assign_cuda(dirty, sup_v, sup_w, dens, k, thr, valid)
    w = ref.assign_ref(dirty, sup_v, sup_w, dens, k, thr, valid)
    need(torch.equal(g[0], w[0]) and torch.equal(g[1], w[1]),
         "assign: masked batch differs from the plain version")
    need(bool((g[0][40:] == -1).all()) and bool((g[1][40:] == 0.0).all()),
         "assign: masked pad slots must come out -1 and 0.0")
    need(torch.equal(g[0][:40], got[0][:40])
         and torch.equal(g[1][:40], got[1][:40]),
         "assign: poisoned pad rows changed the real rows")
    print("[serve] assign masked 64-slot batch, NaN pads: bitwise_equal=True")
    q64 = q[:64]
    t = timings(lambda: assign_cuda(q64, sup_v, sup_w, dens, k, thr),
                lambda: ref.assign_ref(q64, sup_v, sup_w, dens, k, thr),
                plain_runs=3)
    lib = composition(q64, sup_v, sup_w, dens, k, thr)
    agree = float((lib[0] == got[0][:64]).float().mean())
    lib_ms = graph_ms(lambda: composition(q64, sup_v, sup_w, dens, k, thr))
    m = 64
    b_ms, b_by = bound(4 * (m * d + n_c * a_cap * (d + 1) + n_c) + 8 * m,
                       2 * m * n_c * a_cap * d + 2 * n_c * a_cap * d
                       + 2 * m * d + 9 * m * n_c * a_cap + 2 * m * n_c)
    out["assign"] = dict(t, max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
    print(f"[serve] assign one 64-slot batch: {time_line(t)} "
          f"bound_ms={b_ms:.4f} ({b_by}) library_ms=null (no one PyTorch "
          "call computes distance + exp + segment sum + argmax + "
          f"threshold); cuBLAS composition {lib_ms:.4f} ms (device time, "
          f"CUDA graph; yardstick, labels agree on {agree:.4f} of the rows)")
    return sup_v, sup_w, dens


def check_serving(dev, res, points, mix, sup):
    """The serving path from launch counts at 0: bulk predict, the
    ClusterService, and run_palid's open-loop ClusterServer bench."""
    from repro_torch.core.alid import assign_labels
    from repro_torch.kernels import ops
    from repro_torch.launch import run_palid
    from repro_torch.serve import ClusterService
    queries = run_palid.serve_queries(points)
    # the reference: each query assigned alone, through predict's own path
    # (assign_labels) on the resident supports
    t0 = time.perf_counter()
    alone = np.asarray([assign_labels(v[None], *sup, res.k, 0.5,
                                      device=dev)[0] for v in queries],
                       np.int32)
    print(f"[serve] per-query assignment of {len(queries)} queries: "
          f"{time.perf_counter() - t0:.2f}s, labelled="
          f"{int((alone >= 0).sum())}")
    ops.reset_launch_counts()

    bulk_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bulk = res.predict(mix, device=dev)
        bulk_s.append(time.perf_counter() - t0)
    print(f"[serve] bulk predict of {len(mix)} rows (supports uploaded per "
          f"call, host clock): {' '.join(f'{x * 1e3:.2f}' for x in bulk_s)} "
          f"ms, labelled={int((bulk >= 0).sum())}")
    need(bulk.shape == (len(mix),) and bulk.dtype == np.int32,
         "bulk predict output")

    svc = ClusterService(res, batch_slots=64, device=dev)
    t0 = time.perf_counter()
    rids = [svc.submit(v) for v in queries]
    served = svc.serve()
    svc_s = time.perf_counter() - t0
    svc_labels = np.asarray([served[r] for r in rids], np.int32)
    print(f"[serve] ClusterService(batch_slots=64) over {len(queries)} "
          f"queries: {svc_s * 1e3:.2f} ms, equal to per-query "
          f"assignment: {np.array_equal(svc_labels, alone)}")
    need(np.array_equal(svc_labels, alone),
         "ClusterService labels differ from per-query assignment")

    out = run_palid._serve_bench(res, points, SERVE_RATE, device=dev)
    need(out is not None, "serve bench skipped")
    same = np.array_equal(out["labels"], svc_labels)
    st = out["stats"]
    print(f"[serve] ClusterServer open loop at {SERVE_RATE:.0f} req/s: "
          f"p50={out['latency_ms_p50']:.4f} ms p99="
          f"{out['latency_ms_p99']:.4f} ms max={out['latency_ms_max']:.4f} "
          f"ms throughput={out['throughput_rps']:.1f} req/s occupancy="
          f"{out['occupancy']:.4f} batches={st['batches']} compute_s="
          f"{st['compute_s']:.4f} pack_s={st['pack_s']:.4f} queue_wait_s="
          f"{st['queue_wait_s']:.4f}; labels equal to the service's: {same}")
    need(same, "ClusterServer labels differ from ClusterService labels")
    counts = ops.launch_counts()
    print(f"[serve] launches of the serving path: {counts}")
    need(counts["assign"] > 0, "the serving path never launched assign")
    return counts


# -------------------------------------------------------- full matrix ----
def full_matrix_args() -> list[str]:
    """launch/full_matrix.py's arguments for the full-matrix configuration:
    200 blobs of 80 and 24,000 noise points in d = 128 (n = 40,000)."""
    return [f"--{key.replace('_', '-')}={val}"
            for key, val in FULL_MATRIX.items()]


FULL_MATRIX = dict(n_clusters=200, cluster_size=80, n_noise=24_000, d=128,
                   seed=0)
# phase 6c's peels: the same data rule at n = 4,000
PEEL_DATA = dict(n_clusters=20, cluster_size=80, n_noise=2_400, d=128,
                 seed=0)
SLAB = 256        # rows of the full-width block checked against the plain
BIG = (65_537, 32_800, 16)   # a block of more than 2**31 entries


def affinity_library(v, k: float):
    """The affinity as PyTorch library calls (cuBLAS q c^T, then the norms,
    clamp, sqrt and exp in place; TF32 off): timed as a yardstick, never
    called by the port."""
    q2 = (v * v).sum(-1)
    g = torch.mm(v, v.T)
    g.mul_(-2.0).add_(q2[:, None]).add_(q2[None, :]).clamp_min_(0.0)
    return g.sqrt_().mul_(-k).exp_()


def nan_equal(a, b) -> bool:
    """Bit-equal where both are numbers, NaN at the same places."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def check_affinity(dev, out):
    """6a: the affinity kernel against its plain version, bitwise."""
    from repro_torch.core.affinity import estimate_k
    from repro_torch.data import make_blobs_with_noise
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity import affinity_cuda, smem_plan
    spec = make_blobs_with_noise(**FULL_MATRIX)
    v = torch.as_tensor(spec.points, device=dev)
    n, d = v.shape
    k = estimate_k(v)
    a = affinity_cuda(v, v, k)
    torch.cuda.synchronize()
    err = 0.0
    for lo in (0, n - SLAB):
        want = ref.affinity_ref(v[lo:lo + SLAB], v, k)
        err = max(err, float((a[lo:lo + SLAB] - want).abs().max()))
        need(torch.equal(a[lo:lo + SLAB], want),
             f"affinity: rows [{lo}, {lo + SLAB}) of the {n} x {n} block "
             "differ from the plain version")
    sym = torch.equal(a, a.T)
    print(f"[affinity] {n}x{n}x{d} k={k:.6g} smem_plan={smem_plan(d)}: rows "
          f"[0, {SLAB}) and [{n - SLAB}, {n}) bitwise_equal=True, "
          f"symmetric={sym}")
    need(sym, "affinity: the full-width block is not bitwise symmetric")
    cases = []
    for cap, dd in ((240, 128), (560, 256)):         # a LID column
        st = live_states(1, cap, dd, dev, seed=cap)
        cases.append((f"LID column ({cap}, 1, {dd})", st.v_beta[0],
                      st.v_beta[0, 7:8], k_for(dd)))
    g = torch.Generator(device="cpu").manual_seed(6)
    for m_, n_, d_ in ((1, 300, 7), (130, 257, 100)):
        cases.append((f"ragged ({m_}, {n_}, {d_})",
                      torch.randn((m_, d_), generator=g).to(dev),
                      torch.randn((n_, d_), generator=g).to(dev), 0.37))
    for name, q, c, kk in cases:
        same = torch.equal(affinity_cuda(q, c, kk), ref.affinity_ref(q, c, kk))
        print(f"[affinity] {name}: bitwise_equal={same}")
        need(same, f"affinity: {name} differs from the plain version")
    q = torch.randn((70, 40), generator=g).to(dev)
    c = torch.randn((90, 40), generator=g).to(dev)
    q[3, 7] = float("nan")
    c[11] = float("nan")
    got, want = affinity_cuda(q, c, 0.5), ref.affinity_ref(q, c, 0.5)
    need(nan_equal(got, want) and bool(torch.isnan(got[3]).all()),
         "affinity: NaN rows come out other than in the plain version")
    print("[affinity] NaN-poisoned rows: NaN where the plain version puts "
          "it, other entries bitwise_equal=True")
    m_, n_, d_ = BIG
    qb = torch.randn((m_, d_), generator=g).to(dev)
    cb = torch.randn((n_, d_), generator=g).to(dev)
    big = affinity_cuda(qb, cb, 0.37)
    tail = torch.equal(big[-64:], ref.affinity_ref(qb[-64:], cb, 0.37))
    head = torch.equal(big[:64], ref.affinity_ref(qb[:64], cb, 0.37))
    print(f"[affinity] {m_}x{n_}x{d_} = {big.numel()} entries (2**31 = "
          f"{2 ** 31}): last 64 rows bitwise_equal={tail}, first 64 rows "
          f"bitwise_equal={head}")
    need(big.numel() > 2 ** 31 and tail and head,
         "affinity: the block past 2**31 entries differs")
    del big, qb, cb, a
    torch.cuda.empty_cache()
    t = dict(ms=graph_ms(lambda: affinity_cuda(v, v, k), runs=3, replays=3),
             call_ms=call_ms(lambda: affinity_cuda(v, v, k), runs=5),
             plain_ms=graph_ms(lambda: ref.affinity_ref(v, v, k), runs=1,
                               replays=1),
             plain_in_graph=True)
    lib_ms = graph_ms(lambda: affinity_library(v, k), runs=3, replays=3)
    lib = affinity_library(v, k)
    lib_err = float((lib[:SLAB] - affinity_cuda(v[:SLAB], v, k)).abs().max())
    del lib
    torch.cuda.empty_cache()
    # each input read once and the result written once; the dots, the
    # norms, and per entry add, double, subtract, scale, sqrt and exp
    b_ms, b_by = bound(4 * (2 * n * d + n * n),
                       2 * n * n * d + 4 * n * d + 6 * n * n)
    out["affinity"] = dict(t, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms)
    print(f"[affinity] {n}x{n}x{d}: {time_line(t)} bound_ms={b_ms:.4f} "
          f"({b_by}) library_ms={lib_ms:.4f} (cuBLAS q c^T + norms, clamp, "
          f"sqrt, exp; device time, CUDA graph; a yardstick the port never "
          f"calls; max_abs_err against the kernel {lib_err:.3e})")
    return k


def check_lid_unfused(dev):
    """6b: lid_solve_unfused (affinity kernel) == lid_solve (lid_sweep)."""
    from repro_torch.core.lid import lid_solve, lid_solve_unfused
    from repro_torch.kernels import ops
    for bsz, cap, d in ((32, 240, 128), (32, 240, 256), (8, 560, 256)):
        st = live_states(bsz, cap, d, dev, seed=cap + d)
        k = k_for(d)
        ops.reset_launch_counts()
        fused = lid_solve(st, k, max_iters=200)
        t0 = time.perf_counter()
        unfused = lid_solve_unfused(st, k, max_iters=200)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        same = all(torch.equal(getattr(fused, f), getattr(unfused, f))
                   for f in ("x", "ax", "n_iters", "converged"))
        print(f"[lid] unfused vs fused B={bsz} cap={cap} d={d}: "
              f"bitwise_equal={same} iters={int(unfused.n_iters.sum())} "
              f"(max {int(unfused.n_iters.max())}) unfused_s={dt:.3f} "
              f"launches lid_sweep={counts['lid_sweep']} "
              f"affinity={counts['affinity']}")
        need(int(unfused.n_iters.max()) > 2, "lid: the states did not iterate")
        need(counts["affinity"] > 0 and counts["lid_sweep"] > 0,
             "lid: a loop did not go through its kernel")
        need(same, "lid_solve_unfused differs from lid_solve")


def check_peel_parity(dev):
    """6c: IID and DS peels on the kernel's and the plain version's matrix
    at n = 4,000."""
    from repro_torch.core.affinity import affinity_matrix, estimate_k
    from repro_torch.core.iid import iid_solve, uniform_on
    from repro_torch.core.peeling import ds_detect, iid_detect
    from repro_torch.data import make_blobs_with_noise
    from repro_torch.utils import avg_f1_score
    spec = make_blobs_with_noise(**PEEL_DATA)
    v = torch.as_tensor(spec.points, device=dev)
    k = estimate_k(v)
    mats = {b: affinity_matrix(v, k, backend=b) for b in ("kernel", "ref")}
    sym = {b: torch.equal(a, a.T) for b, a in mats.items()}
    same = torch.equal(mats["kernel"], mats["ref"])
    print(f"[peel] n={v.shape[0]} d={v.shape[1]} k={k:.6g}: matrices "
          f"bitwise_equal={same} symmetric={sym}")
    need(same and all(sym.values()), "peel: the kernel's and the plain "
         "matrices differ or are not symmetric")
    # one IID solve from the barycenter, eager and from CUDA graphs
    x0 = uniform_on(torch.ones(v.shape[0], dtype=torch.bool, device=dev))
    loops = {}
    for graphs in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = iid_solve(mats["kernel"], x0, max_iters=3000, graphs=graphs)
        torch.cuda.synchronize()
        loops[graphs] = (r, (time.perf_counter() - t0) / int(r.n_iters))
    eq = all(torch.equal(getattr(loops[False][0], f),
                         getattr(loops[True][0], f)) for f in r._fields)
    print(f"[peel] iid_solve {int(r.n_iters)} iterations: "
          f"{loops[False][1] * 1e6:.1f} us each eager, "
          f"{loops[True][1] * 1e6:.1f} us from CUDA graphs of 64 (host "
          f"clock, capture included); bitwise_equal={eq}")
    need(eq, "iid_solve: the graph replays differ from the eager loop")
    for name, detect in (("iid", iid_detect), ("ds", ds_detect)):
        res = {}
        for b, a in mats.items():
            t0 = time.perf_counter()
            res[b] = detect(a)
            res[b + "_s"] = time.perf_counter() - t0
        g, w = res["kernel"], res["ref"]
        eq = (np.array_equal(g.labels, w.labels)
              and np.array_equal(g.densities, w.densities)
              and g.n_rounds == w.n_rounds)
        print(f"[peel] {name}_detect kernel matrix vs plain matrix: "
              f"equal={eq} rounds={g.n_rounds} clusters={len(g.densities)} "
              f"AVG-F={avg_f1_score(spec.labels, g.labels):.4f} "
              f"seconds {res['kernel_s']:.2f} / {res['ref_s']:.2f}")
        need(eq, f"peel: {name}_detect differs between the matrices")


def full_matrix_run(dev):
    """6d: the full-width IID run from launch counts at 0."""
    from repro_torch.kernels import ops
    from repro_torch.launch import full_matrix
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = full_matrix.main(["--solver", "iid", f"--device={dev}",
                            *full_matrix_args()])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"[full-matrix] n={res['n']} d={res['d']} (not cut): wall="
          f"{wall:.2f}s affinity_matrix_s={res['matrix_s']:.4f} "
          f"iid_peel_s={res['peel_s']:.2f} rounds={res['rounds']} "
          f"clusters={res['clusters']} AVG-F={res['avg_f']:.4f} (reported, "
          f"not gated) max_memory_allocated={res['peak_bytes']} "
          f"launches={counts}")
    peel = res["result"]
    need(peel.labels.shape == (res["n"],) and res["rounds"] > 0
         and np.isfinite(peel.densities).all(), "full-matrix output")
    need(counts["affinity"] > 0, "the full-matrix path never launched "
         "the affinity kernel")
    return counts


def check_baselines(dev):
    """6e: every baseline on the card, on tests/test_baselines.py's easy
    data, above that file's AVG-F floor."""
    from repro_torch.core import baselines as tb
    from repro_torch.core.affinity import affinity_matrix, estimate_k
    from repro_torch.core.peeling import ds_detect, iid_detect
    from repro_torch.data import make_blobs_with_noise
    from repro_torch.utils import avg_f1_score
    spec = make_blobs_with_noise(n_clusters=4, cluster_size=25, n_noise=60,
                                 d=8, seed=7, overlap_pairs=0)
    pts = spec.points
    k = estimate_k(torch.as_tensor(pts, device=dev))
    a = affinity_matrix(torch.as_tensor(pts, device=dev), k)
    runs = [("iid_detect", 0.75, lambda: iid_detect(a).labels),
            ("ds_detect", 0.7, lambda: ds_detect(a).labels),
            ("sea_detect", 0.4, lambda: tb.sea_detect(pts, k,
                                                      device=dev).labels),
            ("affinity_propagation", 0.5,
             lambda: tb.affinity_propagation(pts, device=dev)[0]),
            ("kmeans", 0.5, lambda: tb.kmeans(pts, 5, device=dev)[0]),
            ("spectral_clustering", 0.5,
             lambda: tb.spectral_clustering(pts, 5, k, device=dev)),
            ("mean_shift", 0.5,
             lambda: tb.mean_shift(pts, bandwidth=12.0, device=dev)[0])]
    for name, floor, run in runs:
        t0 = time.perf_counter()
        score = avg_f1_score(spec.labels, run())
        print(f"[baseline] {name}: AVG-F={score:.4f} (floor {floor}) "
              f"{time.perf_counter() - t0:.2f}s")
        need(score > floor, f"{name}: AVG-F {score} <= {floor}")


def main() -> int:
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    smi = nvidia_smi()
    print(f"[env] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    _build.library()
    print(f"[env] kernel build and load {time.perf_counter() - t0:.2f}s")
    for line in (_build.BUILD_DIR / "ptxas.txt").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")

    spec, lshp = full_data()
    stats: dict = {}
    check_lsh_hash(dev, stats, (spec.points, lshp))
    check_roi_filter(dev, stats)
    check_affinity_matvec(dev, stats)
    check_lid_sweep(dev, stats)
    check_parity_fit(dev)
    res, counts = full_fit(dev, spec, lshp)
    mix = serving_mix(spec.points, BULK_ROWS)
    sup = check_assign(dev, stats, res, mix)
    counts["assign"] = check_serving(dev, res, spec.points, mix,
                                     sup)["assign"]
    del res, sup, mix, spec
    torch.cuda.empty_cache()

    check_affinity(dev, stats)
    check_lid_unfused(dev)
    check_peel_parity(dev)
    counts["affinity"] = full_matrix_run(dev)["affinity"]
    check_baselines(dev)

    table = []
    for name, s in stats.items():
        table.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s.get("library_ms")})
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
