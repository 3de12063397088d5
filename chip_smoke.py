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
   `easy` data, each above its AVG-F floor, and SEA run twice with the
   same bits;
7. LM serving (h2o-danube-1.8b at full width, bf16, random weights from
   the port's threefry): (a) the flash_attention kernel against its plain
   version on numpy-seeded inputs at the serving path's shapes (prefill:
   4 rows x 32 heads x 5,120 queries over 5,137 cache slots, dh 80,
   window 4,096, one long row and three left-padded short ones; decode:
   one query at slot 5,120), in bf16 and f32, `launch.serve`'s own
   batches at their shapes (prefill and every decode step, q the model's
   transposed view), then gemma2's dh 128 with softcap 50 (local and
   full), a chunked mask and ragged shapes, by the rule of
   `kernels.flash_attention.compare_with_plain` (fully masked rows
   exactly 0), two calls bitwise equal, each case's `kernel_plan` (the
   decode's split count) printed, with the kernel's device and per-call
   time, the plain version's, the bound, and the time of
   `scaled_dot_product_attention` with the same mask as a yardstick the
   port never calls, and the prefill's tile kernel with the batch on
   grid.z against it folded into grid.x, timed in turns; (b) from
   launch counts at 0, `launch.serve`'s own request mix on BatchServer,
   then one batch packing a 5,120-token prompt with three short ones,
   with tokens/s, prefill seconds, decode ms per step and peak memory,
   and `flash_attention` launches > 0; (c) for the packed batch and each
   of the mix's batches, the generated tokens fed back through the model
   with the kernel and with the plain attention: the kernel's argmax is
   the served tokens, the logits differ by at most (layers + 1) bf16
   ulps at their scale, at least 16 steps have a plain top-2 gap over
   twice the step's largest difference, and on those the argmaxes agree;
8. BST serving and the segment sums: (a) the embedding_bag kernel
   bit-equal to its plain version (f32 and bf16) at BST's three bag
   shapes as the model builds them from `bst_batch` ids (serve_p99 1,024
   bags, serve_bulk 524,288, retrieval_cand 2,000,000 of one user), plus
   interspersed pads, empty bags, mean mode, the serve_bulk entries in a
   random order (the unsorted placement, timed too) and ids at and past
   the table's end (read as its last row); the segment_matmul kernel
   bit-equal to its plain version at ogb_products' shape (61,859,328 x
   100 messages into 2,449,029 nodes, skewed in-degrees, the registry's
   188 trailing pad edges; leading pads; unvisited row blocks exactly 0;
   f32 and bf16), through `ops.segment_matmul` from launch counts at 0;
   each timed beside F.embedding_bag / index_add_ as yardsticks the port
   never calls; (b) the flash_attention kernel at BST's shape (B = 512,
   262,144 and 1,000,000; H = Hkv = 8, Sq = Sk = 21, dh = 4, f32, not
   causal, q, k and v the model's views; the small kernel) against its
   plain version on slabs of rows; (c) BST's CONFIG at full width
   (random weights from the port's threefry, 574 MB), from launch counts
   at 0: make_bst_serve_step at 512 and 262,144 rows and
   make_bst_retrieval_step at 1,000,000 candidates,
   with step seconds, peak memory and one profiled step each (the
   device's idle share, time by kernel), embedding_bag and
   flash_attention launches > 0, and each batch's logits within 1e-4 +
   1e-4 |ref| of backend="ref";

then prints the kernel table as one JSON line, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Without a CUDA
device, or without the repository's `src/` beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# published peaks of one H100 SXM (dense, 700 W): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores, bf16 FLOP/s in them
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TIMED_RUNS = 25
# the size of the parity fits (the full-width fit's configuration is
# repro_torch.launch.full_width)
PARITY_N = 20_000
DEVICE = "cuda:0"

# the JAX package's Pallas kernels the nine CUDA kernels replace
REPLACES = {
    "lsh_hash": "src/repro/kernels/lsh_hash.py:41",
    "roi_filter": "src/repro/kernels/roi_filter.py:46",
    "affinity_matvec": "src/repro/kernels/affinity_matvec.py:50",
    "lid_sweep": "src/repro/kernels/lid_sweep.py:149",
    "assign": "src/repro/kernels/assign.py:52",
    "affinity": "src/repro/kernels/affinity.py:34",
    "flash_attention": "src/repro/kernels/flash_attention.py:102",
    "embedding_bag": "src/repro/kernels/embedding_bag.py:56",
    "segment_matmul": "src/repro/kernels/segment_matmul.py:72",
}
# the kernels of the fit (phase 4); serving and the full-matrix path run
# the others
FIT_KERNELS = ("lsh_hash", "roi_filter", "affinity_matvec", "lid_sweep")
# the CUDA kernels behind flash_attention and embedding_bag, by name in a
# profile
FLASH_KERNELS = ("flash_kernel", "flash_split_kernel", "flash_combine_kernel",
                 "flash_small_kernel")
BAG_KERNELS = ("bag_pass_kernel", "bag_sum_kernel")
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


def bound(n_bytes: float, n_ops: float,
          flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    """The least time the card could take (ms) and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flop_per_s * 1e3
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
    # SEA's transpose product adds in input order (ops.segment_matmul):
    # two runs give the same bits
    a, b = (tb.sea_detect(pts, k, device=dev) for _ in range(2))
    same = np.array_equal(a.labels, b.labels) and \
        np.array_equal(a.densities, b.densities)
    print(f"[baseline] sea_detect twice: labels and densities bitwise "
          f"equal {same} (densities {a.densities.tolist()})")
    need(same, "sea_detect: two runs on the card differ")


# ---------------------------------------------------------- LM serving ----
LM_ARCH = "h2o-danube-1.8b"
LONG_PROMPT = 5120       # a multiple of the plain version's q blocks
SHORT_PROMPTS = (7, 9, 11)
MAX_NEW = 16
MIX_REQUESTS, MIX_SLOTS = 6, 4           # launch.serve's defaults
# 7c: per batch, the steps whose plain top-2 gap must clear twice the
# step's kernel-plain difference, so that the argmax comparison is not
# vacuous
MIN_CLEAR_STEPS = 16


def mix_batches(vocab: int):
    """launch.serve's requests as BatchServer packs them: per batch, the
    left-padded tokens (slots, maxp) and the lengths (slots,)."""
    from repro_torch.launch.serve import mix_prompts
    from repro_torch.serve.engine import pack_prompts
    prompts = mix_prompts(vocab, MIX_REQUESTS)
    return [pack_prompts(prompts[i:i + MIX_SLOTS], MIX_SLOTS)
            for i in range(0, len(prompts), MIX_SLOTS)]


def flash_shapes():
    """7a's cases: (name, B, H, Hkv, Sq, Sk, dh, q_offsets, kv_start, mask
    keywords, dtype, q as the model's transposed view). The first two are
    the packed batch's (prefill, then a decode step at slot 5,120); the
    mix cases are launch.serve's batches at their own shapes, with the
    model's keywords: prefill and every decode step."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import _attn_kwargs
    sk = LONG_PROMPT + MAX_NEW + 1
    ks = [0] + [LONG_PROMPT - n for n in SHORT_PROMPTS]
    local = dict(window=4096)
    out = []
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        out += [(f"prefill {tag}", 4, 32, 8, LONG_PROMPT, sk, 80, [0], ks,
                 local, dt, False),
                (f"decode {tag}", 4, 32, 8, 1, sk, 80, [LONG_PROMPT], ks,
                 local, dt, False)]
    cfg = get_arch(LM_ARCH).CONFIG
    kw = _attn_kwargs(cfg, cfg.pattern[0])
    for i, (toks, lens) in enumerate(mix_batches(cfg.vocab)):
        maxp = toks.shape[1]
        mk = (maxp - lens).tolist()
        shape = (MIX_SLOTS, cfg.n_heads, cfg.n_kv_heads)
        out += [(f"mix batch {i} prefill", *shape, maxp, maxp + MAX_NEW + 1,
                 cfg.head_dim, [0], mk, kw, cfg.dtype, True),
                (f"mix batch {i} decode", *shape, 1, maxp + MAX_NEW + 1,
                 cfg.head_dim, list(range(maxp, maxp + MAX_NEW - 1)), mk, kw,
                 cfg.dtype, True)]
    gemma_ks = [0, 1500]
    out += [("gemma2 local dh128 softcap", 2, 32, 16, 2048, 2065, 128, [0],
             gemma_ks, dict(window=1024, softcap=50.0), torch.bfloat16,
             False),
            ("gemma2 full dh128 softcap", 2, 32, 16, 2048, 2065, 128, [0],
             gemma_ks, dict(softcap=50.0), torch.bfloat16, False),
            ("chunked", 2, 8, 2, 2048, 2065, 128, [0], [0, 300],
             dict(chunk=512), torch.bfloat16, False),
            ("ragged", 3, 12, 4, 777, 1301, 80, [524], [0, 40, 1000],
             dict(window=300), torch.float32, False)]
    return out


def flash_inputs(dev, b, h, hkv, sq, sk, dh, dtype, seed, q_view=False):
    """q, k, v; with `q_view` q is the (B, S, H, dh) projection's transposed
    view, as the model passes it."""
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dtype)
    q = t((b, sq, h, dh)).transpose(1, 2) if q_view else t((b, h, sq, dh))
    return q, t((b, hkv, sk, dh)), t((b, hkv, sk, dh))


def sdpa(q, k, v, mask):
    """torch's fused attention with the same boolean mask: a yardstick the
    port never calls."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[:, None], enable_gqa=True)


def check_flash_attention(dev, out):
    """7a: the attention kernel against its plain version, by the stated
    rule, at the serving path's shapes and the other masks."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import compare_with_plain, \
        flash_attention_cuda, kernel_plan, smem_plan
    timed = {}
    for seed, (name, b, h, hkv, sq, sk, dh, offs, ks, kw, dt, q_view) in \
            enumerate(flash_shapes()):
        mask_kw = {x: kw[x] for x in ("causal", "window", "chunk")
                   if kw.get(x) is not None}
        plans = sorted({kernel_plan(b, h, hkv, sq, sk, dh, off, **mask_kw)
                        for off in offs}, key=str)
        plan = "; ".join(
            (f"{p.kernel} {smem_plan(dh, h // hkv, sq)[:3]}"
             if p.kernel == "tiles" else f"{p.kernel} n_split={p.n_split} "
             f"from slot {p.split_lo}, {p.split_len} slots a chunk"
             if p.kernel == "split" else p.kernel) for p in plans)
        q, k, v = flash_inputs(dev, b, h, hkv, sq, sk, dh, dt, seed, q_view)
        kv_start = torch.tensor(ks, dtype=torch.int32, device=dev)
        bad = masked_nonzero = compared = 0
        err = 0.0
        for off in offs:
            got = flash_attention_cuda(q, k, v, off, kv_start=kv_start, **kw)
            want = ref.attention_ref(q, k, v, q_offset=off,
                                     kv_start=kv_start, **kw)
            torch.cuda.synchronize()
            mask = ref.attention_mask(sq, sk, off, kv_start, device=dev,
                                      **mask_kw)
            rows = mask.any(-1)
            res = compare_with_plain(got, want, rows)
            bad += res["bad"]
            masked_nonzero += res["masked_nonzero"]
            compared += int(rows.sum())
            err = max(err, res["max_abs_err"])
            again = flash_attention_cuda(q, k, v, off, kv_start=kv_start,
                                         **kw)
            need(torch.equal(got, again), f"flash_attention {name}: two "
                 "calls differ")
        at = (f"q_offset={offs[0]}" if len(offs) == 1 else
              f"q_offset {offs[0]}..{offs[-1]} ({len(offs)} steps)")
        print(f"[flash] {name}: B={b} H={h} Hkv={hkv} Sq={sq} Sk={sk} "
              f"dh={dh} {at} kv_start={ks} {kw}{' q a view' * q_view} "
              f"plan: {plan}; two calls bitwise equal; compared rows "
              f"{compared} of {b * sq * len(offs)}, outside the rule {bad}, "
              f"max_abs_err={err:.3e}, nonzero on rows attending nothing "
              f"{masked_nonzero}")
        need(bad == 0, f"flash_attention {name}: {bad} entries differ from "
             "the plain version beyond the rule")
        need(masked_nonzero == 0, f"flash_attention {name}: rows that "
             "attend nothing are not 0")
        if name in ("prefill bf16", "decode bf16"):
            off = offs[0]

            def kernel():
                return flash_attention_cuda(q, k, v, off, kv_start=kv_start,
                                            **kw)

            def plain():
                return ref.attention_ref(q, k, v, q_offset=off,
                                         kv_start=kv_start, **kw)
            lib = sdpa(q, k, v, mask)
            lib_err = compare_with_plain(lib.float(), want.float(), rows)
            # each attended (q, k) pair: 2 dh for the logit, 2 dh for p v;
            # q read and out written once, and of k and v each slot that
            # some query of its row attends, once for each kv head
            pairs = int(mask.sum()) * h
            slots = int(mask.any(1).sum())
            es = q.element_size()
            b_ms, b_by = bound(es * (2 * b * h * sq * dh
                                     + 2 * hkv * slots * dh),
                               4 * dh * pairs, BF16_FLOP_PER_S)
            runs = 5 if sq > 1 else TIMED_RUNS
            if sq > 1:
                grid_cmp = prefill_grids(q, k, v, off, kv_start, kw)
            t = dict(ms=graph_ms(kernel, runs=runs), call_ms=call_ms(kernel),
                     plain_ms=graph_ms(plain, runs=1 if sq > 1 else runs,
                                       replays=3),
                     plain_in_graph=True,
                     library_ms=graph_ms(lambda: sdpa(q, k, v, mask),
                                         runs=runs),
                     max_abs_err=err, bound_ms=b_ms,
                     bound_by=b_by, pairs=pairs, plan=plan)
            timed[name.split()[0]] = t
            print(f"[flash] {name}: {time_line(t)} bound_ms={b_ms:.4f} "
                  f"({b_by}; {pairs} attended pairs x 4 dh operations at "
                  f"the bf16 tensor-core peak, or q and out once and the "
                  f"{slots} (row, slot)s some query attends of k and v "
                  f"once per kv head) library_ms={t['library_ms']:.4f} "
                  f"(scaled_dot_product_attention, same mask, enable_gqa; "
                  f"device time, CUDA graph; a yardstick the port never "
                  f"calls; its max_abs_err on attended rows "
                  f"{lib_err['max_abs_err']:.3e})")
        del q, k, v, got, want
        torch.cuda.empty_cache()
    out["flash_attention"] = dict(timed["prefill"], decode={
        key: timed["decode"][key] for key in
        ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
         "max_abs_err", "plan")}, prefill_grid=grid_cmp)
    print(f"[flash] decode bf16: kernel {timed['decode']['ms']:.4f} ms vs "
          f"SDPA {timed['decode']['library_ms']:.4f} ms (device time, same "
          f"run): no slower than SDPA "
          f"{timed['decode']['ms'] <= timed['decode']['library_ms']}")


def prefill_grids(q, k, v, off, kv_start, kw):
    """The tile kernel at the prefill shape with the batch on grid.z and
    folded into grid.x, timed in turns (z, x, x, z; device time, CUDA
    graphs); both give the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    def run(on_z):
        return flash_attention_cuda(q, k, v, off, kv_start=kv_start,
                                    batch_on_z=on_z, **kw)
    need(torch.equal(run(True), run(False)), "flash_attention prefill: the "
         "grid.z and grid.x launches differ")
    ms = {True: [], False: []}
    for on_z in (True, False, False, True):
        ms[on_z].append(graph_ms(lambda: run(on_z), runs=5, replays=3))
    res = dict(z_ms=min(ms[True]), x_ms=min(ms[False]), z_runs=ms[True],
               x_runs=ms[False])
    print(f"[flash] prefill bf16 grids (device time, CUDA graph, in turns "
          f"z, x, x, z): batch on grid.z {ms[True]} ms, folded into grid.x "
          f"{ms[False]} ms; bitwise equal")
    return res


def packed_batch(vocab: int, seed: int = 14):
    """7b's batch: one 5,120-token prompt and three short ones."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in (LONG_PROMPT, *SHORT_PROMPTS)]


def serve_lm(dev):
    """7b: danube at full width on BatchServer, from launch counts at 0:
    launch.serve's own mix, then the packed long batch."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer as lm_m
    from repro_torch.random import PRNGKey
    from repro_torch.serve import BatchServer, ServeConfig
    cfg = get_arch(LM_ARCH).CONFIG
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm_m.init_params(PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    w_bytes = lm_m.param_bytes(params)
    print(f"[lm] {cfg.name} CONFIG: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv heads "
          f"x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window "
          f"{cfg.window}, {cfg.dtype}; {cfg.param_count()} parameters, "
          f"{w_bytes} bytes; init_params on the card "
          f"{time.perf_counter() - t0:.2f}s")
    n_norm = (2 * cfg.n_layers + 1) * cfg.d_model       # the f32 norm scales
    need(w_bytes == 2 * (cfg.param_count() - n_norm) + 4 * n_norm,
         "the weights are not the configuration's parameters in bf16")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    mix = serve_cli.run(params, cfg, requests=MIX_REQUESTS, max_new=MAX_NEW,
                        slots=MIX_SLOTS, device=dev)
    need(mix["tokens"] == MIX_REQUESTS * MAX_NEW and all(
        r.shape == (MAX_NEW,) and ((r >= 0) & (r < cfg.vocab)).all()
        for r in mix["results"].values()), "launch.serve mix output")
    print(f"[lm] launch.serve mix: {MIX_REQUESTS} requests, {mix['tokens']} "
          f"tokens, {mix['tokens'] / mix['seconds']:.1f} tok/s (host clock, "
          f"kernel build excluded); batches {mix['batch_stats']}")
    prompts = packed_batch(cfg.vocab)
    srv = BatchServer(params, cfg, batch_slots=4,
                      scfg=ServeConfig(max_new_tokens=MAX_NEW), device=dev)
    ids = [srv.submit(p) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = srv.serve()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = srv.batch_stats[0]
    gen = np.stack([res[i] for i in ids])
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = (4 * (LONG_PROMPT + MAX_NEW + 1) * cfg.n_layers * 2
                   * cfg.n_kv_heads * cfg.head_dim * 2)
    print(f"[lm] packed batch (prompts {[len(p) for p in prompts]}, "
          f"{MAX_NEW} new tokens each, greedy): wall {wall:.3f}s, "
          f"{gen.size / wall:.1f} tok/s, prefill {st['prefill_s']:.4f}s, "
          f"decode {st['decode_s'] / st['decode_steps'] * 1e3:.3f} ms/step "
          f"over {st['decode_steps']} steps (host clock, each ending in a "
          f"synchronise); max_memory_allocated={peak} (weights {w_bytes}, "
          f"cache {cache_bytes}; prefill computes the last position's "
          f"logits only); launches={counts}")
    need(gen.shape == (4, MAX_NEW) and ((gen >= 0) & (gen < cfg.vocab)).all(),
         "packed batch output")
    need(counts["flash_attention"] > 0, "LM serving never launched the "
         "flash_attention kernel")
    mix_served = [mix["results"][i] for i in mix["ids"]]
    return cfg, params, prompts, gen, mix_served, counts


def teacher_forced(dev, cfg, params, name, toks, lens, gen, profiled=False):
    """7c for one batch: the generated tokens `gen` (B, MAX_NEW) fed back
    through the model after the left-padded prompts `toks` (B, P), with
    the kernel and with the plain attention; the logits of every step
    compared."""
    from repro_torch.models import transformer as lm_m
    from torch.profiler import ProfilerActivity, profile
    b, p = toks.shape
    toks = torch.as_tensor(toks, device=dev).long()
    pad = torch.as_tensor(p - lens, dtype=torch.int32, device=dev)
    g = torch.as_tensor(gen, device=dev).long()
    logits = {}
    for backend in ("kernel", "ref"):
        t0 = time.perf_counter()
        cache = lm_m.init_cache(cfg, b, p + MAX_NEW + 1, device=dev)
        step, cache = lm_m.prefill_with_cache(params, cfg, cache, toks, pad,
                                              backend=backend)
        steps = [step]
        torch.cuda.synchronize()
        # the kernel's decode steps run under the profiler (device activity
        # only): the device's busy time against the window's wall time
        with profile(activities=[ProfilerActivity.CUDA],
                     record_shapes=False) if profiled and \
                backend == "kernel" else contextlib.nullcontext() as prof:
            t1 = time.perf_counter()
            for t in range(MAX_NEW - 1):
                step, cache = lm_m.decode_step(params, cfg, cache,
                                               g[:, t:t + 1], p + t, pad,
                                               backend=backend)
                steps.append(step)
            torch.cuda.synchronize()
            window = time.perf_counter() - t1
        logits[backend] = torch.stack(steps, dim=1)       # (B, MAX_NEW, V)
        torch.cuda.synchronize()
        print(f"[lm] teacher-forced {name} {backend}: "
              f"{time.perf_counter() - t0:.2f}s")
        if prof is not None:
            kernels = [e for e in prof.key_averages()
                       if e.device_type.name == "CUDA"]
            busy = sum(e.self_device_time_total for e in kernels) / 1e6
            attn = sum(e.self_device_time_total for e in kernels
                       if any(n in e.key for n in FLASH_KERNELS)) / 1e6
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            print(f"[lm] decode window, {MAX_NEW - 1} steps through the "
                  f"kernel (profiled, device activity only): wall "
                  f"{window:.4f}s, device busy {busy:.4f}s, idle_share="
                  f"{1 - busy / window:.4f}, flash_attention {attn:.4f}s "
                  f"({attn / busy:.3f} of busy); top kernels: "
                  + "; ".join(f"{e.self_device_time_total / 1e3:.2f} ms "
                              f"x{e.count} {e.key[:60]}" for e in top[:5]))
        del cache
        torch.cuda.empty_cache()
    kern, plain = logits["kernel"], logits["ref"]
    need(bool(torch.isfinite(kern).all() and torch.isfinite(plain).all()),
         f"teacher-forced {name}: logits are not finite")
    # the serve loop's tokens come back from the kernel's teacher-forced
    # pass: the loop fed each step what it sampled
    same_tokens = torch.equal(kern.argmax(-1).cpu(), g.cpu())
    delta = (kern - plain).abs()
    diff = float(delta.max())
    # the stated limit: attention outputs one bf16 ulp apart, carried
    # through every layer, each adding at most one ulp at the logits'
    # scale, plus the logits' own rounding to bf16
    top_ulp = 2.0 ** (math.floor(math.log2(float(plain.abs().max()))) - 7)
    limit = (cfg.n_layers + 1) * top_ulp
    top2 = plain.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    # a step's argmax cannot flip where its plain top-2 gap exceeds twice
    # that step's largest difference, so agreement there follows from the
    # difference; the count of such steps says the differences are small
    # beside the model's own gaps, step by step
    step_diff = delta.amax(-1)
    clear = gap > 2 * step_diff
    agree = kern.argmax(-1) == plain.argmax(-1)
    print(f"[lm] teacher-forced {name} logits ({b} rows x {MAX_NEW} steps x "
          f"{cfg.vocab}): the serve loop's tokens reproduced {same_tokens}; "
          f"max |kernel - plain| {diff:.4e} = {diff / top_ulp:g} bf16 ulps "
          f"at the logits' scale (limit {limit:.4e}: {cfg.n_layers} layers "
          f"+ 1 x "
          f"{top_ulp:.4e}, the ulp at the largest |logit| "
          f"{float(plain.abs().max()):.3f}); argmax equal on "
          f"{int(agree.sum())} of {agree.numel()} steps, on "
          f"{int((agree & clear).sum())} of {int(clear.sum())} whose plain "
          f"top-2 gap exceeds twice the step's largest difference (at "
          f"least {MIN_CLEAR_STEPS} required; {int((gap > 2 * diff).sum())}"
          f" exceed twice the batch's, {2 * diff:.4e})")
    need(same_tokens, f"teacher-forced {name}: the kernel's argmax is not "
         "the served tokens")
    need(diff <= limit, f"teacher-forced {name}: kernel and plain logits "
         f"differ by {diff} > {limit}")
    need(int(clear.sum()) >= MIN_CLEAR_STEPS, f"teacher-forced {name}: only "
         f"{int(clear.sum())} steps have a clear top-2 gap")
    need(bool(agree[clear].all()), f"teacher-forced {name}: kernel and "
         "plain argmax differ where the plain top-2 gap exceeds twice the "
         "step's largest difference")
    return diff


def teacher_force_all(dev, cfg, params, prompts, gen, mix_served):
    """7c: the packed batch (its decode window profiled), then each of
    launch.serve's batches. A mix batch's empty slots are not returned by
    the server, so the batch is generated again through the kernel, whose
    real rows must equal what the server returned."""
    from repro_torch.serve import ServeConfig, generate
    from repro_torch.serve.engine import pack_prompts
    toks, lens = pack_prompts(prompts, len(prompts))
    teacher_forced(dev, cfg, params, "packed batch", toks, lens, gen,
                   profiled=True)
    for i, (toks, lens) in enumerate(mix_batches(cfg.vocab)):
        full = generate(params, cfg, toks, ServeConfig(max_new_tokens=MAX_NEW),
                        prompt_lens=lens, device=dev).cpu().numpy()
        served = np.stack(mix_served[i * MIX_SLOTS:(i + 1) * MIX_SLOTS])
        need(np.array_equal(full[:len(served)], served), f"mix batch {i}: "
             "generate again differs from what the server returned")
        teacher_forced(dev, cfg, params, f"mix batch {i}", toks, lens, full)


# ------------------------------------------------------------ BST, GNN ----
BST_SHAPES = (("serve_p99", 512), ("serve_bulk", 262_144),
              ("retrieval_cand", 1_000_000))
# ogb_products (the JAX registry's GNN_SHAPES): N nodes, E edges padded to
# a multiple of 512 with -1 edges, d_feat-wide messages (a first SAGE
# layer's aggregation)
OGB_NODES, OGB_EDGES, OGB_DIM = 2_449_029, 61_859_140, 100
OGB_PADDED = OGB_EDGES + (-OGB_EDGES) % 512
# 8c: |kernel - plain| <= LOGIT_ATOL + LOGIT_RTOL |plain| for every logit
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
REF_CHUNK = 262_144      # candidates a plain retrieval pass scores


def bag_args(dev, batch: int, step: int, retrieval: bool = False):
    """embedding_bag's arguments as the model builds them from a bst_batch
    drawn on the card: its multi-hot ids (retrieval: one user's, tiled
    over the candidates, so every bag is the same user's)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import bst_batch
    from repro_torch.models import bst as bst_m
    cfg = get_arch("bst").CONFIG
    ids = bst_batch(step, batch=1 if retrieval else batch,
                    seq_len=cfg.seq_len, item_vocab=cfg.item_vocab,
                    cat_vocab=cfg.cat_vocab, device=dev)["multi_ids"]
    if retrieval:
        ids = ids.expand(batch, *ids.shape[1:])
    return bst_m.bag_inputs(cfg, ids)


def bag_bound(table, idx, n_bags):
    """ms, what bounds it: the ids and bag ids read once, each distinct
    table row named once, the bags written once; one add per element."""
    valid = idx[(idx >= 0) & (idx < table.shape[0])]
    rows = int(torch.unique(valid).numel())
    es, dim = table.element_size(), table.shape[1]
    return bound(8 * idx.numel() + es * dim * (rows + n_bags),
                 dim * valid.numel()) + (rows,)


def check_embedding_bag(dev, out):
    """8a, EmbeddingBag: the kernel bit-equal to its plain version at BST's
    three shapes (f32 and bf16), with pads and empty bags, and mean; each
    shape timed with F.embedding_bag as the yardstick."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    g = torch.Generator(device=dev).manual_seed(15)
    table32 = torch.randn((131_072, 32), generator=g, device=dev) * 0.02
    tables = {"f32": table32, "bf16": table32.to(torch.bfloat16)}
    timed = {}
    err = 0.0
    for step, (shape, batch) in enumerate(BST_SHAPES):
        idx, bags, n_bags = bag_args(dev, batch, step,
                                     shape == "retrieval_cand")
        cases = [(tag, t, idx, bags, "sum") for tag, t in tables.items()]
        if shape == "serve_bulk":   # short fields: pads anywhere, empty bags
            pidx = idx.clone()
            pidx[torch.rand(idx.shape, generator=g, device=dev) < 0.3] = -1
            pidx.view(-1, 8)[::13] = -1
            pbags = torch.where(pidx >= 0, bags, -1)
            # the same entries in a random order: the unsorted placement
            order = torch.randperm(idx.numel(), generator=g, device=dev)
            uidx, ubags = pidx[order], pbags[order]
            # ids at and past the table's end read its last row (C3)
            vidx = pidx.clone()
            vidx[::37] = table32.shape[0] + torch.arange(
                vidx[::37].numel(), device=dev, dtype=vidx.dtype) % 3
            vbags = torch.where(vidx >= 0, bags, -1)
            cases += [("f32 pads", table32, pidx, pbags, "sum"),
                      ("bf16 pads", tables["bf16"], pidx, pbags, "mean"),
                      ("f32 pads", table32, pidx, pbags, "mean"),
                      ("f32 unsorted", table32, uidx, ubags, "sum"),
                      ("bf16 unsorted", tables["bf16"], uidx, ubags, "mean"),
                      ("f32 ids >= V", table32, vidx, vbags, "sum"),
                      ("bf16 ids >= V", tables["bf16"], vidx, vbags,
                       "mean")]
        for tag, t, i, b, mode in cases:
            got = embedding_bag_cuda(t, i, b, n_bags, mode)
            want = ref.embedding_bag_ref(t, i, b, n_bags, mode)
            same = torch.equal(got, want)
            err = max(err, float((got.float() - want.float()).abs().max()))
            hit = torch.zeros(n_bags, dtype=torch.bool, device=dev)
            hit[b[(b >= 0) & (i >= 0)].long()] = True
            print(f"[bag] {shape} {tag} {mode}: {n_bags} bags of {i.numel()} "
                  f"ids ({int((b < 0).sum())} pads, "
                  f"{int((i >= t.shape[0]).sum())} ids >= V, "
                  f"{int((~hit).sum())} empty bags) table {tuple(t.shape)}: "
                  f"bitwise_equal={same}")
            need(same, f"embedding_bag {shape} {tag} {mode}: kernel differs "
                 "from its plain version")
            need(bool((got[~hit] == 0).all()),
                 f"embedding_bag {shape}: empty bags are not 0")
        counts = torch.full((idx.numel() // 8,), 8, device=dev)
        offsets = torch.cumsum(counts, 0) - counts
        lib_idx = idx.long()

        def kernel():
            return embedding_bag_cuda(table32, idx, bags, n_bags)

        def plain():
            return ref.embedding_bag_ref(table32, idx, bags, n_bags)

        def library():
            return torch.nn.functional.embedding_bag(lib_idx, table32,
                                                     offsets, mode="sum")
        lib_same = bool(torch.allclose(library(), kernel(), rtol=1e-6,
                                       atol=1e-7))
        b_ms, b_by, rows = bag_bound(table32, idx, n_bags)
        t = dict(ms=graph_ms(kernel), call_ms=call_ms(kernel),
                 plain_ms=call_ms(plain, runs=5), plain_in_graph=False,
                 library_ms=graph_ms(library), max_abs_err=err,
                 bound_ms=b_ms, bound_by=b_by)
        timed[shape] = t
        print(f"[bag] {shape} f32: {time_line(t)} bound_ms={b_ms:.5f} "
              f"({b_by}; {rows} distinct rows) library_ms="
              f"{t['library_ms']:.4f} (F.embedding_bag with offsets, sum; "
              f"device time, CUDA graph; a yardstick the port never calls; "
              f"within 1e-6 of the kernel: {lib_same}); the op is a memset "
              f"and 2 kernels; no slower than the library "
              f"{t['ms'] <= t['library_ms']}")
        if shape == "serve_bulk":
            t["unsorted_ms"] = graph_ms(lambda: embedding_bag_cuda(
                table32, uidx, ubags, n_bags), runs=3, replays=3)
            print(f"[bag] {shape} f32 unsorted (the same entries in a "
                  f"random order, one-block placement): kernel_ms="
                  f"{t['unsorted_ms']:.4f} (device time, CUDA graph)")
            del uidx, ubags, pidx, pbags, vidx, vbags
        del idx, bags, cases
        torch.cuda.empty_cache()
    out["embedding_bag"] = dict(timed["serve_bulk"], shapes={
        k: {key: v[key] for key in ("ms", "call_ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by")}
        for k, v in timed.items()})


def ogb_segments(dev, leading: bool = False):
    """ogb_products' destination ids: N nodes with Pareto(2) in-degrees
    (a heavy tail; capped at 20,000) summing to E, every 1,000th block of
    128 nodes with no edge, ascending (edges sorted by destination), and
    the registry's 188 pad edges (-1) after them, or before them with
    `leading`."""
    g = torch.Generator(device=dev).manual_seed(8)
    u = torch.rand(OGB_NODES, generator=g, device=dev, dtype=torch.float64)
    w = (1.0 - u) ** -0.5
    w[(torch.arange(OGB_NODES, device=dev) // 128) % 1000 == 7] = 0.0
    deg = (w / w.sum() * OGB_EDGES).floor().clamp(max=20_000).long()
    short = OGB_EDGES - int(deg.sum())
    live = torch.nonzero(w > 0).flatten()
    deg[live] += short // live.numel()
    extra = live[torch.randperm(live.numel(), generator=g,
                                device=dev)[:short % live.numel()]]
    deg[extra] += 1
    seg = torch.repeat_interleave(
        torch.arange(OGB_NODES, dtype=torch.int32, device=dev), deg)
    pads = torch.full((OGB_PADDED - OGB_EDGES,), -1, dtype=torch.int32,
                      device=dev)
    return torch.cat([pads, seg] if leading else [seg, pads]), deg


def check_segment_matmul(dev, out):
    """8a, segment sums: the kernel bit-equal to its plain version at
    ogb_products' shape (f32 and bf16, trailing pads as the registry pads;
    leading pads; unvisited row blocks exactly 0), timed with index_add_
    as the yardstick."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.segment_matmul import segment_matmul_cuda
    seg, deg = ogb_segments(dev)
    err = 0.0
    print(f"[segment] ogb_products: N={OGB_NODES} E={OGB_EDGES} padded to "
          f"{OGB_PADDED} ({OGB_PADDED - OGB_EDGES} pad edges), d={OGB_DIM}; "
          f"in-degree max {int(deg.max())}, mean {OGB_EDGES / OGB_NODES:.2f}, "
          f"{int((deg == 0).sum())} nodes with none")
    g = torch.Generator(device=dev).manual_seed(9)
    msg = torch.randn((OGB_PADDED, OGB_DIM), generator=g, device=dev)
    empty = deg == 0
    for tag, s in (("trailing pads", seg), ("leading pads",
                                            ogb_segments(dev, True)[0])):
        got = segment_matmul_cuda(msg, s, OGB_NODES)
        want = ref.segment_matmul_ref(msg, s, OGB_NODES)
        same = torch.equal(got, want)
        err = max(err, float((got - want).abs().max()))
        print(f"[segment] f32 {tag}: bitwise_equal={same}, unvisited rows "
              f"exactly 0: {bool((got[empty] == 0).all())}")
        need(same, f"segment_matmul f32 {tag}: kernel differs from its "
             "plain version")
        need(bool((got[empty] == 0).all()), "segment_matmul: unvisited rows "
             "are not 0")
        del got, want
    n_valid = OGB_EDGES

    def kernel():
        return segment_matmul_cuda(msg, seg, OGB_NODES)

    def plain():
        return ref.segment_matmul_ref(msg, seg, OGB_NODES)

    def library():
        return torch.zeros((OGB_NODES, OGB_DIM), device=dev).index_add_(
            0, seg[:n_valid], msg[:n_valid])
    lib_err = float((library() - kernel()).abs().max())
    b_ms, b_by = bound(4 * OGB_PADDED * (OGB_DIM + 1)
                       + 4 * OGB_NODES * OGB_DIM, OGB_EDGES * OGB_DIM)
    t = dict(ms=graph_ms(kernel, runs=5), call_ms=call_ms(kernel, runs=5),
             plain_ms=call_ms(plain, runs=1), plain_in_graph=False,
             library_ms=graph_ms(library, runs=5), max_abs_err=err,
             bound_ms=b_ms, bound_by=b_by)
    print(f"[segment] f32: {time_line(t)} bound_ms={b_ms:.4f} ({b_by}: "
          f"messages and ids read once, rows written once) library_ms="
          f"{t['library_ms']:.4f} (index_add_, atomics; device time, CUDA "
          f"graph; a yardstick the port never calls; max |library - "
          f"kernel| {lib_err:.3e})")
    ops.reset_launch_counts()          # the op's own path, "auto"
    main = ops.segment_matmul(msg, seg, OGB_NODES)
    t["launches"] = ops.launch_counts()["segment_matmul"]
    need(torch.equal(main, kernel()) and t["launches"] > 0,
         "ops.segment_matmul did not go through its kernel")
    del main
    msg16 = msg.to(torch.bfloat16)
    del msg
    torch.cuda.empty_cache()
    got = segment_matmul_cuda(msg16, seg, OGB_NODES)
    want = ref.segment_matmul_ref(msg16, seg, OGB_NODES)
    same = torch.equal(got, want)
    t["max_abs_err"] = max(err, float((got.float() - want.float()).abs()
                                      .max()))
    t["bf16_ms"] = graph_ms(lambda: segment_matmul_cuda(msg16, seg,
                                                        OGB_NODES), runs=5)
    print(f"[segment] bf16 trailing pads: bitwise_equal={same}; kernel_ms="
          f"{t['bf16_ms']:.4f} (device time, CUDA graph)")
    need(same, "segment_matmul bf16: kernel differs from its plain version")
    out["segment_matmul"] = t
    del msg16, got, want, seg
    torch.cuda.empty_cache()


def check_bst_attention(dev, out):
    """8b: the attention kernel at BST's shape (H = Hkv = 8, Sq = Sk = 21,
    dh = 4, f32, not causal; kernel_plan's "small" kernel, q, k and v the
    model's transposed views) for B = 512, 262,144 and 1,000,000 against
    its plain version on slabs of rows (the op is independent across the
    batch): the first and last 65,536 rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import compare_with_plain, \
        flash_attention_cuda, kernel_plan
    timed = {}
    for seed, (shape, b) in enumerate(BST_SHAPES):
        q, k, v = bst_qkv(dev, b, 100 + seed)
        plan = kernel_plan(b, 8, 8, 21, 21, 4, causal=False).kernel
        got = flash_attention_cuda(q, k, v, 0, causal=False)
        slabs = [(0, min(b, 65_536))] + ([(b - 65_536, b)] if b > 65_536
                                         else [])
        bad, err = 0, 0.0
        for lo, hi in slabs:
            want = ref.attention_ref(q[lo:hi], k[lo:hi], v[lo:hi],
                                     causal=False)
            res = compare_with_plain(got[lo:hi], want, torch.ones(
                (hi - lo, 21), dtype=torch.bool, device=dev))
            bad += res["bad"]
            err = max(err, res["max_abs_err"])
        print(f"[flash] BST {shape}: B={b} H=Hkv=8 Sq=Sk=21 dh=4 f32 not "
              f"causal, q, k, v the model's views, plan {plan}: rows "
              f"{slabs} compared, outside the rule {bad}, max_abs_err="
              f"{err:.3e}")
        need(bad == 0, f"flash_attention BST {shape}: outside the rule")
        pairs = b * 8 * 21 * 21
        b_ms, b_by = bound(4 * 4 * b * 8 * 21 * 4, 4 * 4 * pairs)
        if shape == "serve_bulk":
            def kernel():
                return flash_attention_cuda(q, k, v, 0, causal=False)

            def plain():
                return ref.attention_ref(q, k, v, causal=False)
            t = dict(ms=graph_ms(kernel, runs=5), call_ms=call_ms(kernel),
                     plain_ms=graph_ms(plain, runs=3, replays=3),
                     plain_in_graph=True, library_ms=graph_ms(
                         lambda: torch.nn.functional.
                         scaled_dot_product_attention(q, k, v), runs=5),
                     max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                     plan=plan)
            timed = t
            print(f"[flash] BST {shape}: {time_line(t)} bound_ms={b_ms:.4f} "
                  f"({b_by}; {pairs} pairs x 4 dh f32 operations at 67 "
                  f"TFLOP/s, or q, k, v, out once) library_ms="
                  f"{t['library_ms']:.4f} (scaled_dot_product_attention; "
                  "device time, CUDA graph; a yardstick the port never "
                  f"calls); no slower than the plain version "
                  f"{t['ms'] <= t['plain_ms']}")
        del q, k, v, got
        torch.cuda.empty_cache()
    out["flash_attention"]["bst"] = {
        key: timed[key] for key in ("ms", "call_ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by", "max_abs_err",
                                    "plan")}


def bst_qkv(dev, b: int, seed: int):
    """q, k and v of BST's attention as the model makes them: (B, 8, 21,
    4) views of three (B, 21, 32) projections (numpy-seeded, f32)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (b, 21, 32), dtype=np.float32)).to(dev).view(b, 21, 8, 4)
        .transpose(1, 2) for _ in range(3))


def bst_batches(dev):
    """8c's batches, drawn on the card: serve_p99 and serve_bulk as
    bst_batch gives them, and retrieval_cand as one user's context (row 0
    of a 1,000,000-row batch) against that batch's targets."""
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import bst_batch
    cfg = get_arch("bst").CONFIG
    out = []
    for step, (shape, b) in enumerate(BST_SHAPES):
        batch = bst_batch(step, batch=b, seq_len=cfg.seq_len,
                          item_vocab=cfg.item_vocab, cat_vocab=cfg.cat_vocab,
                          device=dev)
        if shape == "retrieval_cand":
            user = ("seq_items", "seq_cats", "dense_feats", "multi_ids")
            batch = dict({k: batch[k][:1] for k in user},
                         cand_items=batch["target_item"],
                         cand_cats=batch["target_cat"])
        else:
            batch.pop("labels")
        out.append((shape, b, batch))
    return out


def plain_logits(step, params, shape, batch):
    """The same batch through backend="ref"; retrieval in chunks of
    candidates (one user's context each time)."""
    if shape != "retrieval_cand":
        return step(params, batch)
    parts = []
    for lo in range(0, batch["cand_items"].shape[0], REF_CHUNK):
        part = dict(batch, cand_items=batch["cand_items"][lo:lo + REF_CHUNK],
                    cand_cats=batch["cand_cats"][lo:lo + REF_CHUNK])
        parts.append(step(params, part))
    return torch.cat(parts)


def profile_bst_step(step, params, batch, shape):
    """One more step under torch.profiler (device activity only): the
    device's busy time against the step's wall time, and where it goes."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6

    def share(*names):
        return sum(e.self_device_time_total for e in kernels
                   if any(n in e.key for n in names)) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    print(f"[bst] {shape} step profiled (device activity only): wall "
          f"{wall:.4f}s, device busy {busy:.4f}s, idle_share="
          f"{1 - busy / wall:.4f}; flash_attention "
          f"{share(*FLASH_KERNELS):.4f}s, embedding_bag "
          f"{share(*BAG_KERNELS):.4f}s, sorts "
          f"{share('Sort', 'sort'):.4f}s; top: " + "; ".join(
              f"{e.self_device_time_total / 1e3:.3f} ms x{e.count} "
              f"{e.key[:50]}" for e in top[:6]))


def serve_bst(dev):
    """8c: BST's CONFIG at full width on the card, from launch counts at 0:
    make_bst_serve_step at 512 and 262,144, make_bst_retrieval_step at
    1,000,000 candidates; then each batch's logits through backend="ref"
    against the kernel path's."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import bst as bst_m
    from repro_torch.random import PRNGKey
    from repro_torch.train.steps import make_bst_retrieval_step, \
        make_bst_serve_step
    cfg = get_arch("bst").CONFIG
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = bst_m.init_params(PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[bst] {cfg.name} CONFIG: embed_dim {cfg.embed_dim}, seq_len "
          f"{cfg.seq_len}, {cfg.n_blocks} block x {cfg.n_heads} heads, MLP "
          f"{cfg.mlp}, tables {cfg.item_vocab} / {cfg.cat_vocab} / "
          f"{cfg.multi_vocab}; {n_par} parameters, {w_bytes} bytes; "
          f"init_params on the card {time.perf_counter() - t0:.2f}s")
    need(n_par == cfg.param_count() and w_bytes == 4 * n_par,
         "the weights are not the configuration's parameters in f32")
    batches = bst_batches(dev)
    steps = {"kernel": (make_bst_serve_step(cfg),
                        make_bst_retrieval_step(cfg)),
             "ref": (make_bst_serve_step(cfg, backend="ref"),
                     make_bst_retrieval_step(cfg, backend="ref"))}
    ops.reset_launch_counts()
    logits = {}
    for shape, b, batch in batches:
        step = steps["kernel"][shape == "retrieval_cand"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            y = step(params, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        logits[shape] = y
        unit = "candidates" if shape == "retrieval_cand" else "rows"
        print(f"[bst] {shape}: {b} {unit}, "
              f"step seconds {', '.join(f'{s:.4f}' for s in secs)} (host "
              f"clock, each ending in a synchronise; the first includes "
              f"warm-up), {b / statistics.median(secs):.0f} scored/s; "
              f"max_memory_allocated={peak}")
        need(y.shape == (b,) and bool(torch.isfinite(y).all()),
             f"BST {shape}: logits not finite or of the wrong shape")
        profile_bst_step(step, params, batch, shape)
    counts = ops.launch_counts()
    print(f"[bst] launches of the BST serving path: {counts}")
    need(counts["embedding_bag"] > 0 and counts["flash_attention"] > 0,
         "BST serving never launched embedding_bag or flash_attention")
    for shape, b, batch in batches:
        step = steps["ref"][shape == "retrieval_cand"]
        want = plain_logits(step, params, shape, batch)
        got = logits.pop(shape)
        diff = (got - want).abs()
        worst = float((diff - LOGIT_RTOL * want.abs()).max())
        print(f"[bst] {shape} logits, kernel path vs backend='ref': max "
              f"|diff| {float(diff.max()):.3e} on logits up to "
              f"{float(want.abs().max()):.3f}; rule |diff| <= {LOGIT_ATOL} "
              f"+ {LOGIT_RTOL} |ref| holds: {worst <= LOGIT_ATOL}")
        need(worst <= LOGIT_ATOL, f"BST {shape}: kernel-path logits differ "
             "from backend='ref' beyond the rule")
        del got, want
    del params, batches
    torch.cuda.empty_cache()
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in f32 and round once, as XLA's dot does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    torch.cuda.empty_cache()

    check_flash_attention(dev, stats)
    cfg, params, prompts, gen, mix_served, lm_counts = serve_lm(dev)
    counts["flash_attention"] = lm_counts["flash_attention"]
    teacher_force_all(dev, cfg, params, prompts, gen, mix_served)
    del params, gen, mix_served
    torch.cuda.empty_cache()

    check_embedding_bag(dev, stats)
    check_segment_matmul(dev, stats)
    check_bst_attention(dev, stats)
    bst_counts = serve_bst(dev)
    counts["embedding_bag"] = bst_counts["embedding_bag"]
    counts["segment_matmul"] = stats["segment_matmul"].pop("launches")
    stats["flash_attention"]["bst"]["launches"] = \
        bst_counts["flash_attention"]

    table = []
    for name, s in stats.items():
        table.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s.get("library_ms"),
            **{key: s[key] for key in ("decode", "bst", "prefill_grid",
                                       "shapes", "unsorted_ms", "bf16_ms")
               if key in s}})
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
