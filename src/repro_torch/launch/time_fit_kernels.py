"""Device time of the fit's kernels at the full-width fit's shapes, and of
the full matrix's affinity kernel on both routes, for comparing two trees
of the port on one card.

    python src/repro_torch/launch/time_fit_kernels.py [--src DIR] [--runs 25]

Imports `repro_torch` from DIR (default: the tree this file is in), so the
same command times another checkout's kernels: run it on two trees in
turns (A, B, B, A) in one session on one card. Times, as chip_smoke.py
takes them: 25 calls captured in a CUDA graph, the median of 5 replays,
per call. Shapes: `lid_sweep` over 32 seeds x (240, 128) for 8 steps and
for 1 (its fixed cost), and on lanes converged on entry; `affinity_matvec`
at 32 x 240 x 240 x 128 (the ROI's pi(x)) and 32 x 240 x 112 x 128 (the
CIVS support rebuild); `lsh_hash` at the store build's 1,000,000 x 128
points and the CIVS probe's 3,584 (L = 4 tables of m = 8); `affinity` on
the full-matrix path's 40,000 x 128 rows against themselves (symmetric
route: q and c one tensor, as `affinity_matrix` calls it) and against a
copy (general route), 3 calls a graph, 3 replays. Prints one JSON line
with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def graph_ms(fn, runs: int = 25, replays: int = 5) -> float:
    import torch
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


def fit_state(bsz: int, cap: int = 240, d: int = 128):
    """(LIDState, k) of B seeds of clustered rows, x at slot 0, exact Ax:
    states that iterate, at the full-width fit's (cap, d)."""
    import numpy as np
    import torch
    from repro_torch.core.lid import LIDState, refresh_ax
    dev = torch.device("cuda", 0)
    k = float(np.float32(np.log(1 / 0.95) / np.sqrt(2.0 * d) * 4))
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(bsz, 4, d)) * 3.0
    pts = centers[:, rng.integers(0, 4, cap)] + rng.normal(size=(bsz, cap, d))
    v = torch.tensor(pts, dtype=torch.float32, device=dev)
    x = torch.zeros((bsz, cap), dtype=torch.float32, device=dev)
    x[:, 0] = 1.0
    st = LIDState(torch.arange(cap, dtype=torch.int32, device=dev)
                  .repeat(bsz, 1),
                  torch.ones((bsz, cap), dtype=torch.bool, device=dev), v, x,
                  torch.zeros_like(x),
                  torch.zeros(bsz, dtype=torch.int32, device=dev),
                  torch.zeros(bsz, dtype=torch.bool, device=dev))
    return refresh_ax(st, k, backend="ref"), k


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_fit_kernels needs a CUDA device")
    from repro_torch.kernels.affinity import affinity_cuda
    from repro_torch.kernels.affinity_matvec import affinity_matvec_cuda
    from repro_torch.kernels.lid_sweep import lid_sweep_cuda
    from repro_torch.kernels.lsh_hash import lsh_hash_cuda

    bsz, cap, a_cap = 32, 240, 112
    st, k = fit_state(bsz, cap)
    v, idx = st.v_beta, st.beta_idx
    lanes = (st.v_beta, st.beta_idx, st.beta_mask, st.x, st.ax, st.n_iters)
    kw = dict(n_steps=8, max_iters=256, tol=1e-5)
    w = torch.rand((bsz, cap), generator=torch.Generator(device="cpu")
                   .manual_seed(3)).to(v.device)

    def sweep(n_steps, converged):
        return lambda: lid_sweep_cuda(*lanes, converged, k,
                                      **dict(kw, n_steps=n_steps))

    def matvec(n):  # the support side contiguous, as the fit gives it
        c, ci, wc = (t[:, :n].contiguous() for t in (v, idx, w))
        return lambda: affinity_matvec_cuda(v, idx, c, ci, wc, k)

    done = torch.ones_like(st.converged)
    out = {
        "src": str(Path(args.src).resolve()),
        "lid_sweep_8_steps_ms": graph_ms(sweep(8, st.converged), args.runs),
        "lid_sweep_1_step_ms": graph_ms(sweep(1, st.converged), args.runs),
        "lid_sweep_converged_ms": graph_ms(sweep(8, done), args.runs),
        "affinity_matvec_240_ms": graph_ms(matvec(cap), args.runs),
        "affinity_matvec_112_ms": graph_ms(matvec(a_cap), args.runs),
    }
    gen = torch.Generator(device=v.device).manual_seed(5)
    x = torch.randn((1_000_000, 128), generator=gen, device=v.device) * 4
    proj = torch.randn((4, 8, 128), generator=gen, device=v.device)
    bias = torch.rand((4, 8), generator=gen, device=v.device) * 4.0
    probe = x[:bsz * a_cap].contiguous()
    out["lsh_hash_1m_ms"] = graph_ms(
        lambda: lsh_hash_cuda(x, proj, bias, 4.0), args.runs)
    out["lsh_hash_probe_ms"] = graph_ms(
        lambda: lsh_hash_cuda(probe, proj, bias, 4.0), args.runs)
    del x, probe
    rows = torch.randn((40_000, 128), generator=gen, device=v.device) * 3
    copy = rows.clone()
    out["affinity_symmetric_ms"] = graph_ms(
        lambda: affinity_cuda(rows, rows, 0.05), 3, 3)
    out["affinity_general_ms"] = graph_ms(
        lambda: affinity_cuda(rows, copy, 0.05), 3, 3)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
