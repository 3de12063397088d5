"""Where a call of the fit's two LID kernels spends its cycles, by phase.

    python src/repro_torch/launch/profile_kernel_phases.py

Builds copies of `csrc/lid_sweep.cu` and `csrc/affinity_matvec.cu` with
clock64() counters between their phases (block 0, thread 0; the copies
live in a temporary directory, the sources are not changed), then runs
them at the full-width fit's shapes: `lid_sweep` over 32 seeds x (240, 128)
for 8 steps with every cluster size (1, 2 and 4 blocks at B = 32; 8 at
B = 16), and `affinity_matvec` at 32 x 240 x 240 and x 112. Prints the
device time of the uninstrumented kernel (CUDA graph, as chip_smoke.py
takes it) and the instrumented one's cycles by phase, summed over the
steps: the sweep's staging, |v|^2 and its exchange, then per step pi,
the argmax, the scalar chain, the x update, the column (and the part of
it up to the first dot, v_i's loads included) and the cluster barrier;
the matvec's q rows and norms, the columns' staging, their norms and the
register-tile products.

Then where the time of `affinity` and `lsh_hash` goes, by ablation: each
source is built again with -DDROP_PHASE=n (the phase switches its head
comment lists) and every copy is timed as the kernel is, at the main path's
shapes: `affinity` at 40,000^2 x 128 on both routes, `lsh_hash` at the
store build's 1,000,000 x 128 points (stream route) and the CIVS probe's
3,584 (probe route), L = 4 tables of m = 8. A phase's cost is the copy's
time less the whole kernel's (drop 0); the copies' results are wrong and
only timed. Prints one JSON line of those times. Needs a CUDA device and
nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "csrc"
PROF = ('\n__device__ unsigned long long g_prof[16];\n'
        'extern "C" int prof_read(unsigned long long* h) {\n'
        '  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }\n'
        'extern "C" int prof_reset() { unsigned long long z[16] = {0};\n'
        '  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n')
SWEEP_PHASES = ("stage", "v2", "pi", "argmax", "scalars", "x", "column",
                "barrier")
MATVEC_PHASES = ("q_rows_and_norms", "c_stage", "c_norms", "products")
# the phases -DDROP_PHASE=1, 2, ... take out of each source (0 drops none)
DROPS = {"affinity": ("none", "stores", "epilogue", "half_leaves"),
         "lsh_hash": ("none", "fma", "point_copies", "division", "fold")}

# (anchor, text put before it) pairs; each anchor must occur in the source
SWEEP_MARKS = [
    ("  const int ng = leaf_groups(d);\n  const int ldr",
     "  long long P0 = clock64(); unsigned long long A[8] = {};\n"
     "  int NS = 0;\n"),
    ("\n  // a row of the seed", "  long long P1 = clock64();\n"),
    ("  bool peers_quiet", "  long long P2 = clock64();\n"),
    ("    const float* x = xb + cur * capp;\n    const float* ax",
     "    long long S0 = clock64(); ++NS;\n"),
    ("    // the argmax, by every warp",
     "    long long Sp = clock64(); A[0] += Sp - S0;\n"),
    ("\n    if (!done) {", "\n    long long S1 = clock64(); A[1] += S1 - Sp;"),
    ("      const int nxt = cur ^ 1;",
     "      long long S2 = clock64(); A[2] += S2 - S1;\n"),
    ("      if (refresh_every <= 0 || (it + 1) % refresh_every != 0) {",
     "      long long S3 = clock64(); A[3] += S3 - S2;\n"),
    ("          float col = affinity(",
     "          if (rd == 0) A[6] += clock64() - S3;\n"),
    ("      cluster_barrier(cs);  // every block's Ax rows",
     "      long long S4 = clock64(); A[4] += S4 - S3;\n"),
    ("      peers_quiet = true;", "      A[5] += clock64() - S4;\n"),
    ("  const float* x = xb + cur * capp;\n  const float* ax = axb",
     "  if (blockIdx.x == 0 && tid == 0) {\n"
     "    atomicAdd(&g_prof[0], (unsigned long long)(P1 - P0));\n"
     "    atomicAdd(&g_prof[1], (unsigned long long)(P2 - P1));\n"
     "    for (int q = 0; q < 6; ++q) atomicAdd(&g_prof[2 + q], A[q]);\n"
     "    atomicAdd(&g_prof[8], A[6]);\n"
     "    atomicAdd(&g_prof[9], (unsigned long long)NS);\n  }\n"),
]
MATVEC_MARKS = [
    ("  if constexpr (kSmemRows) {\n    stage(qs,",
     "  long long P0 = clock64(); unsigned long long A[4] = {};\n"),
    ("  const Row* qr[TQ];",
     "  __syncthreads(); long long P1 = clock64(); A[0] += P1 - P0;\n"),
    ("    if constexpr (kSmemRows) {\n      stage(cs,",
     "    long long Pa = clock64();\n"),
    ("    for (int s0 = 0; s0 < slots; s0 += nquads) {",
     "    long long Pb = clock64(); A[1] += Pb - Pa;\n"),
    ("\n    for (int gg = 0;", "\n    long long Pc = clock64(); A[2] += Pc - Pb;"),
    ("  const int depth = 31 - __clz(groups);",
     "  A[3] = clock64() - P1 - A[1] - A[2];\n"
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {\n"
     "    for (int q = 0; q < 4; ++q) atomicAdd(&g_prof[q], A[q]);\n  }\n"),
]


def instrument(text: str, marks) -> str:
    text = text.replace('#include "common.cuh"\n',
                        '#include "common.cuh"\n' + PROF)
    for anchor, before in marks:
        if anchor not in text:
            raise SystemExit(f"profile_kernel_phases: anchor not found: "
                             f"{anchor[:60]!r}")
        text = text.replace(anchor, before + anchor, 1)
    return text


def main() -> int:
    sys.path.insert(0, str(SRC.parent.parent))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernel_phases needs a CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels.affinity_matvec import leaf_groups
    from repro_torch.kernels.affinity_matvec import plan as matvec_plan
    from repro_torch.launch.time_fit_kernels import fit_state, graph_ms

    tmp = Path(tempfile.mkdtemp())
    srcs = {
        "lid_sweep": (SRC / "lid_sweep.cu").read_text(),
        "affinity_matvec": (SRC / "affinity_matvec.cu").read_text()}
    srcs["lid_sweep_prof"] = instrument(srcs["lid_sweep"], SWEEP_MARKS)
    srcs["affinity_matvec_prof"] = instrument(srcs["affinity_matvec"],
                                              MATVEC_MARKS)
    jobs = {}   # library -> (source, extra flags, kernel)
    for name, text in srcs.items():
        (tmp / f"{name}.cu").write_text(text)
        jobs[name] = (tmp / f"{name}.cu", [], name.replace("_prof", ""))
    for kernel, phases in DROPS.items():
        for i, phase in enumerate(phases):
            jobs[f"{kernel}_drop_{phase}"] = (SRC / f"{kernel}.cu",
                                              [f"-DDROP_PHASE={i}"], kernel)
    procs = {}
    for name, (src, flags, _) in jobs.items():   # all nvcc at once
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-I",
             str(SRC), str(src), "-o", str(tmp / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out[-3000:]}")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        key = jobs[name][2] + "_launch"
        getattr(lib, key).argtypes = list(_build.SIGNATURES[key])
        getattr(lib, key).restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)

    def stream():  # the current stream at launch (graph capture's own)
        return torch.cuda.current_stream().cuda_stream

    def sweep(lib, st, k, cs):
        bsz, cap, d = st.v_beta.shape
        rows_per = -(-cap // cs)   # kernels.lid_sweep.plan with cs forced
        threads = min(256, max(32, -(-4 * rows_per // 32) * 32))
        smem = (4 * 7 * (-(-cap // 32) * 32)
                + rows_per * 4 * (128 * leaf_groups(d) + 16))
        m8 = st.beta_mask.view(torch.uint8)
        cv = st.converged.view(torch.uint8)
        outs = [torch.empty_like(st.x), torch.empty_like(st.x),
                torch.empty_like(st.n_iters), torch.empty_like(cv)]

        def go():
            err = lib.lid_sweep_launch(
                st.v_beta.data_ptr(), st.beta_idx.data_ptr(), m8.data_ptr(),
                st.x.data_ptr(), st.ax.data_ptr(), st.n_iters.data_ptr(),
                cv.data_ptr(), *(o.data_ptr() for o in outs), bsz, cap, d, k,
                8, 256, 1e-5, 0, 1e-6, cs, threads, rows_per, 1, smem,
                stream())
            if err:
                raise SystemExit(f"lid_sweep launch failed: {err}")
        return go

    def matvec(lib, st, k, n, w):
        bsz, m, d = st.v_beta.shape
        pl = matvec_plan(m, n, d)
        c, ci, wc = (t[:, :n].contiguous() for t in (st.v_beta, st.beta_idx,
                                                     w))
        out = torch.empty((bsz, m), device=dev)

        def go():
            err = lib.affinity_matvec_launch(
                st.v_beta.data_ptr(), st.beta_idx.data_ptr(), c.data_ptr(),
                ci.data_ptr(), wc.data_ptr(), out.data_ptr(), bsz, m, n, d, k,
                1, pl.rows, pl.classes, pl.ubits, pl.tc, pl.groups, pl.gpp,
                pl.smem, stream())
            if err:
                raise SystemExit(f"affinity_matvec launch failed: {err}")
        return go

    def cycles(lib, go, names):
        lib.prof_reset()
        go()
        torch.cuda.synchronize()
        h = (ctypes.c_ulonglong * 16)()
        lib.prof_read(h)
        return {n: int(h[i]) for i, n in enumerate(names)}, h

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[phases] card: {card}")
    for bsz, sizes in ((32, (1, 2, 4)), (16, (8,))):
        st, k = fit_state(bsz)
        for cs in sizes:
            ms = graph_ms(sweep(libs["lid_sweep"], st, k, cs))
            got, h = cycles(libs["lid_sweep_prof"],
                            sweep(libs["lid_sweep_prof"], st, k, cs),
                            SWEEP_PHASES)
            print(f"[phases] lid_sweep B={bsz} cluster={cs} 8 steps: "
                  f"{ms:.4f} ms; cycles of block 0: {got} "
                  f"(column to its first dot {int(h[8])}; steps {int(h[9])})")
    st, k = fit_state(32)
    w = torch.rand((32, 240), generator=torch.Generator(device="cpu")
                   .manual_seed(3)).to(dev)
    for n in (240, 112):
        ms = graph_ms(matvec(libs["affinity_matvec"], st, k, n, w))
        got, _ = cycles(libs["affinity_matvec_prof"],
                        matvec(libs["affinity_matvec_prof"], st, k, n, w),
                        MATVEC_PHASES)
        print(f"[phases] affinity_matvec 32 x 240 x {n} x 128: {ms:.4f} ms; "
              f"cycles of block 0: {got}")
    del st, w
    print(json.dumps(dict(ablation(libs, dev, stream), card=card)))
    return 0


def ablation(libs, dev, stream) -> dict:
    """Device time (ms) of every DROP_PHASE copy of `lsh_hash` and
    `affinity` at the main path's shapes, keyed kernel_drop_phase_route."""
    import torch
    from repro_torch.kernels.affinity import plan as affinity_plan
    from repro_torch.kernels.lsh_hash import PER_THREAD
    from repro_torch.kernels.lsh_hash import plan as lsh_plan
    from repro_torch.launch.time_fit_kernels import graph_ms

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    x = torch.randn((1_000_000, 128), generator=gen, device=dev) * 4
    proj = torch.randn((4, 8, 128), generator=gen, device=dev)
    bias = torch.rand((4, 8), generator=gen, device=dev) * 4.0
    keys = torch.empty((1_000_000, 4), dtype=torch.int32, device=dev)
    for n in (1_000_000, 3_584):
        pl = lsh_plan(n, 128, 4, 8)
        for phase in DROPS["lsh_hash"]:
            name = f"lsh_hash_drop_{phase}"

            def go(lib=libs[name], n=n, pl=pl, name=name):
                err = lib.lsh_hash_launch(
                    x.data_ptr(), proj.data_ptr(), bias.data_ptr(),
                    keys.data_ptr(), n, 128, 4, 8,
                    PER_THREAD[pl.route], pl.pts, pl.threads, pl.smem, 4.0,
                    stream())
                if err:
                    raise SystemExit(f"{name} failed to launch: {err}")
            out[f"{name}_{pl.route}_ms"] = graph_ms(go)
    del x, keys
    torch.cuda.empty_cache()

    n, d = 40_000, 128
    rows = torch.randn((n, d), generator=gen, device=dev) * 3
    copy = rows.clone()
    res = torch.empty((n, n), device=dev)
    for route, c in (("symmetric", rows), ("general", copy)):
        pl = affinity_plan(n, n, d, route == "symmetric")
        pad = -(-n // pl.tile) * pl.tile
        qp = torch.empty((pad, pl.ld), device=dev)
        q2 = torch.empty(pad, device=dev)
        cp, c2 = ((qp, q2) if route == "symmetric" else
                  (torch.empty((pad, pl.ld), device=dev),
                   torch.empty(pad, device=dev)))
        for phase in DROPS["affinity"]:
            name = f"affinity_drop_{phase}"

            def go(lib=libs[name], c=c, pl=pl, qp=qp, q2=q2, cp=cp, c2=c2,
                   name=name):
                err = lib.affinity_launch(
                    rows.data_ptr(), c.data_ptr(), res.data_ptr(),
                    qp.data_ptr(), q2.data_ptr(), cp.data_ptr(),
                    c2.data_ptr(), 1, n, n, d, pl.ng, pl.tile, pl.stages,
                    int(pl.route == "symmetric"), pl.smem, 0.05, stream())
                if err:
                    raise SystemExit(f"{name} failed to launch: {err}")
            out[f"{name}_{route}_ms"] = graph_ms(go, 3, 3)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
