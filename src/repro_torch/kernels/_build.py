"""Build and load the hand-written CUDA kernels of `repro_torch/csrc/`.

At first use every `csrc/*.cu` is compiled for Hopper (`sm_90a`) by one
`nvcc -c` per source, all started together, and the objects are linked into
a shared library with a plain C interface, which `ctypes` loads. Nothing
includes PyTorch's headers. The library is named after a hash of the
sources and flags, so an edited source never loads a stale build. No
`--use_fast_math`: the kernels need IEEE `expf`, `sqrtf` and division.

`LATE_SOURCES` (affinity_matvec.cu, whose unrolled register tiles take
minutes of nvcc where every other source takes under one) link into a
second library, loaded at the first call of one of its functions:
`start_background_build()` compiles it on a thread of its own, so a
program can build, load and use the rest meanwhile. `library()` holds
both behind one namespace.

Every C entry point takes its tensors as raw device pointers plus the
current CUDA stream, launches, and returns `cudaGetLastError()`; `check`
raises on anything but 0.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the sources of the second library (module docstring); their C entry
# points all start with "<source>_"
LATE_SOURCES = ("affinity_matvec",)
# seconds from the start of a build in this process to each source's
# object, by source stem (the sources compile in parallel, so the longest
# is the build's wall time)
COMPILE_SECONDS: dict[str, float] = {}

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
L = ctypes.c_longlong
IP = ctypes.POINTER(ctypes.c_int)

# C entry points: name -> argtypes (all return the int cudaError_t)
SIGNATURES = {
    # x, proj, bias, out, n, d, n_tables, n_proj, points a thread,
    # points a block, threads, smem_bytes, seg, stream
    "lsh_hash_launch": (P, P, P, P, I, I, I, I, I, I, I, I, F, P),
    # vc, center, radius, valid, dist, ok, neg, rows, per_seed, d, route
    # (ring, rows), stage_rows, stream
    "roi_filter_launch": (P, P, P, P, P, P, P, I, I, I, I, I, P),
    # q, q_idx, c, c_idx, w, out, batch, m, n, d, k, smem_rows, rows,
    # classes, ubits, tc, groups, gpp, smem_bytes, stream
    "affinity_matvec_launch": (P, P, P, P, P, P, I, I, I, I, F, I, I, I, I,
                               I, I, I, I, P),
    # v, idx, mask, x, ax, it, cv, x_out, ax_out, it_out, cv_out,
    # batch, cap, d, k, n_steps, max_iters, tol, refresh_every,
    # support_eps, cluster, threads, rows_per, smem_rows, smem_bytes, stream
    "lid_sweep_launch": (P, P, P, P, P, P, P, P, P, P, P, I, I, I, F, I, I,
                         F, I, F, I, I, I, I, I, P),
    # q, sup_v, sup_w, dens, valid, scores, labels, bscore,
    # m, n_clusters, a_cap, d, path, rows, slices, smem_bytes, k,
    # threshold, stream
    "assign_launch": (P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, F,
                      P),
    # q, c, out, qp, q2, cp, c2, batch, m, n, d, ng, tile, stages,
    # symmetric, smem_bytes, k, stream
    "affinity_launch": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F,
                        P),
    # q, k, v, kv_start, out, batch, h, hkv, sq, sk, dh, q, k and v
    # strides (b, h, s), q_offset, causal, window, chunk, softcap, scale,
    # is_bf16, path (tiles, split, small, wgmma), hb, ppt, bc, smem_bytes,
    # batch_on_z, n_split, split_lo, split_len, vec, scratch, lse (the
    # wgmma route's, or null), stream
    "flash_attention_launch": (P, P, P, P, P, I, I, I, I, I, I, L, L, L, L,
                               L, L, L, L, L, I, I, I, I, F, F, I, I, I, I,
                               I, I, I, I, I, I, I, P, P, P),
    # q, k, v, o, dout, dq, dk, dv, lse, dsum, batch, h, hkv, sq, sk, dh,
    # q, k and v strides (b, h, s), causal, window, chunk, softcap, scale,
    # is_bf16, path (0: tiles), hb, ppt, rp, bc, bk, dq smem bytes, dkdv
    # smem bytes, stream
    "flash_attention_bwd_launch": (P, P, P, P, P, P, P, P, P, P, I, I, I, I,
                                   I, I, L, L, L, L, L, L, L, L, L, I, I, I,
                                   F, F, I, I, I, I, I, I, I, I, I, P),
    # q, k, v, o, dout, dq, dk, dv, batch, h, hkv, sq, sk, dh, q, k and v
    # strides (b, h, s), causal, window, chunk, softcap, scale, is_bf16,
    # problems a block, smem bytes, stream
    "flash_bwd_small_launch": (P, P, P, P, P, P, P, P, I, I, I, I, I, I, L,
                               L, L, L, L, L, L, L, L, I, I, I, F, F, I, I,
                               I, P),
    # q, k, v, o, dout, dq, dk, dv, lse, dsum, batch, h, hkv, sq, sk, dh,
    # q, k and v strides (b, h, s), causal, window, chunk, softcap, scale,
    # hb, ppt, dq smem bytes, dkdv smem bytes, stream
    "flash_bwd_wgmma_launch": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                               I, L, L, L, L, L, L, L, L, L, I, I, I, F, F,
                               I, I, I, I, P),
    # msg, perm, bounds, out, n_seg, d, is_bf16, vec, group, stream
    "segment_matmul_launch": (P, P, P, P, L, I, I, I, I, P),
    # d_out, seg_ids, d_msg, n_rows, n_seg, d, is_bf16, ids64, vec, stream
    "segment_matmul_bwd_launch": (P, P, P, L, L, I, I, I, I, P),
    # table, v_rows, idx, bag_ids, idx64, scratch, out, n, n_bags, dim,
    # is_bf16, vec, group, mean, stream
    "embedding_bag_launch": (P, L, P, P, I, P, P, L, I, I, I, I, I, I, P),
    # d_out, bag_ids, counts (or null), perm, bounds, d_table, v_rows, dim,
    # n_bags, is_bf16, ids64, vec, group, stream
    "embedding_bag_bwd_launch": (P, P, P, P, P, P, L, I, I, I, I, I, I, P),
    # stream (a kernel that does nothing: the floor of one launch)
    "empty_launch": (P,),
}
# the fit's four kernels on bf16 points: the f32 entry point's arguments
for _name in ("lsh_hash", "roi_filter", "affinity_matvec", "lid_sweep"):
    SIGNATURES[f"{_name}_bf16_launch"] = SIGNATURES[f"{_name}_launch"]
# the sources whose kernels' static shared bytes can be queried
# (`static_smem`, csrc/static_smem.cuh)
STATIC_SMEM_SOURCES = ("lsh_hash", "roi_filter", "affinity_matvec",
                       "lid_sweep", "assign", "affinity", "flash_attention",
                       "flash_wgmma", "flash_wgmma_lse",
                       "flash_attention_bwd", "flash_bwd_small",
                       "flash_bwd_wgmma",
                       "embedding_bag",
                       "segment_matmul", "segment_bwd")
for _name in STATIC_SMEM_SOURCES:
    # int* bytes
    SIGNATURES[f"{_name}_static_smem"] = (IP,)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _is_late(name: str) -> bool:
    return name.startswith(tuple(f"{src}_" for src in LATE_SOURCES))


def build(late: bool = False) -> Path:
    """Compile the late sources (`late`) or the others into
    `_build/libreprokernels-<hash>[-late].so` unless that library exists
    already, and return its path. The hash covers every source, so an
    edited source rebuilds both. A build writes the ptxas report
    (registers, shared memory, spills) to `_build/ptxas[-late].txt`."""
    every = sorted(CSRC.glob("*.cu"))
    sources = [src for src in every if (src.stem in LATE_SOURCES) == late]
    tag = "-late" if late else ""
    lib_path = BUILD_DIR / f"libreprokernels-{_digest(every)}{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        t0 = time.perf_counter()
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            log = Path(tmp) / (src.stem + ".log")
            objs.append(obj)
            with open(log, "w") as out:
                procs.append((src, log, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=out, stderr=subprocess.STDOUT)))
        pending = list(procs)
        while pending:
            for item in list(pending):
                if item[2].poll() is not None:
                    COMPILE_SECONDS[item[0].stem] = time.perf_counter() - t0
                    pending.remove(item)
            if pending:
                time.sleep(0.05)
        reports = []
        for src, log, proc in procs:
            out = log.read_text()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
            reports.append(out)
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (BUILD_DIR / f"ptxas{tag}.txt").write_text("".join(reports))
        os.replace(tmp_lib, lib_path)
    return lib_path


_late_lock = threading.Lock()
_late_build: "concurrent.futures.Future | None" = None


def start_background_build() -> None:
    """Start building the late library on a thread of its own (once; the
    thread ends when nvcc does, and the interpreter waits for it)."""
    global _late_build
    with _late_lock:
        if _late_build is None:
            pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
            _late_build = pool.submit(build, True)
            pool.shutdown(wait=False)


def _load(path: Path, late: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        if _is_late(name) == late:
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


class _Library:
    """The two loaded libraries behind one namespace: a late source's
    function loads the late library at its first call, waiting for its
    build if it has not ended (or building it then, if nothing started
    it)."""

    def __init__(self) -> None:
        self._main = _load(build(), late=False)
        self._late: "ctypes.CDLL | None" = None

    def __getattr__(self, name: str):
        # called once a name: the function found is kept as an attribute
        if _is_late(name):
            start_background_build()
            path = _late_build.result()
            with _late_lock:
                if self._late is None:
                    self._late = _load(path, late=True)
            fn = getattr(self._late, name)
        else:
            fn = getattr(self._main, name)
        setattr(self, name, fn)
        return fn


@functools.lru_cache(maxsize=1)
def library() -> _Library:
    """The loaded kernel libraries (the first built at first call, the
    late one at the first call of one of its functions)."""
    return _Library()


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")


def empty_kernel(device) -> None:
    """Launch a kernel that does nothing on `device`'s current stream: its
    device time is the floor of one launch."""
    check("empty", library().empty_launch(stream_ptr(device)))


def static_smem(source: str) -> int:
    """The most static `__shared__` bytes that any kernel of
    `csrc/<source>.cu` declares, read from the loaded module by
    cudaFuncGetAttributes (needs the card)."""
    bytes_ = ctypes.c_int(0)
    check(f"{source} static shared memory query",
          getattr(library(), f"{source}_static_smem")(ctypes.byref(bytes_)))
    return bytes_.value


def stream_ptr(device) -> int:
    """The current CUDA stream of `device`, as the pointer a launch takes."""
    return torch.cuda.current_stream(device).cuda_stream
