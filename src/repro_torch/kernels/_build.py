"""Build and load the hand-written CUDA kernels of `repro_torch/csrc/`.

At first use every `csrc/*.cu` is compiled for Hopper (`sm_90a`) by one
`nvcc -c` per source, all started together, and the objects are linked into
one shared library with a plain C interface, which `ctypes` loads. Nothing
includes PyTorch's headers, so a build takes seconds. The library is named
after a hash of the sources and flags, so an edited source never loads a
stale build. No `--use_fast_math`: the kernels need IEEE `expf`, `sqrtf`
and division.

Every C entry point takes its tensors as raw device pointers plus the
current CUDA stream, launches, and returns `cudaGetLastError()`; `check`
raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    # vc, center, radius, valid, dist, ok, neg, rows, per_seed, d, stream
    "roi_filter_launch": (P, P, P, P, P, P, P, I, I, I, P),
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
    # batch_on_z, n_split, split_lo, split_len, vec, scratch, stream
    "flash_attention_launch": (P, P, P, P, P, I, I, I, I, I, I, L, L, L, L,
                               L, L, L, L, L, I, I, I, I, F, F, I, I, I, I,
                               I, I, I, I, I, I, I, P, P),
    # msg, perm, bounds, out, n_seg, d, is_bf16, vec, group, stream
    "segment_matmul_launch": (P, P, P, P, L, I, I, I, I, P),
    # table, v_rows, idx, bag_ids, idx64, scratch, out, n, n_bags, dim,
    # is_bf16, vec, group, mean, stream
    "embedding_bag_launch": (P, L, P, P, I, P, P, L, I, I, I, I, I, I, P),
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
                       "flash_wgmma", "embedding_bag", "segment_matmul")
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


def build() -> Path:
    """Compile the sources into `_build/libreprokernels-<hash>.so` unless
    that library exists already, and return its path. A build writes the
    ptxas report (registers, shared memory, spills) to `_build/ptxas.txt`.
    """
    sources = sorted(CSRC.glob("*.cu"))
    lib_path = BUILD_DIR / f"libreprokernels-{_digest(sources)}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        reports = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
            reports.append(out)
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (BUILD_DIR / "ptxas.txt").write_text("".join(reports))
        os.replace(tmp_lib, lib_path)
    return lib_path


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


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
