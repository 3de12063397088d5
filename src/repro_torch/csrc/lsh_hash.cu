// p-stable LSH bucket keys: projection, floor-quantize, per-table fold.
//
// Replaces the TPU kernel `lsh_hash_pallas` (src/repro/kernels/lsh_hash.py,
// `_lsh_kernel`). For x (n, d) f32, proj (L*m, d) f32 and bias (L*m,) f32 it
// computes z = x . proj^T + bias in f32, h = floor(z / seg_len) with IEEE
// division by the f32-rounded seg_len (never a reciprocal multiply), and per
// table l the fold acc = 0x811C9DC5; acc = (acc ^ h) * 0x9E3779B1 mod 2^32;
// acc ^= acc >> 15 over its m words. Keys are written as int32 bits (n, L).
//
// Both routes sum a projection in one order: one fused multiply-add chain
// over t = 0 .. d-1 from 0, then + bias. It is not the plain version's
// pinned order, so a key flips where z / seg_len lies within rounding of an
// integer; keys are integers and a flip moves one point to a neighbouring
// bucket of one table, which the checks count and bound
// (kernels/lsh_hash.py `key_flips`). One order for both routes keeps a
// point's keys the same whichever route hashes it (the store build and the
// CIVS probes meet in the buckets).
//
// What bounds it on an H100: at the store build (d = 128, L*m = 32, 10^6
// points) 512 MB of reads, ~0.153 ms, against 4.1e9 FMAs, ~0.122 ms: the
// two are balanced. A block takes one tile of points: it copies the
// projections and the tile into shared memory by cp.async, all copies in
// flight at once, then each thread computes a register tile of points x 4
// projections (the tile's points pg + (pts / P) i and projections qg + 8 k,
// so that a warp's float4 loads touch each 16-byte bank group once), and
// the block folds the words into keys. Two blocks share an SM, so that one
// block's copies overlap the other's FMAs. Two routes of that kernel:
// "stream" for the store build (128 points a block, a thread 4 points x 4
// projections: 8 shared loads for 64 FMAs) and "probe" for the CIVS probes
// (3,584 points: 32 points a block, a thread one point, so that 112 blocks
// spread the ~2 us of one SM's FMAs over the card and the launch and the
// first copies set the time). Measured slower on the card (H100 80GB HBM3
// at 700 W): persistent blocks with double-buffered tiles (0.46 ms against
// 0.39 at 10^6 points), a tile copied in two halves, the first half's
// products overlapping the second half's copies (0.46), 2 points a thread
// (0.47), and at the probe 2 or 4 points a thread (0.0064, 0.0093 ms
// against 0.0063).
//
// x may be stored as f32 or bf16 (proj and bias stay f32): bf16 points are
// loaded 4 at a time (8 bytes) and widened to f32 as the tile is staged, so
// the shared tile, the FMA chains and the keys are those of the upcast f32
// points, bit for bit; the f32 tile is copied by cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"
#include "static_smem.cuh"

// A profiling build (launch/profile_kernel_phases.py, -DDROP_PHASE=n) takes
// one phase out to time it: 1 the projections' FMA chains, 2 the copies of
// the points, 3 the division (floor(z / seg) becomes a multiply), 4 the
// keys' fold and stores. Its keys are wrong; the library's build is 0,
// which changes no instruction. The runtime tests on seg > 0 keep the
// compiler from removing what the dropped phase fed.
#ifndef DROP_PHASE
#define DROP_PHASE 0
#endif

namespace {

namespace sm90 = repro_kernels::sm90;

constexpr int kThreads = 256;  // the most threads a block
constexpr int kQ = 4;          // projections of a thread

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   sm90::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// floor(z / seg) of z = acc + bias, converted with saturation (NaN -> 0)
__device__ __forceinline__ int32_t quantize(float acc, float bias,
                                            float seg) {
  return __float2int_rd(DROP_PHASE == 3
                            ? __fmul_rn(__fadd_rn(acc, bias), seg)
                            : __fdiv_rn(__fadd_rn(acc, bias), seg));
}

// the multiply-xor fold of one table's m words
__device__ __forceinline__ int32_t fold(const int32_t* h, int n_proj) {
  uint32_t acc = 0x811C9DC5u;
#pragma unroll 8
  for (int j = 0; j < n_proj; ++j) {
    acc = (acc ^ static_cast<uint32_t>(h[j])) * 0x9E3779B1u;
    acc ^= acc >> 15;
  }
  return static_cast<int32_t>(acc);
}

// --------------------------------------------------------------- tiles ---
// One tile of `pts` points a block: the projections and the tile copied
// into shared memory (every copy issued at once), then each thread a P x
// kQ register tile (points pg + (pts / P) i, projections qg + G k for G =
// ceil(L m / kQ)), the words into hs (rows L m + 1 apart), and a thread a
// (point, table) for the fold.
template <class T, int P>
__global__ void __launch_bounds__(kThreads) lsh_tile_kernel(
    const T* __restrict__ x, const float* __restrict__ proj,
    const float* __restrict__ bias, int32_t* __restrict__ out, int n, int d,
    int n_tables, int n_proj, int pts, float seg, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lm = n_tables * n_proj;
  const int groups = (lm + kQ - 1) / kQ;
  const int dp = (d + 3) & ~3;
  // rows 16 bytes past a multiple of 128: consecutive rows, one bank group
  // apart
  const int ldx = ((dp + 31) & ~31) + 4;
  const int ldh = lm + 1;
  float* ps = smem;                             // (G kQ, ldx)
  float* xs = ps + groups * kQ * ldx;           // (pts, ldx)
  int32_t* hs = reinterpret_cast<int32_t*>(xs + pts * ldx);
  const long base = static_cast<long>(blockIdx.x) * pts;
  const int rows = static_cast<int>(min(static_cast<long>(pts), n - base));
  // the projections (zero past d and past L m) and the tile (zero past d)
  const int d4 = dp >> 2;
  for (int e = threadIdx.x; e < groups * kQ * d4; e += blockDim.x) {
    const int r = e / d4, c = 4 * (e - r * d4);
    if (vec && r < lm) {
      sm90::cp_async16(sm90::smem_addr(ps + r * ldx + c), proj + r * d + c,
                       true);
    } else {
      for (int u = 0; u < 4; ++u) {
        ps[r * ldx + c + u] = r < lm && c + u < d ? proj[r * d + c + u] : 0.f;
      }
    }
  }
  const int copies = DROP_PHASE == 2 && seg > 0.f ? 0 : rows * d4;
  if constexpr (!std::is_same<T, float>::value) {
    // bf16 points: 4 elements (8 bytes) a load, each widened (its bits
    // above 16 zero bits); a thread has four loads in flight (clamped to
    // the tile, so that they issue unconditionally) before its stores
    for (int e0 = threadIdx.x; e0 < copies; e0 += 4 * blockDim.x) {
      float4 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = min(e0 + q * static_cast<int>(blockDim.x), copies - 1);
        const int r = e / d4, c = 4 * (e - r * d4);
        const T* src = x + (base + r) * d + c;
        if (vec) {
          const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
          v[q].x = __uint_as_float(u.x << 16);
          v[q].y = __uint_as_float(u.x & 0xffff0000u);
          v[q].z = __uint_as_float(u.y << 16);
          v[q].w = __uint_as_float(u.y & 0xffff0000u);
        } else {
          v[q].x = repro_kernels::load_f32(src);
          v[q].y = c + 1 < d ? repro_kernels::load_f32(src + 1) : 0.f;
          v[q].z = c + 2 < d ? repro_kernels::load_f32(src + 2) : 0.f;
          v[q].w = c + 3 < d ? repro_kernels::load_f32(src + 3) : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = e0 + q * static_cast<int>(blockDim.x);
        const int r = e / d4, c = 4 * (e - r * d4);
        if (e < copies) *reinterpret_cast<float4*>(xs + r * ldx + c) = v[q];
      }
    }
  } else {
    for (int e = threadIdx.x; e < copies; e += blockDim.x) {
      const int r = e / d4, c = 4 * (e - r * d4);
      const float* src = x + (base + r) * d + c;
      if (vec) {
        sm90::cp_async16(sm90::smem_addr(xs + r * ldx + c), src, true);
      } else {
        for (int u = 0; u < 4; ++u) {
          if (c + u < d) {
            cp_async4(xs + r * ldx + c + u, src + u);
          } else {
            xs[r * ldx + c + u] = 0.f;
          }
        }
      }
    }
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
  const int pgs = pts / P;
  for (int item = threadIdx.x; item < pgs * groups; item += blockDim.x) {
    const int qg = item % groups, pg = item / groups;
    const float* xr = xs + pg * ldx;
    const float* pr = ps + qg * ldx;
    float b[kQ];
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      b[k] = __ldg(bias + min(qg + groups * k, lm - 1));
    }
    float acc[P][kQ];
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int k = 0; k < kQ; ++k) acc[i][k] = 0.f;
    }
    // rows past `rows` hold stale shared memory: never stored
#pragma unroll 4
    for (int j = 0; j < (DROP_PHASE == 1 && seg > 0.f ? 0 : dp); j += 4) {
      float4 a[P], w[kQ];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        a[i] = *reinterpret_cast<const float4*>(xr + i * pgs * ldx + j);
      }
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        w[k] = *reinterpret_cast<const float4*>(pr + k * groups * ldx + j);
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          acc[i][k] = fmaf(a[i].x, w[k].x, acc[i][k]);
          acc[i][k] = fmaf(a[i].y, w[k].y, acc[i][k]);
          acc[i][k] = fmaf(a[i].z, w[k].z, acc[i][k]);
          acc[i][k] = fmaf(a[i].w, w[k].w, acc[i][k]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int p = pg + pgs * i;
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        const int q = qg + groups * k;
        if (p < rows && q < lm) {
          hs[p * ldh + q] = quantize(acc[i][k], b[k], seg);
        }
      }
    }
  }
  __syncthreads();
  const int keys = DROP_PHASE == 4 && seg > 0.f ? 0 : rows * n_tables;
  for (int e = threadIdx.x; e < keys; e += blockDim.x) {
    const int p = e / n_tables, l = e - p * n_tables;
    out[(base + p) * n_tables + l] = fold(hs + p * ldh + l * n_proj, n_proj);
  }
}

// raise the kernel's dynamic shared-memory limit only when a launch needs
// more than before, so that repeated launches (and CUDA graph captures of
// them) make no further API call; then launch one block a tile
template <class T, int P>
int launch_tiles(int tiles, int threads, int smem_bytes, cudaStream_t st,
                 const T* x, const float* proj, const float* bias,
                 int32_t* out, int n, int d, int n_tables, int n_proj,
                 int pts, float seg, int vec) {
  static int limit = 0;
  if (smem_bytes > limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        lsh_tile_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit = smem_bytes;
  }
  lsh_tile_kernel<T, P><<<tiles, threads, smem_bytes, st>>>(
      x, proj, bias, out, n, d, n_tables, n_proj, pts, seg, vec);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(const T* x, const float* proj, const float* bias, int32_t* out,
           int n, int d, int n_tables, int n_proj, int per_thread, int pts,
           int threads, int smem_bytes, float seg, void* stream) {
  if (n_tables <= 0 || n_proj <= 0 || d < 0 || pts <= 0 ||
      (per_thread != 1 && per_thread != 4) ||
      pts % per_thread != 0 || threads <= 0 || threads > kThreads ||
      threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaSuccess);
  // rows of whole 4-element groups, each group aligned for one load
  const int vec = (d & 3) == 0 &&
                  (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T))) == 0 &&
                  (reinterpret_cast<uintptr_t>(proj) & 15) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + pts - 1) / pts;
  if (per_thread == 4) {
    return launch_tiles<T, 4>(tiles, threads, smem_bytes, st, x, proj, bias,
                              out, n, d, n_tables, n_proj, pts, seg, vec);
  }
  return launch_tiles<T, 1>(tiles, threads, smem_bytes, st, x, proj, bias,
                            out, n, d, n_tables, n_proj, pts, seg, vec);
}

}  // namespace

// The plan (points a thread: 1 or 4; points a block, threads,
// smem_bytes) comes from kernels/lsh_hash.py `plan`, whose byte count is
// the layout carved in lsh_tile_kernel. x is f32 (lsh_hash_launch) or bf16
// (lsh_hash_bf16_launch).
extern "C" int lsh_hash_launch(const float* x, const float* proj,
                               const float* bias, int32_t* out, int n, int d,
                               int n_tables, int n_proj, int per_thread,
                               int pts, int threads, int smem_bytes, float seg,
                               void* stream) {
  return launch(x, proj, bias, out, n, d, n_tables, n_proj, per_thread, pts,
                threads, smem_bytes, seg, stream);
}

extern "C" int lsh_hash_bf16_launch(const __nv_bfloat16* x, const float* proj,
                                    const float* bias, int32_t* out, int n,
                                    int d, int n_tables, int n_proj,
                                    int per_thread, int pts, int threads,
                                    int smem_bytes, float seg, void* stream) {
  return launch(x, proj, bias, out, n, d, n_tables, n_proj, per_thread, pts,
                threads, smem_bytes, seg, stream);
}

// the static shared bytes of this source's kernels (static_smem.cuh)
extern "C" int lsh_hash_static_smem(int* bytes) {
  return repro_smem::max_static(
      {repro_smem::fn(lsh_tile_kernel<float, 4>),
       repro_smem::fn(lsh_tile_kernel<float, 1>),
       repro_smem::fn(lsh_tile_kernel<__nv_bfloat16, 4>),
       repro_smem::fn(lsh_tile_kernel<__nv_bfloat16, 1>)},
      bytes);
}
