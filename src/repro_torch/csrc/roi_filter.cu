// CIVS ROI filter: distance of every candidate to its seed's ROI center,
// the radius + validity mask, and the -dist scores top-delta ranks.
//
// Replaces the TPU kernel `roi_filter_pallas` (src/repro/kernels/
// roi_filter.py, `_roi_kernel`). For candidate rows vc (B*C, d) f32, where
// the C rows of seed b sit at rows [b*C, (b+1)*C), centers (B, d), radii
// (B,) and a validity mask (B*C,) it writes dist = sqrt(sum((v - c)^2)) (the
// DIRECT form, not the |v|^2 + |c|^2 - 2vc expansion), ok = valid & (dist
// <= r) and neg = -dist where ok, else -inf. The seed batch, which the JAX
// package vmapped, is the row blocks of one launch.
//
// What bounds it on an H100: bytes. Each row is read once (d f32 or bf16)
// and three scalars are written; at the main path's B = 32, C = 7168, d =
// 128 that is ~118 MB (f32) or ~60 MB (bf16), 35 / 18 us at 3.35 TB/s,
// against 3 flops per element. Reading a row once is all it does, so what
// it needs is enough bytes in flight, and two routes
// (kernels/roi_filter.py `plan`) get them:
//
// 1. "ring": a persistent grid, as many blocks as the SMs hold, walks the
//    rows in chunks of R contiguous rows (R a multiple of 8, at least 2 KB:
//    one group of 8 rows at d = 128), chunk c to warp c mod W (W the
//    grid's warps). Each warp streams its chunks through its own ring of
//    stages in shared memory: one lane issues a 1-D bulk copy
//    (`cp.async.bulk`, the TMA's plain form: a chunk's rows are
//    contiguous) that completes on the stage's mbarrier, and refills the
//    stage as soon as the warp has reduced it, so the warp keeps the next
//    chunk in flight while it reduces one and no warp waits on another.
//    Small stages let an SM hold many warps, hence many chunks in flight:
//    on the card two stages of one group beat deeper rings of fewer warps
//    (kStages, kRingWarps below). A warp reduces 8 rows
//    at once: lane l keeps each row's running sum of squares at t = l, l +
//    32, ..., read from the staged row by column index (no bank
//    conflict), and a reduce-scatter of the 8 x 32 sums over the lanes (9
//    shuffles instead of 40) leaves lane 4k with row k's total. Its adds
//    are the pairs of the halving tree, each once, so the sum is the
//    pinned order of kernels/ref.py.
// 2. "rows": one warp a row and 8 rows a 256-thread block, read in place
//    with scalar loads, a warp's running sums combined by a butterfly of
//    shuffles. It keeps one row in flight a warp; the plan takes it below
//    a row count where the ring's set-up costs more than it saves, and
//    where the rows are not 16-byte aligned.
//
// Both routes sum in the pinned order, so the kernel gives its plain
// version's bits. Rows whose valid flag is false may hold NaN or Inf:
// they come out ok = false, neg = -inf, and no other row reads them. The
// candidate rows may be stored as f32 or bf16 (the centre and radii are
// f32): a bf16 element is widened to f32 as it is read, exactly, so on
// bf16 rows the kernel gives the bits it gives on the upcast rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "static_smem.cuh"

namespace {

constexpr int kThreads = 256;           // the rows route's block
// The ring's stages a warp and warps a block (kernels/roi_filter.py
// STAGES, RING_WARPS mirror them). On the card (H100) the throughput
// followed the warps an SM holds, not the bytes each keeps in flight:
// two stages of one 8-row group ran fastest, three or four stages and
// 4 KB bf16 stages slower, 8 warps a block no faster (PERF.md, the
// roi_filter row's sweep).
constexpr int kStages = 2;
constexpr int kRingWarps = 4;
constexpr int kGroup = 8;               // rows a warp reduces at once

// ---- mbarriers and the 1-D bulk copy (PTX; sm_90) ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(tx)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// to shared memory, completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a staged element, widened exactly
__device__ __forceinline__ float staged(const float* p) { return *p; }
__device__ __forceinline__ float staged(const __nv_bfloat16* p) {
  const unsigned short u = *reinterpret_cast<const unsigned short*>(p);
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// One step of the reduce-scatter: each lane holds N running sums (rows);
// the lanes whose bit `off` is clear keep rows [0, N/2) and those whose bit
// is set rows [N/2, N), each adding its partner's (lane ^ off) copy.
// Either lane of a pair adds the same two numbers (IEEE addition
// commutes), so every step is one level of the halving tree.
template <int N>
__device__ __forceinline__ void scatter_step(float (&acc)[kGroup], int off,
                                             bool upper) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float keep = upper ? acc[N / 2 + i] : acc[i];
    const float give = upper ? acc[i] : acc[N / 2 + i];
    acc[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, give, off));
  }
}

// acc[k]: lane l's running sum l of row k (k < 8). Returns, in lane 4k,
// row k's halving-tree total over the 32 running sums: offsets 16, 8, 4
// scatter the rows over the lane bits 4, 3, 2 (row k = bit4 * 4 + bit3 *
// 2 + bit2), offsets 2, 1 finish each row's tree within its four lanes.
__device__ __forceinline__ float reduce_rows8(float (&acc)[kGroup],
                                              int lane) {
  scatter_step<8>(acc, 16, (lane & 16) != 0);
  scatter_step<4>(acc, 8, (lane & 8) != 0);
  scatter_step<2>(acc, 4, (lane & 4) != 0);
  float s = acc[0];
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
  return s;
}

// 1. "ring": warp w of the grid streams the chunks w, w + W, w + 2W, ...
// (W the grid's warps) through its own kStages shared-memory stages of
// `stage_rows` rows, each filled by one bulk copy that completes on the
// stage's mbarrier; it refills a stage as soon as its rows are reduced.
template <class T>
__global__ void __launch_bounds__(32 * kRingWarps)
    roi_ring_kernel(const T* __restrict__ vc,
                    const float* __restrict__ center,
                    const float* __restrict__ radius,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ dist, uint8_t* __restrict__ ok,
                    float* __restrict__ neg, int rows, int per_seed, int d,
                    int stage_rows) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kRingWarps][kStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row_bytes = static_cast<long>(d) * sizeof(T);
  const long stage_bytes = stage_rows * row_bytes;
  const int n_chunks = (rows + stage_rows - 1) / stage_rows;
  const int stride = gridDim.x * kRingWarps;
  const int first = blockIdx.x * kRingWarps + warp;
  unsigned char* mine = ring + static_cast<long>(warp) * kStages * stage_bytes;
  uint64_t* bar = full[warp];
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // chunk c into stage s, by lane 0: one bulk copy of the bytes up to a
  // multiple of 16, the tail (< 8 elements, the launch's last chunk only)
  // by hand before the arrive that publishes both
  auto issue = [&](int c, int s) {
    const long r0 = static_cast<long>(c) * stage_rows;
    const long nr = rows - r0 < stage_rows ? rows - r0 : stage_rows;
    const uint32_t bytes = static_cast<uint32_t>(nr * row_bytes);
    const uint32_t bulk = bytes & ~15u;
    unsigned char* dst = mine + s * stage_bytes;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(vc) + r0 * row_bytes;
    for (uint32_t e = bulk / sizeof(T); e < bytes / sizeof(T); ++e) {
      reinterpret_cast<T*>(dst)[e] = reinterpret_cast<const T*>(src)[e];
    }
    mbar_arrive_tx(&bar[s], bulk);
    if (bulk > 0) bulk_copy(dst, src, bulk, &bar[s]);
  };
  if (lane == 0) {
    for (int i = 0; i < kStages && first + i * stride < n_chunks; ++i) {
      issue(first + i * stride, i);
    }
  }

  int s = 0;
  uint32_t phase = 0;
  for (int c = first; c < n_chunks; c += stride) {
    const int r0 = c * stage_rows;
    const int nr = rows - r0 < stage_rows ? rows - r0 : stage_rows;
    mbar_wait(&bar[s], phase);
    const T* buf = reinterpret_cast<const T*>(mine + s * stage_bytes);
    for (int g0 = 0; g0 < nr; g0 += kGroup) {
      const int row0 = r0 + g0;
      const int last = row0 + (nr - g0 < kGroup ? nr - g0 : kGroup) - 1;
      // lane 4k's row: its seed, flag and radius, read before the sums
      const int row = row0 + (lane >> 2);
      const bool writer = (lane & 3) == 0 && row <= last;
      int rb = 0;
      bool rv = false;
      float rr = 0.f;
      if (writer) {
        rb = row / per_seed;
        rv = valid[row] != 0;
        rr = __ldg(radius + rb);
      }
      const int b0 = row0 / per_seed;
      const T* v = buf + static_cast<long>(g0) * d;
      float acc[kGroup] = {};
      if (last / per_seed == b0) {
        // one seed: its centre's element read once for the 8 rows
        const float* cen = center + static_cast<long>(b0) * d;
#pragma unroll 4
        for (int t = lane; t - lane < d; t += 32) {
          const bool in = t < d;
          const float cv = __ldg(cen + (in ? t : 0));
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            const float x = staged(v + k * d + (in ? t : 0));
            const float diff = __fsub_rn(x, cv);
            const float sq = in ? __fmul_rn(diff, diff) : 0.f;
            acc[k] = t == lane ? sq : __fadd_rn(acc[k], sq);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const int rk = row0 + k <= last ? row0 + k : last;
          const float* cen = center + static_cast<long>(rk / per_seed) * d;
          for (int t = lane; t - lane < d; t += 32) {
            const bool in = t < d;
            const float diff = __fsub_rn(staged(v + k * d + (in ? t : 0)),
                                         __ldg(cen + (in ? t : 0)));
            const float sq = in ? __fmul_rn(diff, diff) : 0.f;
            acc[k] = t == lane ? sq : __fadd_rn(acc[k], sq);
          }
        }
      }
      const float tot = reduce_rows8(acc, lane);
      if (writer) {
        const float dd = sqrtf(tot);
        const bool keep = rv && dd <= rr;
        dist[row] = dd;
        ok[row] = keep ? 1 : 0;
        neg[row] = keep ? -dd : -INFINITY;
      }
    }
    __syncwarp();
    if (lane == 0 && c + kStages * stride < n_chunks) {
      issue(c + kStages * stride, s);
    }
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
}

// 2. "rows"
template <class T>
__global__ void roi_rows_kernel(const T* __restrict__ vc,
                                const float* __restrict__ center,
                                const float* __restrict__ radius,
                                const uint8_t* __restrict__ valid,
                                float* __restrict__ dist,
                                uint8_t* __restrict__ ok,
                                float* __restrict__ neg, long rows,
                                int per_seed, int d) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * (blockDim.x / 32) +
                   (threadIdx.x >> 5);
  if (row >= rows) return;
  const long b = row / per_seed;
  const T* v = vc + row * d;
  const float* c = center + b * d;
  // lane l: the running sum of the squares at t = l, l + 32, ... (the
  // pinned order of kernels/ref.py), then the butterfly over the lanes
  float acc = 0.f;
  for (int t = lane; t - lane < d; t += 32) {
    float sq = 0.f;
    if (t < d) {
      const float diff =
          __fsub_rn(repro_kernels::load_f32(v + t), c[t]);
      sq = __fmul_rn(diff, diff);
    }
    acc = t == lane ? sq : __fadd_rn(acc, sq);
  }
  acc = repro_kernels::warp_tree32(acc);
  if (lane == 0) {
    const float dd = sqrtf(acc);
    const bool keep = valid[row] != 0 && dd <= radius[b];
    dist[row] = dd;
    ok[row] = keep ? 1 : 0;
    neg[row] = keep ? -dd : -INFINITY;
  }
}

template <class T>
int launch(const T* vc, const float* center, const float* radius,
           const uint8_t* valid, float* dist, uint8_t* ok, float* neg,
           int rows, int per_seed, int d, int route, int stage_rows,
           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (route == 0) {
    const long smem = static_cast<long>(kRingWarps) * kStages * stage_rows *
                      d * static_cast<long>(sizeof(T));
    if (stage_rows <= 0 || stage_rows % kGroup != 0 || smem > INT32_MAX ||
        (reinterpret_cast<uintptr_t>(vc) & 15) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int smem_bytes = static_cast<int>(smem);
    // opt in to every size asked (its static barriers count against the
    // 48 KB a block has without it)
    static int limit = 0;
    if (smem_bytes > limit) {
      const cudaError_t err = cudaFuncSetAttribute(
          roi_ring_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      limit = smem_bytes;
    }
    // a persistent grid: a block for every kRingWarps chunks, no more
    // blocks than the SMs hold at once
    static int last_smem = -1, resident = 0;
    if (smem_bytes != last_smem) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      }
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, roi_ring_kernel<T>, 32 * kRingWarps, smem_bytes);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm <= 0) return static_cast<int>(cudaErrorInvalidValue);
      resident = per_sm * sms;
      last_smem = smem_bytes;
    }
    const int chunks = (rows + stage_rows - 1) / stage_rows;
    const int blocks = (chunks + kRingWarps - 1) / kRingWarps;
    roi_ring_kernel<T>
        <<<blocks < resident ? blocks : resident, 32 * kRingWarps,
           smem_bytes, st>>>(vc, center, radius, valid, dist, ok, neg, rows,
                             per_seed, d, stage_rows);
  } else if (route == 1) {
    const int per_block = kThreads / 32;
    const int grid = (rows + per_block - 1) / per_block;
    roi_rows_kernel<T><<<grid, kThreads, 0, st>>>(
        vc, center, radius, valid, dist, ok, neg, rows, per_seed, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vc is f32 (roi_filter_launch) or bf16 (roi_filter_bf16_launch); route 0
// = ring (stage_rows rows a stage, a multiple of 8; vc 16-byte aligned),
// 1 = rows (stage_rows unread)
extern "C" int roi_filter_launch(const float* vc, const float* center,
                                 const float* radius, const uint8_t* valid,
                                 float* dist, uint8_t* ok, float* neg,
                                 int rows, int per_seed, int d, int route,
                                 int stage_rows, void* stream) {
  return launch(vc, center, radius, valid, dist, ok, neg, rows, per_seed, d,
                route, stage_rows, stream);
}

extern "C" int roi_filter_bf16_launch(const __nv_bfloat16* vc,
                                      const float* center,
                                      const float* radius,
                                      const uint8_t* valid, float* dist,
                                      uint8_t* ok, float* neg, int rows,
                                      int per_seed, int d, int route,
                                      int stage_rows, void* stream) {
  return launch(vc, center, radius, valid, dist, ok, neg, rows, per_seed, d,
                route, stage_rows, stream);
}

// the static shared bytes of this source's kernels (static_smem.cuh)
extern "C" int roi_filter_static_smem(int* bytes) {
  return repro_smem::max_static(
      {repro_smem::fn(roi_ring_kernel<float>),
       repro_smem::fn(roi_ring_kernel<__nv_bfloat16>),
       repro_smem::fn(roi_rows_kernel<float>),
       repro_smem::fn(roi_rows_kernel<__nv_bfloat16>)},
      bytes);
}
