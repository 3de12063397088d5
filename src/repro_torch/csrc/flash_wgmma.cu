// The prefill attention kernel on Hopper's tensor cores: the same function
// as flash_attention.cu's kernels (see there: f32 softmax over the attended
// keys, masks in logical positions, rows that attend nothing written as 0),
// for bf16 q, k and v with dh a multiple of 16 up to 128 (danube's 80,
// gemma2's 128); kernels/flash_attention.py `kernel_plan` sends it every
// such call that the split and small kernels do not take.
//
// Replaces the TPU kernel `flash_attention_pallas` (src/repro/kernels/
// flash_attention.py, `_flash_kernel`) on the prefill path, where the SIMT
// tile kernel (`flash_kernel`) ran at ~13 TFLOP/s with the tensor cores
// idle. What bounds it: operations, 4 dh per attended (query, key) pair
// (129 GFLOP for danube's 5,120-token prompt, 0.13 ms at the bf16
// tensor-core peak of 989 TFLOP/s). The design:
//  - a block takes up to 128 query rows that share a kv head: the rep
//    heads of the kv head times as many positions as fit (4 x 32 for
//    danube), one warpgroup (128 threads) for each 64 rows, so that each
//    K / V tile serves every head of the group and every position: K / V
//    come from L2 once for 128 rows, which halved the kernel's time
//    against 64-row blocks (the L2 traffic of the tiles bounded it);
//  - Q.K^T: `wgmma` m64n64k16, Q and the 64-key K tile read from shared
//    memory, the scores accumulated in f32 registers. Products of bf16 are
//    exact in f32: only the order of the sum differs from the plain
//    version;
//  - the kv loop covers only the slots that some row of the tile attends
//    (the window, the chunk, kv_start, causality), in tiles of 64 keys; the
//    mask is evaluated only on tiles that one of its boundaries crosses;
//  - the online softmax in registers, in base 2: a row's 64 scores lie in
//    the four lanes of a quad, so its max takes two shuffles; without a
//    softcap the scale folds into one fused multiply-add before the SFU's
//    exp2, and the rescale of the f32 output accumulators stays in
//    registers. With the loads halved, this arithmetic is what the kernel
//    spends most of its time on;
//  - P.V: P (f32) is split into hi = bf16(P) and lo = bf16(P - hi) and
//    both multiply the same V tile (`wgmma` with A from registers, the
//    accumulator layout of the scores being the A operand's layout), so P
//    enters the sum exact to about 2^-16 of itself: one rounding of P to
//    bf16 (2^-9) breaks the plain version's 1e-5 rule where the weighted
//    sum cancels near 0;
//  - K and V tiles stream through a two-stage ring of cp.async copies: the
//    next tile loads while the current one is computed; a block of two
//    warpgroups holds 864 dh bytes of shared memory (69 KB at dh 80) and
//    at most 128 registers a thread, so two blocks share an SM;
//  - blocks take the query tiles last to first, so that under a causal
//    mask the longest kv ranges start first; a tile whose rows attend
//    nothing (the pad queries of a left-padded row) writes 0 and returns
//    before it loads anything.
// Tiles are stored unswizzled as 8 x 8 core matrices (wgmma.cuh), 144
// bytes apart along a row so that the copies into them do not conflict:
// any dh that is a multiple of 8 fits, and dh = 80 needs no padding to
// the 128-byte swizzle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "wgmma.cuh"
#include "static_smem.cuh"

using namespace repro_flash;
namespace sm90 = repro_kernels::sm90;

namespace {

constexpr int kRows = 64;     // query rows a warpgroup
constexpr int kKeys = 64;     // keys a kv tile
constexpr int kThreadsWg = 128;
constexpr int kCore = 144;    // bytes between a row's core matrices
constexpr int kStages = 2;    // K / V tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

// every real row of the tile (logical query positions qf..ql) attends every
// key of [j0, j0 + nj), so the tile needs no mask
__device__ __forceinline__ bool tile_full(const Params& p, int j0, int nj,
                                          int start, int qf, int ql) {
  if (nj < kKeys) return false;
  const int kp0 = j0 - start, kp1 = kp0 + kKeys - 1;
  if (kp0 < 0) return false;
  if (p.causal && kp1 > qf) return false;
  if (p.window > 0 && kp0 <= ql - p.window) return false;
  if (p.chunk > 0) {
    const int c = floor_div(kp0, p.chunk);
    if (floor_div(kp1, p.chunk) != c || floor_div(qf, p.chunk) != c ||
        floor_div(ql, p.chunk) != c) {
      return false;
    }
  }
  return true;
}

// P.V for one 16-key slice: dh cut into pieces of 64, 32 and 16 columns
// from column C on, one product each
template <int DH, int C = 0>
__device__ __forceinline__ void pv_slice(float (&o)[DH / 2],
                                         const uint32_t (&a)[4],
                                         uint32_t v_addr) {
  constexpr int kGroup = DH / 8 * kCore;
  const uint64_t d = sm90::desc(v_addr + C / 8 * kCore, kGroup, kCore);
  if constexpr (DH - C >= 64) {
    sm90::mma_rs_n64(o + C / 2, a, d);
    pv_slice<DH, C + 64>(o, a, v_addr);
  } else if constexpr (DH - C >= 32) {
    sm90::mma_rs_n32(o + C / 2, a, d);
    pv_slice<DH, C + 32>(o, a, v_addr);
  } else if constexpr (DH - C >= 16) {
    sm90::mma_rs_n16(o + C / 2, a, d);
  }
}

// 2^x (the SFU's approximation, relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// WG warpgroups a block; two blocks of two an SM (128 registers a thread)
template <int DH, int WG>
__global__ void __launch_bounds__(kThreadsWg * WG, WG == 2 ? 2 : 1)
    flash_wgmma_kernel(const Params p) {
  static_assert(DH % 16 == 0 && DH <= 128, "dh a multiple of 16, <= 128");
  constexpr int kThreads = kThreadsWg * WG;
  constexpr int kChunks = DH / 8;                // 16-byte chunks of a row
  constexpr int kGroup = kChunks * kCore;        // bytes of 8 rows
  constexpr uint32_t kTile = kRows / 8 * kGroup;  // bytes of a 64-row tile
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t q_addr = sm90::smem_addr(smem);      // [WG] tiles
  const uint32_t k_addr = q_addr + WG * kTile;        // [kStages] tiles
  const uint32_t v_addr = k_addr + kStages * kTile;   // [kStages] tiles

  int b, tile;
  tile_of_block(p, &b, &tile);
  const int g = blockIdx.y;
  // the last query tiles first: under a causal mask they attend the most
  const int qtile = (p.sq + p.ppt - 1) / p.ppt - 1 - tile / p.n_hc;
  const int hc = tile % p.n_hc;
  const int rep = p.h / p.hkv;
  const int s0 = qtile * p.ppt;
  const int h0 = g * rep + hc * p.hb;
  const int n_h = min(p.hb, rep - hc * p.hb);
  const int n_pos = min(p.ppt, p.sq - s0);
  const int start = p.kv_start[b];
  int lo, hi;
  kv_range(p, start, p.q_offset + s0, p.q_offset + s0 + n_pos - 1, &lo, &hi);

  // warpgroup wg computes rows 64 wg .. 64 wg + 63 of the block's tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid / kThreadsWg;
  const uint32_t q_wg = q_addr + wg * kTile;
  // this thread's two rows of the accumulator layout: r[0], r[0] + 8
  int pos[2], head[2];
  bool real[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 16 * warp + (lane >> 2) + 8 * rr;
    pos[rr] = r / p.hb;
    head[rr] = r - pos[rr] * p.hb;
    real[rr] = pos[rr] < n_pos && head[rr] < n_h;
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  auto out_row = [&](int rr) {
    return out + ((static_cast<long long>(b) * p.h + h0 + head[rr]) * p.sq +
                  s0 + pos[rr]) * DH;
  };
  if (lo > hi) {  // no row of the tile attends anything
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (!real[rr]) continue;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        *reinterpret_cast<uint32_t*>(out_row(rr) + 8 * i + 2 * (lane & 3)) =
            0u;
      }
    }
    return;
  }

  // the Q tile: row r is position s0 + r / hb of head h0 + r % hb
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
#pragma unroll 1
  for (int e = tid; e < WG * kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e - r * kChunks;
    const int pi = r / p.hb, hh = r - pi * p.hb;
    const bool ok = pi < n_pos && hh < n_h;
    const __nv_bfloat16* src =
        ok ? q + b * p.q_sb + (h0 + hh) * p.q_sh + (s0 + pi) * p.q_ss + 8 * c
           : q;
    sm90::cp_async16(q_addr + sm90::core_off(r, c, kCore, kGroup), src, ok);
  }
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + g * p.k_sh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + g * p.v_sh;
  auto load_kv = [&](int j0, int stage) {
    const int nj = min(kKeys, hi - j0 + 1);
#pragma unroll 1
    for (int e = tid; e < kKeys * kChunks; e += kThreads) {
      const int j = e / kChunks, c = e - j * kChunks;
      const bool ok = j < nj;
      const long long slot = ok ? j0 + j : j0;
      const uint32_t off =
          stage * kTile + sm90::core_off(j, c, kCore, kGroup);
      sm90::cp_async16(k_addr + off, kb + slot * p.k_ss + 8 * c, ok);
      sm90::cp_async16(v_addr + off, vb + slot * p.v_ss + 8 * c, ok);
    }
  };
  const int n_tiles = (hi - lo + kKeys) / kKeys;
  // the ring's first kStages - 1 tiles, the first in one group with the Q
  // tile; every iteration commits one group (empty past the last tile), so
  // that waiting for all but the newest kStages - 2 groups is waiting for
  // the tile about to be used
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(lo + t * kKeys, t);
    sm90::cp_async_commit();
  }

  const float scale_log2 = p.scale * kLog2e;
  const bool fold = !(p.softcap > 0.f) && p.scale > 0.f;
  const int qf = p.q_offset + s0 - start;
  const int ql = qf + n_pos - 1;
  int qp[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) qp[rr] = qf + pos[rr];

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's columns only

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = lo + t * kKeys, stage = t % kStages;
    const int nj = min(kKeys, hi - j0 + 1);
    sm90::cp_async_wait<kStages - 2>();
    sm90::fence_async_smem();
    __syncthreads();  // tile t in place; every thread done with tile t - 1
    if (t + kStages - 1 < n_tiles) {
      load_kv(j0 + (kStages - 1) * kKeys, (t + kStages - 1) % kStages);
    }
    sm90::cp_async_commit();

    // S = Q K^T (64 x 64) in f32
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sm90::fence_operand(s[i]);
    __syncwarp();
    sm90::fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      sm90::mma_ss_n64(
          s, sm90::desc(q_wg + 2 * kk * kCore, kCore, kGroup),
          sm90::desc(k_addr + stage * kTile + 2 * kk * kCore, kCore, kGroup),
          kk > 0);
    }
    sm90::commit();
    sm90::wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) sm90::fence_operand(s[i]);

    // the logits in base 2, the mask where a boundary crosses the tile, the
    // online max: s[4 i + 2 rr + e] is row rr, key 8 i + 2 (lane % 4) + e.
    // Without a softcap the scale (> 0) and log2 e fold into the exponent's
    // one fused multiply-add, so the max is taken over the raw dots.
    const bool full = tile_full(p, j0, nj, start, qf, ql);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * i + 2 * (lane & 3) + e;
          float x = s[4 * i + 2 * rr + e];
          if (!fold) x = logit(p, x) * kLog2e;
          if (!full && !(j < nj && attends(p, j0 + j - start, qp[rr]))) {
            x = -INFINITY;
          }
          s[4 * i + 2 * rr + e] = x;
          mx[rr] = fmaxf(mx[rr], x);
        }
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_run[rr], fold ? mx[rr] * scale_log2
                                                : mx[rr]);
      // a row that has attended nothing yet keeps o = l = 0 (alpha = 0)
      // and exponent -inf for every key
      m_use[rr] = m_new == -INFINITY ? 0.f : m_new;
      alpha[rr] = ex2(m_run[rr] - m_use[rr]);
      m_run[rr] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * i + 2 * rr + e];
          x = ex2(fold ? fmaf(x, scale_log2, -m_use[rr]) : x - m_use[rr]);
          sum[rr] += x;
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l_run[rr] = alpha[rr] * l_run[rr] + sum[rr];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        o[4 * i + 2 * rr] *= alpha[rr];
        o[4 * i + 2 * rr + 1] *= alpha[rr];
      }
    }

    // O += P V, P as hi + lo: key slice kk is the scores' n8 blocks 2 kk
    // and 2 kk + 1, which is the A operand's register layout; all the
    // fragments are packed before the first product is issued
    uint32_t a_hi[kKeys / 16][4], a_lo[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float x0 = s[8 * kk + 2 * f], x1 = s[8 * kk + 2 * f + 1];
        a_hi[kk][f] = pack_bf16(x0, x1);
        const __nv_bfloat162 h2 =
            *reinterpret_cast<const __nv_bfloat162*>(&a_hi[kk][f]);
        a_lo[kk][f] = pack_bf16(x0 - __low2float(h2), x1 - __high2float(h2));
      }
    }
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) sm90::fence_operand(o[i]);
    __syncwarp();
    sm90::fence();
    const uint32_t v_stage = v_addr + stage * kTile;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      // keys 16 kk .. 16 kk + 15 are two 8-row groups of the V tile
      const uint32_t va = v_stage + 2 * kk * kGroup;
      pv_slice<DH>(o, a_hi[kk], va);
      pv_slice<DH>(o, a_lo[kk], va);
    }
    sm90::commit();
    sm90::wait_all();
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) sm90::fence_operand(o[i]);
  }

  // out = o / l, 0 for a row that attended nothing
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_run[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (!real[rr]) continue;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const float x0 = l > 0.f ? o[4 * i + 2 * rr] / l : 0.f;
      const float x1 = l > 0.f ? o[4 * i + 2 * rr + 1] / l : 0.f;
      *reinterpret_cast<uint32_t*>(out_row(rr) + 8 * i + 2 * (lane & 3)) =
          pack_bf16(x0, x1);
    }
  }
}

template <int DH, int WG>
cudaError_t launch_wg(const Params& p, int batch, int smem_bytes,
                      cudaStream_t stream) {
  static int smem_limit = 0;
  return launch_tile_grid(flash_wgmma_kernel<DH, WG>, p, batch,
                          WG * kThreadsWg, smem_bytes, &smem_limit, stream);
}

// one warpgroup for a tile of up to 64 rows, two past that
template <int DH>
cudaError_t launch_dh(const Params& p, int batch, int smem_bytes,
                      cudaStream_t stream) {
  return p.hb * p.ppt <= kRows
             ? launch_wg<DH, 1>(p, batch, smem_bytes, stream)
             : launch_wg<DH, 2>(p, batch, smem_bytes, stream);
}

}  // namespace

namespace repro_flash {

cudaError_t launch_wgmma(const Params& p, int batch, int smem_bytes,
                         cudaStream_t stream) {
  if (p.hb * p.ppt > 2 * kRows) return cudaErrorInvalidValue;
  switch (p.dh) {
    case 16: return launch_dh<16>(p, batch, smem_bytes, stream);
    case 32: return launch_dh<32>(p, batch, smem_bytes, stream);
    case 48: return launch_dh<48>(p, batch, smem_bytes, stream);
    case 64: return launch_dh<64>(p, batch, smem_bytes, stream);
    case 80: return launch_dh<80>(p, batch, smem_bytes, stream);
    case 96: return launch_dh<96>(p, batch, smem_bytes, stream);
    case 112: return launch_dh<112>(p, batch, smem_bytes, stream);
    case 128: return launch_dh<128>(p, batch, smem_bytes, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro_flash

// the static shared bytes of this source's kernels (static_smem.cuh)
extern "C" int flash_wgmma_static_smem(int* bytes) {
  return repro_smem::max_static(
      {repro_smem::fn(flash_wgmma_kernel<16, 1>),
       repro_smem::fn(flash_wgmma_kernel<16, 2>),
       repro_smem::fn(flash_wgmma_kernel<32, 1>),
       repro_smem::fn(flash_wgmma_kernel<32, 2>),
       repro_smem::fn(flash_wgmma_kernel<48, 1>),
       repro_smem::fn(flash_wgmma_kernel<48, 2>),
       repro_smem::fn(flash_wgmma_kernel<64, 1>),
       repro_smem::fn(flash_wgmma_kernel<64, 2>),
       repro_smem::fn(flash_wgmma_kernel<80, 1>),
       repro_smem::fn(flash_wgmma_kernel<80, 2>),
       repro_smem::fn(flash_wgmma_kernel<96, 1>),
       repro_smem::fn(flash_wgmma_kernel<96, 2>),
       repro_smem::fn(flash_wgmma_kernel<112, 1>),
       repro_smem::fn(flash_wgmma_kernel<112, 2>),
       repro_smem::fn(flash_wgmma_kernel<128, 1>),
       repro_smem::fn(flash_wgmma_kernel<128, 2>)},
      bytes);
}
