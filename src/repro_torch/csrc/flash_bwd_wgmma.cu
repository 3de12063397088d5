// The attention backward on Hopper's tensor cores: the function of
// flash_attention_bwd.cu (see there: dQ, dK, dV of the forward's masked,
// capped softmax attention, summed in f32 and rounded once, dK and dV
// summed over each kv head's query heads in a fixed order) for bf16 q, k,
// v with dh 64, 80 or 128; kernels/flash_attention.py `bwd_plan` sends it
// every such call outside the small route (route "wgmma").
//
// The JAX package has no backward kernel (it differentiates its plain
// attention, src/repro/kernels/ref.py `attention_ref`, where the TPU
// kernel `flash_attention_pallas` serves the forward); this source is the
// port's own. What bounds it: operations, 10 dh FLOP an attended (query,
// key) pair at the least (S and four products), 26 dh as computed here:
// S and dP in each kernel and three products of three terms each.
//
// The design carries over the forward's (flash_wgmma.cuh): unswizzled 8 x 8
// core matrices 144 bytes apart along a row (wgmma.cuh), `wgmma` m64nNk16
// with f32 accumulators, a two-stage cp.async ring. Every product whose A
// operand is P or dS is taken three times, over x's bf16 terms
// (`split_bf16`; the forward's P V takes two), so that x enters the sum
// exact to about 2^-27 of itself: dK's and dV's sums over up to 40,000
// rows cancel ten-thousand-fold in places, where two terms (2^-18) left
// entries of llama4's layer outside the one-ulp rule on an H100. For the
// same reason no accumulator chain runs longer than one tile in the
// tensor cores: each tile's dQ, dK, dV partial is summed from 0 there and
// added to the f32 registers by IEEE adds (`add_split`). Two kernels, no
// atomics, every sum in a fixed order, so two calls give the same bits:
//
// 1. `flash_bwd_dq_wgmma_kernel`: a block takes the forward's query rows
//    (the rep heads of one kv head times as many positions as fill 128
//    rows, one warpgroup each 64) and computes D = rowsum(dO o O) for
//    them (written for kernel 2). It streams the 64-key K and V tiles of
//    the rows' attended range through the ring (tiles no row attends are
//    never loaded, the mask is evaluated only on tiles a boundary
//    crosses) and for each: S = Q K^T and dP = dO V^T (both operands in
//    shared memory), P = exp(S - lse) from the lse the forward kept, dS =
//    P o (dP - D) o (1 - (S/c)^2) in registers, and dQ += dS K (scaled
//    once, when written), dS as the A operand from registers (the
//    accumulator layout of S is the A layout) and K the MN-major B, as V
//    is in the forward's P V.
// 2. `flash_bwd_dkdv_wgmma_kernel`: a block owns 128 keys of one (batch
//    row, kv head), 64 a warpgroup, their K and V staged once. The 64-row
//    Q and dO tiles of the kv head's query heads stream through the ring,
//    heads and then positions, with their rows' lse and D: S^T = K Q^T and
//    dP^T = V dO^T (keys are the M dimension, so each accumulator is the A
//    layout of the next products), P^T and dS^T in registers, dV += P^T dO
//    and dK += dS^T Q with dO and Q the MN-major B operands. dK and dV stay
//    in f32 registers (128 a thread at dh 128; one block of two
//    warpgroups an SM, up to 255 registers a thread) and are written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "static_smem.cuh"
#include "wgmma.cuh"

using namespace repro_flash;
namespace sm90 = repro_kernels::sm90;

namespace {

constexpr int kRows = 64;      // rows (queries or keys) a warpgroup
constexpr int kKeys = 64;      // keys a K / V tile of the dQ kernel
constexpr int kThreadsWg = 128;
constexpr int kCore = 144;     // bytes between a row's core matrices
constexpr int kStages = 2;     // tiles in the ring
constexpr int kKvWg = 2;       // warpgroups of the dK / dV kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTerms = 3;      // bf16 terms of an A operand (split_bf16)

// the A fragments (key or row slice kk, term, register) of a 64 x 64 f32
// tile x in the accumulator layout: slice kk is n8 blocks 2 kk and
// 2 kk + 1, which is the A operand's register layout
__device__ __forceinline__ void fragments(const float (&x)[32],
                                          uint32_t (&a)[4][kTerms][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      uint32_t t[kTerms];
      sm90::split_bf16<kTerms>(x[8 * kk + 2 * f], x[8 * kk + 2 * f + 1], t);
#pragma unroll
      for (int i = 0; i < kTerms; ++i) a[kk][i][f] = t[i];
    }
  }
}

struct Bwd {
  Params m;  // q, k, v, their strides, shapes, masks, scale, softcap; the
             // dQ kernel's tile plan (hb, ppt, n_hc)
  const __nv_bfloat16* o;     // (B, H, Sq, dh) contiguous
  const __nv_bfloat16* dout;  // (B, H, Sq, dh) contiguous
  __nv_bfloat16* dq;          // (B, H, Sq, dh) contiguous
  __nv_bfloat16* dk;          // (B, Hkv, Sk, dh) contiguous
  __nv_bfloat16* dv;
  const float* lse;           // (B, H, Sq): the forward's
  float* dsum;                // (B, H, Sq): D, from the dQ kernel
  int per_row;                // blocks a batch row
  int fold;                   // the batch folded into grid.x
};

// The block's batch row and tile: the batch on grid.z up to 65,535 rows,
// folded into grid.x past that.
__device__ __forceinline__ void place(const Bwd& p, int* b, int* tile) {
  if (p.fold) {
    *b = blockIdx.x / p.per_row;
    *tile = blockIdx.x - *b * p.per_row;
  } else {
    *b = blockIdx.z;
    *tile = blockIdx.x;
  }
}

// every query position of [qf, ql] attends every key of [j0, j0 + nj), so
// the tile needs no mask
__device__ __forceinline__ bool tile_full(const Params& m, int j0, int nj,
                                          int qf, int ql) {
  return nj >= kKeys && all_attend(m, j0, j0 + kKeys - 1, qf, ql);
}

// P and dS / scale of one pair from its raw dot, dP, the row's lse times
// log2 e and D; 0 where !ok. Without a softcap the scale and log2 e fold
// into the exponent's one fused multiply-add (sl2 = scale log2 e), as in
// the forward; the scale of dS (the gradient of the raw dot) is applied
// to the dQ and dK sums once, when they are written
__device__ __forceinline__ void prob_dscore(const Params& m, float sl2,
                                            float dot, float dp, float lse2,
                                            float d, bool ok, float* pr,
                                            float* ds) {
  if (m.softcap > 0.f) {
    const float x = logit(m, dot);
    const float pv = ok ? sm90::ex2(fmaf(x, kLog2e, -lse2)) : 0.f;
    const float t = x / m.softcap;
    *pr = pv;
    *ds = pv * (dp - d) * (1.f - t * t);
  } else {
    const float pv = ok ? sm90::ex2(fmaf(dot, sl2, -lse2)) : 0.f;
    *pr = pv;
    *ds = pv * (dp - d);
  }
}

// S (or S^T) and dP (or dP^T) of a warpgroup: 64 x 64 each, A and B both
// K-major tiles in shared memory, dh deep
template <int DH>
__device__ __forceinline__ void scores(float (&s)[32], float (&dp)[32],
                                       uint32_t a_s, uint32_t b_s,
                                       uint32_t a_p, uint32_t b_p) {
  constexpr int kGroup = DH / 8 * kCore;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
    dp[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sm90::fence_operand(s[i]);
    sm90::fence_operand(dp[i]);
  }
  __syncwarp();
  sm90::fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    sm90::mma_ss_n64(s, sm90::desc(a_s + 2 * kk * kCore, kCore, kGroup),
                     sm90::desc(b_s + 2 * kk * kCore, kCore, kGroup), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    sm90::mma_ss_n64(dp, sm90::desc(a_p + 2 * kk * kCore, kCore, kGroup),
                     sm90::desc(b_p + 2 * kk * kCore, kCore, kGroup), kk > 0);
  }
  sm90::commit();
  sm90::wait_all();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sm90::fence_operand(s[i]);
    sm90::fence_operand(dp[i]);
  }
}

// acc (64 x DH) += A B for a 64-deep A held as four 16-deep register
// fragments of kTerms bf16 terms each, and B the MN-major tile at b_tile
// (the k depth its rows), in column chunks of at most COLS from column C0
// on: each chunk's product is summed by the tensor cores from 0 (twelve
// products deep) and then added to acc by IEEE f32 adds. Summed into acc
// directly, a dK entry's chain would run thousands of products deep in
// the tensor cores' accumulator, whose adds lose low bits with a bias
// (on an H100 that put entries where the sum cancels several ulps off
// the plain version); this way only each tile's 64-row partial is.
template <int DH, int COLS = 64, int C0 = 0>
__device__ __forceinline__ void add_split(float (&acc)[DH / 2],
                                          const uint32_t (&a)[4][kTerms][4],
                                          uint32_t b_tile) {
  constexpr int kGroup = DH / 8 * kCore;
  constexpr int kCols = DH - C0 >= 64 && COLS >= 64   ? 64
                        : DH - C0 >= 32 && COLS >= 32 ? 32
                                                      : 16;
  float part[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) {
    part[i] = 0.f;
    sm90::fence_operand(part[i]);
  }
  __syncwarp();
  sm90::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // depth 16 kk .. 16 kk + 15: two 8-row groups of the B tile
    const uint32_t b = b_tile + 2 * kk * kGroup + C0 / 8 * kCore;
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
      sm90::mma_rs_cols<kCols, kCore>(part, a[kk][t], b, kGroup);
    }
  }
  sm90::commit();
  sm90::wait_all();
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) {
    sm90::fence_operand(part[i]);
    acc[C0 / 2 + i] += part[i];
  }
  if constexpr (C0 + kCols < DH) {
    add_split<DH, COLS, C0 + kCols>(acc, a, b_tile);
  }
}

// the thread's row rr of a 64 x DH accumulator times c as bf16, at dst
// (the row's first element): columns 8 i + 2 (lane % 4) + {0, 1}
template <int DH>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst,
                                          const float (&acc)[DH / 2], int rr,
                                          int lane, float c) {
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    *reinterpret_cast<uint32_t*>(dst + 8 * i + 2 * (lane & 3)) =
        sm90::pack_bf16(acc[4 * i + 2 * rr] * c,
                        acc[4 * i + 2 * rr + 1] * c);
  }
}

// ----------------------------------------------------------------- dQ ----
template <int DH, int WG>
__global__ void __launch_bounds__(kThreadsWg * WG, WG == 1 ? 2 : 1)
    flash_bwd_dq_wgmma_kernel(const Bwd p) {
  static_assert(DH % 16 == 0 && DH <= 128, "dh a multiple of 16, <= 128");
  constexpr int kThreads = kThreadsWg * WG;
  constexpr int kChunks = DH / 8;
  constexpr int kGroup = kChunks * kCore;
  constexpr uint32_t kTile = kRows / 8 * kGroup;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t q_addr = sm90::smem_addr(smem);     // [WG] Q tiles
  const uint32_t o_addr = q_addr + WG * kTile;       // [WG] dO tiles
  const uint32_t k_addr = o_addr + WG * kTile;       // [kStages] K tiles
  const uint32_t v_addr = k_addr + kStages * kTile;  // [kStages] V tiles
  const Params& m = p.m;

  int b, tile;
  place(p, &b, &tile);
  const int g = blockIdx.y;
  // the last query tiles first: under a causal mask they attend the most
  const int qtile = (m.sq + m.ppt - 1) / m.ppt - 1 - tile / m.n_hc;
  const int hc = tile % m.n_hc;
  const int rep = m.h / m.hkv;
  const int s0 = qtile * m.ppt;
  const int h0 = g * rep + hc * m.hb;
  const int n_h = min(m.hb, rep - hc * m.hb);
  const int n_pos = min(m.ppt, m.sq - s0);
  int lo, hi;
  kv_range(m, 0, s0, s0 + n_pos - 1, &lo, &hi);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid / kThreadsWg;
  // this thread's two rows of the accumulator layout: block rows
  // 16 warp + lane / 4 (+ 8), row r = position s0 + r / hb of head
  // h0 + r % hb; (B, H, Sq) index of each real row
  int pos[2];
  bool real[2];
  long long row[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 16 * warp + (lane >> 2) + 8 * rr;
    pos[rr] = r / m.hb;
    const int head = r - pos[rr] * m.hb;
    real[rr] = pos[rr] < n_pos && head < n_h;
    row[rr] = real[rr] ? (static_cast<long long>(b) * m.h + h0 + head) *
                                 m.sq + s0 + pos[rr]
                       : 0;
  }

  // D = rowsum(dO o O): a row's columns 8 i + 2 (lane % 4) + {0, 1} in
  // each lane of its quad, the four partial sums met by two shuffles; the
  // rows' lse in base 2 (+inf for a pad row, whose P is then 0)
  float dsum[2], lse2[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float acc = 0.f;
    if (real[rr]) {
      const __nv_bfloat16* orow = p.o + row[rr] * DH;
      const __nv_bfloat16* drow = p.dout + row[rr] * DH;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = 8 * i + 2 * (lane & 3);
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(orow + c));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(drow + c));
        acc = fmaf(y.x, x.x, acc);
        acc = fmaf(y.y, x.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dsum[rr] = acc;
    lse2[rr] = real[rr] ? p.lse[row[rr]] * kLog2e : INFINITY;
    if (real[rr] && (lane & 3) == 0) p.dsum[row[rr]] = acc;
  }

  if (lo > hi) {  // no row of the tile attends anything: dQ = 0
    float zero[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) zero[i] = 0.f;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (real[rr]) store_row<DH>(p.dq + row[rr] * DH, zero, rr, lane, 1.f);
    }
    return;
  }

  // the Q and dO tiles, zeros in the pad rows
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(m.q);
#pragma unroll 1
  for (int e = tid; e < WG * kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e - r * kChunks;
    const int pi = r / m.hb, hh = r - pi * m.hb;
    const bool ok = pi < n_pos && hh < n_h;
    const uint32_t off = sm90::core_off(r, c, kCore, kGroup);
    const __nv_bfloat16* qs =
        ok ? q + b * m.q_sb + (h0 + hh) * m.q_sh + (s0 + pi) * m.q_ss + 8 * c
           : q;
    const __nv_bfloat16* ds =
        ok ? p.dout + ((static_cast<long long>(b) * m.h + h0 + hh) * m.sq +
                       s0 + pi) * DH + 8 * c
           : p.dout;
    sm90::cp_async16(q_addr + off, qs, ok);
    sm90::cp_async16(o_addr + off, ds, ok);
  }
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(m.k) + b * m.k_sb + g * m.k_sh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(m.v) + b * m.v_sb + g * m.v_sh;
  auto load_kv = [&](int j0, int stage) {
    const int nj = min(kKeys, hi - j0 + 1);
#pragma unroll 1
    for (int e = tid; e < kKeys * kChunks; e += kThreads) {
      const int j = e / kChunks, c = e - j * kChunks;
      const bool ok = j < nj;
      const long long slot = ok ? j0 + j : j0;
      const uint32_t off =
          stage * kTile + sm90::core_off(j, c, kCore, kGroup);
      sm90::cp_async16(k_addr + off, kb + slot * m.k_ss + 8 * c, ok);
      sm90::cp_async16(v_addr + off, vb + slot * m.v_ss + 8 * c, ok);
    }
  };
  const int n_tiles = (hi - lo + kKeys) / kKeys;
  // the ring's first tile in one group with the Q and dO tiles; every
  // iteration commits one group (empty past the last tile)
  load_kv(lo, 0);
  sm90::cp_async_commit();

  const int qf = s0, ql = s0 + n_pos - 1;
  const float sl2 = m.scale * kLog2e;
  const uint32_t q_wg = q_addr + wg * kTile, o_wg = o_addr + wg * kTile;
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = lo + t * kKeys, stage = t % kStages;
    const int nj = min(kKeys, hi - j0 + 1);
    sm90::cp_async_wait<0>();
    sm90::fence_async_smem();
    __syncthreads();  // tile t in place; every thread done with tile t - 1
    if (t + 1 < n_tiles) load_kv(j0 + kKeys, (t + 1) % kStages);
    sm90::cp_async_commit();

    float s[32], dp[32];
    scores<DH>(s, dp, q_wg, k_addr + stage * kTile, o_wg,
               v_addr + stage * kTile);

    // dS into dp, in place: s[4 i + 2 rr + e] is row rr, key
    // 8 i + 2 (lane % 4) + e
    const bool full = tile_full(m, j0, nj, qf, ql);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      const int j = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const bool ok = full || (j < nj && attends(m, j0 + j, s0 + pos[rr]));
      float pr;
      prob_dscore(m, sl2, s[i], dp[i], lse2[rr], dsum[rr], ok, &pr, &dp[i]);
    }
    uint32_t a[4][kTerms][4];
    fragments(dp, a);
    // dQ += dS K
    add_split<DH>(acc, a, k_addr + stage * kTile);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (real[rr]) {
      store_row<DH>(p.dq + row[rr] * DH, acc, rr, lane, m.scale);
    }
  }
}

// ------------------------------------------------------------- dK / dV ----
template <int DH>
__global__ void __launch_bounds__(kThreadsWg * kKvWg, 1)
    flash_bwd_dkdv_wgmma_kernel(const Bwd p) {
  static_assert(DH % 16 == 0 && DH <= 128, "dh a multiple of 16, <= 128");
  constexpr int kThreads = kThreadsWg * kKvWg;
  constexpr int kChunks = DH / 8;
  constexpr int kGroup = kChunks * kCore;
  constexpr uint32_t kTile = kRows / 8 * kGroup;
  constexpr int kBlockKeys = kRows * kKvWg;
  // the partials' column chunk: past dh 80 the dK and dV accumulators
  // (dh a thread) leave room for 32 columns (16 registers) only
  constexpr int kKvCols = DH > 80 ? 32 : 64;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t k_addr = sm90::smem_addr(smem);       // [kKvWg] K tiles
  const uint32_t v_addr = k_addr + kKvWg * kTile;      // [kKvWg] V tiles
  const uint32_t q_addr = v_addr + kKvWg * kTile;      // [kStages] Q tiles
  const uint32_t o_addr = q_addr + kStages * kTile;    // [kStages] dO tiles
  // [kStages][kRows] each: the Q tile's rows' lse and D
  float* lse_s = reinterpret_cast<float*>(smem + (2 * kKvWg + 2 * kStages) *
                                                     kTile);
  float* dsum_s = lse_s + kStages * kRows;
  const Params& m = p.m;

  int b, ktile;
  place(p, &b, &ktile);
  const int g = blockIdx.y;
  const int rep = m.h / m.hkv;
  const int j0 = ktile * kBlockKeys;
  const int nj = min(kBlockKeys, m.sk - j0);
  int qlo, qhi;
  q_range(m, j0, j0 + nj - 1, &qlo, &qhi);
  const int n_qt = qhi >= qlo ? (qhi - qlo + kRows) / kRows : 0;
  const int n_tiles = rep * n_qt;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid / kThreadsWg;
  // this thread's two keys (the accumulator rows): block rows
  // 16 warp + lane / 4 (+ 8)
  int key[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    key[rr] = j0 + 16 * warp + (lane >> 2) + 8 * rr;
  }

  // K and V of the block's keys, zeros past Sk (none where no query
  // attends them: dK = dV = 0)
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(m.k) + b * m.k_sb + g * m.k_sh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(m.v) + b * m.v_sb + g * m.v_sh;
#pragma unroll 1
  for (int e = tid; n_tiles > 0 && e < kBlockKeys * kChunks; e += kThreads) {
    const int j = e / kChunks, c = e - j * kChunks;
    const bool ok = j < nj;
    const long long slot = ok ? j0 + j : j0;
    const uint32_t off = sm90::core_off(j, c, kCore, kGroup);
    sm90::cp_async16(k_addr + off, kb + slot * m.k_ss + 8 * c, ok);
    sm90::cp_async16(v_addr + off, vb + slot * m.v_ss + 8 * c, ok);
  }
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(m.q);
  // Q tile t: positions qlo + 64 (t % n_qt) .. + 63 of query head
  // g rep + t / n_qt, with its rows' lse and D; zeros past Sq
  auto load_q = [&](int t, int stage) {
    const int hq = g * rep + t / n_qt;
    const int s0 = qlo + (t % n_qt) * kRows;
    const long long base = (static_cast<long long>(b) * m.h + hq) * m.sq;
#pragma unroll 1
    for (int e = tid; e < kRows * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e - r * kChunks;
      const bool ok = s0 + r < m.sq;
      const int sp = ok ? s0 + r : 0;
      const uint32_t off =
          stage * kTile + sm90::core_off(r, c, kCore, kGroup);
      sm90::cp_async16(q_addr + off,
                       q + b * m.q_sb + hq * m.q_sh + sp * m.q_ss + 8 * c, ok);
      sm90::cp_async16(o_addr + off, p.dout + (base + sp) * DH + 8 * c, ok);
    }
    if (tid < 2 * kRows) {
      const int r = tid % kRows;
      const bool ok = s0 + r < m.sq;
      const long long i = base + (ok ? s0 + r : 0);
      const uint32_t dst = sm90::smem_addr(
          (tid < kRows ? lse_s : dsum_s) + stage * kRows + r);
      sm90::cp_async4(dst, tid < kRows ? p.lse + i : p.dsum + i, ok);
    }
  };
  if (n_tiles > 0) load_q(0, 0);
  sm90::cp_async_commit();

  const uint32_t k_wg = k_addr + wg * kTile, v_wg = v_addr + wg * kTile;
  const float sl2 = m.scale * kLog2e;
  const int kp0 = j0 + wg * kRows, kp1 = kp0 + kRows - 1;
  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kStages;
    const int s0 = qlo + (t % n_qt) * kRows;
    sm90::cp_async_wait<0>();
    sm90::fence_async_smem();
    __syncthreads();  // tile t in place; every thread done with tile t - 1
    if (t + 1 < n_tiles) load_q(t + 1, (t + 1) % kStages);
    sm90::cp_async_commit();

    float s[32], dp[32];
    scores<DH>(s, dp, k_wg, q_addr + stage * kTile, v_wg,
               o_addr + stage * kTile);

    // P^T into s and dS^T into dp, in place: s[4 i + 2 rr + e] is key
    // rr, query row 8 i + 2 (lane % 4) + e of the tile
    const bool full = kp1 < m.sk && s0 + kRows - 1 < m.sq &&
                      all_attend(m, kp0, kp1, s0, s0 + kRows - 1);
    const float* lse_t = lse_s + stage * kRows;
    const float* dsum_t = dsum_s + stage * kRows;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      const int n = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const bool ok = full || (key[rr] < m.sk && s0 + n < m.sq &&
                               attends(m, key[rr], s0 + n));
      prob_dscore(m, sl2, s[i], dp[i], lse_t[n] * kLog2e, dsum_t[n], ok,
                  &s[i], &dp[i]);
    }
    // dV += P^T dO, then dK += dS^T Q
    uint32_t a[4][kTerms][4];
    fragments(s, a);
    add_split<DH, kKvCols>(dv, a, o_addr + stage * kTile);
    fragments(dp, a);
    add_split<DH, kKvCols>(dk, a, q_addr + stage * kTile);
  }
  const long long kbase = (static_cast<long long>(b) * m.hkv + g) * m.sk;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (key[rr] >= m.sk) continue;
    store_row<DH>(p.dk + (kbase + key[rr]) * DH, dk, rr, lane, m.scale);
    store_row<DH>(p.dv + (kbase + key[rr]) * DH, dv, rr, lane, 1.f);
  }
}

// (per_row blocks, kv heads, batch) with the batch on grid.z up to 65,535
// rows, folded into grid.x past that
template <typename K>
cudaError_t launch_grid(K kernel, const Bwd& p, int per_row, int batch,
                        int threads, int smem_bytes, int* limit,
                        cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem_bytes, limit);
  if (err != cudaSuccess) return err;
  Bwd lp = p;
  lp.per_row = per_row;
  lp.fold = batch > 65535;
  if (!lp.fold) {
    const dim3 grid(per_row, p.m.hkv, batch);
    kernel<<<grid, threads, smem_bytes, stream>>>(lp);
  } else {
    const long long x = static_cast<long long>(per_row) * batch;
    if (x > 0x7fffffffLL) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(x), p.m.hkv, 1);
    kernel<<<grid, threads, smem_bytes, stream>>>(lp);
  }
  return cudaGetLastError();
}

template <int DH, int WG>
cudaError_t launch_dq(const Bwd& p, int batch, int smem_bytes,
                      cudaStream_t stream) {
  static int limit = 0;
  const int per_row = (p.m.sq + p.m.ppt - 1) / p.m.ppt * p.m.n_hc;
  return launch_grid(flash_bwd_dq_wgmma_kernel<DH, WG>, p, per_row, batch,
                     kThreadsWg * WG, smem_bytes, &limit, stream);
}

template <int DH>
cudaError_t launch_dh(const Bwd& p, int batch, int dq_smem, int dkdv_smem,
                      cudaStream_t stream) {
  static int limit = 0;
  cudaError_t err = p.m.hb * p.m.ppt <= kRows
                        ? launch_dq<DH, 1>(p, batch, dq_smem, stream)
                        : launch_dq<DH, 2>(p, batch, dq_smem, stream);
  if (err != cudaSuccess) return err;
  const int per_row = (p.m.sk + kRows * kKvWg - 1) / (kRows * kKvWg);
  return launch_grid(flash_bwd_dkdv_wgmma_kernel<DH>, p, per_row, batch,
                     kThreadsWg * kKvWg, dkdv_smem, &limit, stream);
}

}  // namespace

// q, k, v bf16 through their strides (b, h, s; dh contiguous, base and
// strides in whole 16 bytes); o, dout, dq (B, H, Sq, dh) and dk, dv (B,
// Hkv, Sk, dh) contiguous bf16; lse the forward's (B, H, Sq) f32, dsum
// (B, H, Sq) f32 scratch. hb, ppt (the dQ kernel's query tiles) and the
// two kernels' shared bytes from kernels/flash_attention.py `bwd_plan`.
// Two launches: dQ (and D), then dK / dV.
extern "C" int flash_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const float* lse,
    float* dsum, int batch, int h, int hkv, int sq, int sk, int dh,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, int causal, int window, int chunk, float softcap,
    float scale, int hb, int ppt, int dq_smem, int dkdv_smem, void* stream) {
  const int rep = hkv > 0 ? h / hkv : 0;
  if (batch <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 ||
      sk <= 0 || hkv > 65535 || hb <= 0 || ppt <= 0 || hb > rep ||
      hb * ppt > kRows * 2 || lse == nullptr || dsum == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Bwd p = {};
  Params& m = p.m;
  m.q = q;
  m.k = k;
  m.v = v;
  m.h = h;
  m.hkv = hkv;
  m.sq = sq;
  m.sk = sk;
  m.dh = dh;
  m.q_sb = q_sb;
  m.q_sh = q_sh;
  m.q_ss = q_ss;
  m.k_sb = k_sb;
  m.k_sh = k_sh;
  m.k_ss = k_ss;
  m.v_sb = v_sb;
  m.v_sh = v_sh;
  m.v_ss = v_ss;
  m.causal = causal;
  m.window = window;
  m.chunk = chunk;
  m.softcap = softcap;
  m.scale = scale;
  m.hb = hb;
  m.ppt = ppt;
  m.n_hc = (rep + hb - 1) / hb;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lse = lse;
  p.dsum = dsum;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64: return static_cast<int>(
        launch_dh<64>(p, batch, dq_smem, dkdv_smem, st));
    case 80: return static_cast<int>(
        launch_dh<80>(p, batch, dq_smem, dkdv_smem, st));
    case 128: return static_cast<int>(
        launch_dh<128>(p, batch, dq_smem, dkdv_smem, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the static shared bytes of this source's kernels (static_smem.cuh)
extern "C" int flash_bwd_wgmma_static_smem(int* bytes) {
  return repro_smem::max_static(
      {repro_smem::fn(flash_bwd_dq_wgmma_kernel<64, 1>),
       repro_smem::fn(flash_bwd_dq_wgmma_kernel<64, 2>),
       repro_smem::fn(flash_bwd_dq_wgmma_kernel<80, 1>),
       repro_smem::fn(flash_bwd_dq_wgmma_kernel<80, 2>),
       repro_smem::fn(flash_bwd_dq_wgmma_kernel<128, 1>),
       repro_smem::fn(flash_bwd_dq_wgmma_kernel<128, 2>),
       repro_smem::fn(flash_bwd_dkdv_wgmma_kernel<64>),
       repro_smem::fn(flash_bwd_dkdv_wgmma_kernel<80>),
       repro_smem::fn(flash_bwd_dkdv_wgmma_kernel<128>)},
      bytes);
}
