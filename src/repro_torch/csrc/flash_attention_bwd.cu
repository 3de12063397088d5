// The backward pass of the attention of flash_attention.cu: for
//   O = softmax(mask(softcap(scale Q K^T))) V
// (q (B, H, Sq, dh), k and v (B, Hkv, Sk, dh), f32 or bf16; q head h reads
// kv head g = h / (H / Hkv)) and the gradient dO of O, it writes dQ, dK and
// dV in the inputs' type, summed in f32 and rounded once. With S the
// logits after scale and softcap, P = exp(S - lse) (lse a row's
// log-sum-exp over its attended keys), D = rowsum(dO o O) and
//   dP = dO V^T,  dS = P o (dP - D) o (1 - (S / c)^2 under softcap c),
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO,
// with dK and dV summed over the rep = H / Hkv query heads of their kv
// head. Causal, window and chunk masks as the forward's (flash_common.cuh
// `attends`); training passes no kv_start and no q_offset, so positions are
// slots.
//
// The JAX package has no backward kernel: it differentiates its plain
// attention (src/repro/kernels/ref.py `attention_ref`) where the TPU
// kernel `flash_attention_pallas` serves the forward. This source is the
// port's own. kernels/flash_attention.py `bwd_plan` picks one of two
// routes:
//
// 1. "tiles": two kernels and no atomics, so the result is the same bits
//    from run to run. `flash_bwd_dq_kernel`, one block per (batch row, kv
//    head, tile of query rows: the rep heads of the kv head times as many
//    positions as fill 64 rows, 32 past dh = 96; the forward's tiles):
//    D first, then a pass over the attended kv tiles for the rows' running
//    max and sum (the forward kernels write no lse), then a second pass
//    that recomputes S, takes dP in the same 4 x 4 register tiles of fused
//    multiply-adds over dh, forms dS in registers and adds dS K to dQ
//    accumulators in shared memory; it writes dQ, and lse and D (f32, (B,
//    H, Sq)) for the second kernel. `flash_bwd_dkdv_kernel`, one block per
//    (batch row, kv head, tile of bk keys): the query positions that can
//    attend the tile, in tiles of the same rows, in a fixed order (head
//    chunks, then positions), each recomputing P from lse and dS, adding
//    P^T dO to dV and dS^T Q to dK in shared memory. Queries, dO, keys and
//    values are staged transposed as f32 ([dh][rows]), so one 16-byte load
//    feeds four products in every product of the pass.
// 2. "small" (BST: Sq, Sk <= 32, dh <= 16), one kernel: a warp per (batch
//    row, kv head), a lane per query, the whole key range in shared memory;
//    for each of the kv head's query heads in order, lane i forms row i of
//    P and dS and its dQ, then lane j sums column j of dS Q and P dO over
//    the rows in order into its dK and dV. Eight warps a block, so one
//    block holds eight problems: a 64-row tile per (batch row, head) would
//    leave most of it idle at BST's 21 x 21 x 4.
//
// What bounds it on an H100: operations. The tiles route computes four
// products of an attended (row, key) pair's dh in each kernel, 16 dh
// FLOP a pair, on the SIMT units (67 TFLOP/s f32); tensor cores are later
// work (ROADMAP B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "static_smem.cuh"

using repro_flash::Params;
using repro_flash::allow_smem;
using repro_flash::attends;
using repro_flash::floor_div;
using repro_flash::ld4;
using repro_flash::logit;
using repro_flash::store;
using repro_flash::to_f32;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmallS = 32;
constexpr int kSmallDh = 16;

struct Bwd {
  Params m;              // q, k, v, strides, masks, scale, softcap, dh
  const void* o;         // (B, H, Sq, dh) contiguous
  const void* dout;      // (B, H, Sq, dh) contiguous
  void* dq;              // (B, H, Sq, dh) contiguous
  void* dk;              // (B, Hkv, Sk, dh) contiguous
  void* dv;
  float* lse;            // (B, H, Sq)
  float* dsum;           // (B, H, Sq): D
  int batch;
  int hb, ppt, n_hc, rp, bc, bk, dh4;  // tile plan, see bwd_plan
  int q_tiles;           // query tiles a (head chunk) row: ceil(Sq / ppt)
  int k_tiles;           // key tiles: ceil(Sk / bk)
  int dh_pad;            // the small route's dh rounded up to 4, 8 or 16
  int fold;              // the batch folded into grid.x (past 65,535 rows)
};

// the scaled, capped logit of a pair, or -inf where it is not attended
__device__ __forceinline__ float masked_logit(const Params& p, bool ok,
                                              float dot) {
  return ok ? logit(p, dot) : -INFINITY;
}

// dS of one pair, times scale and softcap's chain factor: the gradient of
// the raw dot product q . k
__device__ __forceinline__ float dscore(const Params& p, float s, float lse,
                                        float dp, float d) {
  if (s == -INFINITY) return 0.f;
  const float pr = expf(s - lse);
  float ds = pr * (dp - d);
  if (p.softcap > 0.f) {
    const float t = s / p.softcap;
    ds = ds * (1.f - t * t);
  }
  return ds * p.scale;
}

__device__ __forceinline__ float prob(float s, float lse) {
  return s == -INFINITY ? 0.f : expf(s - lse);
}

// The block's batch row and tile: the batch on grid.z up to 65,535 rows,
// folded into grid.x past that (`launch_rows`).
__device__ __forceinline__ void place(int per_row, int fold, int* b,
                                      int* tile) {
  if (fold) {
    *b = blockIdx.x / per_row;
    *tile = blockIdx.x - *b * per_row;
  } else {
    *b = blockIdx.z;
    *tile = blockIdx.x;
  }
}

// Stage rows [s0, s0 + n_pos) x heads [h0, h0 + n_h) of x (strides sb, sh,
// ss; dh contiguous) transposed into dst [dh4][ld] as f32, row r = (pos r /
// hb, head r % hb); zeros where outside and in the pad rows dh..dh4-1.
template <typename T>
__device__ __forceinline__ void stage_rows_t(
    float* dst, int ld, const T* x, long long sb, long long sh, long long ss,
    int b, int h0, int s0, int n_h, int n_pos, int hb, int rp, int dh,
    int dh4) {
  for (int e = threadIdx.x; e < rp * dh4; e += kThreads) {
    const int r = e / dh4, d = e - r * dh4;
    const int pi = r / hb, hh = r - pi * hb;
    float val = 0.f;
    if (pi < n_pos && hh < n_h && d < dh) {
      val = to_f32(x[b * sb + (h0 + hh) * sh + (s0 + pi) * ss + d]);
    }
    dst[d * ld + r] = val;
  }
}

// Stage keys [j0, j0 + nj) of kv head g transposed into dst [dh4][ld].
template <typename T>
__device__ __forceinline__ void stage_keys_t(float* dst, int ld, const T* x,
                                             long long ss, int j0, int nj,
                                             int n_cols, int dh, int dh4) {
  for (int e = threadIdx.x; e < n_cols * dh4; e += kThreads) {
    const int j = e / dh4, d = e - j * dh4;
    float val = 0.f;
    if (j < nj && d < dh) val = to_f32(x[(j0 + j) * ss + d]);
    dst[d * ld + j] = val;
  }
}

// ------------------------------------------------------------ 1. tiles ----
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Bwd p) {
  extern __shared__ float4 smem4[];
  const Params& m = p.m;
  const int dh = m.dh, dh4 = p.dh4, bc = p.bc, rp = p.rp;
  const int ldq = rp + 4, ldk = bc + 4;
  float* qt = reinterpret_cast<float*>(smem4);  // [dh4][ldq] Q^T
  float* ot = qt + dh4 * ldq;                    // [dh4][ldq] dO^T
  float* kt = ot + dh4 * ldq;                    // [dh4][ldk] K^T
  float* vt = kt + dh4 * ldk;                    // [dh4][ldk] V^T
  float* ss = vt + dh4 * ldk;                    // [rp][ldk] scores, dS
  float* dqa = ss + rp * ldk;                    // [rp][dh4] dQ
  float* ms = dqa + rp * dh4;                    // [rp] max, then lse
  float* ls = ms + rp;                           // [rp] sum
  float* dd = ls + rp;                           // [rp] D

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int b, tile;
  place(p.q_tiles * p.n_hc, p.fold, &b, &tile);
  const int g = blockIdx.y;
  const int qtile = tile / p.n_hc, hc = tile - qtile * p.n_hc;
  const int rep = m.h / m.hkv;
  const int s0 = qtile * p.ppt;
  const int h0 = g * rep + hc * p.hb;
  const int n_h = min(p.hb, rep - hc * p.hb);
  const int n_pos = min(p.ppt, m.sq - s0);

  int lo, hi;
  repro_flash::kv_range(m, 0, s0, s0 + n_pos - 1, &lo, &hi);

  const T* q = static_cast<const T*>(m.q);
  const T* o = static_cast<const T*>(p.o);
  const T* dout = static_cast<const T*>(p.dout);
  const long long row_sh = static_cast<long long>(m.sq) * dh;
  const long long row_sb = static_cast<long long>(m.h) * row_sh;
  stage_rows_t(qt, ldq, q, m.q_sb, m.q_sh, m.q_ss, b, h0, s0, n_h, n_pos,
               p.hb, rp, dh, dh4);
  stage_rows_t(ot, ldq, dout, row_sb, row_sh, static_cast<long long>(dh), b,
               h0, s0, n_h, n_pos, p.hb, rp, dh, dh4);
  for (int e = tid; e < rp * dh4; e += kThreads) dqa[e] = 0.f;
  // D, a warp a row: lane l adds columns l, l + 32, ...; then the shuffle
  for (int r = warp; r < rp; r += kWarps) {
    const int pi = r / p.hb, hh = r - pi * p.hb;
    float acc = 0.f;
    if (pi < n_pos && hh < n_h) {
      const long long base = b * row_sb + (h0 + hh) * row_sh +
                             static_cast<long long>(s0 + pi) * dh;
      for (int d = lane; d < dh; d += 32) {
        acc = fmaf(to_f32(dout[base + d]), to_f32(o[base + d]), acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) {
      dd[r] = acc;
      ms[r] = -INFINITY;
      ls[r] = 0.f;
    }
  }
  __syncthreads();

  const T* kb = static_cast<const T*>(m.k) + b * m.k_sb + g * m.k_sh;
  const T* vb = static_cast<const T*>(m.v) + b * m.v_sb + g * m.v_sh;
  const int n_rg = rp / 4, n_kg = bc / 4, n_cg = dh4 / 4;

  // pass 1: the rows' log-sum-exp over the attended keys
  for (int j0 = lo; j0 <= hi; j0 += bc) {
    const int nj = min(bc, hi - j0 + 1);
    stage_keys_t(kt, ldk, kb, m.k_ss, j0, nj, bc, dh, dh4);
    __syncthreads();
    for (int t = tid; t < n_rg * n_kg; t += kThreads) {
      const int ri = t / n_kg, kj = t - ri * n_kg;
      float acc[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < dh; ++d) {
        const float4 x = ld4(qt + d * ldq + 4 * ri);
        const float4 y = ld4(kt + d * ldk + 4 * kj);
        const float xs[4] = {x.x, x.y, x.z, x.w};
        const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(xs[a], ys[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = 4 * ri + a;
        const int pi = r / p.hb, hh = r - pi * p.hb;
        const bool row_ok = pi < n_pos && hh < n_h;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * kj + c;
          const bool ok = row_ok && j < nj && attends(m, j0 + j, s0 + pi);
          ss[r * ldk + j] = masked_logit(m, ok, acc[a][c]);
        }
      }
    }
    __syncthreads();
    for (int r = warp; r < rp; r += kWarps) {
      const float* row = ss + r * ldk;
      float mx = -INFINITY;
      for (int j = lane; j < bc; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(ms[r], mx);
      float sum = 0.f;
      if (m_new != -INFINITY) {
        for (int j = lane; j < bc; j += 32) sum += expf(row[j] - m_new);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) {
        const float alpha = m_new == -INFINITY ? 1.f : expf(ms[r] - m_new);
        ls[r] = alpha * ls[r] + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
  }
  // lse; +inf for a row that attends nothing, so that its P is 0
  for (int r = tid; r < rp; r += kThreads) {
    ms[r] = ls[r] > 0.f ? ms[r] + logf(ls[r]) : INFINITY;
  }
  __syncthreads();

  // pass 2: dS, then dQ += dS K
  for (int j0 = lo; j0 <= hi; j0 += bc) {
    const int nj = min(bc, hi - j0 + 1);
    stage_keys_t(kt, ldk, kb, m.k_ss, j0, nj, bc, dh, dh4);
    stage_keys_t(vt, ldk, vb, m.v_ss, j0, nj, bc, dh, dh4);
    __syncthreads();
    for (int t = tid; t < n_rg * n_kg; t += kThreads) {
      const int ri = t / n_kg, kj = t - ri * n_kg;
      float as[4][4] = {}, ap[4][4] = {};
#pragma unroll 2
      for (int d = 0; d < dh; ++d) {
        const float4 x = ld4(qt + d * ldq + 4 * ri);
        const float4 y = ld4(kt + d * ldk + 4 * kj);
        const float4 u = ld4(ot + d * ldq + 4 * ri);
        const float4 w = ld4(vt + d * ldk + 4 * kj);
        const float xs[4] = {x.x, x.y, x.z, x.w};
        const float ys[4] = {y.x, y.y, y.z, y.w};
        const float us[4] = {u.x, u.y, u.z, u.w};
        const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            as[a][c] = fmaf(xs[a], ys[c], as[a][c]);
            ap[a][c] = fmaf(us[a], ws[c], ap[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = 4 * ri + a;
        const int pi = r / p.hb, hh = r - pi * p.hb;
        const bool row_ok = pi < n_pos && hh < n_h;
        const float lse = ms[r], d = dd[r];
        float o4[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * kj + c;
          const bool ok = row_ok && j < nj && attends(m, j0 + j, s0 + pi);
          o4[c] = dscore(m, masked_logit(m, ok, as[a][c]), lse, ap[a][c], d);
        }
        *reinterpret_cast<float4*>(ss + r * ldk + 4 * kj) =
            make_float4(o4[0], o4[1], o4[2], o4[3]);
      }
    }
    __syncthreads();
    const int nj4 = (nj + 3) & ~3;
    for (int t = tid; t < n_rg * n_cg; t += kThreads) {
      const int ri = t / n_cg, cj = t - ri * n_cg;
      float acc[4][4] = {};
      for (int j = 0; j < nj4; j += 4) {
        float s4[4][4], k4[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 x = ld4(ss + (4 * ri + a) * ldk + j);
          s4[a][0] = x.x;
          s4[a][1] = x.y;
          s4[a][2] = x.z;
          s4[a][3] = x.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 y = ld4(kt + (4 * cj + c) * ldk + j);
          k4[c][0] = y.x;
          k4[c][1] = y.y;
          k4[c][2] = y.z;
          k4[c][3] = y.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[a][c] = fmaf(s4[a][u], k4[c][u], acc[a][c]);
            }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float4* dst = reinterpret_cast<float4*>(dqa + (4 * ri + a) * dh4 +
                                                4 * cj);
        float4 x = *dst;
        x.x += acc[a][0];
        x.y += acc[a][1];
        x.z += acc[a][2];
        x.w += acc[a][3];
        *dst = x;
      }
    }
    __syncthreads();
  }

  T* dq = static_cast<T*>(p.dq);
  for (int e = tid; e < rp * dh; e += kThreads) {
    const int r = e / dh, d = e - r * dh;
    const int pi = r / p.hb, hh = r - pi * p.hb;
    if (pi >= n_pos || hh >= n_h) continue;
    store(dq + b * row_sb + (h0 + hh) * row_sh +
              static_cast<long long>(s0 + pi) * dh + d,
          dqa[r * dh4 + d]);
  }
  for (int r = tid; r < rp; r += kThreads) {
    const int pi = r / p.hb, hh = r - pi * p.hb;
    if (pi >= n_pos || hh >= n_h) continue;
    const long long i = (static_cast<long long>(b) * m.h + h0 + hh) * m.sq +
                        s0 + pi;
    p.lse[i] = ms[r];
    p.dsum[i] = dd[r];
  }
}

// the query positions [*qlo, *qhi] that can attend some key in [j0, j1]
__device__ __forceinline__ void q_range(const Params& m, int j0, int j1,
                                        int* qlo, int* qhi) {
  int lo = 0, hi = m.sq - 1;
  if (m.causal) lo = max(lo, j0);
  if (m.window > 0) hi = min(hi, j1 + m.window - 1);
  if (m.chunk > 0) {
    lo = max(lo, floor_div(j0, m.chunk) * m.chunk);
    hi = min(hi, (floor_div(j1, m.chunk) + 1) * m.chunk - 1);
  }
  *qlo = lo;
  *qhi = hi;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const Bwd p) {
  extern __shared__ float4 smem4[];
  const Params& m = p.m;
  const int dh = m.dh, dh4 = p.dh4, bk = p.bk, rp = p.rp;
  const int ldq = rp + 4, ldk = bk + 4;
  float* kt = reinterpret_cast<float*>(smem4);  // [dh4][ldk] K^T
  float* vt = kt + dh4 * ldk;                    // [dh4][ldk] V^T
  float* qt = vt + dh4 * ldk;                    // [dh4][ldq] Q^T
  float* ot = qt + dh4 * ldq;                    // [dh4][ldq] dO^T
  float* ps = ot + dh4 * ldq;                    // [rp][ldk] P
  float* ss = ps + rp * ldk;                     // [rp][ldk] dS
  float* dka = ss + rp * ldk;                    // [bk][dh4] dK
  float* dva = dka + bk * dh4;                   // [bk][dh4] dV
  float* lr = dva + bk * dh4;                    // [rp] lse
  float* dr = lr + rp;                           // [rp] D

  const int tid = threadIdx.x;
  int b, ktile;
  place(p.k_tiles, p.fold, &b, &ktile);
  const int g = blockIdx.y;
  const int rep = m.h / m.hkv;
  const int j0 = ktile * bk;
  const int nj = min(bk, m.sk - j0);

  const T* kb = static_cast<const T*>(m.k) + b * m.k_sb + g * m.k_sh;
  const T* vb = static_cast<const T*>(m.v) + b * m.v_sb + g * m.v_sh;
  stage_keys_t(kt, ldk, kb, m.k_ss, j0, nj, bk, dh, dh4);
  stage_keys_t(vt, ldk, vb, m.v_ss, j0, nj, bk, dh, dh4);
  for (int e = tid; e < bk * dh4; e += kThreads) {
    dka[e] = 0.f;
    dva[e] = 0.f;
  }
  int qlo, qhi;
  q_range(m, j0, j0 + nj - 1, &qlo, &qhi);

  const T* q = static_cast<const T*>(m.q);
  const T* dout = static_cast<const T*>(p.dout);
  const long long row_sh = static_cast<long long>(m.sq) * dh;
  const long long row_sb = static_cast<long long>(m.h) * row_sh;
  const int n_rg = rp / 4, n_kg = bk / 4, n_cg = dh4 / 4;

  for (int hc = 0; hc < p.n_hc; ++hc) {
    const int h0 = g * rep + hc * p.hb;
    const int n_h = min(p.hb, rep - hc * p.hb);
    for (int s0 = qlo; s0 <= qhi; s0 += p.ppt) {
      const int n_pos = min(p.ppt, qhi - s0 + 1);
      __syncthreads();  // the last tile's reads of qt, ot, ps, ss are done
      stage_rows_t(qt, ldq, q, m.q_sb, m.q_sh, m.q_ss, b, h0, s0, n_h, n_pos,
                   p.hb, rp, dh, dh4);
      stage_rows_t(ot, ldq, dout, row_sb, row_sh, static_cast<long long>(dh),
                   b, h0, s0, n_h, n_pos, p.hb, rp, dh, dh4);
      for (int r = tid; r < rp; r += kThreads) {
        const int pi = r / p.hb, hh = r - pi * p.hb;
        float l = INFINITY, d = 0.f;
        if (pi < n_pos && hh < n_h) {
          const long long i =
              (static_cast<long long>(b) * m.h + h0 + hh) * m.sq + s0 + pi;
          l = p.lse[i];
          d = p.dsum[i];
        }
        lr[r] = l;
        dr[r] = d;
      }
      __syncthreads();
      for (int t = tid; t < n_rg * n_kg; t += kThreads) {
        const int ri = t / n_kg, kj = t - ri * n_kg;
        float as[4][4] = {}, ap[4][4] = {};
#pragma unroll 2
        for (int d = 0; d < dh; ++d) {
          const float4 x = ld4(qt + d * ldq + 4 * ri);
          const float4 y = ld4(kt + d * ldk + 4 * kj);
          const float4 u = ld4(ot + d * ldq + 4 * ri);
          const float4 w = ld4(vt + d * ldk + 4 * kj);
          const float xs[4] = {x.x, x.y, x.z, x.w};
          const float ys[4] = {y.x, y.y, y.z, y.w};
          const float us[4] = {u.x, u.y, u.z, u.w};
          const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              as[a][c] = fmaf(xs[a], ys[c], as[a][c]);
              ap[a][c] = fmaf(us[a], ws[c], ap[a][c]);
            }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = 4 * ri + a;
          const int pi = r / p.hb, hh = r - pi * p.hb;
          const bool row_ok = pi < n_pos && hh < n_h;
          float p4[4], d4[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = 4 * kj + c;
            const bool ok = row_ok && j < nj && attends(m, j0 + j, s0 + pi);
            const float s = masked_logit(m, ok, as[a][c]);
            p4[c] = prob(s, lr[r]);
            d4[c] = dscore(m, s, lr[r], ap[a][c], dr[r]);
          }
          *reinterpret_cast<float4*>(ps + r * ldk + 4 * kj) =
              make_float4(p4[0], p4[1], p4[2], p4[3]);
          *reinterpret_cast<float4*>(ss + r * ldk + 4 * kj) =
              make_float4(d4[0], d4[1], d4[2], d4[3]);
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: thread tile (4 keys, 4 columns), the
      // tile's rows in order
      for (int t = tid; t < n_kg * n_cg; t += kThreads) {
        const int kj = t / n_cg, cj = t - kj * n_cg;
        float av[4][4] = {}, ak[4][4] = {};
        for (int r = 0; r < rp; r += 4) {
          float p4[4][4], s4[4][4], o4[4][4], q4[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 x = ld4(ps + (r + u) * ldk + 4 * kj);
            const float4 y = ld4(ss + (r + u) * ldk + 4 * kj);
            p4[u][0] = x.x;
            p4[u][1] = x.y;
            p4[u][2] = x.z;
            p4[u][3] = x.w;
            s4[u][0] = y.x;
            s4[u][1] = y.y;
            s4[u][2] = y.z;
            s4[u][3] = y.w;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4 x = ld4(ot + (4 * cj + c) * ldq + r);
            const float4 y = ld4(qt + (4 * cj + c) * ldq + r);
            o4[c][0] = x.x;
            o4[c][1] = x.y;
            o4[c][2] = x.z;
            o4[c][3] = x.w;
            q4[c][0] = y.x;
            q4[c][1] = y.y;
            q4[c][2] = y.z;
            q4[c][3] = y.w;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                av[a][c] = fmaf(p4[u][a], o4[c][u], av[a][c]);
                ak[a][c] = fmaf(s4[u][a], q4[c][u], ak[a][c]);
              }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int off = (4 * kj + a) * dh4 + 4 * cj;
          float4* v4 = reinterpret_cast<float4*>(dva + off);
          float4* k4 = reinterpret_cast<float4*>(dka + off);
          float4 x = *v4, y = *k4;
          x.x += av[a][0];
          x.y += av[a][1];
          x.z += av[a][2];
          x.w += av[a][3];
          y.x += ak[a][0];
          y.y += ak[a][1];
          y.z += ak[a][2];
          y.w += ak[a][3];
          *v4 = x;
          *k4 = y;
        }
      }
    }
  }
  __syncthreads();
  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
  const long long kbase =
      (static_cast<long long>(b) * m.hkv + g) * m.sk * dh;
  for (int e = tid; e < nj * dh; e += kThreads) {
    const int j = e / dh, d = e - j * dh;
    const long long i = kbase + static_cast<long long>(j0 + j) * dh + d;
    store(dk + i, dka[j * dh4 + d]);
    store(dv + i, dva[j * dh4 + d]);
  }
}

// ------------------------------------------------------------ 2. small ----
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_small_kernel(const Bwd p, long long n_problems) {
  extern __shared__ float4 smem4[];
  const Params& m = p.m;
  const int dh = m.dh, dp = p.dh_pad, sq = m.sq, sk = m.sk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a warp's slice: K, V [32][dp], Q, dO [32][dp], P, dS [32][33]
  float* base = reinterpret_cast<float*>(smem4) +
                warp * (4 * kSmallS * dp + 2 * kSmallS * (kSmallS + 1));
  float* ks = base;
  float* vs = ks + kSmallS * dp;
  float* qs = vs + kSmallS * dp;
  float* os = qs + kSmallS * dp;
  float* pm = os + kSmallS * dp;
  float* sm = pm + kSmallS * (kSmallS + 1);
  const int rep = m.h / m.hkv;
  const T* q = static_cast<const T*>(m.q);
  const T* k = static_cast<const T*>(m.k);
  const T* v = static_cast<const T*>(m.v);
  const T* o = static_cast<const T*>(p.o);
  const T* dout = static_cast<const T*>(p.dout);
  T* dq = static_cast<T*>(p.dq);
  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);

  for (long long prob_i = blockIdx.x * static_cast<long long>(kWarps) + warp;
       prob_i < n_problems;
       prob_i += static_cast<long long>(gridDim.x) * kWarps) {
    const int b = static_cast<int>(prob_i / m.hkv);
    const int g = static_cast<int>(prob_i - static_cast<long long>(b) * m.hkv);
    __syncwarp();
    for (int d = 0; d < dp; ++d) {
      float kx = 0.f, vx = 0.f;
      if (lane < sk && d < dh) {
        kx = to_f32(k[b * m.k_sb + g * m.k_sh + lane * m.k_ss + d]);
        vx = to_f32(v[b * m.v_sb + g * m.v_sh + lane * m.v_ss + d]);
      }
      ks[lane * dp + d] = kx;
      vs[lane * dp + d] = vx;
    }
    float dka[kSmallDh], dva[kSmallDh];
#pragma unroll
    for (int d = 0; d < kSmallDh; ++d) {
      dka[d] = 0.f;
      dva[d] = 0.f;
    }
    for (int hq = g * rep; hq < (g + 1) * rep; ++hq) {
      const bool row = lane < sq;
      const long long rbase =
          ((static_cast<long long>(b) * m.h + hq) * sq + lane) * dh;
      float qi[kSmallDh], oi[kSmallDh];
      float dsum = 0.f;
#pragma unroll
      for (int d = 0; d < kSmallDh; ++d) {
        float qx = 0.f, ox = 0.f;
        if (row && d < dh) {
          qx = to_f32(q[b * m.q_sb + hq * m.q_sh + lane * m.q_ss + d]);
          ox = to_f32(dout[rbase + d]);
          dsum = fmaf(ox, to_f32(o[rbase + d]), dsum);
        }
        qi[d] = qx;
        oi[d] = ox;
        if (d < dp) {
          qs[lane * dp + d] = qx;
          os[lane * dp + d] = ox;
        }
      }
      __syncwarp();
      // row `lane` of the logits, its lse, then P and dS
      float s[kSmallS];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSmallS; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kSmallDh; ++d) {
          if (d < dh) dot = fmaf(qi[d], ks[j * dp + d], dot);
        }
        const bool ok = row && j < sk && attends(m, j, lane);
        s[j] = masked_logit(m, ok, dot);
        mx = fmaxf(mx, s[j]);
      }
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < kSmallS; ++j) {
        if (s[j] != -INFINITY) l += expf(s[j] - mx);
      }
      const float lse = l > 0.f ? mx + logf(l) : INFINITY;
      float dqi[kSmallDh];
#pragma unroll
      for (int d = 0; d < kSmallDh; ++d) dqi[d] = 0.f;
#pragma unroll
      for (int j = 0; j < kSmallS; ++j) {
        float dpv = 0.f;
#pragma unroll
        for (int d = 0; d < kSmallDh; ++d) {
          if (d < dh) dpv = fmaf(oi[d], vs[j * dp + d], dpv);
        }
        const float pr = prob(s[j], lse);
        const float ds = dscore(m, s[j], lse, dpv, dsum);
        pm[lane * (kSmallS + 1) + j] = pr;
        sm[lane * (kSmallS + 1) + j] = ds;
#pragma unroll
        for (int d = 0; d < kSmallDh; ++d) {
          if (d < dh) dqi[d] = fmaf(ds, ks[j * dp + d], dqi[d]);
        }
      }
      if (row) {
#pragma unroll
        for (int d = 0; d < kSmallDh; ++d) {
          if (d < dh) store(dq + rbase + d, dqi[d]);
        }
      }
      __syncwarp();
      // column `lane`: dK += dS^T Q, dV += P^T dO over the rows in order
      for (int i = 0; i < sq; ++i) {
        const float pr = pm[i * (kSmallS + 1) + lane];
        const float ds = sm[i * (kSmallS + 1) + lane];
#pragma unroll
        for (int d = 0; d < kSmallDh; ++d) {
          if (d < dp) {
            dka[d] = fmaf(ds, qs[i * dp + d], dka[d]);
            dva[d] = fmaf(pr, os[i * dp + d], dva[d]);
          }
        }
      }
      __syncwarp();
    }
    if (lane < sk) {
      const long long kbase =
          ((static_cast<long long>(b) * m.hkv + g) * sk + lane) * dh;
#pragma unroll
      for (int d = 0; d < kSmallDh; ++d) {
        if (d < dh) {
          store(dk + kbase + d, dka[d]);
          store(dv + kbase + d, dva[d]);
        }
      }
    }
  }
}

// (per_row blocks, kv heads, batch) with the batch on grid.z up to
// 65,535 rows, folded into grid.x past that (one launch while it fits)
template <typename K>
cudaError_t launch_rows(K kernel, const Bwd& p, int per_row, int smem_bytes,
                        int* limit, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem_bytes, limit);
  if (err != cudaSuccess) return err;
  Bwd lp = p;
  lp.fold = p.batch > 65535;
  if (!lp.fold) {
    const dim3 grid(per_row, p.m.hkv, p.batch);
    kernel<<<grid, kThreads, smem_bytes, stream>>>(lp);
  } else {
    const long long x = static_cast<long long>(per_row) * p.batch;
    if (x > 0x7fffffffLL) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(x), p.m.hkv, 1);
    kernel<<<grid, kThreads, smem_bytes, stream>>>(lp);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiles(const Bwd& p, int dq_smem, int dkdv_smem,
                         cudaStream_t stream) {
  static int dq_limit = 48 * 1024, kv_limit = 48 * 1024;
  cudaError_t err = launch_rows(flash_bwd_dq_kernel<T>, p,
                                p.q_tiles * p.n_hc, dq_smem, &dq_limit,
                                stream);
  if (err != cudaSuccess) return err;
  return launch_rows(flash_bwd_dkdv_kernel<T>, p, p.k_tiles, dkdv_smem,
                     &kv_limit, stream);
}

template <typename T>
cudaError_t launch_small(const Bwd& p, int smem_bytes, cudaStream_t stream) {
  static int limit = 48 * 1024;
  cudaError_t err = allow_smem(flash_bwd_small_kernel<T>, smem_bytes, &limit);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(p.batch) * p.m.hkv;
  const long long blocks = (n + kWarps - 1) / kWarps;
  const unsigned grid = static_cast<unsigned>(
      blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL);
  flash_bwd_small_kernel<T><<<grid, kThreads, smem_bytes, stream>>>(p, n);
  return cudaGetLastError();
}

}  // namespace

// q, k, v through their strides (b, h, s; dh contiguous); o, dout, dq
// (B, H, Sq, dh) and dk, dv (B, Hkv, Sk, dh) contiguous; lse, dsum (B, H,
// Sq) f32 scratch of the tiles route. path 0 = tiles, 1 = small; the plan
// (hb, ppt, rp, bc, bk, shared bytes) from kernels/flash_attention.py
// `bwd_plan`.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* dsum,
    int batch, int h, int hkv, int sq, int sk, int dh, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    int causal, int window, int chunk, float softcap, float scale,
    int is_bf16, int path, int hb, int ppt, int rp, int bc, int bk,
    int dq_smem, int dkdv_smem, void* stream) {
  if (batch <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 ||
      sk <= 0 || dh <= 0 || dh > 256 || hkv > 65535 || path < 0 ||
      path > 1) {
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
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = lse;
  p.dsum = dsum;
  p.batch = batch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (sq > kSmallS || sk > kSmallS || dh > kSmallDh) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.dh_pad = dh <= 4 ? 4 : (dh <= 8 ? 8 : 16);
    return static_cast<int>(is_bf16 ? launch_small<__nv_bfloat16>(p, dq_smem,
                                                                   st)
                                    : launch_small<float>(p, dq_smem, st));
  }
  const int rep = h / hkv;
  if (hb <= 0 || ppt <= 0 || rp % 4 != 0 || bc % 4 != 0 || bk % 4 != 0 ||
      rp < hb * ppt || rp <= 0 || bc <= 0 || bk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.hb = hb;
  p.ppt = ppt;
  p.n_hc = (rep + hb - 1) / hb;
  p.rp = rp;
  p.bc = bc;
  p.bk = bk;
  p.dh4 = (dh + 3) / 4 * 4;
  p.q_tiles = (sq + ppt - 1) / ppt;
  p.k_tiles = (sk + bk - 1) / bk;
  return static_cast<int>(
      is_bf16 ? launch_tiles<__nv_bfloat16>(p, dq_smem, dkdv_smem, st)
              : launch_tiles<float>(p, dq_smem, dkdv_smem, st));
}

// the static shared bytes of this source's kernels (static_smem.cuh)
extern "C" int flash_attention_bwd_static_smem(int* bytes) {
  return repro_smem::max_static(
      {repro_smem::fn(flash_bwd_dq_kernel<float>),
       repro_smem::fn(flash_bwd_dq_kernel<__nv_bfloat16>),
       repro_smem::fn(flash_bwd_dkdv_kernel<float>),
       repro_smem::fn(flash_bwd_dkdv_kernel<__nv_bfloat16>),
       repro_smem::fn(flash_bwd_small_kernel<float>),
       repro_smem::fn(flash_bwd_small_kernel<__nv_bfloat16>)},
      bytes);
}
