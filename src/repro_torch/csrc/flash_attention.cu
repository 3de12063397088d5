// Attention with a softmax over the attended keys, for the LMs' prefill and
// decode and for BST's short sequences:
//   out[b, h, i] = sum_j softmax_j(mask(softcap(scale q_bhi . k_bgj))) v_bgj
// for q (B, H, Sq, dh) and k, v (B, Hkv, Sk, dh), f32 or bf16, where q
// head h reads kv head g = h / (H / Hkv) (GQA). Causal, sliding-window and
// chunk masks run in LOGICAL positions, slot - kv_start[b], so that a
// prompt left-padded into a serving batch attends as it does alone; kv
// slots below kv_start[b] are pad and never attended. Query slot i sits at
// kv slot q_offset + i. A row with no attended key writes 0. q, k and v
// are read through their strides (the last dim contiguous), so the model's
// transposed views need no copy.
//
// Replaces the TPU kernel `flash_attention_pallas` (src/repro/kernels/
// flash_attention.py, `_flash_kernel`). That kernel walks a (B, H, Sq/bq,
// Sk/bk) grid with the kv axis sequential and schedules every kv block,
// masked or not. Here kernels/flash_attention.py `kernel_plan` picks one of
// four kernels by shape and dtype: the three below, and for bf16 prefill
// with dh a multiple of 16 up to 128 the tensor-core kernel of
// flash_wgmma.cuh; all sum in f32 and round the output once to q's type.
//
// 1. `flash_kernel` (prefill in f32 or at another dh, and anything the
//    others do not take): one block of 256 threads takes a tile of query
//    rows that share one kv head: the rep = H / Hkv heads of a kv head
//    times up to 64 / rep query positions (64 rows; 32 past dh = 96).
//    Its kv loop covers only the
//    slots some row of the tile can attend, from max(kv_start, first slot -
//    window + 1) (and the first row's chunk) to the last row's slot, in
//    tiles of bc keys staged through shared memory as f32. Each tile: the
//    score tile in 4 x 4 register tiles of fused multiply-adds over dh
//    (queries and keys stored transposed so that one 16-byte load feeds
//    four products), the mask, a warp per row for the running max and sum,
//    then the value product in 4 x 4 register tiles added to accumulators
//    in shared memory after the rescale. What bounds it: operations (4 dh
//    per attended pair: 129 GFLOP for danube's 5,120-token prompt, 0.13 ms
//    at the bf16 tensor-core peak); it runs on the SIMT units, and bf16
//    prefill at the models' dh goes to the wgmma kernel instead.
// 2. `flash_split_kernel` + `flash_combine_kernel` (decode: few query rows
//    over a long cache): what bounds it is bytes, the cache read once, and
//    B x Hkv blocks alone would leave most of the 132 SMs idle. So the
//    grid is (n_split, Hkv, B): each block takes one contiguous chunk of
//    the host's bound of the attended range for all rep x Sq query rows
//    of one kv head of one batch row, loads K and V as vectors of up to 16
//    bytes straight from device memory (a thread a key for q.k; a thread
//    a vector of columns and every (256 / vectors)-th key for p.v) and
//    writes its partial max, sum and f32 accumulator to scratch. A block
//    whose rows attend nothing of its chunk (below kv_start, say) returns
//    after one load. The combine kernel merges the partials of each (row,
//    kv head) in split order, so the output is the same bits from run to
//    run.
// 3. `flash_small_kernel` (BST: Sq, Sk <= 32, dh <= 16): a warp per (row,
//    head), a lane per query, the whole key range in shared memory, so one
//    softmax and no rescale; the 8 warps of a block take 8 (row, head)s and
//    walk the grid. What bounds it: bytes, q, k, v and out once.
//
// dh may be any value up to 256 (80 for danube, 4 for BST). The shared-
// memory layouts are carved at the top of each kernel; kernels/
// flash_attention.py `smem_plan` and `split_smem_bytes` compute the same
// byte counts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "flash_common.cuh"
#include "segment_sum.cuh"
#include "static_smem.cuh"

using namespace repro_flash;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitRows = 8;     // query rows a split block holds, at most
constexpr int kSplitTile = 128;   // keys a split block scores at a time
constexpr int kMaxSplit = 256;    // partials a combine block merges, at most
constexpr int kBatch = 8;         // K vectors a split thread loads at once
constexpr int kVBatch = 8;        // V vectors a split thread loads at once
constexpr int kMerge = 16;        // partials a combine thread loads at once
constexpr int kCombineThreads = 512;
constexpr int kSmallS = 32;       // Sq, Sk of the small kernel, at most
constexpr int kSmallDh = 16;      // dh of the small kernel, at most

// ------------------------------------------------------------ 1. tiles ----
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int dh = p.dh, dh4 = p.dh4, bc = p.bc, rp = p.rp;
  const int ldq = rp + 4, ldk = bc + 4, ldp = bc + 4;
  float* qt = reinterpret_cast<float*>(smem4);  // [dh][ldq] queries^T
  float* kt = qt + dh * ldq;                     // [dh][ldk] keys^T
  float* vs = kt + dh * ldk;                     // [bc][dh4] values
  float* sp = vs + bc * dh4;                     // [rp][ldp] scores, probs
  float* os = sp + rp * ldp;                     // [rp][dh4] accumulators
  float* ms = os + rp * dh4;                     // [rp] running max
  float* ls = ms + rp;                           // [rp] running sum
  float* al = ls + rp;                           // [rp] this tile's rescale

  const int tid = threadIdx.x;
  // the batch row on grid.z, or folded into grid.x (past grid.z's 65,535)
  int b, tile;
  tile_of_block(p, &b, &tile);
  const int g = blockIdx.y;
  const int qtile = tile / p.n_hc, hc = tile - qtile * p.n_hc;
  const int rep = p.h / p.hkv;
  const int s0 = qtile * p.ppt;                 // first query position
  const int h0 = g * rep + hc * p.hb;           // first q head
  const int n_h = min(p.hb, rep - hc * p.hb);   // heads in this tile
  const int n_pos = min(p.ppt, p.sq - s0);      // positions in this tile
  const int start = p.kv_start[b];

  // the kv slots some row of the tile can attend: [lo, hi]
  int lo, hi;
  kv_range(p, start, p.q_offset + s0, p.q_offset + s0 + n_pos - 1, &lo, &hi);

  // row r of the tile: position s0 + r / hb, head h0 + r % hb
  const T* q = static_cast<const T*>(p.q);
  for (int e = tid; e < rp * dh; e += kThreads) {
    const int r = e / dh, d = e - r * dh;
    const int pi = r / p.hb, hh = r - pi * p.hb;
    float x = 0.f;
    if (pi < n_pos && hh < n_h) {
      x = to_f32(q[b * p.q_sb + (h0 + hh) * p.q_sh + (s0 + pi) * p.q_ss + d]);
    }
    qt[d * ldq + r] = x;
  }
  for (int r = tid; r < rp; r += kThreads) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }
  for (int e = tid; e < rp * dh4; e += kThreads) os[e] = 0.f;
  for (int e = tid; e < bc * (dh4 - dh); e += kThreads) {
    const int j = e / (dh4 - dh);
    vs[j * dh4 + dh + (e - j * (dh4 - dh))] = 0.f;  // pad columns of V
  }
  __syncthreads();

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  const int n_rg = rp / 4, n_kg = bc / 4, n_cg = dh4 / 4;
  const int lane = tid & 31, warp = tid >> 5;

  for (int j0 = lo; j0 <= hi; j0 += bc) {
    const int nj = min(bc, hi - j0 + 1);
    for (int e = tid; e < bc * dh; e += kThreads) {
      const int j = e / dh, d = e - j * dh;
      float kx = 0.f, vx = 0.f;
      if (j < nj) {
        kx = to_f32(kb[(j0 + j) * p.k_ss + d]);
        vx = to_f32(vb[(j0 + j) * p.v_ss + d]);
      }
      kt[d * ldk + j] = kx;
      vs[j * dh4 + d] = vx;
    }
    __syncthreads();

    // scores: scale, softcap, then the mask (-inf where not attended)
    for (int t = tid; t < n_rg * n_kg; t += kThreads) {
      const int ri = t / n_kg, kj = t - ri * n_kg;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
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
        const int qp = p.q_offset + s0 + pi - start;
        float s4[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * kj + c;
          const bool ok = row_ok && j < nj && attends(p, j0 + j - start, qp);
          s4[c] = ok ? logit(p, acc[a][c]) : -INFINITY;
        }
        *reinterpret_cast<float4*>(sp + r * ldp + 4 * kj) =
            make_float4(s4[0], s4[1], s4[2], s4[3]);
      }
    }
    __syncthreads();

    // online softmax, a warp per row
    for (int r = warp; r < rp; r += kWarps) {
      float* row = sp + r * ldp;
      float mx = -INFINITY;
      for (int j = lane; j < bc; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      if (m_new == -INFINITY) {
        for (int j = lane; j < bc; j += 32) row[j] = 0.f;
      } else {
        for (int j = lane; j < bc; j += 32) {
          const float e = expf(row[j] - m_new);  // exp(-inf) = 0
          row[j] = e;
          sum += e;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      __syncwarp();
      if (lane == 0) {
        const float alpha = m_new == -INFINITY ? 1.f : expf(m_prev - m_new);
        ls[r] = alpha * ls[r] + sum;
        ms[r] = m_new;
        al[r] = alpha;
      }
    }
    __syncthreads();

    // accumulators: o = o * alpha + p v, four keys a step
    const int nj4 = (nj + 3) & ~3;
    for (int t = tid; t < n_rg * n_cg; t += kThreads) {
      const int ri = t / n_cg, cj = t - ri * n_cg;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
      for (int j = 0; j < nj4; j += 4) {
        float pr[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 x = ld4(sp + (4 * ri + a) * ldp + j);
          pr[a][0] = x.x;
          pr[a][1] = x.y;
          pr[a][2] = x.z;
          pr[a][3] = x.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 y = ld4(vs + (j + u) * dh4 + 4 * cj);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[a][0] = fmaf(pr[a][u], y.x, acc[a][0]);
            acc[a][1] = fmaf(pr[a][u], y.y, acc[a][1]);
            acc[a][2] = fmaf(pr[a][u], y.z, acc[a][2]);
            acc[a][3] = fmaf(pr[a][u], y.w, acc[a][3]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float alpha = al[4 * ri + a];
        float4* o = reinterpret_cast<float4*>(os + (4 * ri + a) * dh4 + 4 * cj);
        float4 x = *o;
        x.x = fmaf(x.x, alpha, acc[a][0]);
        x.y = fmaf(x.y, alpha, acc[a][1]);
        x.z = fmaf(x.z, alpha, acc[a][2]);
        x.w = fmaf(x.w, alpha, acc[a][3]);
        *o = x;
      }
    }
    __syncthreads();
  }

  // out = o / l, 0 for a row that attended nothing
  T* out = static_cast<T*>(p.out);
  for (int e = tid; e < rp * dh; e += kThreads) {
    const int r = e / dh, d = e - r * dh;
    const int pi = r / p.hb, hh = r - pi * p.hb;
    if (pi >= n_pos || hh >= n_h) continue;
    const float l = ls[r];
    const float x = l > 0.f ? os[r * dh4 + d] / l : 0.f;
    store(out + ((static_cast<long long>(b) * p.h + h0 + hh) * p.sq + s0 + pi)
                    * dh + d, x);
  }
}

// ------------------------------------------------------------ 2. split ----
// VEC elements of T, one load of up to 16 bytes (the widest that dh, the
// strides and the base allow), kept raw until used
template <typename T, int VEC>
using raw_vec = typename repro_kernels::Raw<sizeof(T) * VEC>::type;

template <typename T, int VEC>
__device__ __forceinline__ raw_vec<T, VEC> load_raw(const T* src) {
  return __ldg(reinterpret_cast<const raw_vec<T, VEC>*>(src));
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const raw_vec<T, VEC>& raw,
                                       float* dst) {
  T x[VEC];
  memcpy(x, &raw, sizeof(raw));
#pragma unroll
  for (int v = 0; v < VEC; ++v) dst[v] = to_f32(x[v]);
}

// The slots [lo, hi] of chunk s that batch row b's queries can attend
// (lo > hi: none). The split and combine kernels both use it.
__device__ __forceinline__ void chunk_range(const Params& p, int start,
                                            int s, int* lo, int* hi) {
  kv_range(p, start, p.q_offset, p.q_offset + p.sq - 1, lo, hi);
  const int c_lo = p.split_lo + s * p.split_len;
  *lo = max(*lo, c_lo);
  *hi = min(*hi, c_lo + p.split_len - 1);
}

// One block per (kv chunk s, kv head g, batch row b), for the rows = rep x
// Sq query rows of that kv head (ROWS, a power of two, bounds them in
// registers); a block whose rows attend nothing of its chunk (a left-
// padded short prompt, say) returns at once. Partial of (b, g, s) at
// scratch + ((b * hkv + g) * n_split + s) * rows * (dh + 2): [rows] max,
// [rows] sum, [rows][dh] accumulators. Each tile of up to 128 keys: two
// threads a key for the scores (each half the key's vectors, added by a
// shuffle), a warp a row for the softmax, then thread (kq, cv) adds keys
// kq, kq + ks, ... of vector cv of V; the key subsets' parts are added in
// subset order. A tile's K loads and the first tile's q are issued
// together, and its V loads before the softmax, so a tile waits on device
// memory about twice.
template <typename T, int VEC, int ROWS>
__global__ void __launch_bounds__(kThreads, 2)
    flash_split_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int dh = p.dh, rep = p.h / p.hkv, rows = rep * p.sq;  // <= ROWS
  const int ncv = dh / VEC, ks = kThreads / ncv, hv = (ncv + 1) / 2;
  float* qs = reinterpret_cast<float*>(smem4);  // [rows][dh] queries
  float* sp = qs + rows * dh;                    // [rows][tile] scores, probs
  float* red = sp + rows * kSplitTile;           // [ks][rows][dh] p.v parts
  float* os = red + ks * rows * dh;              // [rows][dh] accumulators
  float* ms = os + rows * dh;                    // [rows] running max
  float* ls = ms + rows;                         // [rows] running sum
  float* al = ls + rows;                         // [rows] this tile's rescale

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int key = tid >> 1, c_lo = (tid & 1) * hv;  // q.k: key, vectors
  const int c_hi = min(c_lo + hv, ncv);
  const int kq = tid / ncv, cv = tid - kq * ncv;    // p.v: key subset, vector
  const int start = p.kv_start[b];
  int lo, hi;
  chunk_range(p, start, s, &lo, &hi);
  if (lo > hi) return;

  const T* q = static_cast<const T*>(p.q);
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  for (int j0 = lo; j0 <= hi; j0 += kSplitTile) {
    const int nj = min(kSplitTile, hi - j0 + 1);
    // this tile's loads: the first kBatch vectors of this thread's half of
    // its key and (first tile) the queries
    raw_vec<T, VEC> kraw[kBatch], vraw[kVBatch];
    const T* kr = kb + (j0 + key) * p.k_ss;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (key < nj && c_lo + u < c_hi) {
        kraw[u] = load_raw<T, VEC>(kr + (c_lo + u) * VEC);
      }
    }
    if (j0 == lo) {
      // row r: position r / rep, head g * rep + r % rep
      for (int e = tid; e < rows * dh; e += kThreads) {
        const int r = e / dh, d = e - r * dh;
        const int pi = r / rep, hh = r - pi * rep;
        qs[e] = to_f32(
            q[b * p.q_sb + (g * rep + hh) * p.q_sh + pi * p.q_ss + d]);
        os[e] = 0.f;
      }
      if (tid < rows) {
        ms[tid] = -INFINITY;
        ls[tid] = 0.f;
      }
      __syncthreads();
    }

    // scores: two threads a key
    {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      if (key < nj) {
        for (int c0 = c_lo; c0 < c_hi; c0 += kBatch) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (c0 > c_lo && c0 + u < c_hi) {
              kraw[u] = load_raw<T, VEC>(kr + (c0 + u) * VEC);
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (c0 + u < c_hi) {
              float x[VEC];
              unpack<T, VEC>(kraw[u], x);
#pragma unroll
              for (int r = 0; r < ROWS; ++r) {
                if (r < rows) {
                  const float* qr = qs + r * dh + (c0 + u) * VEC;
#pragma unroll
                  for (int v = 0; v < VEC; ++v) {
                    acc[r] = fmaf(qr[v], x[v], acc[r]);
                  }
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        // the key's second half added to its first, in that order
        const float other = __shfl_xor_sync(0xffffffffu, acc[r], 1);
        if (r < rows && (tid & 1) == 0) {
          const float dot = acc[r] + other;
          const int qp = p.q_offset + r / rep - start;
          const bool ok = key < nj && attends(p, j0 + key - start, qp);
          sp[r * kSplitTile + key] = ok ? logit(p, dot) : -INFINITY;
        }
      }
    }
    // the first kVBatch keys of this thread's p.v subset, in flight while
    // the softmax runs
#pragma unroll
    for (int u = 0; u < kVBatch; ++u) {
      const int jj = kq + u * ks;
      if (kq < ks && jj < nj) {
        vraw[u] = load_raw<T, VEC>(vb + (j0 + jj) * p.v_ss + cv * VEC);
      }
    }
    __syncthreads();

    // softmax: a warp per row
    for (int r = warp; r < rows; r += kWarps) {
      float* row = sp + r * kSplitTile;
      float mx = -INFINITY;
      for (int j = lane; j < kSplitTile; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kSplitTile; j += 32) {
        const float e = m_new == -INFINITY ? 0.f : expf(row[j] - m_new);
        row[j] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      __syncwarp();
      if (lane == 0) {
        const float alpha = m_new == -INFINITY ? 1.f : expf(m_prev - m_new);
        ls[r] = alpha * ls[r] + sum;
        ms[r] = m_new;
        al[r] = alpha;
      }
    }
    __syncthreads();

    // p.v: thread (kq, cv) adds keys kq, kq + ks, ... of vector cv
    if (kq < ks) {
      float acc[ROWS][VEC];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
      for (int j = kq; j < nj; j += kVBatch * ks) {
#pragma unroll
        for (int u = 0; u < kVBatch; ++u) {
          const int jj = j + u * ks;
          if (j > kq && jj < nj) {
            vraw[u] = load_raw<T, VEC>(vb + (j0 + jj) * p.v_ss + cv * VEC);
          }
        }
#pragma unroll
        for (int u = 0; u < kVBatch; ++u) {
          const int jj = j + u * ks;
          if (jj < nj) {
            float x[VEC];
            unpack<T, VEC>(vraw[u], x);
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              if (r < rows) {
                const float pr = sp[r * kSplitTile + jj];
#pragma unroll
                for (int v = 0; v < VEC; ++v) {
                  acc[r][v] = fmaf(pr, x[v], acc[r][v]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < rows) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            red[(kq * rows + r) * dh + cv * VEC + v] = acc[r][v];
          }
        }
      }
    }
    __syncthreads();

    // o = o * alpha + the key subsets' parts, added in subset order
    for (int e = tid; e < rows * dh; e += kThreads) {
      float t = 0.f;
      for (int k = 0; k < ks; ++k) t += red[k * rows * dh + e];
      os[e] = fmaf(os[e], al[e / dh], t);
    }
    __syncthreads();
  }

  float* part = p.scratch +
      ((static_cast<long long>(b) * p.hkv + g) * p.n_split + s) * rows *
          (dh + 2);
  for (int e = tid; e < rows * (dh + 2); e += kThreads) {
    part[e] = e < rows ? ms[e] : e < 2 * rows ? ls[e - rows]
                                              : os[e - 2 * rows];
  }
}

// One block of 512 threads per (kv head g, batch row b): the partials of
// the chunks its queries attend merged in split order (a chunk they do not
// attend was never written: its loads are made, then passed over); out =
// o / l, 0 for a row that attended nothing. The partials' max and sum are
// staged in shared memory by all threads at once, and each output's loads
// are kept in flight kMerge at a time.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    flash_combine_kernel(const Params p) {
  __shared__ float mw[kMaxSplit * kSplitRows];  // [c][r] max, then weight
  __shared__ float sl[kMaxSplit * kSplitRows];  // [c][r] sum
  __shared__ float mrow[kSplitRows], lsum[kSplitRows];
  __shared__ unsigned char live[kMaxSplit];
  const int dh = p.dh, rep = p.h / p.hkv, rows = rep * p.sq, ns = p.n_split;
  const int tid = threadIdx.x, g = blockIdx.x, b = blockIdx.y;
  const long long stride = static_cast<long long>(rows) * (dh + 2);
  const float* parts =
      p.scratch + (static_cast<long long>(b) * p.hkv + g) * ns * stride;
  const int start = p.kv_start[b];
  for (int t = tid; t < ns * rows; t += kCombineThreads) {
    const int c = t / rows, r = t - c * rows;
    const float m = parts[c * stride + r], l = parts[c * stride + rows + r];
    int lo, hi;
    chunk_range(p, start, c, &lo, &hi);
    if (r == 0) live[c] = lo <= hi;
    mw[t] = lo <= hi ? m : -INFINITY;
    sl[t] = lo <= hi ? l : 0.f;
  }
  __syncthreads();
  if (tid < rows) {
    float m = -INFINITY;
    for (int c = 0; c < ns; ++c) m = fmaxf(m, mw[c * rows + tid]);
    mrow[tid] = m;
  }
  __syncthreads();
  for (int t = tid; t < ns * rows; t += kCombineThreads) {
    const float m = mrow[t - (t / rows) * rows];
    mw[t] = m == -INFINITY ? 0.f : expf(mw[t] - m);  // exp(-inf) = 0
  }
  __syncthreads();
  if (tid < rows) {
    float l = 0.f;
    for (int c = 0; c < ns; ++c) {
      l = fmaf(sl[c * rows + tid], mw[c * rows + tid], l);
    }
    lsum[tid] = l;
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out);
  for (int e = tid; e < rows * dh; e += kCombineThreads) {
    const int r = e / dh, d = e - r * dh;
    float o = 0.f;
    for (int c0 = 0; c0 < ns; c0 += kMerge) {
      float x[kMerge];
#pragma unroll
      for (int u = 0; u < kMerge; ++u) {
        x[u] = c0 + u < ns ? parts[(c0 + u) * stride + 2 * rows + e] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kMerge; ++u) {
        if (c0 + u < ns && live[c0 + u]) {
          o = fmaf(x[u], mw[(c0 + u) * rows + r], o);
        }
      }
    }
    const float l = lsum[r];
    const int pi = r / rep, hh = r - pi * rep;
    store(out + ((static_cast<long long>(b) * p.h + g * rep + hh) * p.sq + pi)
                    * dh + d,
          l > 0.f ? o / l : 0.f);
  }
}

// ------------------------------------------------------------ 3. small ----
// A warp per (batch row, q head): lane j stages key j's K and V rows in the
// warp's shared memory, lane i scores query i against every key, takes one
// softmax and the value sum. The 8 warps of a block take 8 consecutive
// pairs (one BST row's 8 heads, whose rows share cache lines) and walk the
// grid; each lane loads the next pair's rows into registers while it
// computes the current one. DH: dh rounded up to 4, 8 or 16.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_small_kernel(const Params p, int n_pairs) {
  extern __shared__ float4 smem4[];
  const int dh = p.dh, rep = p.h / p.hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ks = reinterpret_cast<float*>(smem4) + warp * 2 * kSmallS * DH;
  float* vs = ks + kSmallS * DH;  // [32][DH] each, zero past dh
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* out = static_cast<T*>(p.out);
  const int step = gridDim.x * kWarps;

  // this lane's K, V and q rows and kv_start of a pair, into registers
  float kx[DH], vx[DH], qx[DH];
  int start_x = 0;
  auto fetch = [&](int pair) {
    const int b = pair / p.h, hh = pair - b * p.h, g = hh / rep;
    start_x = p.kv_start[b];
#pragma unroll
    for (int d = 0; d < DH; ++d) kx[d] = vx[d] = qx[d] = 0.f;
    if (lane < p.sk) {
      const T* kr = k + b * p.k_sb + g * p.k_sh + lane * p.k_ss;
      const T* vr = v + b * p.v_sb + g * p.v_sh + lane * p.v_ss;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        if (d < dh) {
          kx[d] = to_f32(kr[d]);
          vx[d] = to_f32(vr[d]);
        }
      }
    }
    if (lane < p.sq) {
      const T* qr = q + b * p.q_sb + hh * p.q_sh + lane * p.q_ss;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        if (d < dh) qx[d] = to_f32(qr[d]);
      }
    }
  };

  int pair = blockIdx.x * kWarps + warp;
  if (pair < n_pairs) fetch(pair);
  for (; pair < n_pairs; pair += step) {
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      ks[lane * DH + d] = kx[d];
      vs[lane * DH + d] = vx[d];
    }
    float qv[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qv[d] = qx[d];
    const int start = start_x;
    __syncwarp();
    if (pair + step < n_pairs) fetch(pair + step);
    if (lane < p.sq) {
      // the keys query slot q_offset + lane attends: one interval
      int jlo, jhi;
      kv_range(p, start, p.q_offset + lane, p.q_offset + lane, &jlo, &jhi);
      float s[kSmallS];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSmallS; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) dot = fmaf(qv[d], ks[j * DH + d], dot);
        s[j] = j >= jlo && j <= jhi ? logit(p, dot) : -INFINITY;
        m = fmaxf(m, s[j]);
      }
      float l = 0.f, o[DH];
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] = 0.f;
      if (m != -INFINITY) {
#pragma unroll
        for (int j = 0; j < kSmallS; ++j) {
          if (j < p.sk) {
            const float e = expf(s[j] - m);  // exp(-inf) = 0
            l += e;
#pragma unroll
            for (int d = 0; d < DH; ++d) o[d] = fmaf(e, vs[j * DH + d], o[d]);
          }
        }
      }
      T* orow = out + (static_cast<long long>(pair) * p.sq + lane) * dh;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        if (d < dh) store(orow + d, l > 0.f ? o[d] / l : 0.f);
      }
    }
    __syncwarp();
  }
}

// ----------------------------------------------------------- launches ----
// raise a kernel's dynamic shared-memory limit only when a launch needs
// more than before, so that repeated launches (and CUDA graph captures of
// them) make no further API call
template <typename T>
cudaError_t launch_tiles(const Params& p, int batch, int smem_bytes,
                         cudaStream_t stream) {
  static int smem_limit = 0;
  return launch_tile_grid(flash_kernel<T>, p, batch, kThreads, smem_bytes,
                          &smem_limit, stream);
}

template <typename T, int VEC, int ROWS>
cudaError_t launch_split(const Params& p, int batch, int smem_bytes,
                         cudaStream_t stream) {
  static int smem_limit = 0;
  cudaError_t err =
      allow_smem(flash_split_kernel<T, VEC, ROWS>, smem_bytes, &smem_limit);
  if (err != cudaSuccess) return err;
  flash_split_kernel<T, VEC, ROWS>
      <<<dim3(p.n_split, p.hkv, batch), kThreads, smem_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_combine_kernel<T>
      <<<dim3(p.hkv, batch), kCombineThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_split_rows(const Params& p, int batch, int smem_bytes,
                              cudaStream_t stream) {
  switch ((p.h / p.hkv) * p.sq) {
    case 1: return launch_split<T, VEC, 1>(p, batch, smem_bytes, stream);
    case 2: return launch_split<T, VEC, 2>(p, batch, smem_bytes, stream);
    case 3:
    case 4: return launch_split<T, VEC, 4>(p, batch, smem_bytes, stream);
    default: return launch_split<T, VEC, 8>(p, batch, smem_bytes, stream);
  }
}

template <typename T>
cudaError_t launch_split_vec(const Params& p, int vec, int batch,
                             int smem_bytes, cudaStream_t stream) {
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2) {
        return launch_split_rows<T, 8>(p, batch, smem_bytes, stream);
      }
      break;
    case 4: return launch_split_rows<T, 4>(p, batch, smem_bytes, stream);
    case 2: return launch_split_rows<T, 2>(p, batch, smem_bytes, stream);
    case 1: return launch_split_rows<T, 1>(p, batch, smem_bytes, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int DH>
cudaError_t launch_small(const Params& p, int batch, int smem_bytes,
                         cudaStream_t stream) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) return err;
  }
  const long long n_pairs = static_cast<long long>(batch) * p.h;
  if (n_pairs > 0x7fffffffLL - 32LL * kWarps * n_sm) {
    return cudaErrorInvalidValue;
  }
  // enough blocks to fill every SM several times over; each warp then
  // walks its share of the (row, head) pairs
  const long long want = (n_pairs + kWarps - 1) / kWarps;
  const long long cap = 32LL * n_sm;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  flash_small_kernel<T, DH><<<grid, kThreads, smem_bytes, stream>>>(
      p, static_cast<int>(n_pairs));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_small_dh(const Params& p, int batch, int smem_bytes,
                            cudaStream_t stream) {
  if (p.dh <= 4) return launch_small<T, 4>(p, batch, smem_bytes, stream);
  if (p.dh <= 8) return launch_small<T, 8>(p, batch, smem_bytes, stream);
  return launch_small<T, 16>(p, batch, smem_bytes, stream);
}

}  // namespace

// path: 0 tiles, 1 split, 2 small, 3 wgmma (kernels/flash_attention.py
// `kernel_plan`). hb, ppt, bc (the tile plan) and smem_bytes come from its
// `smem_plan` / `wgmma_plan` / `split_smem_bytes` / `small_smem_bytes`;
// vec (elements a K / V load) from `split_vec`; scratch holds the split
// partials (B x Hkv x n_split x rows x (dh + 2) floats); lse, where not
// null, the wgmma route's (B, H, Sq) f32 log-sum-exp of each row.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const int* kv_start,
    void* out, int batch, int h, int hkv, int sq, int sk, int dh,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, int q_offset, int causal, int window, int chunk,
    float softcap, float scale, int is_bf16, int path, int hb, int ppt,
    int bc, int smem_bytes, int batch_on_z, int n_split, int split_lo,
    int split_len, int vec, void* scratch, float* lse, void* stream) {
  if (batch <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 ||
      sk <= 0 || dh <= 0 || dh > 256 || path < 0 || path > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_start = kv_start;
  p.out = out;
  p.scratch = static_cast<float*>(scratch);
  p.lse = lse;
  p.h = h;
  p.hkv = hkv;
  p.sq = sq;
  p.sk = sk;
  p.dh = dh;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_ss = v_ss;
  p.q_offset = q_offset;
  p.causal = causal;
  p.window = window;
  p.chunk = chunk;
  p.softcap = softcap;
  p.scale = scale;
  p.hb = hb;
  p.ppt = ppt;
  p.n_hc = hb > 0 ? (h / hkv + hb - 1) / hb : 0;
  p.bc = bc;
  p.rp = (hb * ppt + 3) & ~3;
  p.dh4 = (dh + 3) & ~3;
  p.blocks_per_row = 0;
  p.b0 = 0;
  p.batch_on_z = batch_on_z;
  p.n_split = n_split;
  p.split_lo = split_lo;
  p.split_len = split_len;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (path == 0) {
    if (hb <= 0 || ppt <= 0 || bc <= 0 || bc % 4 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    err = is_bf16 ? launch_tiles<__nv_bfloat16>(p, batch, smem_bytes, st)
                  : launch_tiles<float>(p, batch, smem_bytes, st);
  } else if (path == 1) {
    if ((h / hkv) * sq > kSplitRows || n_split <= 0 || n_split > kMaxSplit ||
        split_len <= 0 || batch > 65535 || hkv > 65535 || vec <= 0 ||
        dh % vec != 0 || dh / vec > kThreads || scratch == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    err = is_bf16
              ? launch_split_vec<__nv_bfloat16>(p, vec, batch, smem_bytes, st)
              : launch_split_vec<float>(p, vec, batch, smem_bytes, st);
  } else if (path == 2) {
    if (sq > kSmallS || sk > kSmallS || dh > kSmallDh) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    err = is_bf16 ? launch_small_dh<__nv_bfloat16>(p, batch, smem_bytes, st)
                  : launch_small_dh<float>(p, batch, smem_bytes, st);
  } else {
    if (!is_bf16 || hb <= 0 || ppt <= 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    err = launch_wgmma(p, batch, smem_bytes, st);
  }
  return static_cast<int>(err);
}

// the static shared bytes of this source's kernels (static_smem.cuh)
extern "C" int flash_attention_static_smem(int* bytes) {
  return repro_smem::max_static(
      {repro_smem::fn(flash_kernel<float>),
       repro_smem::fn(flash_kernel<__nv_bfloat16>),
       repro_smem::fn(flash_split_kernel<float, 4, 1>),
       repro_smem::fn(flash_split_kernel<float, 4, 2>),
       repro_smem::fn(flash_split_kernel<float, 4, 4>),
       repro_smem::fn(flash_split_kernel<float, 4, 8>),
       repro_smem::fn(flash_split_kernel<float, 2, 1>),
       repro_smem::fn(flash_split_kernel<float, 2, 2>),
       repro_smem::fn(flash_split_kernel<float, 2, 4>),
       repro_smem::fn(flash_split_kernel<float, 2, 8>),
       repro_smem::fn(flash_split_kernel<float, 1, 1>),
       repro_smem::fn(flash_split_kernel<float, 1, 2>),
       repro_smem::fn(flash_split_kernel<float, 1, 4>),
       repro_smem::fn(flash_split_kernel<float, 1, 8>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 8, 1>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 8, 2>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 8, 4>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 8, 8>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 4, 1>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 4, 2>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 4, 4>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 4, 8>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 2, 1>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 2, 2>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 2, 4>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 2, 8>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 1, 1>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 1, 2>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 1, 4>),
       repro_smem::fn(flash_split_kernel<__nv_bfloat16, 1, 8>),
       repro_smem::fn(flash_combine_kernel<float>),
       repro_smem::fn(flash_combine_kernel<__nv_bfloat16>),
       repro_smem::fn(flash_small_kernel<float, 4>),
       repro_smem::fn(flash_small_kernel<float, 8>),
       repro_smem::fn(flash_small_kernel<float, 16>),
       repro_smem::fn(flash_small_kernel<__nv_bfloat16, 4>),
       repro_smem::fn(flash_small_kernel<__nv_bfloat16, 8>),
       repro_smem::fn(flash_small_kernel<__nv_bfloat16, 16>)},
      bytes);
}
