// Attention with an online softmax, for the LMs' prefill and decode:
//   out[b, h, i] = sum_j softmax_j(mask(softcap(scale q_bhi . k_bgj))) v_bgj
// for q (B, H, Sq, dh) and k, v (B, Hkv, Sk, dh), f32 or bf16, where q
// head h reads kv head g = h / (H / Hkv) (GQA). Causal, sliding-window and
// chunk masks run in LOGICAL positions, slot - kv_start[b], so that a
// prompt left-padded into a serving batch attends as it does alone; kv
// slots below kv_start[b] are pad and never attended. Query slot i sits at
// kv slot q_offset + i. A row with no attended key writes 0.
//
// Replaces the TPU kernel `flash_attention_pallas` (src/repro/kernels/
// flash_attention.py, `_flash_kernel`). That kernel walks a (B, H, Sq/bq,
// Sk/bk) grid with the kv axis sequential and schedules every kv block,
// masked or not. Here one block of 256 threads takes a tile of query rows
// that share one kv head: the rep = H / Hkv heads of a kv head times up to
// 64 / rep query positions (64 rows; 32 past dh = 96), so decode's single
// position still fills rep rows. Its kv loop covers only the slots some
// row of the tile can attend, from max(kv_start, first slot - window + 1)
// (and the first row's chunk) to the last row's slot, in tiles of bc keys
// staged through shared memory as f32. Each tile: the score tile in 4 x 4
// register tiles of fused multiply-adds over dh (queries and keys stored
// transposed so that one 16-byte load feeds four products), the mask,
// a warp per row for the running max and sum, then the value product in
// 4 x 4 register tiles added to accumulators in shared memory after the
// rescale. Inputs are read once and upcast once; every sum is f32; the
// output is rounded once to q's type.
//
// What bounds it on an H100: at prefill, operations (4 dh per attended
// pair: 129 GFLOP for danube's 5,120-token prompt, 0.13 ms at the bf16
// tensor-core peak); at decode, bytes (the cache read once). This first
// kernel runs on the SIMT units, without tensor cores, TMA or a split of
// the kv range across blocks, so a decode step keeps only B x Hkv blocks
// busy; those are later work.
//
// dh may be any value up to 256 (80 for danube, 4 for BST): rows and
// tiles are padded to multiples of 4 in shared memory, with zeros, and
// every loop over dh runs to dh exactly. The shared-memory layout is
// carved at the top of flash_kernel; kernels/flash_attention.py
// `smem_plan` computes the same byte count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_start;
  void* out;
  int h, hkv, sq, sk, dh;
  long long q_sb, q_sh, q_ss;  // q's strides (elements); its dh stride is 1
  int q_offset, causal, window, chunk;  // window, chunk: 0 = none
  float softcap, scale;                 // softcap: 0 = none
  int hb, ppt, n_hc, bc, rp, dh4;       // tile plan, see smem_plan
  int blocks_per_row;                   // query tiles x head chunks
  int b0;                               // the launch's first batch row
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// a // b for b > 0, rounding toward -inf as Python and JAX do
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

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
  // blockIdx.x runs over (batch row, query tile, head chunk), so the
  // batch may exceed grid.z's 65,535
  const int bl = blockIdx.x / p.blocks_per_row;
  const int b = p.b0 + bl, g = blockIdx.y;
  const int tile = blockIdx.x - bl * p.blocks_per_row;
  const int qtile = tile / p.n_hc, hc = tile - qtile * p.n_hc;
  const int rep = p.h / p.hkv;
  const int s0 = qtile * p.ppt;                 // first query position
  const int h0 = g * rep + hc * p.hb;           // first q head
  const int n_h = min(p.hb, rep - hc * p.hb);   // heads in this tile
  const int n_pos = min(p.ppt, p.sq - s0);      // positions in this tile
  const int start = p.kv_start[b];

  // the kv slots some row of the tile can attend: [lo, hi]
  const int first = p.q_offset + s0, last = p.q_offset + s0 + n_pos - 1;
  int lo = max(start, 0), hi = p.sk - 1;
  if (p.causal) hi = min(hi, last);
  if (p.window > 0) lo = max(lo, first - p.window + 1);
  if (p.chunk > 0) {
    lo = max(lo, start + floor_div(first - start, p.chunk) * p.chunk);
    hi = min(hi, start + (floor_div(last - start, p.chunk) + 1) * p.chunk - 1);
  }

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

  const long long kv_off = (static_cast<long long>(b) * p.hkv + g) * p.sk * dh;
  const T* kb = static_cast<const T*>(p.k) + kv_off;
  const T* vb = static_cast<const T*>(p.v) + kv_off;
  const int n_rg = rp / 4, n_kg = bc / 4, n_cg = dh4 / 4;
  const int lane = tid & 31, warp = tid >> 5;

  for (int j0 = lo; j0 <= hi; j0 += bc) {
    const int nj = min(bc, hi - j0 + 1);
    for (int e = tid; e < bc * dh; e += kThreads) {
      const int j = e / dh, d = e - j * dh;
      float kx = 0.f, vx = 0.f;
      if (j < nj) {
        const long long o = static_cast<long long>(j0 + j) * dh + d;
        kx = to_f32(kb[o]);
        vx = to_f32(vb[o]);
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
          float s = acc[a][c] * p.scale;
          if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
          const int kp = j0 + j - start;
          bool ok = row_ok && j < nj;
          if (p.causal) ok = ok && kp <= qp;
          if (p.window > 0) ok = ok && kp > qp - p.window;
          if (p.chunk > 0) {
            ok = ok && floor_div(kp, p.chunk) == floor_div(qp, p.chunk);
          }
          s4[c] = ok ? s : -INFINITY;
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

template <typename T>
cudaError_t launch(const Params& p, int batch, int smem_bytes,
                   cudaStream_t stream) {
  // raise the dynamic shared-memory limit only when a launch needs more
  // than before, so that repeated launches (and CUDA graph captures of
  // them) make no further API call
  static int smem_limit = 0;
  if (smem_bytes > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return err;
    smem_limit = smem_bytes;
  }
  const long long per_row =
      static_cast<long long>((p.sq + p.ppt - 1) / p.ppt) * p.n_hc;
  if (per_row > 0x7fffffffLL || p.hkv > 65535) return cudaErrorInvalidValue;
  // batch rows a launch: as many as grid.x holds (one launch unless the
  // grid would pass 2**31 - 1 blocks)
  const long long rows = 0x7fffffffLL / per_row;
  Params lp = p;
  lp.blocks_per_row = static_cast<int>(per_row);
  for (long long b0 = 0; b0 < batch; b0 += rows) {
    const long long n = batch - b0 < rows ? batch - b0 : rows;
    lp.b0 = static_cast<int>(b0);
    const dim3 grid(static_cast<unsigned>(n * per_row), p.hkv, 1);
    flash_kernel<T><<<grid, kThreads, smem_bytes, stream>>>(lp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// hb (q heads per tile), ppt (query positions per tile), bc (keys per kv
// tile) and smem_bytes come from kernels/flash_attention.py `smem_plan`.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const int* kv_start,
    void* out, int batch, int h, int hkv, int sq, int sk, int dh,
    long long q_sb, long long q_sh, long long q_ss, int q_offset, int causal,
    int window, int chunk, float softcap, float scale, int is_bf16, int hb,
    int ppt, int bc, int smem_bytes, void* stream) {
  if (batch <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 ||
      sk <= 0 || dh <= 0 || dh > 256 || hb <= 0 || ppt <= 0 || bc <= 0 ||
      bc % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_start = kv_start;
  p.out = out;
  p.h = h;
  p.hkv = hkv;
  p.sq = sq;
  p.sk = sk;
  p.dh = dh;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_ss = q_ss;
  p.q_offset = q_offset;
  p.causal = causal;
  p.window = window;
  p.chunk = chunk;
  p.softcap = softcap;
  p.scale = scale;
  p.hb = hb;
  p.ppt = ppt;
  p.n_hc = (h / hkv + hb - 1) / hb;
  p.bc = bc;
  p.rp = (hb * ppt + 3) & ~3;
  p.dh4 = (dh + 3) & ~3;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(p, batch, smem_bytes, st)
              : launch<float>(p, batch, smem_bytes, st);
  return static_cast<int>(err);
}
