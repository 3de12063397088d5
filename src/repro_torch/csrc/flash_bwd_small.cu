// The attention backward's "small" route (kernels/flash_attention.py
// `bwd_plan`: Sq, Sk <= 32, dh <= 16; BST's 21 x 21 x dh 4): dQ, dK and
// dV of flash_attention.cu's forward, as csrc/flash_attention_bwd.cu
// defines them (P = exp(S - lse), D = rowsum(dO o O), dP = dO V^T, dS = P
// o (dP - D) o softcap's factor, dQ = scale dS K, dK = scale dS^T Q, dV =
// P^T dO, dK and dV summed over a kv head's query heads), in the inputs'
// type, summed in f32 and rounded once.
//
// The JAX package has no backward kernel (it differentiates its plain
// attention, src/repro/kernels/ref.py `attention_ref`, where the TPU
// kernel `flash_attention_pallas` serves the forward); this kernel is the
// port's own and is held to kernels/ref.py `attention_bwd_ref`.
//
// What bounds it on an H100: bytes. At BST's train batch (65,536 x 8 heads
// x 21 x 21 x dh 4, f32) its five inputs read once and three outputs
// written once are 1.41 GB, 0.42 ms, against ~0.14 ms of f32 FMA and two
// exps an entry. Its design keeps every lane busy, loads rows 16 bytes at
// a time and asks ~1.6 KB of shared memory a problem.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "static_smem.cuh"

using repro_flash::Params;
using repro_flash::allow_smem;
using repro_flash::attends;
using repro_flash::logit;
using repro_flash::store;
using repro_flash::to_f32;

namespace {

constexpr int kThreads = 256;
constexpr int kSmallS = 32;
constexpr int kSmallDh = 16;

struct SmallBwd {
  Params m;              // q, k, v, strides, masks, scale, softcap, dh
  const void* o;         // (B, H, Sq, dh) contiguous
  const void* dout;      // (B, H, Sq, dh) contiguous
  void* dq;              // (B, H, Sq, dh) contiguous
  void* dk;              // (B, Hkv, Sk, dh) contiguous
  void* dv;
  int batch;
  int per, pf, vec;      // problems a block, floats a problem, 16-byte rows
};

// the scaled, capped logit of a pair, or -inf where it is not attended
__device__ __forceinline__ float masked_logit(const Params& p, bool ok,
                                              float dot) {
  return ok ? logit(p, dot) : -INFINITY;
}

// One problem is a (batch row, kv head): its rep x sq query rows (query
// head major) against its sk keys. A block takes `per` problems and lays
// the flat (problem, row) and (problem, key) pairs over its 256 threads,
// so that no lane idles at BST's 21 x 21 (12 problems, 252 threads). Each
// problem keeps in shared memory, f32, at its real size: K, V [sk][DH], Q,
// dO [rows][DH], and each row's max, 1 / sum and D (`small_floats`).
//
// Phase 1, a thread a query row: Q, O, dO rows by 16-byte loads (8 for a
// bf16 dh-4 row), D = dO . O, the row's logits against the staged keys,
// e_j = exp(s_j - max) once an entry, P = e_j / sum; then dP, dS and dQ =
// dS K in registers; Q, dO, max, 1 / sum and D go to shared memory.
// Phase 2, a thread a key: for each of the kv head's query heads in order,
// each row in order, the pair's logit and P = exp(s - max) (1 / sum) again,
// with the same operations as phase 1, so the same bits, and dK += dS Q,
// dV += P dO. No atomics: two calls give the same bits.
//
// Templated on DH (dh rounded up to 4, 8, 16) and SK8 (sk rounded up to
// 8): phase 1 keeps a row's e_j in SK8 registers and skips the keys past
// sk; no product runs on a padded key, nor on a padded dim where dh is 4,
// 8 or 16.

// floats a problem keeps, a multiple of 4 (float4 rows)
__host__ __device__ constexpr int small_floats(int dh_pad, int rows,
                                               int sk) {
  return (2 * sk * dh_pad + 2 * rows * dh_pad + 3 * rows + 3) / 4 * 4;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
         | (static_cast<uint32_t>(
                __bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// a row of dh <= DH elements as f32, zeros past dh: by 16-byte loads (8
// for DH 4 in bf16) where `vec` (dh == DH, the rows aligned), else one by
// one
template <int DH>
__device__ __forceinline__ void load_row(const float* x, int dh, bool vec,
                                         float (&r)[DH]) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < DH / 4; ++c) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(x) + c);
      r[4 * c] = t.x;
      r[4 * c + 1] = t.y;
      r[4 * c + 2] = t.z;
      r[4 * c + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) r[d] = d < dh ? x[d] : 0.f;
  }
}
template <int DH>
__device__ __forceinline__ void load_row(const __nv_bfloat16* x, int dh,
                                         bool vec, float (&r)[DH]) {
  if (vec && DH == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(x));
    r[0] = bf16_lo(t.x);
    r[1] = bf16_hi(t.x);
    r[2] = bf16_lo(t.y);
    r[3] = bf16_hi(t.y);
  } else if (vec) {
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(x) + c);
      const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        r[8 * c + 2 * u] = bf16_lo(w[u]);
        r[8 * c + 2 * u + 1] = bf16_hi(w[u]);
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) r[d] = d < dh ? to_f32(x[d]) : 0.f;
  }
}
template <int DH>
__device__ __forceinline__ void store_row(float* x, int dh, bool vec,
                                          const float (&r)[DH]) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < DH / 4; ++c) {
      reinterpret_cast<float4*>(x)[c] =
          make_float4(r[4 * c], r[4 * c + 1], r[4 * c + 2], r[4 * c + 3]);
    }
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      if (d < dh) x[d] = r[d];
    }
  }
}
template <int DH>
__device__ __forceinline__ void store_row(__nv_bfloat16* x, int dh, bool vec,
                                          const float (&r)[DH]) {
  if (vec && DH == 4) {
    *reinterpret_cast<uint2*>(x) =
        make_uint2(bf16_pair(r[0], r[1]), bf16_pair(r[2], r[3]));
  } else if (vec) {
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      reinterpret_cast<uint4*>(x)[c] = make_uint4(
          bf16_pair(r[8 * c], r[8 * c + 1]),
          bf16_pair(r[8 * c + 2], r[8 * c + 3]),
          bf16_pair(r[8 * c + 4], r[8 * c + 5]),
          bf16_pair(r[8 * c + 6], r[8 * c + 7]));
    }
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      if (d < dh) store(x + d, r[d]);
    }
  }
}
// DH floats to and from shared memory (16-byte aligned), as float4s
template <int DH>
__device__ __forceinline__ void put4(float* x, const float (&r)[DH]) {
#pragma unroll
  for (int c = 0; c < DH / 4; ++c) {
    reinterpret_cast<float4*>(x)[c] =
        make_float4(r[4 * c], r[4 * c + 1], r[4 * c + 2], r[4 * c + 3]);
  }
}
template <int DH>
__device__ __forceinline__ void get4(const float* x, float (&r)[DH]) {
#pragma unroll
  for (int c = 0; c < DH / 4; ++c) {
    const float4 t = reinterpret_cast<const float4*>(x)[c];
    r[4 * c] = t.x;
    r[4 * c + 1] = t.y;
    r[4 * c + 2] = t.z;
    r[4 * c + 3] = t.w;
  }
}
template <int DH>
__device__ __forceinline__ float dot_row(const float (&a)[DH],
                                         const float* b) {
  float r[DH];
  get4<DH>(b, r);
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc = fmaf(a[d], r[d], acc);
  return acc;
}

// dS of an attended pair from P, dP, D and the logit s (softcap's chain
// factor), times scale: the gradient of the raw dot product
__device__ __forceinline__ float small_ds(const Params& m, float pr,
                                          float dp, float d, float s) {
  float ds = pr * (dp - d);
  if (m.softcap > 0.f) {
    const float t = s / m.softcap;
    ds = ds * (1.f - t * t);
  }
  return ds * m.scale;
}

template <typename T, int DH, int SK8>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_small_kernel(const SmallBwd p, long long n_problems) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Params& m = p.m;
  const int dh = m.dh, sq = m.sq, sk = m.sk, rep = m.h / m.hkv;
  const int rows = rep * sq, pf = p.pf;
  const bool vec = p.vec != 0;
  const long long first = static_cast<long long>(blockIdx.x) * p.per;
  const int np = static_cast<int>(
      n_problems - first < p.per ? n_problems - first : p.per);
  const T* q = static_cast<const T*>(m.q);
  const T* k = static_cast<const T*>(m.k);
  const T* v = static_cast<const T*>(m.v);
  const T* o = static_cast<const T*>(p.o);
  const T* dout = static_cast<const T*>(p.dout);

  // K and V of every problem, a thread a key row
  for (int e = threadIdx.x; e < np * sk; e += kThreads) {
    const int pi = e / sk, j = e - pi * sk;
    const long long prob_i = first + pi;
    const long long b = prob_i / m.hkv;
    const long long g = prob_i - b * m.hkv;
    float* base = smem + static_cast<long long>(pi) * pf;
    float r[DH];
    load_row<DH>(k + b * m.k_sb + g * m.k_sh + j * m.k_ss, dh, vec, r);
    put4<DH>(base + j * DH, r);
    load_row<DH>(v + b * m.v_sb + g * m.v_sh + j * m.v_ss, dh, vec, r);
    put4<DH>(base + (sk + j) * DH, r);
  }
  __syncthreads();

  // phase 1: a thread a query row
  for (int e = threadIdx.x; e < np * rows; e += kThreads) {
    const int pi = e / rows, r = e - pi * rows;
    const int hl = r / sq, i = r - hl * sq;
    const long long prob_i = first + pi;
    const long long b = prob_i / m.hkv;
    const long long hq = (prob_i - b * m.hkv) * rep + hl;
    float* base = smem + static_cast<long long>(pi) * pf;
    const float* ks = base;
    const float* vs = base + sk * DH;
    float* qs = base + 2 * sk * DH;
    float* gs = qs + rows * DH;
    float* stat = gs + rows * DH;           // max, 1 / sum, D
    const long long rbase = ((b * m.h + hq) * sq + i) * dh;
    float qi[DH], gi[DH], oi[DH];
    load_row<DH>(q + b * m.q_sb + hq * m.q_sh + i * m.q_ss, dh, vec, qi);
    load_row<DH>(dout + rbase, dh, vec, gi);
    load_row<DH>(o + rbase, dh, vec, oi);
    float dsum = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) dsum = fmaf(gi[d], oi[d], dsum);
    put4<DH>(qs + r * DH, qi);
    put4<DH>(gs + r * DH, gi);
    float ev[SK8];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < SK8; ++j) {
      ev[j] = -INFINITY;
      if (j < sk) {
        const float dot = dot_row<DH>(qi, ks + j * DH);
        ev[j] = masked_logit(m, attends(m, j, i), dot);
        mx = fmaxf(mx, ev[j]);
      }
    }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < SK8; ++j) {
      if (j < sk) {
        ev[j] = ev[j] == -INFINITY ? 0.f : expf(ev[j] - mx);
        l += ev[j];
      }
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float dq[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dq[d] = 0.f;
#pragma unroll
    for (int j = 0; j < SK8; ++j) {
      if (j < sk) {
        const float pr = ev[j] * inv;
        const float dp = dot_row<DH>(gi, vs + j * DH);
        // softcap's factor reads the logit again (no register kept)
        const float s = m.softcap > 0.f
                            ? logit(m, dot_row<DH>(qi, ks + j * DH))
                            : 0.f;
        const float ds = small_ds(m, pr, dp, dsum, s);
        float kr[DH];
        get4<DH>(ks + j * DH, kr);
#pragma unroll
        for (int d = 0; d < DH; ++d) dq[d] = fmaf(ds, kr[d], dq[d]);
      }
    }
    store_row<DH>(static_cast<T*>(p.dq) + rbase, dh, vec, dq);
    stat[r] = mx;
    stat[rows + r] = inv;
    stat[2 * rows + r] = dsum;
  }
  __syncthreads();

  // phase 2: a thread a key, the rows of the kv head's query heads in order
  for (int e = threadIdx.x; e < np * sk; e += kThreads) {
    const int pi = e / sk, j = e - pi * sk;
    const long long prob_i = first + pi;
    const float* base = smem + static_cast<long long>(pi) * pf;
    const float* qs = base + 2 * sk * DH;
    const float* gs = qs + rows * DH;
    const float* stat = gs + rows * DH;
    float kj[DH], vj[DH], dk[DH], dv[DH];
    get4<DH>(base + j * DH, kj);
    get4<DH>(base + (sk + j) * DH, vj);
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dk[d] = 0.f;
      dv[d] = 0.f;
    }
    for (int hl = 0; hl < rep; ++hl) {
      for (int i = 0; i < sq; ++i) {
        if (!attends(m, j, i)) continue;
        const int r = hl * sq + i;
        const float s = logit(m, dot_row<DH>(kj, qs + r * DH));
        const float pr = expf(s - stat[r]) * stat[rows + r];
        const float dp = dot_row<DH>(vj, gs + r * DH);
        const float ds = small_ds(m, pr, dp, stat[2 * rows + r], s);
        float qr[DH], gr[DH];
        get4<DH>(qs + r * DH, qr);
        get4<DH>(gs + r * DH, gr);
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          dk[d] = fmaf(ds, qr[d], dk[d]);
          dv[d] = fmaf(pr, gr[d], dv[d]);
        }
      }
    }
    const long long kbase = (prob_i * sk + j) * dh;
    store_row<DH>(static_cast<T*>(p.dk) + kbase, dh, vec, dk);
    store_row<DH>(static_cast<T*>(p.dv) + kbase, dh, vec, dv);
  }
}

// every rows' base and stride in whole vectors of vw bytes
inline bool rows_aligned(const void* x, long long sb, long long sh,
                         long long ss, int esize, int vw) {
  return reinterpret_cast<uintptr_t>(x) % vw == 0 && sb * esize % vw == 0 &&
         sh * esize % vw == 0 && ss * esize % vw == 0;
}

template <typename T, int DH, int SK8>
cudaError_t launch_small_t(const SmallBwd& p, int smem_bytes,
                           cudaStream_t stream) {
  static int limit = 48 * 1024;
  cudaError_t err =
      allow_smem(flash_bwd_small_kernel<T, DH, SK8>, smem_bytes, &limit);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(p.batch) * p.m.hkv;
  const long long blocks = (n + p.per - 1) / p.per;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_small_kernel<T, DH, SK8>
      <<<static_cast<unsigned>(blocks), kThreads, smem_bytes, stream>>>(p, n);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_small_dh(const SmallBwd& p, int smem_bytes,
                            cudaStream_t stream) {
  switch ((p.m.sk + 7) / 8) {
    case 1: return launch_small_t<T, DH, 8>(p, smem_bytes, stream);
    case 2: return launch_small_t<T, DH, 16>(p, smem_bytes, stream);
    case 3: return launch_small_t<T, DH, 24>(p, smem_bytes, stream);
    default: return launch_small_t<T, DH, 32>(p, smem_bytes, stream);
  }
}

// the small route: DH and SK8 from dh and sk; `per` problems a block and
// their smem_bytes from kernels/flash_attention.py `bwd_plan`
template <typename T>
cudaError_t launch_small(SmallBwd p, int per, int smem_bytes,
                         cudaStream_t stream) {
  const Params& m = p.m;
  const int dh_pad = m.dh <= 4 ? 4 : (m.dh <= 8 ? 8 : 16);
  const int rows = m.h / m.hkv * m.sq;
  p.per = per;
  p.pf = small_floats(dh_pad, rows, m.sk);
  if (per <= 0 ||
      static_cast<long long>(per) * p.pf * 4 > smem_bytes) {
    return cudaErrorInvalidValue;
  }
  const int es = static_cast<int>(sizeof(T));
  const int vw = dh_pad * es < 16 ? dh_pad * es : 16;
  const long long row = m.dh;
  p.vec = m.dh == dh_pad &&
          rows_aligned(m.q, m.q_sb, m.q_sh, m.q_ss, es, vw) &&
          rows_aligned(m.k, m.k_sb, m.k_sh, m.k_ss, es, vw) &&
          rows_aligned(m.v, m.v_sb, m.v_sh, m.v_ss, es, vw) &&
          rows_aligned(p.o, 0, 0, row, es, vw) &&
          rows_aligned(p.dout, 0, 0, row, es, vw) &&
          rows_aligned(p.dq, 0, 0, row, es, vw) &&
          rows_aligned(p.dk, 0, 0, row, es, vw) &&
          rows_aligned(p.dv, 0, 0, row, es, vw);
  switch (dh_pad) {
    case 4: return launch_small_dh<T, 4>(p, smem_bytes, stream);
    case 8: return launch_small_dh<T, 8>(p, smem_bytes, stream);
    default: return launch_small_dh<T, 16>(p, smem_bytes, stream);
  }
}

}  // namespace

// q, k, v through their strides (b, h, s; dh contiguous); o, dout, dq
// (B, H, Sq, dh) and dk, dv (B, Hkv, Sk, dh) contiguous; `per` problems
// (batch row, kv head) a block and their smem_bytes from
// kernels/flash_attention.py `bwd_plan`.
extern "C" int flash_bwd_small_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, int batch, int h,
    int hkv, int sq, int sk, int dh, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, int causal, int window,
    int chunk, float softcap, float scale, int is_bf16, int per,
    int smem_bytes, void* stream) {
  if (batch <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 ||
      sk <= 0 || dh <= 0 || sq > kSmallS || sk > kSmallS || dh > kSmallDh) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SmallBwd p = {};
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
  p.batch = batch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_small<__nv_bfloat16>(p, per, smem_bytes, st)
              : launch_small<float>(p, per, smem_bytes, st));
}

// the static shared bytes of this source's kernels (static_smem.cuh): the
// kernels keep only dynamic shared memory, so one of each type stands for
// the rest
extern "C" int flash_bwd_small_static_smem(int* bytes) {
  return repro_smem::max_static(
      {repro_smem::fn(flash_bwd_small_kernel<float, 4, 24>),
       repro_smem::fn(flash_bwd_small_kernel<__nv_bfloat16, 16, 32>)},
      bytes);
}
