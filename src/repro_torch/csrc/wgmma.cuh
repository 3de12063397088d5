// Hopper's warpgroup matrix multiply (wgmma) and asynchronous copies, as
// the tensor-core kernels of this directory use them; sm_90a only. A
// wgmma names every accumulator register, so each shape has its own
// operand list.
//
// Operand tiles in shared memory are not swizzled: a tile is made of "core
// matrices" of 8 rows x 16 bytes (8 bf16), each stored as 128 contiguous
// bytes. `core_off` places 16-byte chunk c of row r: the core matrices
// along a row lie `cstride` bytes apart and the 8-row groups `gstride`
// apart (both multiples of 16; a cstride of 144 rather than 128 puts the
// chunks of a row in distinct banks, so that the copies into the tile do
// not conflict). One layout serves both roles of a tile:
//  - K-major operand (rows = M or N, chunks along the k depth): leading
//    byte offset (between core matrices along k) cstride, stride byte
//    offset (between 8-row groups) gstride;
//  - MN-major operand (rows = the k depth, chunks along N: the B of P V,
//    V as it lies in memory): leading byte offset (between core matrices
//    along k, the 8-row groups) gstride, stride byte offset (between core
//    matrices along N) cstride.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_kernels {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t core_off(int r, int c, int cstride,
                                             int gstride) {
  return (r >> 3) * gstride + c * cstride + (r & 7) * 16;
}

// the 64-bit matrix descriptor of an unswizzled operand at shared address
// addr: start address, leading and stride byte offsets, all in 16 bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products (as CUTLASS's warpgroup_fence_operand)
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
// shared memory written by threads (or cp.async) made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes from global to shared memory, asynchronously; zeros where !ok
// (src must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes from global to shared memory, asynchronously (through L1); zero
// where !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D (64 x 64) (+)= A (64 x 16, shared) B^T (64 x 16, shared), both K-major;
// D is overwritten where accumulate is 0
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 16) += A (64 x 16, registers) B (16 x 16, shared, MN-major)
__device__ __forceinline__ void mma_rs_n16(float* d, const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32) += A (64 x 16, registers) B (16 x 32, shared, MN-major)
__device__ __forceinline__ void mma_rs_n32(float* d, const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64) += A (64 x 16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x N) += A (64 x 16, registers) B (16 x N, shared, MN-major: a
// tile of core_off's layout whose rows are the k depth, 8-row groups
// `gstride` bytes apart and core matrices along N CSTRIDE apart), N a
// multiple of 16: cut into products of 64, 32 and 16 columns from column C
// on (the B of P V, of dS K, of P^T dO)
template <int N, int CSTRIDE, int C = 0>
__device__ __forceinline__ void mma_rs_cols(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint32_t b_addr,
                                            uint32_t gstride) {
  const uint64_t db = desc(b_addr + C / 8 * CSTRIDE, gstride, CSTRIDE);
  if constexpr (N - C >= 64) {
    mma_rs_n64(d + C / 2, a, db);
    mma_rs_cols<N, CSTRIDE, C + 64>(d, a, b_addr, gstride);
  } else if constexpr (N - C >= 32) {
    mma_rs_n32(d + C / 2, a, db);
    mma_rs_cols<N, CSTRIDE, C + 32>(d, a, b_addr, gstride);
  } else if constexpr (N - C >= 16) {
    mma_rs_n16(d + C / 2, a, db);
  }
}

// 2^x (the SFU's approximation, relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two f32 as the bf16 pair of one A-operand register (the first in the
// low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 as three packed bf16 terms t[0] + t[1] + t[2]: t[0] = bf16(x),
// t[1] = bf16(x - t[0]), t[2] = bf16(x - t[0] - t[1]), their sum x to
// about 2^-27 of itself. Products with each term carry x nearly exact
// where one bf16 rounding (2^-9) or two terms (2^-18) would not: in a sum
// that cancels ten-thousand-fold, 2^-18 a term is an ulp of the result
template <int N>
__device__ __forceinline__ void split_bf16(float x0, float x1,
                                           uint32_t (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

}  // namespace sm90
}  // namespace repro_kernels
