// The segment sum that the embedding_bag and segment_matmul kernels share.
//
// The rows of segment s are the source rows row_of(i) for i in
// [bounds[s], bounds[s + 1]): the wrapper's layout (a stable sort of the
// segment ids, pads sent to an overflow bin past the last segment), so each
// segment's rows come in their input order. A group of `group` lanes (a
// power of two <= 32) owns one segment: lane l holds VEC consecutive
// columns at a time, c = l VEC, l VEC + group VEC, ..., and walks the
// segment's rows one after another, starting from +0 and adding each row
// with one IEEE f32 add. That is the pinned order of kernels/ref.py
// `segment_sum_ref`, so kernel and plain version give the same bits. VEC
// elements are one load of VEC * sizeof(T) bytes (16 where the width
// allows), so a warp reads a 128-byte f32 row of 32 columns as 8 lanes x
// 16 bytes and takes four segments at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace repro_kernels {

// the built-in type of one load of N bytes, which __ldg takes
template <int N>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

__device__ __forceinline__ float seg_to_f32(float x) { return x; }
__device__ __forceinline__ float seg_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void seg_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void seg_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One group's segment: out[seg, :] = the sum of its rows (divided by
// max(count, 1) when `mean`), rounded once to T. RowOf maps a position of
// the layout to the source row it names.
template <typename T, int VEC, typename RowOf>
__device__ __forceinline__ void group_segment_sum(
    const T* __restrict__ src, const long long* __restrict__ bounds,
    T* __restrict__ out, long long seg, int lane, int group, int d, bool mean,
    RowOf row_of) {
  using raw_t = typename Raw<sizeof(T) * VEC>::type;
  const long long lo = bounds[seg], hi = bounds[seg + 1];
  const float count = static_cast<float>(hi - lo > 1 ? hi - lo : 1);
  for (int c0 = lane * VEC; c0 < d; c0 += group * VEC) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (long long i = lo; i < hi; ++i) {
      const raw_t raw = __ldg(reinterpret_cast<const raw_t*>(
          src + row_of(i) * static_cast<long long>(d) + c0));
      T x[VEC];
      memcpy(x, &raw, sizeof(raw));
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], seg_to_f32(x[j]));
    }
    T* o = out + seg * static_cast<long long>(d) + c0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      seg_store(o + j, mean ? __fdiv_rn(acc[j], count) : acc[j]);
    }
  }
}

// Launch one group of `group` lanes per segment, 256 threads a block.
template <typename Kernel, typename... Args>
cudaError_t launch_groups(Kernel kernel, long long n_seg, int group,
                          cudaStream_t stream, Args... args) {
  constexpr int kThreads = 256;
  const long long threads = n_seg * group;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace repro_kernels
