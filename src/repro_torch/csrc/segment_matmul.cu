// Segment sum of messages, the GNN aggregation primitive:
//   out[s, :] = sum of msg[e, :] over the edges e with seg_ids[e] == s
// for msg (E, d) f32 or bf16, accumulated in f32 and rounded once to
// msg's type; ids outside [0, n_segments) are pads, never read, and a
// segment with no edge is 0.
//
// Replaces the TPU kernel `segment_matmul_pallas` (src/repro/kernels/
// segment_matmul.py, `_segment_kernel` and `align_segments`). That kernel
// scatters on the TPU's matrix unit: edges sorted and aligned so that no
// block of edges crosses a block of output rows, each block a one-hot
// (bw x be) matrix times the (be x d) messages, accumulated in an output
// block that stays in VMEM. Hopper scatters with plain loads and stores,
// so there are no one-hot products here. The wrapper lays the edges out
// segment by segment (kernels/segment_matmul.py: a stable sort of the ids,
// pads into an overflow bin, each segment's [start, end)), and one group of
// lanes sums one segment's rows in their input order (segment_sum.cuh), so
// any placement of the pads gives the plain version's bits.
//
// What bounds it on an H100: bytes. Each message is read once and each
// output row written once (ogb_products' E = 61,859,328 x d = 100 f32:
// 24.7 GB in, 0.98 GB out, ~7.75 ms at 3.35 TB/s); one add per element.
// d = 100 f32 is 25 lanes x 16 bytes a row, one warp a segment. The load
// is spread one segment per group: a segment of many edges keeps one warp
// busy for all of them, so in-degree skew leaves a tail of a few warps
// (a split of large segments across warps is later work).

#include "segment_sum.cuh"

namespace {

using repro_kernels::group_segment_sum;
using repro_kernels::launch_groups;

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
    segment_matmul_kernel(const T* __restrict__ msg,
                          const long long* __restrict__ perm,
                          const long long* __restrict__ bounds,
                          T* __restrict__ out, long long n_seg, int d,
                          int group) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long seg = t / group;
  if (seg >= n_seg) return;
  group_segment_sum<T, VEC>(msg, bounds, out, seg,
                            static_cast<int>(t - seg * group), group, d,
                            false, [perm](long long i) { return perm[i]; });
}

template <typename T, int VEC>
cudaError_t launch(const void* msg, const long long* perm,
                   const long long* bounds, void* out, long long n_seg, int d,
                   int group, cudaStream_t stream) {
  return launch_groups(segment_matmul_kernel<T, VEC>, n_seg, group, stream,
                       static_cast<const T*>(msg), perm, bounds,
                       static_cast<T*>(out), n_seg, d, group);
}

}  // namespace

// perm (E,) and bounds (n_seg + 1,) int64 from kernels/segment_matmul.py
// `segment_layout`; vec (elements a load) and group (lanes a segment) from
// its `lane_plan`.
extern "C" int segment_matmul_launch(const void* msg, const long long* perm,
                                     const long long* bounds, void* out,
                                     long long n_seg, int d, int is_bf16,
                                     int vec, int group, void* stream) {
  if (n_seg <= 0 || d <= 0 || group <= 0 || group > 32 ||
      (group & (group - 1)) != 0 || d % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_SEG(T, V) \
  err = launch<T, V>(msg, perm, bounds, out, n_seg, d, group, st)
  if (is_bf16) {
    switch (vec) {
      case 8: REPRO_SEG(__nv_bfloat16, 8); break;
      case 4: REPRO_SEG(__nv_bfloat16, 4); break;
      case 2: REPRO_SEG(__nv_bfloat16, 2); break;
      case 1: REPRO_SEG(__nv_bfloat16, 1); break;
    }
  } else {
    switch (vec) {
      case 4: REPRO_SEG(float, 4); break;
      case 2: REPRO_SEG(float, 2); break;
      case 1: REPRO_SEG(float, 1); break;
    }
  }
#undef REPRO_SEG
  return static_cast<int>(err);
}
