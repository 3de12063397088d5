// EmbeddingBag, the recsys lookup:
//   out[b, :] = sum (or mean) of table[idx[e], :] over the entries e with
//               bag_ids[e] == b
// for a table (V, dim) f32 or bf16, accumulated in f32 and rounded once to
// the table's type. An entry whose id is outside [0, V) (the -1 pads of a
// short multi-hot field, wherever they sit) or whose bag is outside
// [0, n_bags) is skipped; an empty bag is 0; the mean divides by the
// entries not skipped.
//
// Replaces the TPU kernel `embedding_bag_pallas` (src/repro/kernels/
// embedding_bag.py, `_bag_kernel`). That kernel keeps the table in HBM,
// DMAs one row per id into a VMEM staging tile and lands the bag sums with
// segment_matmul's one-hot product, over the same aligned layout. Here the
// wrapper lays the entries out bag by bag (kernels/embedding_bag.py: the
// layout of segment_matmul, a stable sort with pads in an overflow bin),
// and one group of lanes gathers one bag's rows straight from the table in
// device memory and sums them in their input order (segment_sum.cuh), so
// the result is the plain version's bit for bit for any pad placement.
//
// What bounds it on an H100: bytes, the ids and bag ids read once, each
// table row an id names read once, the bags written once. BST's table is
// 131,072 x 32 f32 (16.8 MB), which fits in the 50 MB L2, so the rows
// gathered again by later ids (4,194,304 of them at serve_bulk, 537 MB)
// come from L2. dim = 32 f32 is 8 lanes x 16 bytes a row: a warp sums four
// bags at once.

#include "segment_sum.cuh"

namespace {

using repro_kernels::group_segment_sum;
using repro_kernels::launch_groups;

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
    embedding_bag_kernel(const T* __restrict__ table,
                         const int* __restrict__ idx,
                         const long long* __restrict__ perm,
                         const long long* __restrict__ bounds,
                         T* __restrict__ out, long long n_bags, int dim,
                         int group, int mean) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long bag = t / group;
  if (bag >= n_bags) return;
  group_segment_sum<T, VEC>(
      table, bounds, out, bag, static_cast<int>(t - bag * group), group, dim,
      mean != 0,
      [idx, perm](long long i) { return static_cast<long long>(idx[perm[i]]); });
}

template <typename T, int VEC>
cudaError_t launch(const void* table, const int* idx, const long long* perm,
                   const long long* bounds, void* out, long long n_bags,
                   int dim, int group, int mean, cudaStream_t stream) {
  return launch_groups(embedding_bag_kernel<T, VEC>, n_bags, group, stream,
                       static_cast<const T*>(table), idx, perm, bounds,
                       static_cast<T*>(out), n_bags, dim, group, mean);
}

}  // namespace

// idx (N,) int32; perm (N,) and bounds (n_bags + 1,) int64 from
// kernels/embedding_bag.py (the layout of kernels/segment_matmul.py
// `segment_layout`, which sends every skipped entry past the last bag);
// vec and group from `lane_plan`.
extern "C" int embedding_bag_launch(const void* table, const int* idx,
                                    const long long* perm,
                                    const long long* bounds, void* out,
                                    long long n_bags, int dim, int is_bf16,
                                    int vec, int group, int mean,
                                    void* stream) {
  if (n_bags <= 0 || dim <= 0 || group <= 0 || group > 32 ||
      (group & (group - 1)) != 0 || dim % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_BAG(T, V)                                                     \
  err = launch<T, V>(table, idx, perm, bounds, out, n_bags, dim, group, mean, \
                     st)
  if (is_bf16) {
    switch (vec) {
      case 8: REPRO_BAG(__nv_bfloat16, 8); break;
      case 4: REPRO_BAG(__nv_bfloat16, 4); break;
      case 2: REPRO_BAG(__nv_bfloat16, 2); break;
      case 1: REPRO_BAG(__nv_bfloat16, 1); break;
    }
  } else {
    switch (vec) {
      case 4: REPRO_BAG(float, 4); break;
      case 2: REPRO_BAG(float, 2); break;
      case 1: REPRO_BAG(float, 1); break;
    }
  }
#undef REPRO_BAG
  return static_cast<int>(err);
}
