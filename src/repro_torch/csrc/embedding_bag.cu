// EmbeddingBag, the recsys lookup:
//   out[b, :] = sum (or mean) of table[min(idx[e], V - 1), :] over the
//               entries e with bag_ids[e] == b
// for a table (V, dim) f32 or bf16, accumulated in f32 and rounded once to
// the table's type. An entry whose id is negative (the -1 pads of a short
// multi-hot field, wherever they sit) or whose bag is outside [0, n_bags)
// is skipped; an id at or past the table's end reads its last row, as the
// JAX reference's gather does; an empty bag is 0; the mean divides by the
// entries not skipped.
//
// Replaces the TPU kernel `embedding_bag_pallas` (src/repro/kernels/
// embedding_bag.py, `_bag_kernel`). That kernel keeps the table in HBM,
// DMAs one row per id into a VMEM staging tile and lands the bag sums with
// segment_matmul's one-hot product, over an aligned layout of ids sorted
// by bag. Here the layout is made on the card, in three steps that a CUDA
// graph can hold (no value goes back to the host):
//   1. a memset of each bag's range, a counter and a flag;
//   2. `bag_pass_kernel`, one pass over the entries, 4,096 a block: each
//      bag's first and one-past-last entry (plain stores inside a block,
//      atomics at a block's edges), and whether the valid bag ids are in
//      order within the block. The last block to finish reads the blocks'
//      summaries: whether the valid bag ids are in order over the whole
//      input. In order (BST's case, and the Pallas kernel's contract) each
//      bag's entries lie in its range, in input order, and it returns.
//      Otherwise it sets the flag, counts each bag's entries, scans the
//      counts into bounds, and walks the entries 256 at a time in input
//      order, ranking equal bags within a step by a sort in shared memory,
//      so that each bag's entries are listed in input order: one block, so
//      slow, but right for any order;
//   3. `bag_sum_kernel`: a group of lanes per bag (8 lanes x 16 bytes for
//      BST's 128-byte rows, 4 bags a warp) gathers the bag's rows straight
//      from the table in device memory and sums them in input order from
//      +0 (skipping the pads inside its range), so the result is the plain
//      version's (kernels/ref.py `embedding_bag_ref`) bit for bit.
//
// What bounds it on an H100: bytes, the ids and bag ids read once, each
// table row an id names read once, the bags written once. BST's table is
// 131,072 x 32 f32 (16.8 MB), which fits in the 50 MB L2, so the rows
// gathered again by later ids (4,194,304 of them at serve_bulk, 537 MB)
// come from L2; the layout reads the ids and bag ids once more.

#include <limits.h>

#include "segment_sum.cuh"
#include "static_smem.cuh"

namespace {

using repro_kernels::Raw;
using repro_kernels::seg_store;
using repro_kernels::seg_to_f32;

constexpr int kPassThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kPassThreads * kPerThread;  // entries a pass block
constexpr int kWarpsPass = kPassThreads / 32;
constexpr int kSumThreads = 256;
constexpr int kGather = 8;  // entries a sum group loads at once
// sum blocks up to which the gathering sum is taken: fewer than fill every
// SM a few times over
constexpr long long kGatherBlocks = 1024;

// the entry's bag, or -1 where it is skipped
template <typename I>
__device__ __forceinline__ int entry_bag(const I* idx, const I* bag,
                                         long long e, int n_bags) {
  const long long i = static_cast<long long>(idx[e]);
  const long long b = static_cast<long long>(bag[e]);
  return i >= 0 && b >= 0 && b < n_bags ? static_cast<int>(b) : -1;
}

// exclusive prefix over the block's threads (max where kMax, else sum);
// *total, if given, gets the whole block's
template <bool kMax>
__device__ __forceinline__ int block_exclusive(int x, int* s_warp,
                                               int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = kMax ? max(v, a) : v + a;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  int before = kMax ? -1 : 0, all = kMax ? -1 : 0;
  for (int w = 0; w < kWarpsPass; ++w) {
    const int s = s_warp[w];
    if (w < warp) before = kMax ? max(before, s) : before + s;
    all = kMax ? max(all, s) : all + s;
  }
  const int up = __shfl_up_sync(0xffffffffu, v, 1);
  const int excl = kMax ? (lane == 0 ? before : max(before, up))
                        : before + v - x;
  __syncthreads();  // s_warp is free again
  if (total) *total = all;
  return excl;
}

// The placement of entries whose valid bag ids are out of order (one
// block): each bag's entries counted, the counts scanned into bounds, then
// the entries walked 256 at a time in input order. Each walk step sorts
// its (bag, position) pairs in shared memory (a bitonic sort), so an
// entry's place is its bag's cursor plus its rank among the step's
// entries of that bag, and the first of them moves the cursor past all.
template <typename I>
__device__ void place_unsorted(const I* __restrict__ idx,
                               const I* __restrict__ bag, long long n,
                               int n_bags, int* __restrict__ cursor,
                               int* __restrict__ bounds,
                               int* __restrict__ perm, int* s_warp) {
  __shared__ unsigned long long s_sort[kPassThreads];
  __shared__ int s_count[kPassThreads], s_base[kPassThreads];
  const int tid = threadIdx.x;
  for (int b = tid; b < n_bags; b += kPassThreads) cursor[b] = 0;
  __syncthreads();
  for (long long e = tid; e < n; e += kPassThreads) {
    const int b = entry_bag(idx, bag, e, n_bags);
    if (b >= 0) atomicAdd(cursor + b, 1);
  }
  __syncthreads();
  const long long bpt = (n_bags + kPassThreads - 1LL) / kPassThreads;
  const int b0 = static_cast<int>(min(tid * bpt, 1LL * n_bags));
  const int b1 = static_cast<int>(min(b0 + bpt, 1LL * n_bags));
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += cursor[b];
  int total = 0;
  int run = block_exclusive<false>(sum, s_warp, &total);
  for (int b = b0; b < b1; ++b) {
    const int c = cursor[b];
    bounds[b] = run;
    cursor[b] = run;
    run += c;
  }
  if (tid == 0) bounds[n_bags] = total;
  __syncthreads();

  for (long long t0 = 0; t0 < n; t0 += kPassThreads) {
    const long long e = t0 + tid;
    const int key = e < n ? entry_bag(idx, bag, e, n_bags) : -1;
    const unsigned kk = key >= 0 ? static_cast<unsigned>(key) : 0xffffffffu;
    s_sort[tid] = static_cast<unsigned long long>(kk) << 32 | tid;
    for (int size = 2; size <= kPassThreads; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        __syncthreads();
        const int partner = tid ^ stride;
        if (partner > tid) {
          const unsigned long long a = s_sort[tid], c = s_sort[partner];
          if ((a > c) == ((tid & size) == 0)) {
            s_sort[tid] = c;
            s_sort[partner] = a;
          }
        }
      }
    }
    __syncthreads();
    const unsigned long long me = s_sort[tid];
    const unsigned mk = static_cast<unsigned>(me >> 32);
    const bool valid = mk != 0xffffffffu;
    const bool starts = tid == 0 || static_cast<unsigned>(
                                        s_sort[tid - 1] >> 32) != mk;
    const bool ends = tid == kPassThreads - 1 ||
                      static_cast<unsigned>(s_sort[tid + 1] >> 32) != mk;
    const int own = starts ? tid : -1;
    const int first = max(block_exclusive<true>(own, s_warp, nullptr), own);
    const int rank = tid - first;
    if (ends && valid) s_count[first] = rank + 1;
    __syncthreads();
    if (starts && valid) {
      const int base = cursor[mk];
      s_base[tid] = base;
      cursor[mk] = base + s_count[tid];
    }
    __syncthreads();
    if (valid) {
      perm[s_base[first] + rank] =
          static_cast<int>(t0 + static_cast<int>(me & 0xffffffffu));
    }
  }
}

// Steps 2 and 3. Thread t of block k holds entries k * 4096 + 16 t +
// [0, 16).
// Where the valid bag ids are in order, the last valid bag before a thread
// (within its block) is the prefix max of the earlier threads' bags, and
// the next one after it is the suffix min of the later threads' first
// bags; so each run of one bag knows whether it starts or ends a bag. A
// run at a block's edge may continue in the next block: its end (start)
// goes in by atomicMax. nlo holds ~first so that 0 means none and
// atomicMax keeps the first entry. Each block writes a summary: its first
// valid bag (INT_MAX none), its largest (-1 none), and whether it is out
// of order. The last block to finish (a counter zeroed with the ranges)
// reads the summaries: the input is in order where every block is and each
// block's first valid bag is no lower than every earlier block's largest.
// If it is not, that block sets the flag and places the entries.
template <typename I>
__global__ void __launch_bounds__(kPassThreads)
    bag_pass_kernel(const I* __restrict__ idx, const I* __restrict__ bag,
                    long long n, int n_bags, unsigned* __restrict__ hi,
                    unsigned* __restrict__ nlo, int* __restrict__ done,
                    int* __restrict__ flag, int* __restrict__ summary,
                    int* __restrict__ cursor, int* __restrict__ bounds,
                    int* __restrict__ perm) {
  __shared__ int s_max[kWarpsPass], s_min[kWarpsPass], s_warp[kWarpsPass];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long e0 = blockIdx.x * static_cast<long long>(kTile) +
                       tid * kPerThread;
  int key[kPerThread];
  int first = INT_MAX, mx = -1;
  bool bad = false;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    key[j] = e0 + j < n ? entry_bag(idx, bag, e0 + j, n_bags) : -1;
    if (key[j] >= 0) {
      bad = bad || key[j] < mx;
      mx = max(mx, key[j]);
      first = min(first, key[j]);
    }
  }
  // exclusive prefix max of mx and exclusive suffix min of first, over
  // the block's threads
  int up = mx, down = first;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, up, o);
    const int c = __shfl_down_sync(0xffffffffu, down, o);
    if (lane >= o) up = max(up, a);
    if (lane + o < 32) down = min(down, c);
  }
  int pm = __shfl_up_sync(0xffffffffu, up, 1);
  int sn = __shfl_down_sync(0xffffffffu, down, 1);
  if (lane == 0) pm = -1;
  if (lane == 31) sn = INT_MAX;
  if (lane == 31) s_max[warp] = up;
  if (lane == 0) s_min[warp] = down;
  __syncthreads();
  int block_max = -1, block_first = INT_MAX;
  for (int w = 0; w < kWarpsPass; ++w) {
    if (w < warp) pm = max(pm, s_max[w]);
    if (w > warp) sn = min(sn, s_min[w]);
    block_max = max(block_max, s_max[w]);
    block_first = min(block_first, s_min[w]);
  }
  bad = bad || (first != INT_MAX && first < pm);

  // run boundaries (used only where the input is in order)
  int prev = pm, cur = -1;
  long long cur_last = -1;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int k = key[j];
    if (k < 0) continue;
    const long long e = e0 + j;
    if (k != prev) {
      if (cur >= 0) hi[cur] = static_cast<unsigned>(cur_last + 1);
      if (prev >= 0) {
        nlo[k] = ~static_cast<unsigned>(e);
      } else {
        atomicMax(nlo + k, ~static_cast<unsigned>(e));
      }
    }
    cur = k;  // this thread's run, which may have begun in an earlier one
    cur_last = e;
    prev = k;
  }
  if (cur >= 0) {
    if (sn == INT_MAX) {
      atomicMax(hi + cur, static_cast<unsigned>(cur_last + 1));
    } else if (sn != cur) {
      hi[cur] = static_cast<unsigned>(cur_last + 1);
    }
  }
  const int any_bad = __syncthreads_or(bad);
  if (tid == 0) {
    summary[3 * blockIdx.x] = block_first;
    summary[3 * blockIdx.x + 1] = block_max;
    summary[3 * blockIdx.x + 2] = any_bad;
    __threadfence();
    s_last = atomicAdd(done, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block: in order over the whole input?
  const int n_blocks = gridDim.x;
  const int per = (n_blocks + kPassThreads - 1) / kPassThreads;
  const int k0 = min(tid * per, n_blocks), k1 = min(k0 + per, n_blocks);
  int kmax = -1, kfirst = INT_MAX;
  bool out_of_order = false;
  for (int k = k0; k < k1; ++k) {
    const int f = __ldcg(summary + 3 * k);
    out_of_order = out_of_order || __ldcg(summary + 3 * k + 2) != 0 ||
                   (f != INT_MAX && f < kmax);
    if (kfirst == INT_MAX) kfirst = f;
    kmax = max(kmax, __ldcg(summary + 3 * k + 1));
  }
  const int before = block_exclusive<true>(kmax, s_warp, nullptr);
  out_of_order = out_of_order || (kfirst != INT_MAX && kfirst < before);
  if (!__syncthreads_or(out_of_order)) return;
  if (tid == 0) *flag = 1;
  place_unsorted(idx, bag, n, n_bags, cursor, bounds, perm, s_warp);
}

// Step 3. Bag b's entries: in order, the valid entries of bag b among
// [~nlo[b], hi[b]) (pads inside are skipped); otherwise perm[bounds[b]:
// bounds[b + 1]], all valid. With GATHER (few bags, so few warps to hide
// the wait on memory) the group's lanes take up to kGather entries at a
// time: lane u reads entry u's id, a shuffle hands every lane each entry's
// row, and the group loads those rows together before adding them in
// entry order. Without it (many bags) each lane walks the entries one
// after another, with fewer registers and so more warps in flight.
template <typename T, int VEC, typename I, bool GATHER>
__global__ void __launch_bounds__(kSumThreads)
    bag_sum_kernel(const T* __restrict__ table, long long v_rows,
                   const I* __restrict__ idx, const I* __restrict__ bag,
                   const unsigned* __restrict__ hi,
                   const unsigned* __restrict__ nlo,
                   const int* __restrict__ flag,
                   const int* __restrict__ bounds,
                   const int* __restrict__ perm, T* __restrict__ out,
                   int n_bags, int dim, int group, int mean) {
  using raw_t = typename Raw<sizeof(T) * VEC>::type;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long b = t / group;
  if (b >= n_bags) return;
  const int lane = static_cast<int>(t - b * group);
  const bool placed = *flag != 0;
  long long lo, end;
  if (placed) {
    lo = bounds[b];
    end = bounds[b + 1];
  } else {
    lo = ~nlo[b];
    end = hi[b];
  }
  if constexpr (!GATHER) {
    for (int c0 = lane * VEC; c0 < dim; c0 += group * VEC) {
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
      int count = 0;
#pragma unroll 4
      for (long long i = lo; i < end; ++i) {
        long long row;
        if (placed) {
          row = static_cast<long long>(idx[perm[i]]);
        } else {
          row = static_cast<long long>(idx[i]);
          if (row < 0 || static_cast<long long>(bag[i]) != b) continue;
        }
        row = min(row, v_rows - 1);
        const raw_t raw = __ldg(reinterpret_cast<const raw_t*>(
            table + row * static_cast<long long>(dim) + c0));
        T x[VEC];
        memcpy(x, &raw, sizeof(raw));
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          acc[j] = __fadd_rn(acc[j], seg_to_f32(x[j]));
        }
        ++count;
      }
      const float div = static_cast<float>(count > 1 ? count : 1);
      T* o = out + b * static_cast<long long>(dim) + c0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        seg_store(o + j, mean ? __fdiv_rn(acc[j], div) : acc[j]);
      }
    }
    return;
  }
  // the group's lanes in the warp (groups are aligned: group divides 32)
  const unsigned mask =
      group == 32 ? 0xffffffffu
                  : ((1u << group) - 1) << ((threadIdx.x & 31) & ~(group - 1));
  const int ng = group < kGather ? group : kGather;
  for (int c0 = 0; c0 < dim; c0 += group * VEC) {
    const int col = c0 + lane * VEC;
    const bool on = col < dim;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    int count = 0;
    for (long long i0 = lo; i0 < end; i0 += ng) {
      long long row = -1;  // lane u: entry i0 + u's row, -1 to skip
      if (lane < ng && i0 + lane < end) {
        const long long i = i0 + lane;
        if (placed) {
          row = static_cast<long long>(idx[perm[i]]);
        } else {
          const long long r = static_cast<long long>(idx[i]);
          row = r >= 0 && static_cast<long long>(bag[i]) == b ? r : -1;
        }
        if (row >= 0) row = min(row, v_rows - 1);
      }
      long long rows[kGather];
      raw_t raw[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        if (u < ng) {
          rows[u] = __shfl_sync(mask, row, u, group);
          if (on && rows[u] >= 0) {
            raw[u] = __ldg(reinterpret_cast<const raw_t*>(
                table + rows[u] * static_cast<long long>(dim) + col));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        if (u < ng && rows[u] >= 0) {
          T x[VEC];
          memcpy(x, &raw[u], sizeof(raw_t));
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            acc[j] = __fadd_rn(acc[j], seg_to_f32(x[j]));
          }
          ++count;
        }
      }
    }
    if (on) {
      const float div = static_cast<float>(count > 1 ? count : 1);
      T* o = out + b * static_cast<long long>(dim) + col;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        seg_store(o + j, mean ? __fdiv_rn(acc[j], div) : acc[j]);
      }
    }
  }
}

template <typename I>
struct Layout {
  const I* idx;
  const I* bag;
  unsigned* hi;
  unsigned* nlo;
  int* done;
  int* flag;
  int* summary;
  int* cursor;
  int* bounds;
  int* perm;
};

template <typename T, int VEC, typename I>
cudaError_t launch(const void* table, long long v_rows, const Layout<I>& l,
                   void* out, long long n, int n_bags, int dim, int group,
                   int mean, cudaStream_t stream) {
  const long long n_blocks = (n + kTile - 1) / kTile;
  // the ranges, the done counter and the flag start at 0
  cudaError_t err = cudaMemsetAsync(
      l.hi, 0, sizeof(int) * (2 * static_cast<size_t>(n_bags) + 2), stream);
  if (err != cudaSuccess) return err;
  if (n_blocks > 0) {
    bag_pass_kernel<I><<<static_cast<unsigned>(n_blocks), kPassThreads, 0,
                         stream>>>(l.idx, l.bag, n, n_bags, l.hi, l.nlo,
                                   l.done, l.flag, l.summary, l.cursor,
                                   l.bounds, l.perm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long blocks =
      (static_cast<long long>(n_bags) * group + kSumThreads - 1) / kSumThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks <= kGatherBlocks) {
    bag_sum_kernel<T, VEC, I, true>
        <<<static_cast<unsigned>(blocks), kSumThreads, 0, stream>>>(
            static_cast<const T*>(table), v_rows, l.idx, l.bag, l.hi, l.nlo,
            l.flag, l.bounds, l.perm, static_cast<T*>(out), n_bags, dim,
            group, mean);
  } else {
    bag_sum_kernel<T, VEC, I, false>
        <<<static_cast<unsigned>(blocks), kSumThreads, 0, stream>>>(
            static_cast<const T*>(table), v_rows, l.idx, l.bag, l.hi, l.nlo,
            l.flag, l.bounds, l.perm, static_cast<T*>(out), n_bags, dim,
            group, mean);
  }
  return cudaGetLastError();
}

// scratch (int32): hi [n_bags], nlo [n_bags], done, flag, then the pass
// blocks' summaries [3 x blocks], cursor [n_bags], bounds [n_bags + 1] and
// perm [n] (kernels/embedding_bag.py `embedding_bag_scratch`)
template <typename I>
cudaError_t launch_typed(const void* table, long long v_rows, const void* idx,
                         const void* bag, int* scratch, void* out,
                         long long n, int n_bags, int dim, int is_bf16,
                         int vec, int group, int mean, cudaStream_t st) {
  const long long n_blocks = (n + kTile - 1) / kTile;
  Layout<I> l;
  l.idx = static_cast<const I*>(idx);
  l.bag = static_cast<const I*>(bag);
  l.hi = reinterpret_cast<unsigned*>(scratch);
  l.nlo = l.hi + n_bags;
  l.done = scratch + 2LL * n_bags;
  l.flag = l.done + 1;
  l.summary = l.flag + 1;
  l.cursor = l.summary + 3 * n_blocks;
  l.bounds = l.cursor + n_bags;
  l.perm = l.bounds + n_bags + 1;
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_BAG(T, V) \
  err = launch<T, V, I>(table, v_rows, l, out, n, n_bags, dim, group, mean, st)
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
  return err;
}

}  // namespace

// idx and bag_ids (N,) both int32 or both int64 (idx64); scratch: int32,
// `embedding_bag_scratch` of kernels/embedding_bag.py long; vec and group
// from `lane_plan`.
extern "C" int embedding_bag_launch(const void* table, long long v_rows,
                                    const void* idx, const void* bag,
                                    int idx64, int* scratch, void* out,
                                    long long n, int n_bags, int dim,
                                    int is_bf16, int vec, int group, int mean,
                                    void* stream) {
  if (n_bags <= 0 || dim <= 0 || v_rows <= 0 || n < 0 || n > INT_MAX ||
      group <= 0 || group > 32 || (group & (group - 1)) != 0 ||
      dim % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      idx64 ? launch_typed<long long>(table, v_rows, idx, bag, scratch, out,
                                      n, n_bags, dim, is_bf16, vec, group,
                                      mean, st)
            : launch_typed<int>(table, v_rows, idx, bag, scratch, out, n,
                                n_bags, dim, is_bf16, vec, group, mean, st);
  return static_cast<int>(err);
}

// the static shared bytes of this source's kernels (static_smem.cuh)
extern "C" int embedding_bag_static_smem(int* bytes) {
  return repro_smem::max_static(
      {repro_smem::fn(bag_pass_kernel<int>),
       repro_smem::fn(bag_pass_kernel<long long>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 8, int, true>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 8, int, false>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 8, long long, true>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 8, long long, false>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 4, int, true>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 4, int, false>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 4, long long, true>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 4, long long, false>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 2, int, true>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 2, int, false>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 2, long long, true>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 2, long long, false>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 1, int, true>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 1, int, false>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 1, long long, true>),
       repro_smem::fn(bag_sum_kernel<__nv_bfloat16, 1, long long, false>),
       repro_smem::fn(bag_sum_kernel<float, 4, int, true>),
       repro_smem::fn(bag_sum_kernel<float, 4, int, false>),
       repro_smem::fn(bag_sum_kernel<float, 4, long long, true>),
       repro_smem::fn(bag_sum_kernel<float, 4, long long, false>),
       repro_smem::fn(bag_sum_kernel<float, 2, int, true>),
       repro_smem::fn(bag_sum_kernel<float, 2, int, false>),
       repro_smem::fn(bag_sum_kernel<float, 2, long long, true>),
       repro_smem::fn(bag_sum_kernel<float, 2, long long, false>),
       repro_smem::fn(bag_sum_kernel<float, 1, int, true>),
       repro_smem::fn(bag_sum_kernel<float, 1, int, false>),
       repro_smem::fn(bag_sum_kernel<float, 1, long long, true>),
       repro_smem::fn(bag_sum_kernel<float, 1, long long, false>)},
      bytes);
}
