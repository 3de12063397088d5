// A kernel that does nothing: its device time, replayed from a CUDA graph,
// is the floor of one launch on the card, against which a launch-bound
// kernel (lsh_hash at the CIVS probe) is read. It exists only for that
// measurement in chip_smoke.py (`_build.empty_kernel`); no path of the
// port launches it, and it is not in `ops` or its launch counts.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
