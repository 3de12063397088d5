// The static __shared__ bytes of a source's kernels, as the loaded module
// declares them (cudaFuncGetAttributes). Each source exports one query,
// `<source>_static_smem(int* bytes)`, over every kernel instantiation its
// launches can reach; the contract checker (repro_torch/analysis/
// contracts.py) adds the most to a launch's dynamic bytes, so the sum is at
// least what that launch asks of a block.
#pragma once

#include <cuda_runtime.h>

#include <initializer_list>

namespace repro_smem {

template <typename F>
inline const void* fn(F* kernel) {
  return reinterpret_cast<const void*>(kernel);
}

// the most static shared bytes of any of `kernels` into *bytes; returns 0
// or the cudaError_t of a failed query
inline int max_static(std::initializer_list<const void*> kernels,
                      int* bytes) {
  int most = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (static_cast<int>(attr.sharedSizeBytes) > most) {
      most = static_cast<int>(attr.sharedSizeBytes);
    }
  }
  *bytes = most;
  return 0;
}

}  // namespace repro_smem
