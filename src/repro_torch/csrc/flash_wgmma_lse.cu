// The lse-writing kernels of the tensor-core prefill attention
// (flash_wgmma.cuh, LSE = true) for the head dims of the wgmma backward
// (64, 80, 128): the forward that training's recompute runs, writing each
// row's log-sum-exp for flash_bwd_wgmma.cu. A source of their own, so that
// they compile in parallel with flash_wgmma.cu's sixteen.

#include "flash_wgmma.cuh"
#include "static_smem.cuh"

namespace repro_flash {

cudaError_t launch_wgmma_lse(const Params& p, int batch, int smem_bytes,
                             cudaStream_t stream) {
  if (p.hb * p.ppt > 2 * kRows || p.lse == nullptr) {
    return cudaErrorInvalidValue;
  }
  switch (p.dh) {
    case 64: return launch_dh<64, true>(p, batch, smem_bytes, stream);
    case 80: return launch_dh<80, true>(p, batch, smem_bytes, stream);
    case 128: return launch_dh<128, true>(p, batch, smem_bytes, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro_flash

// the static shared bytes of this source's kernels (static_smem.cuh)
extern "C" int flash_wgmma_lse_static_smem(int* bytes) {
  return repro_smem::max_static(
      {repro_smem::fn(flash_wgmma_kernel<64, 1, true>),
       repro_smem::fn(flash_wgmma_kernel<64, 2, true>),
       repro_smem::fn(flash_wgmma_kernel<80, 1, true>),
       repro_smem::fn(flash_wgmma_kernel<80, 2, true>),
       repro_smem::fn(flash_wgmma_kernel<128, 1, true>),
       repro_smem::fn(flash_wgmma_kernel<128, 2, true>)},
      bytes);
}
