// The launches of the tensor-core prefill attention kernel
// (flash_wgmma.cuh) without the lse store, one kernel for each dh a
// multiple of 16 up to 128 and one or two warpgroups; the lse-writing
// kernels compile apart, in parallel, in flash_wgmma_lse.cu.

#include "flash_wgmma.cuh"
#include "static_smem.cuh"

namespace repro_flash {

cudaError_t launch_wgmma(const Params& p, int batch, int smem_bytes,
                         cudaStream_t stream) {
  if (p.hb * p.ppt > 2 * kRows) return cudaErrorInvalidValue;
  if (p.lse != nullptr) return launch_wgmma_lse(p, batch, smem_bytes, stream);
  switch (p.dh) {
    case 16: return launch_dh<16, false>(p, batch, smem_bytes, stream);
    case 32: return launch_dh<32, false>(p, batch, smem_bytes, stream);
    case 48: return launch_dh<48, false>(p, batch, smem_bytes, stream);
    case 64: return launch_dh<64, false>(p, batch, smem_bytes, stream);
    case 80: return launch_dh<80, false>(p, batch, smem_bytes, stream);
    case 96: return launch_dh<96, false>(p, batch, smem_bytes, stream);
    case 112: return launch_dh<112, false>(p, batch, smem_bytes, stream);
    case 128: return launch_dh<128, false>(p, batch, smem_bytes, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro_flash

// the static shared bytes of this source's kernels (static_smem.cuh)
extern "C" int flash_wgmma_static_smem(int* bytes) {
  return repro_smem::max_static(
      {repro_smem::fn(flash_wgmma_kernel<16, 1, false>),
       repro_smem::fn(flash_wgmma_kernel<16, 2, false>),
       repro_smem::fn(flash_wgmma_kernel<32, 1, false>),
       repro_smem::fn(flash_wgmma_kernel<32, 2, false>),
       repro_smem::fn(flash_wgmma_kernel<48, 1, false>),
       repro_smem::fn(flash_wgmma_kernel<48, 2, false>),
       repro_smem::fn(flash_wgmma_kernel<64, 1, false>),
       repro_smem::fn(flash_wgmma_kernel<64, 2, false>),
       repro_smem::fn(flash_wgmma_kernel<80, 1, false>),
       repro_smem::fn(flash_wgmma_kernel<80, 2, false>),
       repro_smem::fn(flash_wgmma_kernel<96, 1, false>),
       repro_smem::fn(flash_wgmma_kernel<96, 2, false>),
       repro_smem::fn(flash_wgmma_kernel<112, 1, false>),
       repro_smem::fn(flash_wgmma_kernel<112, 2, false>),
       repro_smem::fn(flash_wgmma_kernel<128, 1, false>),
       repro_smem::fn(flash_wgmma_kernel<128, 2, false>)},
      bytes);
}
