// bfloat16 storage: float32 accumulator, bfloat16 output.
#include "filter2d_halo_ring.cuh"

namespace f2d {
cudaError_t launch_bf16(const Params& p, int out_dtype, int form, int w,
                        cudaStream_t s, int* info) {
  if (out_dtype != BF16) return cudaErrorInvalidValue;
  return dispatch<__nv_bfloat16, float, __nv_bfloat16>(p, form, w, s, info);
}
}  // namespace f2d
