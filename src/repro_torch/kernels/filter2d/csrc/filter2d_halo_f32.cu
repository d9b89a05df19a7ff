// float32 storage: float32 accumulator, float32 output.
#include "filter2d_halo_ring.cuh"

namespace f2d {
cudaError_t launch_f32(const Params& p, int out_dtype, int form, int w,
                       cudaStream_t s, int* info) {
  if (out_dtype != F32) return cudaErrorInvalidValue;
  return dispatch<float, float, float>(p, form, w, s, info);
}
}  // namespace f2d
