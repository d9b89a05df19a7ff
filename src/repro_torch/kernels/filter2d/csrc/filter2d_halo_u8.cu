// uint8_t storage: int32 accumulator; int32 output, or the requantised type.
#include "filter2d_halo_ring.cuh"

namespace f2d {
cudaError_t launch_u8(const Params& p, int out_dtype, int form, int w,
                      cudaStream_t s, int* info) {
  return dispatch_int<uint8_t>(p, out_dtype, form, w, s, info);
}
}  // namespace f2d
