// C entry point of the filter2d_halo kernel, loaded from Python with ctypes
// (kernels/filter2d/_build.py). Plain C types only: pointers, ints, one
// double. Returns the cudaError_t of the launch (cudaGetLastError), so a
// refused launch (bad shape, too much shared memory) is reported at once.
#include "filter2d_halo.cuh"

extern "C" int filter2d_halo_launch(
    const void* planes, const void* coeffs, const void* qparams, void* out,
    int M, int H, int W, int N, int Ho, int Wo, int w, int off, int policy,
    double constant, int in_dtype, int out_dtype, int form, int rounding,
    void* stream) {
  f2d::Params p;
  p.planes = planes;
  p.coeffs = coeffs;
  p.qparams = static_cast<const int32_t*>(qparams);
  p.out = out;
  p.M = M;
  p.H = H;
  p.W = W;
  p.N = N;
  p.Ho = Ho;
  p.Wo = Wo;
  p.off = off;
  p.policy = policy;
  p.constant = constant;
  p.rounding = rounding;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case f2d::F32: return (int)f2d::launch_f32(p, out_dtype, form, w, s);
    case f2d::BF16: return (int)f2d::launch_bf16(p, out_dtype, form, w, s);
    case f2d::I8: return (int)f2d::launch_i8(p, out_dtype, form, w, s);
    case f2d::U8: return (int)f2d::launch_u8(p, out_dtype, form, w, s);
    case f2d::I16: return (int)f2d::launch_i16(p, out_dtype, form, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
