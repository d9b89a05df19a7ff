// C entry points of the filter2d_halo kernel, loaded from Python with ctypes
// (kernels/filter2d/_build.py). Plain C types only: pointers, ints, one
// double. filter2d_halo_launch returns the cudaError_t of the launch
// (cudaGetLastError), so a refused launch (bad shape, too much shared
// memory, a TMA frame that is not 16-byte aligned) is reported at once.
#include "filter2d_halo_ring.cuh"

namespace {
int dtype_bytes(int code) {
  switch (code) {
    case f2d::F32: case f2d::I32: return 4;
    case f2d::BF16: case f2d::I16: return 2;
    case f2d::I8: case f2d::U8: return 1;
    default: return 0;
  }
}
}  // namespace

extern "C" int filter2d_halo_launch(
    const void* planes, const void* coeffs, const void* qparams, void* out,
    int M, int H, int W, int N, int Ho, int Wo, int w, int off, int policy,
    double constant, int in_dtype, int out_dtype, int form, int rounding,
    int tma, void* stream) {
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
  // neglect (off 0) stores centre (y, x) at (y - r, x - r)
  p.shift = w / 2 - off;
  p.policy = policy;
  p.constant = constant;
  p.rounding = rounding;
  p.tma = tma != 0;
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

// The tile geometry the kernel uses for these dtypes and window, into
// g[0..7]: tile columns, strip rows, output columns and rows per thread,
// threads per block, ring stages, bytes per stage (window row pitch times
// window rows, 128-byte aligned), window row pitch in bytes. Returns 0, or
// cudaErrorInvalidValue for an unknown dtype.
extern "C" int filter2d_halo_geometry(int in_dtype, int out_dtype, int w,
                                      int* g) {
  const int s = dtype_bytes(in_dtype), so = dtype_bytes(out_dtype);
  if (s == 0 || so == 0 || w < 1) return (int)cudaErrorInvalidValue;
  const f2d::Geometry geo = f2d::geometry(s, so, w);
  const int vals[8] = {f2d::TILE_W, geo.SH,  geo.C,         geo.ROWS,
                       f2d::NT,     f2d::STAGES, geo.STAGE, geo.PITCH};
  for (int i = 0; i < 8; ++i) g[i] = vals[i];
  return 0;
}
