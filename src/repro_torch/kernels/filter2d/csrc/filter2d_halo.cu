// C entry points of the filter2d_halo kernel, loaded from Python with ctypes
// (kernels/filter2d/_build.py). Plain C types only: pointers, ints, one
// double. filter2d_halo_launch returns the cudaError_t of the launch
// (cudaGetLastError), so a refused launch (bad shape, too much shared
// memory, a TMA frame that is not 16-byte aligned) is reported at once.
//
// Built with -DF2D_TRACE (kernels/filter2d/trace.py: this file with the
// float32, int8 and uint8 units only) it exports filter2d_halo_trace_launch
// instead, the same launch writing the ring's event log.
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

f2d::Params make_params(const void* planes, const void* coeffs,
                        const void* qparams, void* out, int M, int H, int W,
                        int N, int Ho, int Wo, int w, int off, int policy,
                        double constant, int rounding, int tma, int n_out) {
  f2d::Params p;
  memset(&p, 0, sizeof p);
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
  p.w = w;
  p.n_out = n_out;
  // neglect (off 0) stores centre (y, x) at (y - r, x - r)
  p.shift = w / 2 - off;
  p.policy = policy;
  p.constant = constant;
  p.rounding = rounding;
  p.tma = tma != 0;
  p.blocks = 0;
  return p;
}

int launch_any(const f2d::Params& p, int in_dtype, int out_dtype, int form,
               int w, cudaStream_t s, int* info) {
  switch (in_dtype) {
    case f2d::F32: return (int)f2d::launch_f32(p, out_dtype, form, w, s, info);
    case f2d::I8: return (int)f2d::launch_i8(p, out_dtype, form, w, s, info);
    case f2d::U8: return (int)f2d::launch_u8(p, out_dtype, form, w, s, info);
#ifndef F2D_TRACE
    case f2d::BF16: return (int)f2d::launch_bf16(p, out_dtype, form, w, s, info);
    case f2d::I16: return (int)f2d::launch_i16(p, out_dtype, form, w, s, info);
#endif
    default: return (int)cudaErrorInvalidValue;
  }
}
}  // namespace

#ifndef F2D_TRACE
// one launch of N filters writing filters [0, N) of an output whose bank
// has n_out filters, `out` pointing at the launch's first one
extern "C" int filter2d_halo_launch(
    const void* planes, const void* coeffs, const void* qparams, void* out,
    int M, int H, int W, int N, int Ho, int Wo, int w, int off, int policy,
    double constant, int in_dtype, int out_dtype, int form, int rounding,
    int tma, int n_out, void* stream) {
  const f2d::Params p =
      make_params(planes, coeffs, qparams, out, M, H, W, N, Ho, Wo, w, off,
                  policy, constant, rounding, tma, n_out);
  return launch_any(p, in_dtype, out_dtype, form, w,
                    static_cast<cudaStream_t>(stream), nullptr);
}
#else
// the same launch on `blocks` blocks (0: as many as fit), logging the
// ring's events into rec[cap][REC_INTS] (`count` counts them, dropped ones
// too); info receives {shared memory bytes, blocks, tiles, strips}
extern "C" int filter2d_halo_trace_launch(
    const void* planes, const void* coeffs, const void* qparams, void* out,
    int M, int H, int W, int N, int Ho, int Wo, int w, int off, int policy,
    double constant, int in_dtype, int out_dtype, int form, int rounding,
    int tma, int n_out, int blocks, void* rec, void* count, int cap,
    int launch, int n0, void* info, void* stream) {
  f2d::Params p =
      make_params(planes, coeffs, qparams, out, M, H, W, N, Ho, Wo, w, off,
                  policy, constant, rounding, tma, n_out);
  p.blocks = blocks;
  p.trace.rec = static_cast<int*>(rec);
  p.trace.count = static_cast<int*>(count);
  p.trace.cap = cap;
  p.trace.launch = launch;
  p.trace.n0 = n0;
  return launch_any(p, in_dtype, out_dtype, form, w,
                    static_cast<cudaStream_t>(stream),
                    static_cast<int*>(info));
}
#endif

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

// The dynamic shared memory a launch of n filters takes (the function the
// launch sizes itself with), or -1 for an unknown dtype.
extern "C" int filter2d_halo_smem(int in_dtype, int out_dtype, int w,
                                  int form, int n) {
  const int s = dtype_bytes(in_dtype), so = dtype_bytes(out_dtype);
  if (s == 0 || so == 0 || w < 1) return -1;
  // the accumulator, and so each coefficient, is 4 bytes for every dtype
  return (int)f2d::smem_bytes(f2d::geometry(s, so, w),
                              f2d::coeff_words(w, form == f2d::SEPARABLE), n,
                              4);
}
