// Causal depthwise 1D convolution for sm_90a:
//     y[b, t, c] = bias[c] + sum_d x[b, t - (k - 1) + d, c] * w[d, c],
// with zero history before t = 0 in each batch row.
//
// Replaces the TPU kernel src/repro/kernels/dwconv1d/kernel.py::dwconv1d
// (_dwconv1d_kernel, pl.pallas_call at :51), the conv path of the mamba
// block (models/ssm.py, use_pallas_conv=True).
//
// What bounds it on an H100: bytes. k = 4 taps is 2k = 8 FLOP per output
// against 2 bytes in and 2 out (bf16); the card needs ~295 FLOP per byte
// before its arithmetic is the limit. At the mamba block's shape
// ([2, 4096, 3200] bf16) the 105 MB in and out take 0.031 ms at 3.35 TB/s.
//
// Design, against the TPU kernel:
//  * The Pallas grid walks sequence chunks in order and carries the last
//    k - 1 rows in VMEM scratch between steps. CUDA blocks run in no
//    order, so nothing is carried between blocks: each thread owns one
//    channel and a run of TT consecutive positions, reads the k - 1 rows
//    before its run itself (zero before t = 0), and slides that history
//    through registers along its run. Each x element is read about
//    (TT + k - 1) / TT times, once in the steady state.
//  * Channels are the fast axis: neighbouring threads take neighbouring
//    channels, so every load and store of a warp is one contiguous row
//    segment.
//  * Arithmetic in x's dtype, tap by tap, as the reference kernel does
//    (kernel.py:33-36): acc = x0 * w0; acc = acc + x_d * w_d; y = acc +
//    bias, each product and each sum rounded to x's dtype (bf16: formed
//    exactly in float32, then rounded; float32: __fmul_rn / __fadd_rn,
//    no fused multiply-add). The plain version repeats these roundings,
//    so the kernel agrees with it bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // channels per block
constexpr int TT = 16;   // positions per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// one multiply / one add in T's arithmetic
template <typename T> __device__ __forceinline__ float mul(float a, float b) {
  return to_f(from_f<T>(__fmul_rn(a, b)));
}
template <typename T> __device__ __forceinline__ float add(float a, float b) {
  return to_f(from_f<T>(__fadd_rn(a, b)));
}

template <typename T, int K>
__global__ void __launch_bounds__(NT)
dwconv1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ y, int S,
                int C) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c >= C) return;
  const int t0 = blockIdx.y * TT;
  const int64_t row = (int64_t)blockIdx.z * S;
  const T* xb = x + row * C + c;
  T* yb = y + row * C + c;
  float wt[K], hist[K];
#pragma unroll
  for (int d = 0; d < K; ++d) wt[d] = to_f(w[(int64_t)d * C + c]);
  const float bc = to_f(bias[c]);
#pragma unroll
  for (int d = 0; d < K - 1; ++d) {
    const int s = t0 - (K - 1) + d;
    hist[d] = s >= 0 ? to_f(xb[(int64_t)s * C]) : 0.f;
  }
  const int t_end = min(t0 + TT, S);
  for (int t = t0; t < t_end; ++t) {
    hist[K - 1] = to_f(xb[(int64_t)t * C]);
    float acc = mul<T>(hist[0], wt[0]);
#pragma unroll
    for (int d = 1; d < K; ++d) acc = add<T>(acc, mul<T>(hist[d], wt[d]));
    yb[(int64_t)t * C] = from_f<T>(add<T>(acc, bc));
#pragma unroll
    for (int d = 0; d < K - 1; ++d) hist[d] = hist[d + 1];
  }
}

template <typename T, int K>
int launch(const void* x, const void* w, const void* b, void* y, int B,
           int S, int C, cudaStream_t stream) {
  const dim3 grid((C + NT - 1) / NT, (S + TT - 1) / TT, B);
  dwconv1d_kernel<T, K><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), S, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(const void* x, const void* w, const void* b, void* y, int B,
             int S, int C, int k, cudaStream_t st) {
  switch (k) {
    case 2: return launch<T, 2>(x, w, b, y, B, S, C, st);
    case 4: return launch<T, 4>(x, w, b, y, B, S, C, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [B, S, C]; w: [k, C]; b: [C]; contiguous, one dtype (0 float32,
// 1 bfloat16). Returns the launch's CUDA error code.
extern "C" int dwconv1d_launch(const void* x, const void* w, const void* b,
                               void* y, int B, int S, int C, int k,
                               int dtype, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || B > 65535 || (S + TT - 1) / TT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_k<float>(x, w, b, y, B, S, C, k, st);
  if (dtype == 1) return launch_k<__nv_bfloat16>(x, w, b, y, B, S, C, k, st);
  return (int)cudaErrorInvalidValue;
}
