// filter2d_halo: w x w correlation of M planes with an N-filter bank, the
// border policy resolved on the read path, one of the paper's reduction
// forms, and an optional fused requantising epilogue. CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/filter2d/kernel.py::filter2d_halo
// (body _halo_kernel, with the halo engine of kernels/filter2d/halo.py and
// the fused epilogue core/filter2d.py::apply_requant).
//
// What bounds it on an H100: at w <= 7 the kernel does 2*w*w operations per
// output pixel and moves one input and one output pixel through HBM, so it
// is bound by HBM bytes, not arithmetic: ~8 B/px for float32 in and out,
// ~2 B/px for an int8 frame with an int8 requantised output, against
// 3.35 TB/s.
//
// What this simple design does about it: each thread block owns one
// TILE_H x TILE_W output tile of one plane. It loads its
// (TILE_H+2r) x (TILE_W+2r) input window into shared memory once, at the
// storage width, remapping each out-of-frame source index by the border
// policy as it loads (the paper's lean border mux: no padded frame in HBM,
// no extra pass). The block then loops over the N filters of the bank and
// reuses the window for each (the coefficient file's read-once property),
// with the bank's coefficients in shared memory. The output is written
// once, at the storage width when the epilogue is on. Halo re-reads
// between neighbouring tiles (~1.3x at w=7) mostly hit L2. A TMA/mbarrier
// double-buffered design is later work.
//
// Arithmetic contract, shared with the plain PyTorch version
// (kernels/filter2d/kernel.py::filter2d_halo_ref):
//   * float32 and bfloat16 frames load at their storage type and
//     accumulate in float32 with separately rounded multiplies and adds
//     (__fmul_rn/__fadd_rn: no FMA contraction), so the kernel and the
//     plain version agree bit for bit. The reference package accumulates
//     bfloat16 at bfloat16; the port does not.
//   * integer frames widen to int32 only at the MAC; the MAC and the
//     epilogue's acc*multiplier run in uint32 and cast back, which is the
//     two's-complement wraparound of the reference (signed overflow is
//     undefined in C++). Because that arithmetic is exact mod 2^32, every
//     reduction order gives the same integer result, so integer frames use
//     the left-fold instantiation for direct, transposed, tree and compress.
//   * forms sum the w*w products in the reference kernel's order
//     (kernel.py:_reduce_taps/_reduce_separable): direct and transposed as
//     a left fold in raster order, tree pairwise level by level with the
//     odd tail carried, compress in groups of 6 then chained; separable
//     runs the w-tap column pass with v along the width over every window
//     row, then the w-tap row pass with u.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace f2d {

constexpr int TILE_W = 64;   // output columns per block (= blockDim.x)
constexpr int TILE_H = 32;   // output rows per block
constexpr int BLOCK_Y = 4;   // blockDim.y: each thread owns TILE_H/BLOCK_Y rows

enum Policy { NEGLECT = 0, CONSTANT = 1, WRAP = 2, DUPLICATE = 3,
              MIRROR_DUP = 4, MIRROR = 5 };
enum Form { FOLD = 0, TREE = 1, COMPRESS = 2, SEPARABLE = 3 };
enum Rounding { NO_REQUANT = -1, TRUNCATE = 0, NEAREST = 1, NEAREST_EVEN = 2 };

struct Params {
  const void* planes;      // [M, H, W] storage type T, contiguous
  const void* coeffs;      // [N, w, w] or [N, 2, w] (separable), type A
  const int32_t* qparams;  // [N, 2] (multiplier, shift) or nullptr
  void* out;               // [M, N, Ho, Wo] type O, contiguous
  int M, H, W, N, Ho, Wo;
  int off;                 // window offset: r for same-size policies, 0 for neglect
  int policy;
  double constant;         // constant(c), already exact in the storage type
  int rounding;
};

// ---------------------------------------------------------------------------
// border mux: the index rules of core/borders.py::map_index, then a clamp
// that only matters for window slots feeding masked (ragged-edge) outputs
// ---------------------------------------------------------------------------
__device__ __forceinline__ int map_index(int i, int n, int policy) {
  if (policy == WRAP) {
    i %= n;
    if (i < 0) i += n;
  } else if (policy == MIRROR_DUP) {
    if (i < 0) i = -i - 1;
    if (i >= n) i = 2 * n - i - 1;
  } else if (policy == MIRROR) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - i - 2;
  }
  return min(max(i, 0), n - 1);
}

// ---------------------------------------------------------------------------
// MAC arithmetic: float without contraction, int32 with wraparound
// ---------------------------------------------------------------------------
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int32_t mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

template <typename A, typename T> __device__ __forceinline__ A widen(T v) {
  return (A)v;
}
template <> __device__ __forceinline__ float widen<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_double(double c) {
  return (T)c;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_double<__nv_bfloat16>(
    double c) {
  return __float2bfloat16_rn((float)c);
}

// pairwise tree, level by level, odd tail carried (core/filter2d.py:_tree)
template <typename A, int N> struct Tree {
  static __device__ __forceinline__ A run(A* p) {
    constexpr int H = N / 2;
#pragma unroll
    for (int i = 0; i < H; ++i) p[i] = add(p[2 * i], p[2 * i + 1]);
    if constexpr ((N & 1) != 0) p[H] = p[N - 1];
    return Tree<A, H + (N & 1)>::run(p);
  }
};
template <typename A> struct Tree<A, 1> {
  static __device__ __forceinline__ A run(A* p) { return p[0]; }
};

// one output pixel: the w*w taps of the window at wp (row stride EW)
template <typename T, typename A, int W, int FORM, int EW>
__device__ __forceinline__ A reduce_taps(const T* wp, const A* k) {
  constexpr int NT = W * W;
  if constexpr (FORM == FOLD) {
    A acc = mul(widen<A>(wp[0]), k[0]);
#pragma unroll
    for (int t = 1; t < NT; ++t)
      acc = add(acc, mul(widen<A>(wp[(t / W) * EW + t % W]), k[t]));
    return acc;
  } else if constexpr (FORM == TREE) {
    A p[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) p[t] = mul(widen<A>(wp[(t / W) * EW + t % W]), k[t]);
    return Tree<A, NT>::run(p);
  } else {  // COMPRESS: groups of 6, then a chain over the partial sums
    A acc = A(0);
#pragma unroll
    for (int g = 0; g < NT; g += 6) {
      A s = mul(widen<A>(wp[(g / W) * EW + g % W]), k[g]);
#pragma unroll
      for (int t = g + 1; t < g + 6 && t < NT; ++t)
        s = add(s, mul(widen<A>(wp[(t / W) * EW + t % W]), k[t]));
      acc = (g == 0) ? s : add(acc, s);
    }
    return acc;
  }
}

// the fused epilogue: the identities of core/filter2d.py::apply_requant
__device__ __forceinline__ int32_t requant(int32_t acc, int32_t m, int32_t sh,
                                           int rounding) {
  sh = min(max(sh, 0), 31);  // RequantSpec's contract; keeps shifts defined
  const int32_t prod = mul(acc, m);
  const int32_t shm1 = sh > 0 ? sh - 1 : 0;
  if (rounding == TRUNCATE) return prod >> sh;  // arithmetic (floor) shift
  if (rounding == NEAREST) {
    const int32_t half = sh > 0 ? (1 << shm1) : 0;
    return add(prod, half) >> sh;
  }
  const int32_t base = prod >> sh;  // NEAREST_EVEN: masked-remainder tie rule
  const int32_t rem = (int32_t)((uint32_t)prod & ((1u << sh) - 1u));
  const int32_t half = 1 << shm1;
  const bool up = (rem > half) || (rem == half && (base & 1) != 0);
  return base + ((sh > 0 && up) ? 1 : 0);
}

template <typename O> struct Limits;
template <> struct Limits<int8_t> { static constexpr int32_t lo = -128, hi = 127; };
template <> struct Limits<uint8_t> { static constexpr int32_t lo = 0, hi = 255; };
template <> struct Limits<int16_t> { static constexpr int32_t lo = -32768, hi = 32767; };

template <typename O, typename A>
__device__ __forceinline__ O finish(A acc, const Params& p, int32_t m, int32_t sh) {
  if constexpr (std::is_same<O, float>::value) {
    return acc;
  } else if constexpr (std::is_same<O, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(acc);
  } else if constexpr (std::is_same<O, int32_t>::value) {
    return acc;
  } else {
    const int32_t q = requant(acc, m, sh, p.rounding);
    return (O)min(max(q, Limits<O>::lo), Limits<O>::hi);
  }
}

template <typename T, typename A, typename O, int W, int FORM>
__global__ void __launch_bounds__(TILE_W * BLOCK_Y)
filter2d_halo_kernel(const Params p) {
  constexpr int R = W / 2;
  constexpr int EH = TILE_H + 2 * R;
  constexpr int EW = TILE_W + 2 * R;
  constexpr int NT = (FORM == SEPARABLE) ? 2 * W : W * W;
  // raw storage: __shared__ arrays of class types (bfloat16) take no
  // constructors
  __shared__ __align__(16) unsigned char win_raw[EH * EW * sizeof(T)];
  __shared__ __align__(16) unsigned char
      hbuf_raw[(FORM == SEPARABLE ? EH * TILE_W : 1) * sizeof(A)];
  T* win = reinterpret_cast<T*>(win_raw);
  A* hbuf = reinterpret_cast<A*>(hbuf_raw);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* cs = reinterpret_cast<A*>(smem_raw);  // the bank's coefficients

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE_W + tx;
  constexpr int NTHREADS = TILE_W * BLOCK_Y;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * TILE_H;
  const int m = blockIdx.z;

  const T* src = static_cast<const T*>(p.planes) + (size_t)m * p.H * p.W;
  const A* gco = static_cast<const A*>(p.coeffs);
  for (int e = tid; e < p.N * NT; e += NTHREADS) cs[e] = gco[e];

  // LOAD: the tile's window at storage width, border policy on the read path
  const T cval = from_double<T>(p.constant);
  for (int e = tid; e < EH * EW; e += NTHREADS) {
    const int ey = e / EW, ex = e - (e / EW) * EW;
    const int gy = y0 - p.off + ey, gx = x0 - p.off + ex;
    const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
    T v;
    if (p.policy == CONSTANT && !inside) {
      v = cval;
    } else {
      const int sy = map_index(gy, p.H, p.policy);
      const int sx = map_index(gx, p.W, p.policy);
      v = src[(size_t)sy * p.W + sx];
    }
    win[e] = v;
  }
  __syncthreads();

  O* out = static_cast<O*>(p.out);
  const int gx = x0 + tx;
  for (int f = 0; f < p.N; ++f) {
    int32_t qm = 1, qs = 0;
    if (p.qparams != nullptr) {
      qm = p.qparams[2 * f];
      qs = p.qparams[2 * f + 1];
    }
    O* oplane = out + ((size_t)m * p.N + f) * p.Ho * p.Wo;
    if constexpr (FORM == SEPARABLE) {
      A u[W], v[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        u[i] = cs[f * NT + i];
        v[i] = cs[f * NT + W + i];
      }
      __syncthreads();  // the previous filter's row pass is done with hbuf
      // column pass (v along the width) over every window row
      for (int e = tid; e < EH * TILE_W; e += NTHREADS) {
        const int ey = e / TILE_W, ox = e - (e / TILE_W) * TILE_W;
        const T* wp = win + ey * EW + ox;
        A s = mul(widen<A>(wp[0]), v[0]);
#pragma unroll
        for (int j = 1; j < W; ++j) s = add(s, mul(widen<A>(wp[j]), v[j]));
        hbuf[e] = s;
      }
      __syncthreads();
      // row pass (u along the height)
#pragma unroll 2
      for (int oy = ty; oy < TILE_H; oy += BLOCK_Y) {
        const int gy = y0 + oy;
        if (gy >= p.Ho || gx >= p.Wo) continue;
        const A* hp = hbuf + oy * TILE_W + tx;
        A acc = mul(hp[0], u[0]);
#pragma unroll
        for (int i = 1; i < W; ++i) acc = add(acc, mul(hp[i * TILE_W], u[i]));
        oplane[(size_t)gy * p.Wo + gx] = finish<O>(acc, p, qm, qs);
      }
    } else {
      A k[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) k[t] = cs[f * NT + t];
#pragma unroll 2
      for (int oy = ty; oy < TILE_H; oy += BLOCK_Y) {
        const int gy = y0 + oy;
        if (gy >= p.Ho || gx >= p.Wo) continue;
        const A acc = reduce_taps<T, A, W, FORM, EW>(win + oy * EW + tx, k);
        oplane[(size_t)gy * p.Wo + gx] = finish<O>(acc, p, qm, qs);
      }
    }
  }
}

template <typename T, typename A, typename O, int W, int FORM>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int NT = (FORM == SEPARABLE) ? 2 * W : W * W;
  // the wrapper caps the bank at 24 KiB, so static (<= ~20 KiB) plus
  // dynamic shared memory stays under the 48 KiB needing no opt-in
  const size_t coeff_bytes = (size_t)p.N * NT * sizeof(A);
  const dim3 block(TILE_W, BLOCK_Y);
  const dim3 grid((p.Wo + TILE_W - 1) / TILE_W, (p.Ho + TILE_H - 1) / TILE_H,
                  p.M);
  filter2d_halo_kernel<T, A, O, W, FORM><<<grid, block, coeff_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename A, typename O, int W>
cudaError_t dispatch_form(const Params& p, int form, cudaStream_t stream) {
  if (form == SEPARABLE) return launch<T, A, O, W, SEPARABLE>(p, stream);
  if constexpr (std::is_integral<A>::value) {
    return launch<T, A, O, W, FOLD>(p, stream);  // exact mod 2^32: any order
  } else {
    if (form == TREE) return launch<T, A, O, W, TREE>(p, stream);
    if (form == COMPRESS) return launch<T, A, O, W, COMPRESS>(p, stream);
    return launch<T, A, O, W, FOLD>(p, stream);
  }
}

template <typename T, typename A, typename O>
cudaError_t dispatch(const Params& p, int form, int w, cudaStream_t stream) {
  switch (w) {
    case 1: return dispatch_form<T, A, O, 1>(p, form, stream);
    case 3: return dispatch_form<T, A, O, 3>(p, form, stream);
    case 5: return dispatch_form<T, A, O, 5>(p, form, stream);
    case 7: return dispatch_form<T, A, O, 7>(p, form, stream);
    default: return cudaErrorInvalidValue;
  }
}

// dtype codes shared with kernels/filter2d/kernel.py
enum DType { F32 = 0, BF16 = 1, I8 = 2, U8 = 3, I16 = 4, I32 = 5 };

// integer storage T: out is the int32 accumulator or a requantised type
template <typename T>
cudaError_t dispatch_int(const Params& p, int out_dtype, int form, int w,
                         cudaStream_t stream) {
  switch (out_dtype) {
    case I32: return dispatch<T, int32_t, int32_t>(p, form, w, stream);
    case I8: return dispatch<T, int32_t, int8_t>(p, form, w, stream);
    case U8: return dispatch<T, int32_t, uint8_t>(p, form, w, stream);
    case I16: return dispatch<T, int32_t, int16_t>(p, form, w, stream);
    default: return cudaErrorInvalidValue;
  }
}

// one entry per storage type, each in its own translation unit so the
// instantiations build in parallel
cudaError_t launch_f32(const Params& p, int out_dtype, int form, int w, cudaStream_t s);
cudaError_t launch_bf16(const Params& p, int out_dtype, int form, int w, cudaStream_t s);
cudaError_t launch_i8(const Params& p, int out_dtype, int form, int w, cudaStream_t s);
cudaError_t launch_u8(const Params& p, int out_dtype, int form, int w, cudaStream_t s);
cudaError_t launch_i16(const Params& p, int out_dtype, int form, int w, cudaStream_t s);

}  // namespace f2d
