// Banded (sliding-window) causal flash attention for sm_90a: the float32
// kernel, on the CUDA cores, and the C entry point for both dtypes (the
// bfloat16 kernel, on the tensor cores, is swattn_bf16.cu).
//
// Replaces the TPU kernel src/repro/kernels/swattn/kernel.py::swattn
// (_swattn_kernel, pl.pallas_call at :102). What it computes is the same:
// for query position i of head h, softmax over the keys j of kv head
// h / (H / KV) with j <= i, j < S and (window > 0) i - j < window, of
// scale * (q_i . k_j), applied to v. window == 0 is full causal attention.
//
// What bounds it on an H100: operations. At the LM's shapes (S 8192,
// window 4096, hd 80, H 32) the band holds 25,167,872 useful (i, j) pairs
// per head, 4 * hd FLOP each (QK^T and PV): 2.58e11 FLOP against 105 MB of
// q, k, v and o, about 2,500 FLOP per byte — the bound is the arithmetic
// rate: 67 TFLOP/s for float32 outside the tensor cores, whose float32 mode
// is TF32, which the reference's float32 dot does not compute. So float32
// stays here, on the CUDA cores in float32 (FMA), by design.
//
// Design, against the TPU kernel:
//  * One thread block per (32-query tile, head, batch row). The Pallas
//    grid walks the band's k blocks in order ("arbitrary") and carries
//    the online-softmax state (m, l, acc) in VMEM scratch; here the
//    block's own loop over the band carries it in registers. The loop
//    visits only the k tiles that exist: from the tile holding
//    q0 - (window - 1) (clamped at 0) to the tile holding the last query
//    row — no clamped duplicate loads, no fully masked tiles.
//  * GQA: the block reads kv head h / (H / KV) in place; k and v are
//    never repeated in device memory.
//  * q, k, v and o stay in the model's [B, S, H, hd] layout, read and
//    written with strides: no transposes, no padding. The ragged edge
//    (positions >= S) is masked, and those rows are not written.
//  * Masking uses the reference's finite NEG_INF = -1e30 and zeroes p
//    under the mask, so a row with no key yet gives exp(0) * 0, never NaN.
//  * Rounding kept from the reference: scores in float32, scale applied
//    after the dot; l sums the float32 p; the reference rounds p to v's
//    dtype before the PV product (kernel.py:65), which for float32 leaves
//    it as it is; acc in float32; the output acc / l (l == 0 -> 1).
//    Products are fused multiply-adds and the dot's order is the
//    kernel's own, so float32 agrees with the plain version to rounding,
//    not bit for bit.
//  * Thread layout: 128 threads as 8 row groups x 16 columns; a thread
//    owns 4 query rows, 2 score columns of the 32-key tile and hd / 16
//    output columns, so each row's max and sum reduce over 16 lanes with
//    shuffles. Tiles sit in shared memory as float32, rows padded by one
//    word against bank conflicts. At hd 256 (gemma3) that is 102,784 bytes
//    of shared memory (opt-in, two blocks an SM) and 16 output columns,
//    64 accumulators, per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads per block
constexpr int TX = 16;         // lanes along a row
constexpr int TY = NT / TX;    // row groups
constexpr int RPT = 4;         // query rows per thread
constexpr int BQ = TY * RPT;   // query rows per block
constexpr int BK = 32;         // keys per tile
constexpr int CPT = BK / TX;   // score columns per thread
constexpr float NEG_INF = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD +
                          BQ * (BK + 1));
}

template <int HD>
__global__ void __launch_bounds__(NT)
swattn_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              int H, int KV, int window, float scale) {
  constexpr int QP = HD + 1;    // row pitches, in floats
  constexpr int KP = HD + 1;
  constexpr int PP = BK + 1;
  constexpr int DPT = HD / TX;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][QP]
  float* Ks = Qs + BQ * QP;     // [BK][KP]
  float* Vs = Ks + BK * KP;     // [BK][HD]
  float* Ps = Vs + BK * HD;     // [BQ][PP]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int r0 = (tid / TX) * RPT;
  const int64_t q_row = (int64_t)H * HD;    // stride of s in q and o
  const int64_t kv_row = (int64_t)KV * HD;  // stride of s in k and v
  const float* qb = q + (int64_t)b * S * q_row + (int64_t)h * HD;
  const float* kb = k + (int64_t)b * S * kv_row + (int64_t)hk * HD;
  const float* vb = v + (int64_t)b * S * kv_row + (int64_t)hk * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    Qs[r * QP + d] = s < S ? qb[s * q_row + d] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - (window - 1)) : 0;
  for (int kt = k_first / BK; kt <= q_last / BK; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      const bool in = s < S;
      Ks[r * KP + d] = in ? kb[s * kv_row + d] : 0.f;
      Vs[r * HD + d] = in ? vb[s * kv_row + d] : 0.f;
    }
    __syncthreads();

    float sc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(r0 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + TX * j) * KP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + r0 + i;
      bool ok[CPT];
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + TX * j;
        ok[j] = kpos <= qpos && kpos < S && qpos < S &&
                (window <= 0 || qpos - kpos < window);
        sc[i][j] = ok[j] ? sc[i][j] * scale : NEG_INF;
        rmax = fmaxf(rmax, sc[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        rsum += p;
        Ps[(r0 + i) * PP + tx + TX * j] = p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(r0 + i) * PP + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[kk * HD + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int s = q0 + r0 + i;
    if (s >= S) continue;
    const float den = l[i] > 0.f ? l[i] : 1.f;
    float* ob = o + ((int64_t)b * S + s) * q_row + (int64_t)h * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[tx + TX * j] = acc[i][j] / den;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      swattn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  swattn_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, window,
      scale);
  return (int)cudaGetLastError();
}

int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, int hd, int window, float scale,
              cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 64: return launch<64>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 80: return launch<80>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 128: return launch<128>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 256: return launch<256>(q, k, v, o, B, S, H, KV, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The bfloat16 path, on the tensor cores: swattn_bf16.cu.
int swattn_bf16_launch(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KV, int hd, int window,
                       float scale, cudaStream_t st);
int swattn_bf16_tile_keys();

// q, o: [B, S, H, hd]; k, v: [B, S, KV, hd]; contiguous, one dtype
// (0 float32, 1 bfloat16). Returns the launch's CUDA error code.
extern "C" int swattn_launch(const void* q, const void* k, const void* v,
                             void* o, int B, int S, int H, int KV, int hd,
                             int window, float scale, int dtype,
                             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd(q, k, v, o, B, S, H, KV, hd, window, scale, st);
  if (dtype == 1)
    return swattn_bf16_launch(q, k, v, o, B, S, H, KV, hd, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Keys per K/V tile of the kernel for dtype (0 float32, 1 bfloat16), so
// callers can place windows on the tile's edges; -1 for another dtype.
extern "C" int swattn_tile_keys(int dtype) {
  if (dtype == 0) return BK;
  if (dtype == 1) return swattn_bf16_tile_keys();
  return -1;
}
