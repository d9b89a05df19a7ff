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
// is TF32 (or three TF32 products for one float32 one), which the
// reference's float32 dot does not compute. So float32 stays on the CUDA
// cores, in float32 FMA, and the design is an SGEMM's: what it has to
// keep small is every instruction that is not an FFMA.
//
// Geometry (the same BQ and BK at every head dim, so the edge sweep can
// place S and windows on them: swattn_tile_queries / swattn_tile_keys):
//  * One block per (head, batch row, 64-query tile); BK = 64 keys a tile.
//    hd 16-128: 128 threads, two blocks an SM; hd 256: 256 threads, one.
//  * A thread owns TM = 4 query rows (r, r + 16, r + 32, r + 48) and, of
//    each 64-key tile, TN keys (c, c + CG, ...): 4 x 8 scores from the 8
//    lanes of its row group (CG = 8), or 4 x 4 from 16 lanes at hd 256.
//    Of the output it owns the same 4 rows and hd / CG columns: float4
//    vectors at 4 (c + CG u), and where hd / 4 is no multiple of CG
//    (hd 16, 80) float2 vectors past them. 40 accumulators at hd 80, 64
//    at hd 128 and 256.
//  * Register tiles read with 128-bit shared loads. QK^T reads Q and K
//    four floats at a time along d: 4 + 8 float4 loads feed 128 FFMA.
//    P goes to shared memory once a tile, each lane's 8 scores of a row
//    as two float4 stores; PV reads them back as float4 and each V row as
//    the thread's column vectors (hd 80: 4 + 12 loads per 160 FFMA).
//    Tiles whose rows are a multiple of 32 floats are
//    XOR-swizzled in 16-byte chunks (chunk c of row r at c ^ (r & 7));
//    the others (hd 16, 80) are padded by 4 floats. Every load of a warp
//    then touches distinct banks, or broadcasts.
//  * A ring of two shared stages, through which K and V tiles stream in
//    turn by cp.async (16 bytes a thread, positions >= S zero-filled): V
//    of tile i loads while Q K_i^T is computed, K of tile i + 1 while
//    P_i V_i is. Two barriers a tile.
//  * Shared memory: Q tile, two stages, P tile = 31,744 B (hd 16), 65,536
//    (hd 64), 80,896 (hd 80), 114,688 (hd 128), 212,992 (hd 256).
//  * The softmax: one FFMA of the score with scale * log2 e before ex2
//    (a negative scale negates the Q tile, which is exact, and uses
//    |scale|); a row's max reduces over the lanes that share it (3 or 4
//    shuffles), O and l are rescaled only when a row maximum of the warp
//    moved, l is summed per lane and reduced once at the end. Only tiles
//    that cross the diagonal, the band's far edge or S are masked.
//  * Scheduling: the grid is (H, B, q tiles) with the q tiles running
//    backwards, so the heaviest launch first, and the H / KV query heads
//    of one kv head are neighbours, so their K / V tiles come from L2.
//    The loop visits only the k tiles of the band.
// What bounds it then: issue and latency. Beside the FFMA a scheduler
// issues the shared loads, the softmax and the copies' addresses, and
// with two warps a scheduler (registers and shared memory allow no more)
// the softmax's shuffle and ex2 chains and the two barriers a tile are
// only partly hidden; at the band's edges the diagonal tiles compute
// their masked halves.
//
// Kept from the reference (src/repro/kernels/swattn/kernel.py:30-73):
// scores in float32 with the scale applied after the dot; the finite
// NEG_INF = -1e30 under the mask and p zeroed there, so a row with no key
// gives 0 / 1, never NaN; m, l and the accumulator carried across the k
// tiles (in registers here, in VMEM scratch there); p kept in float32 for
// the PV product (the reference rounds p to v's dtype, float32 here);
// l summed from the float32 p; the output acc / l (l == 0 -> 1). GQA is
// by index (k and v are never repeated), q, k, v and o stay in the
// model's [B, S, H, hd] layout, and the ragged edge (positions >= S) is
// masked and its rows are not written. The sums run in the kernel's own
// order, and ex2.approx is within 2 ulp, so float32 agrees with the plain
// version to rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per K/V tile
constexpr int TM = 4;           // query rows per thread
constexpr int RG = BQ / TM;     // row groups: a thread's rows are RG apart
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// A [ROWS][COLS] float tile in shared memory, in 16-byte chunks: rows of a
// multiple of 32 floats XOR-swizzled (chunk c of row r at c ^ (r & 7)),
// others padded by 4 floats.
template <int ROWS, int COLS>
struct Tile {
  static constexpr int CHUNKS = COLS / 4;
  static constexpr bool SWIZZLE = CHUNKS % 8 == 0;
  static constexpr int PITCH = SWIZZLE ? COLS : COLS + 4;
  static constexpr int FLOATS = ROWS * PITCH;
  __device__ static __forceinline__ int at(int r, int c) {
    return r * PITCH + 4 * (SWIZZLE ? c ^ (r & 7) : c);
  }
};

// The chunk offsets of one row r0 and of the rows r0 + 8n, which share its
// swizzle: at(dr, c) is a register plus an immediate for c known at
// compile time (dr a multiple of 8).
template <class T>
struct Rows {
  int off[T::SWIZZLE ? 8 : 1];
  __device__ __forceinline__ explicit Rows(int r0) {
    if constexpr (T::SWIZZLE) {
#pragma unroll
      for (int t = 0; t < 8; ++t) off[t] = r0 * T::PITCH + 4 * (t ^ (r0 & 7));
    } else {
      off[0] = r0 * T::PITCH;
    }
  }
  __device__ __forceinline__ int at(int dr, int c) const {
    if constexpr (T::SWIZZLE)
      return off[c & 7] + dr * T::PITCH + 4 * (c & ~7);
    else
      return off[0] + dr * T::PITCH + 4 * c;
  }
};

template <int HD>
struct Geometry {
  static constexpr int NT = HD == 256 ? 256 : 128;  // threads
  static constexpr int MIN_BLOCKS = HD == 256 ? 1 : 2;
  static constexpr int CG = NT / RG;       // lanes along a row: 8 or 16
  static constexpr int TN = BK / CG;       // keys per thread
  static constexpr int DN = HD / CG;       // output columns per thread:
  static constexpr int NV4 = HD / 4 / CG;  // float4 vectors 4 (cg + CG u)
  static constexpr int NV2 = (HD - 4 * CG * NV4) / (2 * CG);  // then float2
  using QT = Tile<BQ, HD>;
  using KT = Tile<BK, HD>;                 // a ring stage: K or V
  using PT = Tile<BQ, BK>;
  static constexpr int UC = QT::SWIZZLE ? 8 : 4;  // d chunks per unrolled step
  static constexpr size_t SMEM =
      sizeof(float) * (QT::FLOATS + 2 * KT::FLOATS + PT::FLOATS);
  static_assert(CG % 8 == 0 && TN % 4 == 0, "geometry");
  static_assert(4 * NV4 + 2 * NV2 == DN && (NV2 == 0 || !KT::SWIZZLE),
                "columns");
  static_assert(QT::CHUNKS % UC == 0 && PT::SWIZZLE, "tiles");
  static_assert((BQ * HD / 4) % NT == 0, "loader");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows s0 .. s0 + ROWS - 1 of a [S, *] float array (rows `stride` floats
// apart) into tile T by cp.async; rows >= S read as zeros.
template <class T, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int s0,
                                          int S, int64_t stride, int tid) {
  constexpr int N = T::FLOATS / T::PITCH * T::CHUNKS;
#pragma unroll
  for (int n = 0; n < N / NT; ++n) {
    const int i = tid + n * NT;
    const int r = i / T::CHUNKS, c = i % T::CHUNKS;
    const bool in = s0 + r < S;
    cp_async16(dst + T::at(r, c), src + (in ? s0 + r : s0) * stride + 4 * c,
               in);
  }
}

template <int HD>
__global__ void __launch_bounds__(Geometry<HD>::NT, Geometry<HD>::MIN_BLOCKS)
swattn_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              int H, int KV, int window, float scale) {
  using G = Geometry<HD>;
  using QT = typename G::QT;
  using KT = typename G::KT;
  using PT = typename G::PT;
  constexpr int NT = G::NT, CG = G::CG, TN = G::TN, DN = G::DN;
  constexpr int NV4 = G::NV4, NV2 = G::NV2;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + QT::FLOATS;  // ring stage 0: K tiles
  float* Vs = Ks + KT::FLOATS;  // ring stage 1: V tiles
  float* Ps = Vs + KT::FLOATS;  // [BQ][BK]: lane c's keys of a row at TN c

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tiles first
  const int hk = h / (H / KV);
  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const int64_t q_row = (int64_t)H * HD;    // stride of s in q and o
  const int64_t kv_row = (int64_t)KV * HD;  // stride of s in k and v
  const float* qb = q + (int64_t)b * S * q_row + (int64_t)h * HD;
  const float* kb = k + (int64_t)b * S * kv_row + (int64_t)hk * HD;
  const float* vb = v + (int64_t)b * S * kv_row + (int64_t)hk * HD;
  const float c2 = fabsf(scale) * LOG2E;  // the exponent is base 2

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - (window - 1)) : 0;
  const int kt_first = k_first / BK, kt_last = q_last / BK;

  load_tile<QT, NT>(Qs, qb, q0, S, q_row, tid);
  load_tile<KT, NT>(Ks, kb, kt_first * BK, S, kv_row, tid);
  cp_async_commit();
  if (scale < 0.f) {  // scale * (q . k) == |scale| * (-q . k), exactly
    cp_async_wait_all();
    __syncthreads();
    for (int i = tid; i < QT::FLOATS; i += NT) Qs[i] = -Qs[i];
  }

  const Rows<QT> qrows(rg);
  const Rows<KT> krows(cg);
  int pw[TN / 4];  // this thread's chunks of P, in its row group's swizzle
#pragma unroll
  for (int w = 0; w < TN / 4; ++w)
    pw[w] = rg * PT::PITCH + 4 * (((TN / 4) * cg + w) ^ (rg & 7));

  float m[TM], l[TM], acc[TM][DN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;  // this lane's part of the row's sum
#pragma unroll
    for (int d = 0; d < DN; ++d) acc[i][d] = 0.f;
  }

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait_all();
    __syncthreads();  // K (and Q) landed; the last PV is done with Vs, Ps
    load_tile<KT, NT>(Vs, vb, k0, S, kv_row, tid);
    cp_async_commit();

    // S = Q K^T: the thread's 4 rows x TN keys, float4 loads along d
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int c0 = 0; c0 < QT::CHUNKS; c0 += G::UC) {
      const float* qc = Qs + 4 * c0;
      const float* kc = Ks + 4 * c0;
#pragma unroll
      for (int t = 0; t < G::UC; ++t) {
        float4 qv[TM], kv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qc + qrows.at(RG * i, t));
#pragma unroll
        for (int j = 0; j < TN; ++j)
          kv[j] = *reinterpret_cast<const float4*>(kc + krows.at(CG * j, t));
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
    }

    // the mask, only on tiles that cross the diagonal, the band's far edge
    // or S; dead bit i * TN + j: the pair is masked
    uint32_t dead = 0;
    if (k0 + BK - 1 > q0 || k0 + BK > S ||
        (window > 0 && q0 + BQ - 1 - k0 >= window)) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int qi = q0 + rg + RG * i, kj = k0 + cg + CG * j;
          if (!(kj <= qi && kj < S && (window <= 0 || qi - kj < window))) {
            s[i][j] = NEG_INF;
            dead |= 1u << (i * TN + j);
          }
        }
    }

    // online softmax; p to shared memory, this lane's TN keys contiguous
    float m_new[TM];
    bool moved = false;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < TN; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      m_new[i] = fmaxf(m[i], mx);
      moved |= m_new[i] > m[i];
    }
    if (__any_sync(0xffffffffu, moved)) {  // a row of the warp moved
#pragma unroll
      for (int i = 0; i < TM; ++i) {  // alpha is 1 where it did not
        const float alpha = ex2((m[i] - m_new[i]) * c2);
        l[i] *= alpha;
#pragma unroll
        for (int d = 0; d < DN; ++d) acc[i][d] *= alpha;
        m[i] = m_new[i];
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float mc = m[i] * c2;
      float p[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        p[j] = ex2(fmaf(s[i][j], c2, -mc));
        if (dead & (1u << (i * TN + j))) p[j] = 0.f;
        l[i] += p[j];
      }
#pragma unroll
      for (int w = 0; w < TN / 4; ++w)
        *reinterpret_cast<float4*>(Ps + pw[w] + RG * i * PT::PITCH) =
            make_float4(p[4 * w], p[4 * w + 1], p[4 * w + 2], p[4 * w + 3]);
    }

    cp_async_wait_all();
    __syncthreads();  // V landed; K and P are complete and free
    if (kt < kt_last) {
      load_tile<KT, NT>(Ks, kb, k0 + BK, S, kv_row, tid);
      cp_async_commit();
    }

    // O += P V: per lane c of the row group, its TN keys c, c + CG, ...
#pragma unroll 2
    for (int c = 0; c < CG; ++c) {
      float4 pv[TM][TN / 4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int w = 0; w < TN / 4; ++w)
          pv[i][w] = *reinterpret_cast<const float4*>(
              Ps + (rg + RG * i) * PT::PITCH +
              4 * (((TN / 4) * c + w) ^ (rg & 7)));
      // key c + CG j sits in row c + CG j, whose swizzle is c's
      const float* v4 =
          Vs + c * KT::PITCH + 4 * (KT::SWIZZLE ? cg ^ (c & 7) : cg);
      const float* v2 = Vs + c * KT::PITCH + 4 * CG * NV4 + 2 * cg;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float vv[DN];
#pragma unroll
        for (int u = 0; u < NV4; ++u) {
          const float4 t = *reinterpret_cast<const float4*>(
              v4 + CG * j * KT::PITCH + 4 * CG * u);
          vv[4 * u] = t.x;
          vv[4 * u + 1] = t.y;
          vv[4 * u + 2] = t.z;
          vv[4 * u + 3] = t.w;
        }
#pragma unroll
        for (int u = 0; u < NV2; ++u) {
          const float2 t = *reinterpret_cast<const float2*>(
              v2 + CG * j * KT::PITCH + 2 * CG * u);
          vv[4 * NV4 + 2 * u] = t.x;
          vv[4 * NV4 + 2 * u + 1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 p4 = pv[i][j / 4];
          const float pij = j % 4 == 0   ? p4.x
                            : j % 4 == 1 ? p4.y
                            : j % 4 == 2 ? p4.z
                                         : p4.w;
#pragma unroll
          for (int d = 0; d < DN; ++d) acc[i][d] = fmaf(pij, vv[d], acc[i][d]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = CG / 2; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int s_pos = q0 + rg + RG * i;
    if (s_pos >= S) continue;
    const float den = li > 0.f ? li : 1.f;
    float* ob = o + ((int64_t)b * S + s_pos) * q_row + (int64_t)h * HD;
#pragma unroll
    for (int u = 0; u < NV4; ++u)
      *reinterpret_cast<float4*>(ob + 4 * (cg + CG * u)) =
          make_float4(acc[i][4 * u] / den, acc[i][4 * u + 1] / den,
                      acc[i][4 * u + 2] / den, acc[i][4 * u + 3] / den);
#pragma unroll
    for (int u = 0; u < NV2; ++u)
      *reinterpret_cast<float2*>(ob + 4 * CG * NV4 + 2 * (cg + CG * u)) =
          make_float2(acc[i][4 * NV4 + 2 * u] / den,
                      acc[i][4 * NV4 + 2 * u + 1] / den);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int window, float scale,
           cudaStream_t stream) {
  using G = Geometry<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      swattn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  // two blocks an SM at hd 128 take 231,424 of its 233,472 bytes
  err = cudaFuncSetAttribute(swattn_kernel<HD>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  swattn_kernel<HD><<<grid, G::NT, G::SMEM, stream>>>(
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
// (0 float32, 1 bfloat16), q, k and v on 16-byte boundaries. Returns the
// launch's CUDA error code. Both kernels run a grid of (H, B, q tiles) of
// at least 64 rows, so B and ceil(S / 64) are at most 65535.
extern "C" int swattn_launch(const void* q, const void* k, const void* v,
                             void* o, int B, int S, int H, int KV, int hd,
                             int window, float scale, int dtype,
                             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      B > 65535 || (S + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v)) % 16)
      return (int)cudaErrorMisalignedAddress;
    return launch_hd(q, k, v, o, B, S, H, KV, hd, window, scale, st);
  }
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

// Query rows per block of the float32 kernel (dtype 0), at every head dim,
// so callers can place S on the tiles' edges; -1 for another dtype (the
// bfloat16 kernel's rows depend on the head dim).
extern "C" int swattn_tile_queries(int dtype) { return dtype == 0 ? BQ : -1; }
