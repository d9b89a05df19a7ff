// Banded (sliding-window) causal flash attention, bfloat16, on Hopper's
// tensor cores (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/swattn/kernel.py::swattn
// (_swattn_kernel, pl.pallas_call at :102) for bfloat16; float32 stays on
// the CUDA cores (swattn.cu). What it computes is the reference's: for query
// i of head h, softmax over the keys j of kv head h / (H / KV) with j <= i,
// j < S and (window > 0) i - j < window, of scale * (q_i . k_j), applied to
// v. window == 0 is full causal attention.
//
// What bounds it on an H100: operations. At the LM's shape ([1, 8192,
// 32/8, 80], window 4096) the band holds 25,167,872 (i, j) pairs per head,
// 4 * 80 FLOP each (QK^T and PV): 2.58e11 FLOP, 0.261 ms at 989 TFLOP/s,
// against 105 MB of q, k, v and o (0.031 ms at 3.35 TB/s).
//
// Design:
//  1. Tensor cores. S = Q K^T is wgmma.mma_async m64n64k16 bf16 -> f32,
//     both operands from shared memory; hd 80 is five k-steps of 16 (the
//     head dims 16/64/80/128/256 are 1/4/5/8/16). O += P V is m64n{hd}k16
//     with P in registers: the m64nNk16 accumulator layout is the A-fragment
//     layout, so the softmax's p is packed to bf16 pairs where it lies and
//     never goes through shared memory. V is the B operand in MN-major
//     (transposed) form, as it sits in memory.
//  2. Asynchronous copies. K and V tiles of BK = 64 keys arrive by TMA
//     (cp.async.bulk.tensor.4d) into a ring of 3 stages, each with a
//     full/empty mbarrier pair. One producer warp issues the loads (one
//     thread); BQ / 64 consumer warpgroups own 64 query rows each. An hd 80
//     bf16 row is 160 bytes, no multiple of 64 or 128, so tiles use the
//     32-byte swizzle and are cut into 16-column boxes (32 bytes, the
//     swizzle span), one k-step each. The tensor maps carry the base
//     pointer, so they are encoded per call on the host
//     (cuTensorMapEncodeTiled from cudaGetDriverEntryPoint: no -lcuda) and
//     passed as __grid_constant__. They are 4D, (hd, heads, S, B): a box at
//     positions >= S reads zeros, and GQA is the kv head's coordinate.
//  3. Masks only where needed. A warpgroup masks a tile only on the band's
//     leading edge, on the diagonal and past S; its interior tiles skip the
//     compare. Tiles of the block's band that hold none of a warpgroup's
//     pairs are released unread.
//  4. Balance. The q tiles with the most work launch first (blockIdx.z runs
//     backwards): past the window each carries about W / BK + 3 tiles, the
//     first W / BQ fewer.
//  5. Pipelining. QK^T of tile i is issued beside PV of tile i - 1, and the
//     softmax of tile i runs while that PV does; O is rescaled only when a
//     row maximum of the warp moved.
//  6. L2. At BQ 192 the blocks read 2,165 K/V tiles of 20,480 bytes per
//     head: 1.42 GB of L2 -> shared traffic per launch at the LM's shape
//     (2.08 GB at BQ 128), which the TMA ring overlaps with the tensor
//     work. TMA multicast across a cluster of the q heads that share a kv
//     head would halve it; it is not built (PERF.md keeps the measurements
//     behind that choice).
//  7. Sizes: three consumer warpgroups (BQ 192) hide the softmax better
//     than two; thirteen warps cap a thread at 128 registers, which BK 64
//     fits and BK 96 or 128 do not (they spill; chip_smoke.py prints
//     ptxas's registers and spills). hd 128 uses BQ 128: at BQ 192 ptxas
//     serialises its wgmma for lack of registers.
//  8. hd 256 (gemma3): BQ 64, one consumer warpgroup. O is m64n256k16,
//     128 float accumulators a thread, beside the 32 scores and 16 packed
//     p of the pipelined loop. At BQ 128 the nine warps cap a thread at
//     168 registers (an SM quadrant holds three of them and 64K / 4
//     registers), so it spilled 1,336 bytes and ptxas serialised its
//     wgmma; five warps leave 255 (ptxas uses 221, no spill). Shared
//     memory: a 32 KB Q tile and three stages of 32 KB K and V tiles,
//     224 KB of the 227 KB a block may have. On an H100: 0.301 against
//     0.484 ms at BQ 128 for [2,4096,8/4,256] W 1024 (PERF.md §6).
//
// Rounding, kept from the reference: float32 scores, the scale applied
// after the dot (folded with log2 e into the exponent's FMA); the finite
// NEG_INF = -1e30 under the mask and p zeroed there; l summed from the
// float32 p; p rounded to bf16 before the PV product; float32 accumulation;
// the output O / l (l == 0 -> 1) rounded to bf16.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // kernels/csrc: mbarriers, TMA, the map encoder

namespace {

using bf16 = __nv_bfloat16;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load_4d;

constexpr int BK = 64;             // keys per K/V tile
constexpr int STAGES = 3;          // K/V ring depth
constexpr int BOX = 16;            // columns per TMA box: 32 bytes, the swizzle span
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Geometry {
  // query rows per block
  static constexpr int BQ = HD <= 80 ? 192 : (HD <= 128 ? 128 : 64);
  static constexpr int NCONSUMER = BQ * 2;          // a warpgroup per 64 rows
  static constexpr int NT = NCONSUMER + 32;         // and the producer warp
  static constexpr int KS = HD / BOX;               // boxes = k-steps of QK^T
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;      // one K or one V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static_assert(BAR_OFF + (2 * STAGES + 1) * 8 + 1024 <= 232448,
                "the block's shared memory exceeds the 227 KB opt-in");
  static constexpr int ALLOC = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
};

// wgmma shared-memory matrix descriptor, 32-byte swizzle. K-major tiles
// (Q, K): 8-row groups 256 bytes apart (sbo); MN-major V: 16-column boxes
// lbo apart along hd, 8-row groups 256 bytes apart along the keys.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving register reads and writes across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A B, m64n64k16, A and B from shared memory (K-major); scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64nNk16, A from registers (bf16 pairs), B from shared memory
// (MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// S = Q K^T for one warpgroup's 64 rows: one k-step per 16-column box
template <int HD>
__device__ __forceinline__ void qk(float (&sacc)[BK / 2], uint32_t sq,
                                   uint32_t sk) {
#pragma unroll
  for (int j = 0; j < HD / BOX; ++j)
    wgmma_ss_n64(sacc, sw32_desc(sq + j * Geometry<HD>::BQ * 32, 16, 256),
                 sw32_desc(sk + j * BK * 32, 16, 256), j > 0);
}

// O += P V: P as bf16 A fragments, V's tile MN-major
template <int HD>
__device__ __forceinline__ void pv(float (&oacc)[HD / 2],
                                   const uint32_t (&pa)[BK / 16][4],
                                   uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<HD>(oacc, pa[kk], sw32_desc(sv + kk * 16 * 32, BK * 32, 256));
}

// online softmax over one tile's scores, in place: sacc (q.k) becomes
// p = 2^(s * scale * log2 e - m); mrow (log2 units) and lrow advance;
// alpha rescales what was accumulated before. A thread holds, per n-tile
// j / 4 of 8 keys, the pair (2t, 2t + 1) of rows qr[0] and qr[1].
__device__ __forceinline__ void softmax(float (&sacc)[BK / 2],
                                        float (&mrow)[2], float (&lrow)[2],
                                        float (&alpha)[2], int k0,
                                        const int (&qr)[2], int t, int S,
                                        int window, float scale2,
                                        bool masked) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    if (masked) {
      const int kpos = k0 + 8 * (j / 4) + 2 * t + (j & 1);
      const int qpos = qr[(j / 2) & 1];
      const bool ok = kpos <= qpos && kpos < S &&
                      (window <= 0 || qpos - kpos < window);
      sacc[j] = ok ? sacc[j] : NEG_INF;
    }
    mx[(j / 2) & 1] = fmaxf(mx[(j / 2) & 1], sacc[j]);
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(mrow[r], mx[r] * scale2);
    alpha[r] = ex2(mrow[r] - m_new);
    mrow[r] = m_new;
    lrow[r] *= alpha[r];
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    const float sc = sacc[j];
    float p = ex2(fmaf(sc, scale2, neg_m[(j / 2) & 1]));
    if (masked) p = sc == NEG_INF ? 0.f : p;
    sacc[j] = p;
    lrow[(j / 2) & 1] += p;
  }
}

__device__ __forceinline__ void pack_p(const float (&sacc)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
}

template <int HD>
__global__ void __launch_bounds__(Geometry<HD>::NT, 1)
swattn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ o, int S, int H, int KV, int window,
                    float scale) {
  using G = Geometry<HD>;
  constexpr int BQ = G::BQ;
  constexpr int KS = G::KS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + G::K_OFF;
  const uint32_t sV = base + G::V_OFF;
  const uint32_t full = base + G::BAR_OFF;    // [STAGES]: the tile landed
  const uint32_t empty = full + 8 * STAGES;   // [STAGES]: the tile is consumed
  const uint32_t qbar = empty + 8 * STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tiles first
  const int hk = h / (H / KV);
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - (window - 1)) : 0;
  const int kt0 = k_first / BK, kt1 = q_last / BK;   // the block's band

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, G::NCONSUMER);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= G::NCONSUMER) {  // the producer warp: one thread issues
    if (threadIdx.x == G::NCONSUMER) {
      mbar_expect_tx(qbar, G::Q_BYTES);
      for (int j = 0; j < KS; ++j)
        tma_load_4d(sQ + j * BQ * 32, &tq, qbar, j * BOX, h, q0, b);
      for (int kt = kt0, i = 0; kt <= kt1; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * G::KV_BYTES);
        for (int j = 0; j < KS; ++j) {
          const uint32_t off = s * G::KV_BYTES + j * BK * 32;
          tma_load_4d(sK + off, &tk, full + 8 * s, j * BOX, hk, kt * BK, b);
          tma_load_4d(sV + off, &tv, full + 8 * s, j * BOX, hk, kt * BK, b);
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wi = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wq0 = q0 + 64 * wg;              // this warpgroup's first row
  const int qr[2] = {wq0 + 16 * wi + g, wq0 + 16 * wi + g + 8};
  // this warpgroup's own band [wkt0, wkt1], empty when its rows lie past S
  const int wkt0 = (window > 0 ? max(0, wq0 - (window - 1)) : 0) / BK;
  const int wkt1 = wq0 < S ? min(wq0 + 63, S - 1) / BK : -1;
  const float scale2 = scale * LOG2E;
  const uint32_t sq = sQ + wg * 64 * 32;
  auto tile_masked = [&](int k0) {
    return k0 + BK - 1 > wq0 || (window > 0 && wq0 + 63 - k0 >= window) ||
           k0 + BK > S;
  };

  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  float mrow[2] = {NEG_INF, NEG_INF};        // rows qr[0], qr[1]; log2 units
  float lrow[2] = {0.f, 0.f};                // this thread's part of the sums
  float alpha[2];
  float sacc[BK / 2];
  uint32_t pa[BK / 16][4];

  mbar_wait(qbar, 0);
  int kt = kt0, i = 0;
  for (; kt < wkt0 && kt <= kt1; ++kt, ++i) {  // before this one's band
    mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
    mbar_arrive(empty + 8 * (i % STAGES));
  }
  if (kt <= wkt1) {
    int ps = i % STAGES;                     // the stage of P's V tile
    mbar_wait(full + 8 * ps, (i / STAGES) & 1);
    wg_fence();
    qk<HD>(sacc, sq, sK + ps * G::KV_BYTES);
    wg_commit();
    wg_wait<0>();
    fence_regs(sacc);
    softmax(sacc, mrow, lrow, alpha, kt * BK, qr, t, S, window, scale2,
            tile_masked(kt * BK));
    pack_p(sacc, pa);
    for (++kt, ++i; kt <= wkt1; ++kt, ++i) {
      const int s = i % STAGES;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
      wg_fence();
      qk<HD>(sacc, sq, sK + s * G::KV_BYTES);
      wg_commit();
      pv<HD>(oacc, pa, sV + ps * G::KV_BYTES);
      wg_commit();
      wg_wait<1>();                          // this tile's S
      fence_regs(sacc);
      softmax(sacc, mrow, lrow, alpha, kt * BK, qr, t, S, window, scale2,
              tile_masked(kt * BK));
      wg_wait<0>();                          // the previous tile's PV
      fence_regs(oacc);
      mbar_arrive(empty + 8 * ps);
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) oacc[j] *= alpha[(j / 2) & 1];
      }
      pack_p(sacc, pa);
      ps = s;
    }
    wg_fence();
    pv<HD>(oacc, pa, sV + ps * G::KV_BYTES);
    wg_commit();
    wg_wait<0>();
    fence_regs(oacc);
    mbar_arrive(empty + 8 * ps);
  }
  for (; kt <= kt1; ++kt, ++i) {             // after this one's band
    mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
    mbar_arrive(empty + 8 * (i % STAGES));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }
  const int64_t q_row = (int64_t)H * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qr[r] >= S) continue;
    const float inv = 1.f / (lrow[r] > 0.f ? lrow[r] : 1.f);
    bf16* ob = o + ((int64_t)b * S + qr[r]) * q_row + (int64_t)h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j + 2 * t) =
          __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv,
                                oacc[4 * j + 2 * r + 1] * inv);
  }
}

// [B, S, heads, hd] bf16 as a 4D map (hd, heads, S, B), boxes of 16 columns
// x 1 head x `rows` positions, 32-byte swizzle; positions >= S read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S,
              int B, int rows) {
  hopper::EncodeTiled enc = hopper::encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int window, float scale,
           cudaStream_t stream) {
  using G = Geometry<HD>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, HD, H, S, B, G::BQ) ||
      !make_map(&tk, k, HD, KV, S, B, BK) ||
      !make_map(&tv, v, HD, KV, S, B, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      swattn_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::ALLOC);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + G::BQ - 1) / G::BQ);
  swattn_wgmma_kernel<HD><<<grid, G::NT, G::ALLOC, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), S, H, KV, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The bfloat16 path of swattn_launch (swattn.cu): same arguments. q, k and v
// must start on 16-byte boundaries (TMA).
int swattn_bf16_launch(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KV, int hd, int window,
                       float scale, cudaStream_t st) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorMisalignedAddress;
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 64: return launch<64>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 80: return launch<80>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 128: return launch<128>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 256: return launch<256>(q, k, v, o, B, S, H, KV, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Keys per K/V tile (swattn_tile_keys in swattn.cu).
int swattn_bf16_tile_keys() { return BK; }
