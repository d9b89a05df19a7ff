// filter2d_halo: w x w correlation of M planes with an N-filter bank, the
// border policy resolved on chip, one of the paper's reduction forms, and
// an optional fused requantising epilogue. CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/filter2d/kernel.py::filter2d_halo
// (body _halo_kernel, with the halo engine of kernels/filter2d/halo.py and
// the fused epilogue core/filter2d.py::apply_requant).
//
// What bounds it on an H100: HBM bytes. At w <= 7 the kernel does 2*w*w
// operations per output pixel and moves one input and one output pixel
// through HBM: ~8 B/px for float32 in and out, ~2 B/px for an int8 frame
// with an int8 requantised output, against 3.35 TB/s (a PyTorch copy of the
// same bytes reaches ~2.7-2.9 TB/s; chip_smoke.py times one beside the
// kernel). The float forms are close behind: no FMA contraction (below)
// makes w5 49 FP instructions per pixel, ~17 us of issue on 132 SMs for a
// [4, 1440, 1920] frame against its 26 us of bytes, so loads, reduction and
// stores have to overlap. The int32 MAC of integer frames runs on the 64
// IMAD lanes of an SM, half the float rate.
//
// Design:
//  1. Persistent blocks. The work is the reference grid's order (plane,
//     column tile, row strip; the bank innermost) cut into TILE_W-column x
//     SH-row items. The launch takes as many blocks as fit on the SMs at
//     once (at most one per item); block b takes items b, b + G, b + 2G, ...
//     (G blocks), so the grid sweeps the reference's order a wave at a time
//     and the frame-edge items, which run the mux, spread over all blocks
//     (a contiguous run per block left the blocks on the edge columns with
//     every mux: 49 against 40 us at w5). The bank's coefficients and
//     requant table come into shared memory once per block, while the
//     first windows are already in flight.
//  2. A ring of STAGES windows. One producer warp loads the block's next
//     items' windows while the consumer warps reduce the current one (the
//     counterpart of the reference's overlap=True LD || EX || ST schedule),
//     behind a full/empty mbarrier pair per stage; each consumer warp
//     releases a stage with one arrival. Two loaders, chosen per launch by
//     the wrapper:
//       * TMA (the rule): one elected thread issues one 3D box
//         (cp.async.bulk.tensor) per window from a tensor map over
//         [M, H, W] encoded on the host per call; box origins may be
//         negative or run past the frame, and TMA fills those slots with
//         zeros. TMA needs a 16-byte aligned base and row pitch
//         (W * sizeof(T) % 16 == 0), and a box's first column must sit on
//         a 16-byte boundary too (an H100 faults with an illegal
//         instruction otherwise), so the box starts LEAD columns left of
//         the tile, not r: r * sizeof(T) rounded up to 16 bytes (at least
//         16), so each window row keeps the frame's 16-byte phase in
//         shared memory;
//       * per-thread (every other frame: odd widths, views that start off
//         16 bytes): the 32 producer lanes copy the same box element by
//         element at the storage width, zeros outside the frame.
//     The loader is a runtime-uniform branch of the producer; the mux, the
//     reduction and the epilogue are the same code for both.
//  3. The border mux after the window lands, only on items whose window
//     crosses the frame edge (17% of them at 1440 x 1920): the consumers
//     overwrite the out-of-frame slots that feed real outputs (rows [-r, 0)
//     and [H, H + r), then columns [-r, 0) and [W, W + r)) with exactly the
//     value of the border rule: the constant (rounded to the storage type)
//     or the frame element at map_index(row), map_index(col). A reflection
//     or a clamp of such a slot lands inside the window, so it is read from
//     shared memory; wrap reads the opposite edge from global memory (L2).
//     The consumer warps then sync on a named barrier. Interior items run
//     no mux and no barrier.
//  4. Register blocking. Each consumer thread owns C adjacent output columns
//     (C * sizeof(out) = 16 bytes; 32 for the float32 generic window) and
//     ROWS rows. It reads each window row segment of C + 2r elements once,
//     with the widest aligned shared loads that cover it (at a
//     compile-time phase: the segment starts LEAD - r columns into its
//     words), and slides down: a row's products go
//     straight into the accumulators of the ROWS outputs it feeds, in the
//     reference's tap order, so the direct form costs (ROWS + 2r) / ROWS
//     row-segment loads per output row segment instead of w*w loads per
//     pixel. The separable form folds each row's v-pass into the same
//     accumulators with u. The tree and compress forms keep the last w row
//     segments in registers and reduce each pixel from them. A bank of N
//     filters reuses the window in shared memory.
//     Windows 1, 3, 5 and 7 are instantiated one by one (the serving
//     path). Every larger odd window takes one generic instantiation per
//     dtype and form whose radius is a runtime value (W = 0 below): the
//     same ring, loaders, mux and epilogue. Its float forms are bound by
//     issue (two FP32 instructions a tap, no contraction), so the other
//     instructions must stay few and the shared-memory pipe below its
//     rate. The direct and separable forms sweep the window rows once; a
//     row's taps run in chunks of JC = 16 whose lengths are compile-time
//     cases, so a chunk's C + 15 elements sit in registers at constant
//     indices, read with the widest aligned shared loads and moved to the
//     segment's start (a runtime byte offset, the same for every thread)
//     by word selects; each row feeds the ROWS output rows it belongs to,
//     each with its coefficient row read by 16-byte broadcast loads from
//     a file of 16-byte rows. An 8-bit direct launch whose coefficients
//     all fit a signed byte runs dp4a on packed coefficient words (four
//     taps an instruction), each block choosing from its own copy of the
//     bank; other banks and int16 frames run the int32 MAC in the same
//     loops, and compress runs them with a running sum of each group of
//     6 taps. The tree keeps the reference's pairing through a binary
//     counter of partial sums per pixel, in registers: it sweeps one
//     output row's window rows at a time, in the same chunks, for a group
//     of the thread's columns (too many registers for all of them); how
//     far each push climbs is the same for the whole warp, known at
//     compile time below level 3 and decided by one branch an 8 taps
//     above it.
//  4b. A bank whose coefficients exceed the coefficient file is split by
//     the wrapper into chunks of filters, one launch each, every launch
//     writing its [:, n0:n1] slice of the one output (Params::n_out is
//     the output's bank size).
//  5. Stores straight from registers, one 16-byte streaming store (__stcs:
//     the output is not read again, the input's halo is) per row segment
//     when Wo % C == 0 (every serving bucket: Wo is 1920 or 1440, float32
//     or int8), element stores otherwise and at the ragged edge. The
//     neglect policy runs the same centred windows over the whole frame and
//     stores output (y - r, x - r) of centre (y, x) where it exists, so one
//     window phase serves every policy; its stores are element stores. A
//     TMA store from a staging tile would add a second ring and still need
//     an element path for unaligned widths; a warp's row of vector stores
//     already writes whole 128-byte lines.
//
// Loader rule (kernels/filter2d/kernel.py::loader_for): TMA when the
// frame's first element is 16-byte aligned and W * sizeof(T) % 16 == 0,
// per-thread otherwise. filter2d_halo_launch refuses TMA for anything else
// (cudaErrorMisalignedAddress).
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
//
// The trace build (-DF2D_TRACE, kernels/filter2d/trace.py) compiles the
// same code with one addition: the producer and each consumer warp append
// a record of every ring event (wait, expect, load, mux, read, store,
// arrive) to a device buffer, numbered by a per-block shared counter. The
// producer takes its number after its wait returns and a consumer before
// it arrives, so the numbers order the events as the barriers do.
// repro_torch.analysis decodes the buffer and checks it.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"  // kernels/csrc: mbarriers, TMA, the map encoder

namespace f2d {

using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int TILE_W = 128;      // centre columns per item
constexpr int NCONS = 256;       // consumer threads: 8 warps
constexpr int NT = NCONS + 32;   // and one producer warp
constexpr int STAGES = 3;        // windows in the ring
constexpr int MUX_BAR = 1;       // the consumers' named barrier

enum Policy { NEGLECT = 0, CONSTANT = 1, WRAP = 2, DUPLICATE = 3,
              MIRROR_DUP = 4, MIRROR = 5 };
enum Form { FOLD = 0, TREE = 1, COMPRESS = 2, SEPARABLE = 3 };
enum Rounding { NO_REQUANT = -1, TRUNCATE = 0, NEAREST = 1, NEAREST_EVEN = 2 };

#ifdef F2D_TRACE
// the trace build's log: REC_INTS ints a record, `count` records written
// (atomically; records past `cap` are counted and dropped)
struct Trace {
  int* rec;
  int* count;
  int cap;
  int launch;   // the launch's index within the call (its bank chunk)
  int n0;       // the chunk's first filter
};
#endif

struct Params {
  const void* planes;      // [M, H, W] storage type T, contiguous
  const void* coeffs;      // [N, w, w] or [N, 2, w] (separable), type A
  const int32_t* qparams;  // [N, 2] (multiplier, shift) or nullptr
  void* out;               // [M, n_out, Ho, Wo] type O, contiguous, at the
                           // launch's first filter
  int M, H, W, N, Ho, Wo;
  int w;                   // the window
  int n_out;               // filters in the output (N, or the whole bank)
  int shift;               // output (y, x) is centre (y + shift, x + shift):
                           // r for neglect, 0 for the same-size policies
  int policy;
  double constant;         // constant(c), already exact in the storage type
  int rounding;
  int tma;                 // 1: windows arrive by TMA; 0: per-thread loads
  int blocks;              // > 0: the grid (the trace build's runs); else
                           // as many blocks as fit on the SMs at once
  int tiles, strips;       // column tiles and row strips per plane (host)
  int vec_store;           // 16-byte output stores allowed (host)
#ifdef F2D_TRACE
  Trace trace;
#endif
};

// The tile geometry for storage bytes s, output bytes so and window w; the
// same numbers on the host (filter2d_halo_geometry), in the kernel and in
// the Python twin (kernels/filter2d/halo.py::ring_geometry). A window row
// in shared memory starts LEAD columns left of the tile, r * s rounded up
// to a 16-byte boundary (at least 16 bytes: TMA's box origin rule), and
// covers the tile's C-column thread segments plus r columns either side.
struct Geometry {
  int C;      // output columns per consumer thread: 16 bytes of output
              // (32 for the float32 generic window)
  int ROWS;   // output rows per consumer thread
  int TX;     // consumer threads across a tile
  int SH;     // centre rows per item (strip height)
  int EH;     // window rows: SH + 2r
  int G;      // alignment of a thread's segment in shared memory (bytes)
  int PITCH;  // bytes per window row in shared memory = TMA box row
  int STAGE;  // bytes per ring stage (128-byte aligned)
  int R;      // the window's radius
  int LEAD;   // box columns left of the tile
  int BOX_W;  // TMA box columns: PITCH / s
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ constexpr Geometry geometry(int s, int so, int w) {
  const int r = w / 2;
  // float32 windows past 7 (the generic path) take 8 x 2 outputs a thread:
  // a window row's products come in blocks of 8 independent sums, and a
  // thread sweeps 2 + w - 1 window rows for 16 outputs
  const bool wide = w > 7 && s == 4 && so == 4;
  const int C = wide ? 8 : 16 / so;
  const int ROWS = wide || C == 16 ? 2 : 4;
  const int TX = TILE_W / C;
  const int SH = (NCONS / TX) * ROWS;
  const int lead_bytes = r * s > 16 ? round_up(r * s, 16) : 16;
  const int PITCH = round_up(TILE_W * s + lead_bytes + round_up(r * s, 4),
                             16);
  return Geometry{C, ROWS, TX, SH, SH + 2 * r, C * s < 16 ? C * s : 16,
                  PITCH, round_up((SH + 2 * r) * PITCH, 128), r,
                  lead_bytes / s, PITCH / s};
}

// a TMA box is at most 256 elements a side
__host__ __device__ constexpr bool box_fits(const Geometry& g) {
  return g.BOX_W <= 256 && g.EH <= 256;
}

// the geometry of an instantiated window W, at compile time
template <typename T, typename O, int W>
struct Geo {
  static constexpr Geometry g = geometry(sizeof(T), sizeof(O), W);
  static constexpr int S = sizeof(T);
  static constexpr int R = W / 2;
  static constexpr int C = g.C, ROWS = g.ROWS, TX = g.TX, SH = g.SH;
  static constexpr int EH = g.EH, G = g.G, PITCH = g.PITCH, STAGE = g.STAGE;
  static constexpr int SEG = C + 2 * R;        // a thread's row segment
  static constexpr int LEAD = g.LEAD;          // box columns left of the tile
  static constexpr int BOX_W = g.BOX_W;        // TMA box columns
  static constexpr int D = LEAD - R;           // segment start in its words
  static constexpr int FIRST = D * S / 4;      // words a thread loads
  static constexpr int LAST = ((D + SEG) * S + 3) / 4;
  static_assert(box_fits(g), "a TMA box is <= 256 a side");
  static_assert(LEAD >= R && (TILE_W - C) * S + 4 * LAST <= PITCH, "layout");
  static_assert(NCONS % TX == 0 && (C * S) % G == 0, "layout");
};

// the geometry of the generic window: the radius and what follows from it
// at run time, the thread blocking (the same for every window past 7) at
// compile time
template <typename T, typename O>
struct DynGeo {
  static constexpr Geometry g0 = geometry(sizeof(T), sizeof(O), 9);
  static constexpr int S = sizeof(T);
  static constexpr int C = g0.C, ROWS = g0.ROWS, TX = g0.TX, SH = g0.SH;
  static constexpr int G = g0.G;
  int R, EH, PITCH, STAGE, LEAD, BOX_W;
  __host__ __device__ explicit DynGeo(int w) {
    const Geometry g = geometry(sizeof(T), sizeof(O), w);
    R = g.R; EH = g.EH; PITCH = g.PITCH; STAGE = g.STAGE; LEAD = g.LEAD;
    BOX_W = g.BOX_W;
  }
};

// GeoOf<T, O, W>::make(p): Geo for an instantiated window, DynGeo (from
// p.w) for the generic one (W = 0)
template <typename T, typename O, int W> struct GeoOf {
  using type = Geo<T, O, W>;
  __host__ __device__ static type make(int) { return type{}; }
};
template <typename T, typename O> struct GeoOf<T, O, 0> {
  using type = DynGeo<T, O>;
  __host__ __device__ static type make(int w) { return type(w); }
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

template <typename T> __device__ __forceinline__ T from_double(double c) {
  return (T)c;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_double<__nv_bfloat16>(
    double c) {
  return __float2bfloat16_rn((float)c);
}

// a storage element widened to the accumulator type A
template <typename A, typename T> __device__ __forceinline__ A widen(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(v);   // exact
  else
    return (A)v;
}

// element e of a row held as 32-bit words, widened to A
template <typename T, typename A, int NW>
__device__ __forceinline__ A element(const uint32_t (&w)[NW], int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else if constexpr (sizeof(T) == 2) {
    const uint32_t bits = (w[e >> 1] >> ((e & 1) * 16)) & 0xffffu;
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return __uint_as_float(bits << 16);   // bf16 -> f32 is exact
    else
      return (int32_t)(int16_t)bits;
  } else {
    const uint32_t bits = (w[e >> 2] >> ((e & 3) * 8)) & 0xffu;
    if constexpr (std::is_same<T, int8_t>::value)
      return (int32_t)(int8_t)bits;
    else
      return (int32_t)bits;
  }
}

// words [K, LAST) of a thread's row from shared memory at p (G-aligned),
// each with the widest load its alignment allows
template <int K, int LAST, int G, int NW>
__device__ __forceinline__ void load_words(const unsigned char* p,
                                           uint32_t (&w)[NW]) {
  if constexpr (K < LAST) {
    if constexpr (G == 16 && K % 4 == 0 && K + 4 <= LAST) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 4 * K);
      w[K] = v.x; w[K + 1] = v.y; w[K + 2] = v.z; w[K + 3] = v.w;
      load_words<K + 4, LAST, G>(p, w);
    } else if constexpr (G >= 8 && K % 2 == 0 && K + 2 <= LAST) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + 4 * K);
      w[K] = v.x; w[K + 1] = v.y;
      load_words<K + 2, LAST, G>(p, w);
    } else {
      w[K] = *reinterpret_cast<const uint32_t*>(p + 4 * K);
      load_words<K + 1, LAST, G>(p, w);
    }
  }
}

// a thread's row segment: SEG elements starting D elements past p
template <typename T, typename A, typename GEO>
__device__ __forceinline__ void load_segment(const unsigned char* p,
                                             A (&x)[GEO::SEG]) {
  uint32_t w[GEO::LAST];
  load_words<GEO::FIRST, GEO::LAST, GEO::G>(p, w);
#pragma unroll
  for (int e = 0; e < GEO::SEG; ++e) x[e] = element<T, A>(w, GEO::D + e);
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

// one output pixel of the tree or compress form from the w row segments
// rows[oy .. oy + w - 1], column c
template <typename A, int W, int FORM, int NR, int SEG>
__device__ __forceinline__ A reduce_pixel(A (&rows)[NR][SEG], int oy, int c,
                                          const A* k) {
  constexpr int NT = W * W;
  if constexpr (FORM == TREE) {
    A p[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) p[t] = mul(rows[oy + t / W][c + t % W], k[t]);
    return Tree<A, NT>::run(p);
  } else {  // COMPRESS: groups of 6, then a chain over the partial sums
    A acc = A(0);
#pragma unroll
    for (int g = 0; g < NT; g += 6) {
      A s = mul(rows[oy + g / W][c + g % W], k[g]);
#pragma unroll
      for (int t = g + 1; t < g + 6 && t < NT; ++t)
        s = add(s, mul(rows[oy + t / W][c + t % W], k[t]));
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

// the output word of one pixel, as the bits of a packed vector store
template <typename O, typename A>
__device__ __forceinline__ uint32_t finish_bits(A acc, int rounding, int32_t m,
                                                int32_t sh) {
  if constexpr (std::is_same<O, float>::value) {
    return __float_as_uint(acc);
  } else if constexpr (std::is_same<O, __nv_bfloat16>::value) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(acc));
  } else if constexpr (std::is_same<O, int32_t>::value) {
    return (uint32_t)acc;
  } else {
    const int32_t q = requant(acc, m, sh, rounding);
    const int32_t c = min(max(q, Limits<O>::lo), Limits<O>::hi);
    return (uint32_t)c & ((1u << (8 * sizeof(O))) - 1u);
  }
}

template <typename O>
__device__ __forceinline__ O from_bits(uint32_t b) {
  if constexpr (std::is_same<O, float>::value) return __uint_as_float(b);
  else if constexpr (std::is_same<O, __nv_bfloat16>::value)
    return __ushort_as_bfloat16((unsigned short)b);
  else return (O)b;
}

// one output row segment of a thread: C pixels at dst, those in [lo, hi)
// inside the output; 16-byte stores where the whole segment is inside and
// the row allows it (and C pixels make whole 16-byte stores)
template <typename O, typename A, int C>
__device__ __forceinline__ void emit(O* dst, const A (&acc)[C], int lo,
                                     int hi, bool vec, int rounding, int32_t m,
                                     int32_t sh) {
  uint32_t bits[C];
#pragma unroll
  for (int c = 0; c < C; ++c) bits[c] = finish_bits<O>(acc[c], rounding, m, sh);
  constexpr int PER = 4 / (int)sizeof(O);     // pixels per 32-bit word
  constexpr int NW = C / PER;                 // words: 4 per 16-byte store
  if constexpr (C % PER == 0 && NW % 4 == 0) {
    if (vec && lo == 0 && hi >= C) {
      uint32_t w[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        w[k] = 0;
#pragma unroll
        for (int e = 0; e < PER; ++e)
          w[k] |= bits[k * PER + e] << (8 * (int)sizeof(O) * e);
      }
      // streaming: the output is not read again, the input's halo is
#pragma unroll
      for (int v = 0; v < NW; v += 4)
        __stcs(reinterpret_cast<uint4*>(dst) + v / 4,
               make_uint4(w[v], w[v + 1], w[v + 2], w[v + 3]));
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c >= lo && c < hi) dst[c] = from_bits<O>(bits[c]);
}

// ---------------------------------------------------------------------------
// the consumers' work on one item: every filter of the bank over the
// thread's ROWS x C centres, from its window rows at `win`; output (y, x)
// of centre (cy, cx) is (cy - shift, cx - shift)
// ---------------------------------------------------------------------------
template <typename T, typename A, typename O, int W, int FORM>
__device__ __forceinline__ void reduce_item(const unsigned char* win,
                                            const A* cs, const int32_t* qs,
                                            const Params& p, int m, int cy0,
                                            int cx0) {
  using GEO = Geo<T, O, W>;
  constexpr int R = GEO::R, C = GEO::C, ROWS = GEO::ROWS, SEG = GEO::SEG;
  constexpr int PITCH = GEO::PITCH;
  constexpr int NTAPS = FORM == SEPARABLE ? 2 * W : W * W;
  const int ox0 = cx0 - p.shift, oy0 = cy0 - p.shift;
  const int lo = max(0, -ox0), hi = min(C, p.Wo - ox0);
  const bool vec = p.vec_store != 0;
  for (int f = 0; f < p.N; ++f) {
    const int32_t qm = qs != nullptr ? qs[2 * f] : 1;
    const int32_t qsh = qs != nullptr ? qs[2 * f + 1] : 0;
    O* out = static_cast<O*>(p.out) +
             ((size_t)m * p.n_out + f) * p.Ho * p.Wo + ox0;
    const A* kf = cs + f * NTAPS;
    A k[NTAPS];
#pragma unroll
    for (int t = 0; t < NTAPS; ++t) k[t] = kf[t];
    auto store = [&](int row, const A (&a)[C]) {
      const int gy = oy0 + row;
      if (gy >= 0 && gy < p.Ho)
        emit<O, A, C>(out + (ptrdiff_t)gy * p.Wo, a, lo, hi, vec, p.rounding,
                      qm, qsh);
    };
    if constexpr (FORM == FOLD || FORM == SEPARABLE) {
      // window row y feeds output rows y - i, i < w, as their tap row i:
      // each pixel's sum runs in raster tap order
      A acc[ROWS][C];
#pragma unroll
      for (int y = 0; y < ROWS + 2 * R; ++y) {
        A x[SEG];
        load_segment<T, A, GEO>(win + y * PITCH, x);
        if constexpr (FORM == FOLD) {
#pragma unroll
          for (int i = 0; i < W; ++i) {
            const int oy = y - i;
            if (oy < 0 || oy >= ROWS) continue;
#pragma unroll
            for (int j = 0; j < W; ++j)
#pragma unroll
              for (int c = 0; c < C; ++c) {
                const A prod = mul(x[c + j], k[i * W + j]);
                acc[oy][c] = (i == 0 && j == 0) ? prod : add(acc[oy][c], prod);
              }
          }
        } else {  // SEPARABLE: the row's v-pass, then its u term
          A h[C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            h[c] = mul(x[c], k[W]);
#pragma unroll
            for (int j = 1; j < W; ++j) h[c] = add(h[c], mul(x[c + j], k[W + j]));
          }
#pragma unroll
          for (int i = 0; i < W; ++i) {
            const int oy = y - i;
            if (oy < 0 || oy >= ROWS) continue;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const A prod = mul(h[c], k[i]);
              acc[oy][c] = i == 0 ? prod : add(acc[oy][c], prod);
            }
          }
        }
        if (y >= 2 * R) store(y - 2 * R, acc[y - 2 * R]);
      }
    } else {  // TREE, COMPRESS: the last w row segments stay in registers
      A rows[ROWS + 2 * R][SEG];
#pragma unroll
      for (int y = 0; y < ROWS + 2 * R; ++y) {
        load_segment<T, A, GEO>(win + y * PITCH, rows[y]);
        if (y >= 2 * R) {
          A res[C];
#pragma unroll
          for (int c = 0; c < C; ++c)
            res[c] = reduce_pixel<A, W, FORM>(rows, y - 2 * R, c, k);
          store(y - 2 * R, res);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the generic window (W = 0): the radius at run time
// ---------------------------------------------------------------------------

// The coefficient file in shared memory. Fixed windows keep the bank as it
// is in global memory. The generic path pads each filter row to KP =
// round_up(w, 4) words, so a chunk of a row is a few 16-byte broadcast
// loads; an 8-bit direct launch whose coefficients all fit a signed byte
// holds them packed instead, four taps a word, rows of round_up(w, 16)
// bytes padded with zero taps (stage_generic_coeffs). coeff_words is the
// file's words per filter (halo.py::ring_coeff_words is its twin).
__host__ __device__ constexpr int coeff_pitch(int w) { return round_up(w, 4); }
__host__ __device__ constexpr int packed_pitch(int w) {   // words a row
  return round_up(w, 16) / 4;
}
__host__ __device__ constexpr int coeff_words(int w, bool separable) {
  return w <= 7 ? (separable ? 2 * w : w * w)
                : (separable ? 2 : w) * coeff_pitch(w);
}

// the start of a sum that leaves its first term unchanged bit for bit
template <typename A> __device__ __forceinline__ A sum_identity() {
  if constexpr (std::is_integral<A>::value) return A(0);
  else return -0.0f;
}

// A window row's taps run in chunks of JC: every chunk but the last has JC
// taps, the last (w is odd) an odd count, and each length is a case of its
// own (by_taps), so every register index inside a chunk is a constant.
constexpr int JC = 16;

template <int N> using Taps = std::integral_constant<int, N>;

// f(Taps<nt>{}) for nt in {JC, JC - 1, JC - 3, ..., 1}
template <int N, typename F>
__device__ __forceinline__ void by_taps(int nt, F&& f) {
  if (nt == N) {
    f(Taps<N>{});
  } else if constexpr (N > 1) {
    by_taps<(N == JC ? JC - 1 : N - 2)>(nt, f);
  }
}

// NWORD 32-bit words of a row from byte b past the G-aligned p (0 <= b <
// G, the same for every thread): the widest aligned loads, then the start
// moved by b: word selects, and a funnel shift for 1- and 2-byte storage
template <int S, int G, int NWORD>
__device__ __forceinline__ void load_realigned(const unsigned char* p, int b,
                                               uint32_t (&out)[NWORD]) {
  constexpr int Q = G / 4;                  // words per aligned load
  constexpr int NL = round_up(NWORD + Q, Q);
  uint32_t a[NL];
  load_words<0, NL, G>(p, a);
  const int q = b >> 2;
  uint32_t u[NWORD + 1];
  if constexpr (Q == 1) {
#pragma unroll
    for (int m = 0; m <= NWORD; ++m) u[m] = a[m];
  } else if constexpr (Q == 2) {
#pragma unroll
    for (int m = 0; m <= NWORD; ++m) u[m] = q ? a[m + 1] : a[m];
  } else {
    uint32_t t[NWORD + 3];
#pragma unroll
    for (int m = 0; m < NWORD + 3; ++m) t[m] = (q & 1) ? a[m + 1] : a[m];
#pragma unroll
    for (int m = 0; m <= NWORD; ++m) u[m] = (q & 2) ? t[m + 2] : t[m];
  }
  if constexpr (S == 4) {
#pragma unroll
    for (int k = 0; k < NWORD; ++k) out[k] = u[k];
  } else {
    const int sh = (b & 3) * 8;
#pragma unroll
    for (int k = 0; k < NWORD; ++k)
      out[k] = __funnelshift_r(u[k], u[k + 1], sh);
  }
}

template <typename V> __device__ __forceinline__ V from_word(uint32_t w) {
  if constexpr (std::is_same<V, float>::value) return __uint_as_float(w);
  else return (V)w;
}

// N (a multiple of 4) 32-bit values from a 16-byte aligned shared row that
// every thread of the warp reads (a broadcast)
template <typename V, int N>
__device__ __forceinline__ void load_row4(const V* src, V (&dst)[N]) {
  static_assert(N % 4 == 0 && sizeof(V) == 4, "16-byte loads");
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + k);
    dst[k] = from_word<V>(v.x);
    dst[k + 1] = from_word<V>(v.y);
    dst[k + 2] = from_word<V>(v.z);
    dst[k + 3] = from_word<V>(v.w);
  }
}

// The direct form's chunk of NTP taps (from tap j0 of each row) at window
// row y: the thread's C + NTP - 1 elements from byte b past `row`, in
// registers; then for each output row oy the row feeds as its tap row i =
// y - oy, row i's NTP coefficients (broadcast loads from kf + i * kp) and
// the C x NTP products into acc[oy], in raster tap order. GROUPS (the
// compress form) sums each run of 6 taps t = i * w + j (raster order,
// counted from 0) into grp[oy] first, adding each closed group to acc[oy]:
// a group opens on -0.0, which leaves its first product unchanged
template <typename T, typename A, int C, int ROWS, int G, int NTP,
          bool GROUPS>
__device__ __forceinline__ void fold_chunk(const unsigned char* row, int b,
                                           const A* kf, int kp, int y, int w,
                                           int j0, A (&acc)[ROWS][C],
                                           A (&grp)[ROWS][C]) {
  constexpr int S = sizeof(T), NE = C + NTP - 1;
  uint32_t words[(NE * S + 3) / 4];
  load_realigned<S, G>(row, b, words);
  A x[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) x[e] = element<T, A>(words, e);
#pragma unroll
  for (int oy = 0; oy < ROWS; ++oy) {
    const int i = y - oy;
    if (i < 0 || i >= w) continue;
    A k[round_up(NTP, 4)];
    load_row4(kf + i * kp, k);
    if constexpr (GROUPS) {
      int q = (i * w + j0) % 6;             // tap j's place in its group
#pragma unroll
      for (int j = 0; j < NTP; ++j) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          grp[oy][c] = add(q == 0 ? sum_identity<A>() : grp[oy][c],
                           mul(x[c + j], k[j]));
          if (q == 5) acc[oy][c] = add(acc[oy][c], grp[oy][c]);
        }
        q = q == 5 ? 0 : q + 1;
      }
    } else {
#pragma unroll
      for (int j = 0; j < NTP; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[oy][c] = add(acc[oy][c], mul(x[c + j], k[j]));
    }
  }
}

// the separable form's v-pass over a chunk: h[c] += x[c + j] * v[j]
template <typename T, typename A, int C, int G, int NTP>
__device__ __forceinline__ void vpass_chunk(const unsigned char* row, int b,
                                            const A* v, A (&h)[C]) {
  constexpr int S = sizeof(T), NE = C + NTP - 1;
  uint32_t words[(NE * S + 3) / 4];
  load_realigned<S, G>(row, b, words);
  A x[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) x[e] = element<T, A>(words, e);
  A k[round_up(NTP, 4)];
  load_row4(v, k);
#pragma unroll
  for (int j = 0; j < NTP; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) h[c] = add(h[c], mul(x[c + j], k[j]));
}

// dp4a: four byte products summed into the int32 accumulator in one
// instruction, exact mod 2^32 like the MAC (8-bit pixels, signed bytes)
template <typename T>
__device__ __forceinline__ int32_t dot4(uint32_t px, uint32_t k, int32_t acc) {
  int32_t d;
  if constexpr (std::is_same<T, int8_t>::value)
    asm("dp4a.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(px), "r"(k), "r"(acc));
  else
    asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(px), "r"(k), "r"(acc));
  return d;
}

// fold_chunk on packed coefficients (8-bit storage): output c's taps 4q ..
// 4q + 3 of the chunk read pixel bytes c + 4q .. c + 4q + 3, the word of
// byte phase c % 4 (a funnel shift of the row's words) at c / 4 + q; the
// zero taps past w add nothing
template <typename T, int C, int ROWS, int G, int NTP>
__device__ __forceinline__ void dp4a_chunk(const unsigned char* row, int b,
                                           const uint32_t* kf, int kq, int y,
                                           int w, int32_t (&acc)[ROWS][C]) {
  constexpr int NQ = (NTP + 3) / 4;        // coefficient words
  constexpr int NB = C / 4 + NQ;           // pixel words the products read
  static_assert(C % 4 == 0, "whole words of outputs");
  uint32_t px[NB];
  load_realigned<1, G>(row, b, px);
  uint32_t ph[4][NB - 1];                  // ph[p][k]: bytes 4k + p ..
#pragma unroll
  for (int k = 0; k < NB - 1; ++k) {
    ph[0][k] = px[k];
#pragma unroll
    for (int s = 1; s < 4; ++s)
      ph[s][k] = __funnelshift_r(px[k], px[k + 1], 8 * s);
  }
#pragma unroll
  for (int oy = 0; oy < ROWS; ++oy) {
    const int i = y - oy;
    if (i < 0 || i >= w) continue;
    uint32_t kw[round_up(NQ, 4)];
    load_row4(kf + i * kq, kw);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[oy][c] = dot4<T>(ph[c % 4][c / 4 + q], kw[q], acc[oy][c]);
  }
}

// The generic tree as a binary counter: the products enter in tap order,
// and pushing product t adds it to the complete blocks that bit by bit end
// at t (each level's left block first). A node of level L then covers
// taps [k 2^L, (k + 1) 2^L), which is the pairwise, level-by-level tree
// with the odd tail carried (core/filter2d.py:_tree); the blocks left at
// the end, one per set bit of w*w, fold from the right. Each pixel keeps
// its counter in registers, a level a row, so every index must be a
// constant. How far a push climbs is the count of trailing ones of t, the
// same for every pixel of the warp:
//  * below TREE_PB it follows from t's low bits, which a chunk knows at
//    compile time once its first tap's phase (t0 mod 2^TREE_PB) is a case
//    of its own (by_phase), so those sums need no branch;
//  * from TREE_PB to TREE_LOW - 1 one uniform branch a 2^TREE_PB taps
//    decides, for a thread's whole group of columns;
//  * a push past TREE_LOW - 1 (t ends in TREE_LOW ones: one tap in any 16)
//    leaves its sum as the chunk's carry, which climbs the higher levels
//    after the chunk's taps.
// The level count LV is a case of w*w's range, each a kernel of its own
// (tree_levels; halo.py::tree_levels is its twin): the smallest of 8, 10,
// 12 and 13 bits that holds w*w, so TREE_LEVELS bits take w <= 89 (every
// window the float datapaths' shared memory allows: 61 for float32, 87
// for bf16). One kernel holding every case spilled kilobytes.
constexpr int TREE_PB = 3;
constexpr int TREE_LOW = 4;
constexpr int TREE_LEVELS = 13;
static_assert(JC <= (1 << TREE_LOW) && TREE_PB <= TREE_LOW,
              "at most one carry a chunk");

__host__ __device__ constexpr int tree_levels(int w) {
  return w * w < (1 << 8) ? 8
         : w * w < (1 << 10) ? 10
         : w * w < (1 << 12) ? 12
         : w * w < (1 << TREE_LEVELS) ? TREE_LEVELS : 0;
}

// the columns of a thread that share a sweep of the window: their
// counters, a chunk's elements and its coefficients stay under the 96
// registers of two blocks an SM
template <int LV> __host__ __device__ constexpr int tree_cols() {
  return LV <= 8 ? 4 : 2;
}

template <int N> using Phase = std::integral_constant<int, N>;

// f(Phase<ph>{}) for ph in [0, 2^TREE_PB)
template <int PH, typename F>
__device__ __forceinline__ void by_phase(int ph, F&& f) {
  if (ph == PH) {
    f(Phase<PH>{});
  } else if constexpr (PH + 1 < (1 << TREE_PB)) {
    by_phase<PH + 1>(ph, f);
  }
}

// The tree form's chunk of NTP taps t0 .. t0 + NTP - 1 (one window row's,
// from its tap j0; t0 = PH mod 2^TREE_PB) for a group of TG columns: the
// TG + NTP - 1 elements from byte b past `row` and the NTP coefficients at
// kr, then each tap's TG products pushed into the counters
// st[level][column]
template <typename T, typename A, int TG, int G, int NTP, int LV, int PH>
__device__ __forceinline__ void tree_chunk(const unsigned char* row, int b,
                                           const A* kr, int t0,
                                           A (&st)[LV][TG]) {
  constexpr int S = sizeof(T), NE = TG + NTP - 1;
  constexpr int PM = (1 << TREE_PB) - 1;
  uint32_t words[(NE * S + 3) / 4];
  load_realigned<S, G>(row, b, words);
  A x[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) x[e] = element<T, A>(words, e);
  // the coefficients by 16-byte broadcast loads into registers, or by a
  // broadcast load a tap where ptxas would spill them beside the counters
  // (float32's 8- and 10-level kernels: 16-88 B; bf16's 8-level kernel
  // spills 52 B the other way)
  constexpr bool KTAP = S == 4 && LV <= 10;
  A k[round_up(NTP, 4)];
  if constexpr (!KTAP) load_row4(kr, k);
  A cv[TG];
#pragma unroll
  for (int j = 0; j < NTP; ++j) {
    A kj;
    if constexpr (KTAP) kj = kr[j];
    else kj = k[j];
    A v[TG];
#pragma unroll
    for (int c = 0; c < TG; ++c) v[c] = mul(x[c + j], kj);
    // below TREE_PB: t's low bits, a constant once the loop unrolls
    const int tl = (PH + j) & PM;
    bool up = true;
#pragma unroll
    for (int L = 0; L < TREE_PB; ++L) {
      if (up && ((tl >> L) & 1)) {
#pragma unroll
        for (int c = 0; c < TG; ++c) v[c] = add(st[L][c], v[c]);
      } else if (up) {
#pragma unroll
        for (int c = 0; c < TG; ++c) st[L][c] = v[c];
        up = false;
      }
    }
    if (up) {   // t ends in TREE_PB ones: the next levels by t itself
      const int top = TREE_PB + __ffs(~((t0 + j) >> TREE_PB)) - 1;
#pragma unroll
      for (int L = TREE_PB; L < TREE_LOW; ++L) {
        if (L < top) {
#pragma unroll
          for (int c = 0; c < TG; ++c) v[c] = add(st[L][c], v[c]);
        } else if (L == top) {
#pragma unroll
          for (int c = 0; c < TG; ++c) st[L][c] = v[c];
        }
      }
      if (top >= TREE_LOW) {
#pragma unroll
        for (int c = 0; c < TG; ++c) cv[c] = v[c];
      }
    }
  }
  // the carry, from the chunk's tap that ends in TREE_LOW ones, if any
  constexpr int M = (1 << TREE_LOW) - 1;
  const int tc = t0 + ((M - t0) & M);
  if (tc < t0 + NTP) {
    // levels TREE_LOW .. LV - 1, unrolled (no early exit: a loop that
    // breaks may not unroll, and the counters would leave the registers)
    const int top = TREE_LOW + __ffs(~(tc >> TREE_LOW)) - 1;
#pragma unroll
    for (int L = TREE_LOW; L < LV; ++L) {
      if (L < top) {
#pragma unroll
        for (int c = 0; c < TG; ++c) cv[c] = add(st[L][c], cv[c]);
      } else if (L == top) {
#pragma unroll
        for (int c = 0; c < TG; ++c) st[L][c] = cv[c];
      }
    }
  }
}

// the sum of the blocks a counter holds after n pushes (one per set bit
// of n), from the right: the deepest level holds the leftmost block
template <typename A, int LV, int TG>
__device__ __forceinline__ void tree_fold(const A (&st)[LV][TG], int n,
                                          A (&out)[TG]) {
  bool have = false;
#pragma unroll
  for (int L = 0; L < LV; ++L)
    if ((n >> L) & 1) {
#pragma unroll
      for (int c = 0; c < TG; ++c)
        out[c] = have ? add(st[L][c], out[c]) : st[L][c];
      have = true;
    }
}

// reduce_item for the generic window: the same outputs, sums and stores.
// Direct, compress and separable sweep the window rows y once: each row's
// taps in chunks (fold_chunk, vpass_chunk, or dp4a_chunk where the block
// holds packed coefficients), each chunk's elements loaded once and used
// by every output row the row feeds. The tree sweeps each output row's w
// window rows in the same chunks (tree_chunk), once for each group of its
// columns, whose counters stay in registers.
template <typename T, typename A, typename O, int FORM, int LV>
__device__ __forceinline__ void reduce_item_generic(
    const unsigned char* win, const A* cs, const int32_t* qs, const Params& p,
    const DynGeo<T, O>& g, bool packed, int m, int cy0, int cx0) {
  using GEO = DynGeo<T, O>;
  constexpr int C = GEO::C, ROWS = GEO::ROWS, S = GEO::S, G = GEO::G;
  constexpr bool PACK = std::is_integral<A>::value && S == 1 && FORM == FOLD;
  const int W = p.w, R = g.R, PITCH = g.PITCH, KP = coeff_pitch(W);
  const int words = coeff_words(W, FORM == SEPARABLE);
  // the thread's segment (from byte (LEAD - R) * S of its window rows) as
  // G-aligned loads from `base`, moved by b bytes (win is G-aligned: the
  // thread's C columns are C * S bytes)
  const int b = ((g.LEAD - R) * S) & (G - 1);
  const unsigned char* base = win + (g.LEAD - R) * S - b;
  const int ox0 = cx0 - p.shift, oy0 = cy0 - p.shift;
  const int lo = max(0, -ox0), hi = min(C, p.Wo - ox0);
  const bool vec = p.vec_store != 0;
  for (int f = 0; f < p.N; ++f) {
    const int32_t qm = qs != nullptr ? qs[2 * f] : 1;
    const int32_t qsh = qs != nullptr ? qs[2 * f + 1] : 0;
    O* out = static_cast<O*>(p.out) +
             ((size_t)m * p.n_out + f) * p.Ho * p.Wo + ox0;
    const A* k = cs + f * words;
    auto store = [&](int row, const A (&a)[C]) {
      const int gy = oy0 + row;
      if (gy >= 0 && gy < p.Ho)
        emit<O, A, C>(out + (ptrdiff_t)gy * p.Wo, a, lo, hi, vec, p.rounding,
                      qm, qsh);
    };
    if constexpr (FORM != TREE) {
      // window row y feeds output rows y - i, i < w, as their tap row i;
      // output row oy is complete after row oy + w - 1 (compress then
      // adds its last, partial, group: w * w is odd). Every sum starts
      // from the additive identity that changes no first term (-0.0 for
      // float: -0.0 + p == p bit for bit, a +0.0 p too)
      auto sweep = [&](auto per_row) {
        A acc[ROWS][C], grp[ROWS][C];
#pragma unroll
        for (int oy = 0; oy < ROWS; ++oy)
#pragma unroll
          for (int c = 0; c < C; ++c) acc[oy][c] = grp[oy][c] = sum_identity<A>();
        for (int y = 0; y < ROWS + W - 1; ++y) {
          per_row(base + y * PITCH, y, acc, grp);
#pragma unroll
          for (int oy = 0; oy < ROWS; ++oy)
            if (y - oy == W - 1) {
              if constexpr (FORM == COMPRESS) {
#pragma unroll
                for (int c = 0; c < C; ++c)
                  acc[oy][c] = add(acc[oy][c], grp[oy][c]);
              }
              store(oy, acc[oy]);
            }
        }
      };
      if constexpr (FORM == FOLD || FORM == COMPRESS) {
        bool done = false;
        if constexpr (PACK) {
          if (packed) {
            const uint32_t* kq = reinterpret_cast<const uint32_t*>(cs) +
                                 f * W * packed_pitch(W);
            sweep([&](const unsigned char* row, int y, auto& acc, auto&) {
              for (int j0 = 0; j0 < W; j0 += JC)
                by_taps<JC>(min(JC, W - j0), [&](auto t) {
                  dp4a_chunk<T, C, ROWS, G, decltype(t)::value>(
                      row + j0, b, kq + j0 / 4, packed_pitch(W), y, W, acc);
                });
            });
            done = true;
          }
        }
        if (!done)
          sweep([&](const unsigned char* row, int y, auto& acc, auto& grp) {
            for (int j0 = 0; j0 < W; j0 += JC)
              by_taps<JC>(min(JC, W - j0), [&](auto t) {
                fold_chunk<T, A, C, ROWS, G, decltype(t)::value,
                           FORM == COMPRESS>(row + j0 * S, b, k + j0, KP, y,
                                             W, j0, acc, grp);
              });
          });
      } else {   // SEPARABLE: the row's v-pass (row 1), then its u term
        sweep([&](const unsigned char* row, int y, auto& acc, auto&) {
          A h[C];
#pragma unroll
          for (int c = 0; c < C; ++c) h[c] = sum_identity<A>();
          for (int j0 = 0; j0 < W; j0 += JC)
            by_taps<JC>(min(JC, W - j0), [&](auto t) {
              vpass_chunk<T, A, C, G, decltype(t)::value>(row + j0 * S, b,
                                                           k + KP + j0, h);
            });
#pragma unroll
          for (int oy = 0; oy < ROWS; ++oy) {
            const int i = y - oy;
            if (i < 0 || i >= W) continue;
            const A u = k[i];
#pragma unroll
            for (int c = 0; c < C; ++c) acc[oy][c] = add(acc[oy][c], mul(h[c], u));
          }
        });
      }
    } else {  // TREE: an output row at a time, a group of columns at a time
      constexpr int TG = tree_cols<LV>();
#pragma unroll 1
      for (int oy = 0; oy < ROWS; ++oy) {
        const int gy = oy0 + oy;
#pragma unroll 1
        for (int grp = 0; grp < C / TG; ++grp) {
          A st[LV][TG];
          // the window rows oy .. oy + w - 1 in tap order, each in chunks
          // from the group's first column
          for (int i = 0; i < W; ++i) {
            const unsigned char* row = base + (oy + i) * PITCH;
            for (int j0 = 0; j0 < W; j0 += JC) {
              const int o = b + (grp * TG + j0) * S, t0 = i * W + j0;
              by_taps<JC>(min(JC, W - j0), [&](auto nt) {
                by_phase<0>(t0 & ((1 << TREE_PB) - 1), [&](auto ph) {
                  tree_chunk<T, A, TG, G, decltype(nt)::value, LV,
                             decltype(ph)::value>(
                      row + (o & ~(G - 1)), o & (G - 1), k + i * KP + j0, t0,
                      st);
                });
              });
            }
          }
          A sum[TG];
          tree_fold(st, W * W, sum);
          // the group's pixels straight out: no register holds the row's
          // other groups meanwhile
          const int c0 = grp * TG;
          if (gy >= 0 && gy < p.Ho)
            emit<O, A, TG>(out + (ptrdiff_t)gy * p.Wo + c0, sum, lo - c0,
                           hi - c0, vec, p.rounding, qm, qsh);
        }
      }
    }
  }
}

// The out-of-frame window slots that feed real outputs, set by the border
// rule: rows [-r, 0) and [H, H + r) across the window, then columns [-r, 0)
// and [W, W + r) down it (numpy.pad's rows-then-columns composition: a
// corner slot reads frame[map(row), map(col)]). The stage holds frame rows
// from ywin0 and frame columns from bx0, the window's from bx0 + LEAD - r.
// Reflections and clamps land inside the window, whose in-frame slots the
// mux never writes, so they are read from shared memory; wrap reads the
// opposite edge from global memory (L2). Returns the slots this thread
// wrote.
template <typename T, typename GEO>
__device__ __forceinline__ int mux(unsigned char* stage, const T* src,
                                   const Params& p, const GEO& g, int ywin0,
                                   int bx0, int tid) {
  const int R = g.R, EH = g.EH, EW = TILE_W + 2 * R;
  const int PITCH = g.PITCH, LEAD = g.LEAD;
  const int xwin0 = bx0 + LEAD - R;
  auto span = [](int lo, int hi, int n) {   // [lo, hi) clipped to [0, n)
    return make_int2(min(max(lo, 0), n), min(max(hi, 0), n));
  };
  // the slots that feed real outputs: frame rows [-r, H + r) and columns
  // [-r, W + r); the reflection of any other slot may leave the window
  const int2 rows = span(-R - ywin0, p.H + R - ywin0, EH);
  const int2 cols = span(-R - xwin0, p.W + R - xwin0, EW);
  const int2 top = span(-R - ywin0, -ywin0, EH);
  const int2 bot = span(p.H - ywin0, p.H + R - ywin0, EH);
  const int2 lft = span(-R - xwin0, -xwin0, EW);
  const int2 rgt = span(p.W - xwin0, p.W + R - xwin0, EW);
  const int nt = top.y - top.x, nl = lft.y - lft.x;
  const int nr = nt + (bot.y - bot.x), nc = nl + (rgt.y - rgt.x);
  const int nw = cols.y - cols.x, nh = rows.y - rows.x;
  const int total = nr * nw + nh * nc;
  const T cval = from_double<T>(p.constant);
  int written = 0;
  for (int idx = tid; idx < total; idx += NCONS) {
    int ey, ex;
    if (idx < nr * nw) {        // out-of-frame rows, across
      const int k = idx / nw;
      ey = k < nt ? top.x + k : bot.x + (k - nt);
      ex = cols.x + (idx - k * nw);
    } else {                    // out-of-frame columns, down
      const int j = idx - nr * nw;
      const int k = j / nh;
      ey = rows.x + (j - k * nh);
      ex = k < nl ? lft.x + k : rgt.x + (k - nl);
    }
    T v = cval;
    if (p.policy != CONSTANT) {
      const int sy = map_index(ywin0 + ey, p.H, p.policy);
      const int sx = map_index(xwin0 + ex, p.W, p.policy);
      if (p.policy == WRAP)   // the opposite edge: from L2
        v = src[(size_t)sy * p.W + sx];
      else                    // a reflection or a clamp: inside the window
        v = reinterpret_cast<const T*>(stage + (sy - ywin0) * PITCH)
            [sx - bx0];
    }
    reinterpret_cast<T*>(stage + ey * PITCH)[ex + LEAD - R] = v;
    ++written;
  }
  return written;
}

// the per-thread loader: the producer warp copies the box TMA would copy,
// at the storage width, zeros outside the frame
template <typename T, typename GEO>
__device__ __forceinline__ void fill(unsigned char* stage, const T* src,
                                     const Params& p, const GEO& g, int ywin0,
                                     int bx0, int lane) {
  const int BW = g.BOX_W, EH = g.EH, PITCH = g.PITCH;
  const T zero = from_double<T>(0.0);
#pragma unroll 8
  for (int e = lane; e < EH * BW; e += 32) {
    const int ey = e / BW, ex = e - (e / BW) * BW;
    const int gy = ywin0 + ey, gx = bx0 + ex;
    const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
    reinterpret_cast<T*>(stage + ey * PITCH)[ex] =
        inside ? src[(size_t)gy * p.W + gx] : zero;
  }
}

// the consumer warps' named barrier. bar.sync is warp-aligned: a warp must
// arrive converged, so the data-dependent loops before it (the mux, the
// coefficient copy) are closed with __syncwarp first
__device__ __forceinline__ void consumers_sync() {
  __syncwarp();
  asm volatile("bar.sync %0, %1;\n" ::"n"(MUX_BAR), "n"(NCONS) : "memory");
}

// consumers_sync that also returns whether v held on every consumer thread
__device__ __forceinline__ bool consumers_all(bool v) {
  __syncwarp();
  int r;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.s32 p, %1, 0;\n"
      " bar.red.and.pred q, %2, %3, p;\n selp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(r) : "r"((int)v), "n"(MUX_BAR), "n"(NCONS) : "memory");
  return r != 0;
}

// The generic path's coefficient file (coeff_words), filled once per block
// by the consumers from the launch's [n, rows, w] bank g: rows padded to
// coeff_pitch(w); or, for an 8-bit direct launch whose every coefficient
// fits a signed byte (checked on the block's own copy of the bank, so the
// route needs no host sync and follows a swapped bank), packed four taps a
// word for dp4a. Returns whether the file is packed.
template <typename T, typename A, int FORM>
__device__ __forceinline__ bool stage_generic_coeffs(A* cs, const A* g, int n,
                                                     int w, int tid) {
  const int rows = n * (FORM == SEPARABLE ? 2 : w);   // the bank's rows
  bool packed = false;
  if constexpr (std::is_integral<A>::value && sizeof(T) == 1 &&
                FORM == FOLD) {
    bool fits = true;
    for (int e = tid; e < rows * w; e += NCONS)
      fits = fits && g[e] >= -128 && g[e] <= 127;
    packed = consumers_all(fits);
  }
  if (packed) {
    const int kq = packed_pitch(w);
    uint32_t* q = reinterpret_cast<uint32_t*>(cs);
    for (int e = tid; e < rows * kq; e += NCONS) {
      const int r = e / kq, j = 4 * (e - r * kq);
      uint32_t word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (j + t < w)
          word |= ((uint32_t)g[r * w + j + t] & 0xffu) << (8 * t);
      q[e] = word;
    }
  } else {
    const int kp = coeff_pitch(w);
    for (int e = tid; e < rows * kp; e += NCONS) {
      const int r = e / kp, j = e - r * kp;
      cs[e] = j < w ? g[r * w + j] : A(0);
    }
  }
  return packed;
}

#ifdef F2D_TRACE
// the trace build's records: REC_INTS ints each, {kind, launch, block,
// item, seq, stage, warp (-1: the producer), payload[9]}; the payloads are
// decoded by repro_torch/analysis/ir.py::from_device_log, and a read's
// seventh (1: the block's coefficient file is packed, the dp4a route) by
// kernels/filter2d/trace.py::mac_routes
enum Event { EV_WAIT_EMPTY = 1, EV_EXPECT_TX = 2, EV_LOAD = 3,
             EV_WAIT_FULL = 4, EV_MUX = 5, EV_READ = 6, EV_ARRIVE = 7,
             EV_STORE = 8 };
constexpr int REC_INTS = 16;

__device__ __forceinline__ void trace_event(
    const Params& p, int* seq, int kind, int item, int stage, int warp,
    int a0 = 0, int a1 = 0, int a2 = 0, int a3 = 0, int a4 = 0, int a5 = 0,
    int a6 = 0, int a7 = 0, int a8 = 0) {
  const int n = atomicAdd(seq, 1);
  const int slot = atomicAdd(p.trace.count, 1);
  if (slot >= p.trace.cap) return;
  int* r = p.trace.rec + (size_t)slot * REC_INTS;
  const int v[REC_INTS] = {kind, p.trace.launch, (int)blockIdx.x, item, n,
                           stage, warp, a0, a1, a2, a3, a4, a5, a6, a7, a8};
#pragma unroll
  for (int i = 0; i < REC_INTS; ++i) r[i] = v[i];
}
#endif

// The explicit minimum of one block per SM is not a no-op: with the
// thread count alone ptxas gives the w5 float kernel 62 registers and
// hoists fewer shared loads, 3% slower on an H100 than with it (93); the
// serving shapes still run two blocks per SM. W = 0 is the generic window:
// ptxas holds it to 96 registers a thread for two blocks per SM, which
// its shared memory allows to w 27 (float32), 39 (bfloat16) and 73
// (8-bit), so one block's warps issue while the other's wait on their
// loads. One block per SM was 9-28% slower on an H100 for float32, and
// 0-42% slower for the bf16 compress and integer instantiations that
// spill 16-628 B under the cap (tools/filter_ab.py); three, at 72
// registers, spill.
template <typename T, typename A, typename O, int W, int FORM, int LV>
__global__ void __launch_bounds__(NT, W == 0 ? 2 : 1)
filter2d_halo_kernel(const __grid_constant__ CUtensorMap map, const Params p) {
  using GEO = typename GeoOf<T, O, W>::type;
  const GEO g = GeoOf<T, O, W>::make(p.w);
  const int w = W > 0 ? W : p.w;
  const int NWORDS = coeff_words(w, FORM == SEPARABLE);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const uint32_t bars = smem_u32(ring + STAGES * g.STAGE);
  // full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s)
  A* cs = reinterpret_cast<A*>(ring + STAGES * g.STAGE + 16 * STAGES);
  int32_t* qs = reinterpret_cast<int32_t*>(cs + p.N * NWORDS);
#ifdef F2D_TRACE
  __shared__ int seq;   // the block's event numbers
#endif

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, p.tma ? 1 : 32);
      mbar_init(bars + 8 * (STAGES + s), NCONS / 32);   // a warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#ifdef F2D_TRACE
    seq = 0;
#endif
  }
  __syncthreads();

  // this block's items: blockIdx.x, then every gridDim.x-th, so the grid
  // sweeps the reference's order (plane, tile, strip) a wave at a time and
  // the frame-edge items, which run the mux, spread over all blocks
  const int per_plane = p.tiles * p.strips;
  const int items = p.M * per_plane;   // < 2^31: the host checks
  const size_t plane = (size_t)p.H * p.W;

  if (tid >= NCONS) {  // the producer warp: the ring's first windows are
    const int lane = tid - NCONS;   // in flight while the consumers fetch
    if (p.tma && lane != 0) return; // the coefficients
    if (p.tma)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map)) : "memory");
    for (int it = blockIdx.x, k = 0; it < items; it += gridDim.x, ++k) {
      const int s = k % STAGES;
      const int m = it / per_plane, rem = it - m * per_plane;
      const int ywin0 = (rem % p.strips) * GEO::SH - g.R;
      const int bx0 = (rem / p.strips) * TILE_W - g.LEAD;
      unsigned char* stage = ring + s * g.STAGE;
      const int parity = ((k / STAGES) & 1) ^ 1;
      mbar_wait(bars + 8 * (STAGES + s), parity);
#ifdef F2D_TRACE
      if (lane == 0) trace_event(p, &seq, EV_WAIT_EMPTY, it, s, -1, parity);
#endif
      if (p.tma) {
#ifdef F2D_TRACE
        trace_event(p, &seq, EV_EXPECT_TX, it, s, -1, g.EH * g.PITCH);
        trace_event(p, &seq, EV_LOAD, it, s, -1, m, ywin0, bx0, g.EH,
                    g.BOX_W, (int)sizeof(T), 1);
#endif
        mbar_expect_tx(bars + 8 * s, g.EH * g.PITCH);
        hopper::tma_load_3d(smem_u32(stage), &map, bars + 8 * s, bx0, ywin0,
                            m);
      } else {
        fill<T>(stage, static_cast<const T*>(p.planes) + m * plane, p, g,
                ywin0, bx0, lane);
#ifdef F2D_TRACE
        if (lane == 0)
          trace_event(p, &seq, EV_LOAD, it, s, -1, m, ywin0, bx0, g.EH,
                      g.BOX_W, (int)sizeof(T), 0);
#endif
        mbar_arrive(bars + 8 * s);
      }
    }
    return;
  }

  // the bank's coefficients and requant table, once per block
  const A* gco = static_cast<const A*>(p.coeffs);
  bool packed = false;
  if constexpr (W > 0)
    for (int e = tid; e < p.N * NWORDS; e += NCONS) cs[e] = gco[e];
  else
    packed = stage_generic_coeffs<T, A, FORM>(cs, gco, p.N, w, tid);
  if (p.qparams != nullptr)
    for (int e = tid; e < 2 * p.N; e += NCONS) qs[e] = p.qparams[e];
  consumers_sync();

  // the consumers
  const int tx = tid % GEO::TX, ty = tid / GEO::TX;
#ifdef F2D_TRACE
  const int warp = tid >> 5, lane = tid & 31;
#endif
  for (int it = blockIdx.x, k = 0; it < items; it += gridDim.x, ++k) {
    const int s = k % STAGES;
    const int m = it / per_plane, rem = it - m * per_plane;
    const int y0 = (rem % p.strips) * GEO::SH, x0 = (rem / p.strips) * TILE_W;
    const int ywin0 = y0 - g.R;
    unsigned char* stage = ring + s * g.STAGE;
    mbar_wait(bars + 8 * s, (k / STAGES) & 1);
#ifdef F2D_TRACE
    if (lane == 0)
      trace_event(p, &seq, EV_WAIT_FULL, it, s, warp, (k / STAGES) & 1);
#endif
    const bool edge = p.policy != NEGLECT &&
                      (ywin0 < 0 || ywin0 + g.EH > p.H ||
                       x0 - g.R < 0 || x0 + TILE_W + g.R > p.W);
    if (edge) {
      const int slots = mux<T>(stage,
                               static_cast<const T*>(p.planes) + m * plane,
                               p, g, ywin0, x0 - g.LEAD, tid);
#ifdef F2D_TRACE
      const int warp_slots = __reduce_add_sync(0xffffffffu, slots);
      if (lane == 0) {   // the constant as the stream holds it
        const long long c = __double_as_longlong(
            (double)widen<float>(from_double<T>(p.constant)));
        trace_event(p, &seq, EV_MUX, it, s, warp, warp_slots,
                    p.policy == CONSTANT, (int)(c & 0xffffffffll),
                    (int)(c >> 32));
      }
#else
      (void)slots;
#endif
      consumers_sync();
    }
    const int cy0 = y0 + ty * GEO::ROWS, cx0 = x0 + tx * GEO::C;
    const bool active = cy0 - p.shift < p.Ho && cx0 - p.shift < p.Wo &&
                        cy0 + GEO::ROWS > p.shift && cx0 + GEO::C > p.shift;
    if (active) {
      const unsigned char* win =
          stage + ty * GEO::ROWS * g.PITCH + tx * GEO::C * GEO::S;
      const int32_t* q = p.qparams != nullptr ? qs : nullptr;
      if constexpr (W > 0)
        reduce_item<T, A, O, W, FORM>(win, cs, q, p, m, cy0, cx0);
      else
        reduce_item_generic<T, A, O, FORM, LV>(win, cs, q, p, g, packed, m,
                                           cy0, cx0);
    }
#ifdef F2D_TRACE
    {  // what the warp read of the stage (from the box's first row and
       // column) and the output rectangle it stored, over its active lanes
      const unsigned all = 0xffffffffu;
      const int big = 1 << 30;
      const int R0 = __reduce_min_sync(all, active ? ty * GEO::ROWS : big);
      const int R1 = __reduce_max_sync(
          all, active ? ty * GEO::ROWS + GEO::ROWS + 2 * g.R : -big);
      const int C0 = __reduce_min_sync(
          all, active ? tx * GEO::C + g.LEAD - g.R : big);
      const int C1 = __reduce_max_sync(
          all, active ? tx * GEO::C + g.LEAD + g.R + GEO::C : -big);
      const int Y0 = __reduce_min_sync(
          all, active ? max(cy0 - p.shift, 0) : big);
      const int Y1 = __reduce_max_sync(
          all, active ? min(cy0 - p.shift + GEO::ROWS, p.Ho) : -big);
      const int X0 = __reduce_min_sync(
          all, active ? max(cx0 - p.shift, 0) : big);
      const int X1 = __reduce_max_sync(
          all, active ? min(cx0 - p.shift + GEO::C, p.Wo) : -big);
      if (lane == 0 && R0 < big) {
        trace_event(p, &seq, EV_READ, it, s, warp, R0, C0, R1 - R0, C1 - C0,
                    GEO::S, std::is_integral<A>::value ? 1 : 2, packed);
        for (int f = 0; f < p.N; ++f)
          trace_event(p, &seq, EV_STORE, it, s, warp, m, p.trace.n0 + f, Y0,
                      X0, Y1 - Y0, X1 - X0,
                      (Y1 - Y0) * (X1 - X0) * (int)sizeof(O));
      }
    }
#endif
    // the mux's generic writes before the next TMA write to this stage
    if (edge) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();   // the warp is done with the stage: one arrival for it
#ifdef F2D_TRACE
    if (lane == 0) trace_event(p, &seq, EV_ARRIVE, it, s, warp);
#endif
    if ((tid & 31) == 0) mbar_arrive(bars + 8 * (STAGES + s));
  }
}

// dynamic shared memory of a launch: alignment slack, the ring, the
// barriers, the chunk's coefficient file (`words` a filter: coeff_words)
// and its requant table (kernels/filter2d/halo.py::ring_smem_bytes is its
// twin)
inline size_t smem_bytes(const Geometry& g, int words, int n, int acc_bytes) {
  return 128 + (size_t)STAGES * g.STAGE + 16 * STAGES +
         (size_t)n * words * acc_bytes + (size_t)n * 8;
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                          : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// [M, H, W] storage type T as a 3D map (W, H, M); boxes of BOX_W x EH x 1,
// no swizzle, out-of-frame slots read as zeros
template <typename T>
bool make_map(CUtensorMap* map, const Params& p, const Geometry& g) {
  hopper::EncodeTiled enc = hopper::encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)p.W, (cuuint64_t)p.H,
                              (cuuint64_t)p.M};
  const cuuint64_t strides[2] = {(cuuint64_t)p.W * sizeof(T),
                                 (cuuint64_t)p.W * p.H * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)g.BOX_W, (cuuint32_t)g.EH, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, tma_type<T>(), 3, const_cast<void*>(p.planes), dims,
             strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `info`, when given, receives {dynamic shared memory bytes, blocks,
// tiles, strips} of the launch; LV is a generic tree's level case (0 for
// every other instantiation)
template <typename T, typename A, typename O, int W, int FORM, int LV = 0>
cudaError_t launch(Params p, cudaStream_t stream, int* info) {
  const int w = W > 0 ? W : p.w;
  if (w != p.w) return cudaErrorInvalidValue;
  const Geometry g = geometry(sizeof(T), sizeof(O), w);
  // the box and the tree's counter bound the window; the wrapper refuses
  // such a window at compile time already (halo.py::check_ring_fits)
  if (!box_fits(g) || (LV > 0 && tree_levels(w) != LV))
    return cudaErrorInvalidValue;
  // centres cover the frame; neglect keeps those whose window is inside
  p.tiles = (p.W + TILE_W - 1) / TILE_W;
  p.strips = (p.H + g.SH - 1) / g.SH;
  p.vec_store = p.shift == 0 && p.Wo % g.C == 0 &&
                reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  const long long items = (long long)p.M * p.tiles * p.strips;
  if (items <= 0 || p.N <= 0 || p.Ho <= 0 || p.Wo <= 0)
    return cudaSuccess;   // an empty output
  if (items >= (1ll << 31)) return cudaErrorInvalidValue;
  CUtensorMap map;
  memset(&map, 0, sizeof map);
  if (p.tma) {
    if (reinterpret_cast<uintptr_t>(p.planes) % 16 != 0 ||
        ((size_t)p.W * sizeof(T)) % 16 != 0)
      return cudaErrorMisalignedAddress;
    if (!make_map<T>(&map, p, g)) return cudaErrorInvalidValue;
  }
  const auto kern = filter2d_halo_kernel<T, A, O, W, FORM, LV>;
  const size_t smem =
      smem_bytes(g, coeff_words(w, FORM == SEPARABLE), p.N, sizeof(A));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long grid = p.blocks > 0 ? p.blocks : (long long)per_sm * sms;
  if (grid > items) grid = items;
  if (info != nullptr) {
    info[0] = (int)smem;
    info[1] = (int)grid;
    info[2] = p.tiles;
    info[3] = p.strips;
  }
  filter2d_halo_kernel<T, A, O, W, FORM, LV>
      <<<(unsigned)grid, NT, smem, stream>>>(map, p);
  return cudaGetLastError();
}
template <typename T, typename A, typename O, int W>
cudaError_t dispatch_form(const Params& p, int form, cudaStream_t stream,
                          int* info) {
  if (form == SEPARABLE) return launch<T, A, O, W, SEPARABLE>(p, stream, info);
  if constexpr (std::is_integral<A>::value) {
    // exact mod 2^32: any order
    return launch<T, A, O, W, FOLD>(p, stream, info);
  } else {
    if (form == TREE) {
      if constexpr (W == 0) {   // a kernel per level case
        switch (tree_levels(p.w)) {
          case 8: return launch<T, A, O, 0, TREE, 8>(p, stream, info);
          case 10: return launch<T, A, O, 0, TREE, 10>(p, stream, info);
          case 12: return launch<T, A, O, 0, TREE, 12>(p, stream, info);
          case TREE_LEVELS:
            // float32 frames stop at w 61 (12 levels): shared memory holds
            // no larger window, so their 13-level kernel is not built
            if constexpr (sizeof(T) == 4) return cudaErrorInvalidValue;
            else return launch<T, A, O, 0, TREE, TREE_LEVELS>(p, stream, info);
          default: return cudaErrorInvalidValue;   // past the counter
        }
      } else {
        return launch<T, A, O, W, TREE>(p, stream, info);
      }
    }
    if (form == COMPRESS) return launch<T, A, O, W, COMPRESS>(p, stream, info);
    return launch<T, A, O, W, FOLD>(p, stream, info);
  }
}

// windows 1..7 have an instantiation each; every larger odd window runs
// the generic one
template <typename T, typename A, typename O>
cudaError_t dispatch(const Params& p, int form, int w, cudaStream_t stream,
                     int* info) {
  switch (w) {
    case 1: return dispatch_form<T, A, O, 1>(p, form, stream, info);
    case 3: return dispatch_form<T, A, O, 3>(p, form, stream, info);
    case 5: return dispatch_form<T, A, O, 5>(p, form, stream, info);
    case 7: return dispatch_form<T, A, O, 7>(p, form, stream, info);
    default:
      if (w < 9 || w % 2 == 0) return cudaErrorInvalidValue;
      return dispatch_form<T, A, O, 0>(p, form, stream, info);
  }
}

// dtype codes shared with kernels/filter2d/kernel.py
enum DType { F32 = 0, BF16 = 1, I8 = 2, U8 = 3, I16 = 4, I32 = 5 };

// integer storage T: out is the int32 accumulator or a requantised type
template <typename T>
cudaError_t dispatch_int(const Params& p, int out_dtype, int form, int w,
                         cudaStream_t stream, int* info) {
  switch (out_dtype) {
    case I32: return dispatch<T, int32_t, int32_t>(p, form, w, stream, info);
    case I8: return dispatch<T, int32_t, int8_t>(p, form, w, stream, info);
    case U8: return dispatch<T, int32_t, uint8_t>(p, form, w, stream, info);
    case I16: return dispatch<T, int32_t, int16_t>(p, form, w, stream, info);
    default: return cudaErrorInvalidValue;
  }
}

// one entry per storage type, each in its own translation unit so the
// instantiations build in parallel
cudaError_t launch_f32(const Params& p, int out_dtype, int form, int w,
                       cudaStream_t s, int* info);
cudaError_t launch_bf16(const Params& p, int out_dtype, int form, int w,
                        cudaStream_t s, int* info);
cudaError_t launch_i8(const Params& p, int out_dtype, int form, int w,
                      cudaStream_t s, int* info);
cudaError_t launch_u8(const Params& p, int out_dtype, int form, int w,
                      cudaStream_t s, int* info);
cudaError_t launch_i16(const Params& p, int out_dtype, int form, int w,
                       cudaStream_t s, int* info);

}  // namespace f2d
