// The int8 tensor-core GEMM shared by the radix kernels: a multi-stage
// shared-memory ring, u8 x s8 -> s32 MMAs (wgmma and mma.sync), the
// dataflows as masked operand passes, split-K, and the fused output-logic
// epilogue.
//
// Counterpart of the helpers repro/kernels/radix_conv.py imports from
// repro/kernels/radix_matmul.py (_accumulate_tile, gated, occ_mask,
// _plane_step, _project_levels / _epilogue_store).  radix_matmul.cu and
// radix_conv.cu compute C[M, N] = sum_k A[m, k] * W[n, k] on this one
// mainloop; they differ only in how a block gathers its A tile (a dense
// row-major matrix, or an implicit-GEMM view of a pre-padded NHWC image).
//
// What bounds the kernels, and what this design does about it:
//   * Operations, at large M (prefill, the convs): Hopper's int8 tensor
//     cores (1979 TOP/s dense).  Every product takes u8 levels and s8
//     weights into s32 (u8 holds every level 0..255, s8 every weight, so
//     no <= 127 gate exists), and tiles stay bytes in shared memory (not
//     int32-widened).  The fused dataflow at M > 32, N > 64 runs
//     wgmma.mma_async m64n128k32 .s32.u8.s8 with both operands read from
//     shared memory by descriptor (WgTile), one group kept in flight
//     across stages; the others run mma.sync m16n8k32 fed by ldmatrix.
//   * Bytes, at small M (decode M = 8, the CNN's linear layers): the
//     weight stream.  The weights are stored K-major, (N, K), prepared once
//     by the caller (kernels/gemm.py), so 16-byte cp.async copies stream
//     them; the operands swap (weights are the MMA's 16-row side, the <= 32
//     tokens its 8-wide side) and K is split across blocks until some 2x132
//     blocks stream, reduced exactly with int32 atomics.
//   * Latency: a STAGES-deep cp.async ring in dynamic shared memory keeps
//     loads in flight during the MMAs.  Rows are XOR-swizzled in 16-byte
//     chunks, which is both conflict-free for ldmatrix and, for 64-byte
//     rows on a 1 KB-aligned ring, wgmma's 64-byte swizzle.
//   TMA loads, a warp-specialised producer and wgmma for the bitserial
//   passes (A from registers) are left for a later revision (ROADMAP.md).
//
// Tiles (tile record: kernels/gemm.py TILES, kernels/autotune.py):
//   LargeTile: 128 token rows x 128 weight rows x 64 K bytes, 4 stages,
//              8 warps of 64 x 32 outputs; A = levels (u8), B = weights.
//   WgTile:    LargeTile's shape for its fused dataflow, on wgmma: two
//              warpgroups of 64 x 128; a fused occupancy mask is applied
//              to the level tile in shared memory before the stage's
//              barrier.
//   SmallTile: 128 weight rows x 32 token columns x 128 K bytes, 4 stages,
//              8 warps of 16 x 32; A = weights (s8), B = levels (u8).
//   MidTile:   128 token rows x 64 weight rows (N <= 64, e.g. VGG's conv1:
//              no MMA or epilogue on columns past N, half the registers
//              of LargeTile, so more blocks hide each block's latency).
// Ragged M/N edges are skipped on store (rows past the edge are never
// loaded: they only reach outputs that are not stored); K past the edge is
// zero-filled.  Callers pass logical shapes.
//
// Dataflows: every pass multiplies a byte-masked copy of the level
// fragments, (a & mask), four levels per 32-bit register, into an int32
// accumulator.
//   fused     - one pass with the occupied planes' bits (all bits without
//               an occupancy row);
//   bitserial - one pass per plane s and K tile, mask 0x01010101 << (s - 8g)
//               (the plane's bit left in place: ((a >> s) & 1) << s, the
//               reference's `acc += (plane @ w) << shift`); a pass whose
//               occ[s] == 0 (uniform over the block) is skipped; the phase
//               schedule (periods > 1) replays the T passes `periods` times
//               and floor-divides the final sum by periods.
//   int32 levels (the avg-pool carry) run the mainloop once per byte group
//   g, loading (x >> 8g) & 0xFF as u8, into a second accumulator that is
//   added << 8g.  Every order of integer sums is exact (mod 2^32, as the
//   reference's int32 arithmetic), split-K included.
//
// Epilogue (repro/kernels/radix_matmul.py:_epilogue_store): on the final
// sum, floor(f32(acc + bias) * mult) (round-to-nearest int->float and
// multiply, no contraction), clamp to [0, out_level], optional pow2 floor,
// store uint8; without it, int32.  Split-K with an epilogue (or a phase
// divide) adds partials into a zeroed workspace and the last block to
// arrive on an output tile finishes it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace radix {

constexpr int THREADS = 256;   // 8 warps
constexpr int MAX_STEPS = 31;  // plane bits an int32 level can carry

struct Schedule {
  int num_steps;  // plane bits the bitserial dataflow extracts
  int fused;      // 1: one pass over packed levels; 0: bitserial passes
  int periods;    // phase-schedule replay count (bitserial)
  int out_level;  // epilogue clamp ceiling
  int pow2;       // epilogue floors onto {0} | {2^k}
};

struct Problem {
  const int8_t* w;     // (N, K) K-major int8 weights
  int M, N, K;         // logical GEMM
  int k_chunk;         // K per split (multiple of BK); gridDim.z splits
  int w_vec;           // weights by 16-byte cp.async (K % 16 == 0, aligned)
  Schedule s;
  const int* occ;      // plane-occupancy row, or null (ungated)
  const int* bias;     // epilogue rows (N), or null
  const float* mult;   // null: int32 out
  void* out;           // (M, N) int32 or uint8
  int* work;           // split-K: (M, N) int32 partials + one arrival count
                       // per output tile, zeroed; null otherwise
};

// Block tile: WR x WC warps, each MT 16-row x NT 8-column MMA tiles;
// ACT_ROWS: the levels are the MMA's A side (rows), else its B side.
template <int WR, int WC, int MT_, int NT_, int BK_, int STAGES_,
          bool ACT_ROWS_, bool WGMMA_ = false>
struct Tile {
  static constexpr int WARPS_R = WR, WARPS_C = WC, MT = MT_, NT = NT_;
  static constexpr bool ACT_ROWS = ACT_ROWS_;
  static constexpr bool WGMMA = WGMMA_;  // warpgroup MMAs from shared memory
  static constexpr int ROWS = WR * MT * 16;  // the MMA's A side
  static constexpr int COLS = WC * NT * 8;   // the MMA's B side
  static constexpr int BK = BK_;             // K bytes per stage
  static constexpr int STAGES = STAGES_;
  static constexpr int CHUNKS = BK / 16;     // 16-byte chunks per tile row
  static constexpr int STAGE_BYTES = (ROWS + COLS) * BK;
  // wgmma reads swizzled tiles by absolute address: 1 KB of slack lets
  // the ring start on a 1 KB boundary
  static constexpr int SMEM = STAGES * STAGE_BYTES + (WGMMA ? 1024 : 0);
  static_assert(WR * WC * 32 == THREADS, "8 warps");
  static_assert(!WGMMA || (ACT_ROWS && BK == 64 && MT == 1 && NT == 16 &&
                           WC == 1), "wgmma: m64n128k32 per warpgroup");
  static_assert(BK == 64 || BK == 128, "swizzle covers 64 or 128 bytes");
  static_assert(NT % 2 == 0, "B fragments load in pairs");
  static_assert((ROWS * CHUNKS) % THREADS == 0 &&
                (COLS * CHUNKS) % THREADS == 0, "whole chunks per thread");
};
using LargeTile = Tile<2, 4, 4, 4, 64, 4, true>;    // 128 x 128 x 64, 64 KB
using SmallTile = Tile<8, 1, 1, 4, 128, 4, false>;  // 128 x 32 x 128, 80 KB
using MidTile = Tile<4, 2, 2, 4, 64, 4, true>;      // 128 x 64 x 64, 48 KB
// LargeTile's shape for the fused dataflow on wgmma: each warpgroup one
// m64n128k32 product per K step; warp w holds rows 16w..16w+15.
using WgTile = Tile<8, 1, 1, 16, 64, 4, true, true>;

// a // b rounding toward -inf (C's '/' truncates toward zero).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int pow2_floor(int q) {
  return q > 0 ? (1 << (31 - __clz(q))) : 0;
}

__device__ __forceinline__ uint8_t epilogue(int acc, int bias, float mult,
                                            int out_level, int pow2) {
  float q = floorf(__fmul_rn(__int2float_rn(acc + bias), mult));
  q = fminf(fmaxf(q, 0.0f), static_cast<float>(out_level));
  int lvl = static_cast<int>(q);
  return static_cast<uint8_t>(pow2 ? pow2_floor(lvl) : lvl);
}

// ---------------------------------------------------------------------------
// PTX wrappers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 32) * b (32 x 8); A_U8: a u8, b s8; else a s8, b u8.
template <bool A_U8>
__device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  if (A_U8) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 64-byte rows in the
// 64-byte swizzle (8-row groups 512 bytes apart).
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFFu) >> 4) | (1ull << 16) | ((512ull >> 4) << 32) |
         (2ull << 62);
}

// d (64 x 128 per warpgroup) += A (64 x 32 u8) * B (32 x 128 s8), both
// from shared memory; asynchronous until wgmma_wait.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[16][4],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin d after the last wait, so no read of it moves above.
__device__ __forceinline__ void wgmma_pin(int (&d)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(d[j][i])::"memory");
}

// Byte offset of 16-byte chunk `ch` of tile row `row`: XOR-swizzled so the
// eight rows one ldmatrix phase reads fall on distinct bank groups.
template <int BK>
__device__ __forceinline__ int swz(int row, int ch) {
  return BK == 128 ? row * 128 + ((ch ^ (row & 7)) << 4)
                   : row * 64 + ((ch ^ ((row >> 1) & 3)) << 4);
}

// ---------------------------------------------------------------------------
// Loaders: a row handle (element offset of a row, -1 past the edge), and
// the 16 bytes k .. k+15 of byte group g of that row into shared memory.
// ---------------------------------------------------------------------------

// A dense row-major (rows, K) matrix: the matmul's levels (uint8 or int32)
// and every kernel's K-major weights (int8).
template <typename T>
struct RowMatrix {
  const T* __restrict__ x;
  int rows, K;
  int vec;  // uint8/int8 rows by cp.async: K % 16 == 0 and x aligned
  __device__ __forceinline__ long long row(int r) const {
    return r < rows ? static_cast<long long>(r) * K : -1;
  }
  __device__ __forceinline__ void load(uint8_t* dst, long long h, int k,
                                       int g) const {
    if (h < 0) return;  // only reaches outputs that are not stored
    if (sizeof(T) == 1 && vec) {
      cp_async16(dst, k < K ? x + h + k : x, k < K);
      return;
    }
    unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (k + j < K) {
        const unsigned b =
            (static_cast<unsigned>(x[h + k + j]) >> (8 * g)) & 0xFFu;
        v[j >> 2] |= b << (8 * (j & 3));
      }
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  }
};

// ---------------------------------------------------------------------------
// The block's GEMM.
// ---------------------------------------------------------------------------

template <class Cfg, bool WIDE, bool EPI, class ActLoader>
struct Gemm {
  static constexpr bool ACT_ROWS = Cfg::ACT_ROWS;
  static constexpr int MT = Cfg::MT, NT = Cfg::NT, BK = Cfg::BK;
  static constexpr int STAGES = Cfg::STAGES, CHUNKS = Cfg::CHUNKS;
  // activations and weights: which MMA side, and how many per block
  static constexpr int ACT_TILE = ACT_ROWS ? Cfg::ROWS : Cfg::COLS;
  static constexpr int W_TILE = ACT_ROWS ? Cfg::COLS : Cfg::ROWS;
  static constexpr int ACT_PER = ACT_TILE * CHUNKS / THREADS;
  static constexpr int W_PER = W_TILE * CHUNKS / THREADS;
  using Acc = int[MT][NT][4];

  ActLoader la;
  RowMatrix<int8_t> lw;
  Problem p;
  uint8_t* smem;
  int tid, act_base, w_base, act_valid;
  long long act_h[ACT_PER], w_h[W_PER];

  __device__ __forceinline__ Gemm(const ActLoader& la_, const Problem& p_,
                                  uint8_t* smem_)
      : la(la_), lw{p_.w, p_.N, p_.K, p_.w_vec}, p(p_), smem(smem_) {
    if (Cfg::WGMMA) smem += (1024 - (smem_addr(smem) & 1023)) & 1023;
    tid = threadIdx.x;
    act_base = blockIdx.x * ACT_TILE;
    w_base = blockIdx.y * W_TILE;
    act_valid = min(ACT_TILE, p.M - act_base);
#pragma unroll
    for (int i = 0; i < ACT_PER; ++i)
      act_h[i] = la.row(act_base + (tid + i * THREADS) / CHUNKS);
#pragma unroll
    for (int i = 0; i < W_PER; ++i)
      w_h[i] = lw.row(w_base + (tid + i * THREADS) / CHUNKS);
  }

  __device__ __forceinline__ uint8_t* rows_s(int st) const {
    return smem + st * Cfg::STAGE_BYTES;
  }
  __device__ __forceinline__ uint8_t* cols_s(int st) const {
    return rows_s(st) + Cfg::ROWS * BK;
  }

  __device__ __forceinline__ void load_stage(int st, int k0, int g) const {
    uint8_t* act_s = ACT_ROWS ? rows_s(st) : cols_s(st);
    uint8_t* w_s = ACT_ROWS ? cols_s(st) : rows_s(st);
#pragma unroll
    for (int i = 0; i < ACT_PER; ++i) {
      const int c = tid + i * THREADS;
      la.load(act_s + swz<BK>(c / CHUNKS, c % CHUNKS), act_h[i],
              k0 + (c % CHUNKS) * 16, g);
    }
#pragma unroll
    for (int i = 0; i < W_PER; ++i) {
      const int c = tid + i * THREADS;
      lw.load(w_s + swz<BK>(c / CHUNKS, c % CHUNKS), w_h[i],
              k0 + (c % CHUNKS) * 16, 0);
    }
  }

  // wgmma's fused pass: the byte mask goes onto the level tile in shared
  // memory, each thread on the chunks it loaded, before the stage's
  // barrier; the fence hands the tile to the async proxy.
  __device__ __forceinline__ void mask_own_chunks(int st,
                                                  unsigned mask) const {
    if (mask != 0xFFFFFFFFu) {
#pragma unroll
      for (int i = 0; i < ACT_PER; ++i) {
        const int c = tid + i * THREADS;
        uint4* q = reinterpret_cast<uint4*>(
            rows_s(st) + swz<BK>(c / CHUNKS, c % CHUNKS));
        uint4 v = *q;
        v.x &= mask;
        v.y &= mask;
        v.z &= mask;
        v.w &= mask;
        *q = v;
      }
    }
    fence_proxy_async();
  }

  // One stage: per 32-deep K step, the raw fragments once, then every pass
  // (a byte mask on the level fragments) into d.
  __device__ __forceinline__ void compute_stage(int st, Acc& d, int reps,
                                                unsigned pass_bits,
                                                unsigned fused_mask) const {
    if constexpr (Cfg::WGMMA) {  // one group in flight: sweep waits
      const uint8_t* a = rows_s(st) + (tid >> 7) * 64 * BK;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        wgmma_m64n128k32(d[0], gmma_desc(a + ks * 32),
                         gmma_desc(cols_s(st) + ks * 32));
      wgmma_commit();
      return;
    }
    const int lane = tid & 31, warp = tid >> 5;
    const int wr = warp / Cfg::WARPS_C, wc = warp % Cfg::WARPS_C;
    const int q = lane >> 3, i8 = lane & 7;
    const uint8_t* ra = rows_s(st);
    const uint8_t* cb = cols_s(st);
    const int col0 = wc * NT * 8;
    // B column pairs holding a valid token (the small tile's token side)
    const int pairs = ACT_ROWS ? NT / 2
                               : min(NT / 2, (act_valid - col0 + 15) / 16);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      unsigned a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wr * MT * 16 + mt * 16 + i8 + 8 * (q & 1);
        ldsm_x4(a[mt], ra + swz<BK>(row, 2 * ks + (q >> 1)));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned r[4] = {0u, 0u, 0u, 0u};
        if (np < pairs) {
          const int col = col0 + np * 16 + i8 + 8 * (q >> 1);
          ldsm_x4(r, cb + swz<BK>(col, 2 * ks + (q & 1)));
        }
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll 1
      for (int rep = 0; rep < reps; ++rep) {
        unsigned bits = pass_bits;
#pragma unroll 1
        while (bits) {
          const int j = __ffs(bits) - 1;
          bits &= bits - 1;
          const unsigned mask = fused_mask ? fused_mask : (0x01010101u << j);
          if (ACT_ROWS) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const unsigned am[4] = {a[mt][0] & mask, a[mt][1] & mask,
                                      a[mt][2] & mask, a[mt][3] & mask};
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma<true>(d[mt][nt], am, b[nt][0], b[nt][1]);
            }
          } else {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              if (nt / 2 >= pairs) continue;
              const unsigned b0 = b[nt][0] & mask, b1 = b[nt][1] & mask;
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                mma<false>(d[mt][nt], a[mt], b0, b1);
            }
          }
        }
      }
    }
  }

  // The block's K range for byte group g, through the cp.async ring:
  // AHEAD stages load while one is computed; on wgmma one more stage is
  // held back for the product still in flight.
  __device__ __forceinline__ void sweep(Acc& d, int g, int reps,
                                        unsigned pass_bits,
                                        unsigned fused_mask) const {
    constexpr int AHEAD = Cfg::WGMMA ? STAGES - 2 : STAGES - 1;
    const int k_lo = blockIdx.z * p.k_chunk;
    const int k_hi = min(p.K, k_lo + p.k_chunk);
    const int nk = (k_hi - k_lo + BK - 1) / BK;
#pragma unroll
    for (int st = 0; st < AHEAD; ++st) {
      if (st < nk) load_stage(st, k_lo + st * BK, g);
      cp_async_commit();
    }
#pragma unroll 1
    for (int it = 0; it < nk; ++it) {
      cp_async_wait<AHEAD - 1>();
      if (Cfg::WGMMA) mask_own_chunks(it % STAGES, fused_mask);
      __syncthreads();
      const int nxt = it + AHEAD;
      if (nxt < nk) load_stage(nxt % STAGES, k_lo + nxt * BK, g);
      cp_async_commit();
      compute_stage(it % STAGES, d, reps, pass_bits, fused_mask);
      if (Cfg::WGMMA) wgmma_wait<1>();
    }
    if constexpr (Cfg::WGMMA) {
      wgmma_wait<0>();
      wgmma_pin(d[0]);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next sweep
  }

  // The output value of a final (or finished split-K) sum: the phase
  // divide, then the epilogue's uint8 level (column bias and multiplier)
  // or the int32 sum.
  __device__ __forceinline__ int finish(int v, int bias, float mult) const {
    const int div = p.s.fused ? 1 : p.s.periods;
    if (div > 1) v = floor_div(v, div);
    return EPI ? epilogue(v, bias, mult, p.s.out_level, p.s.pow2) : v;
  }
  __device__ __forceinline__ int finish(int n, int v) const {
    return EPI ? finish(v, p.bias ? p.bias[n] : 0, p.mult[n])
               : finish(v, 0, 0.f);
  }

  __device__ __forceinline__ void store(int m, int n, int v) const {
    const size_t o = static_cast<size_t>(m) * p.N + n;
    if (EPI)
      static_cast<uint8_t*>(p.out)[o] = static_cast<uint8_t>(finish(n, v));
    else
      static_cast<int*>(p.out)[o] = finish(n, v);
  }

  // The large tile's outputs, staged through the (drained) ring so they
  // leave as 16-byte rows: each fragment pair (i, i + 1) holds two
  // adjacent columns of one row; shared-memory rows are XOR-swizzled by
  // 16-byte chunk like the operand tiles.
  __device__ __forceinline__ void store_tile(const Acc& acc) const {
    using OutT = typename std::conditional<EPI, uint8_t, int>::type;
    constexpr int ROW_BYTES = Cfg::COLS * static_cast<int>(sizeof(OutT));
    constexpr int ROW_CHUNKS = ROW_BYTES / 16;
    constexpr int SWZ = ROW_CHUNKS < 8 ? ROW_CHUNKS - 1 : 7;
    constexpr int PER_CHUNK = 16 / static_cast<int>(sizeof(OutT));
    static_assert(Cfg::ROWS * ROW_BYTES <= Cfg::SMEM, "tile fits the ring");
    const int lane = tid & 31, warp = tid >> 5;
    const int wr = warp / Cfg::WARPS_C, wc = warp % Cfg::WARPS_C;
    // this thread's 2 * NT columns: their epilogue rows, read once
    int bias[NT][2];
    float mult[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = w_base + wc * NT * 8 + nt * 8 + 2 * (lane & 3) + e;
        const bool live = EPI && n < p.N;
        bias[nt][e] = live && p.bias ? p.bias[n] : 0;
        mult[nt][e] = live ? p.mult[n] : 0.f;
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lr = wr * MT * 16 + mt * 16 + lane / 4 + 8 * h;
          const int lc = wc * NT * 8 + nt * 8 + 2 * (lane & 3);
          const int b = lc * static_cast<int>(sizeof(OutT));
          OutT* dst = reinterpret_cast<OutT*>(
              smem + lr * ROW_BYTES + (((b >> 4) ^ (lr & SWZ)) << 4) +
              (b & 15));
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (w_base + lc + e < p.N)  // columns past N are never stored
              dst[e] = static_cast<OutT>(
                  finish(acc[mt][nt][2 * h + e], bias[nt][e], mult[nt][e]));
        }
    __syncthreads();
    const bool vec = (static_cast<long long>(p.N) * sizeof(OutT)) % 16 == 0;
    for (int e = tid; e < Cfg::ROWS * ROW_CHUNKS; e += THREADS) {
      const int lr = e / ROW_CHUNKS, ch = e % ROW_CHUNKS;
      const int m = act_base + lr, n0 = w_base + ch * PER_CHUNK;
      if (m >= p.M || n0 >= p.N) continue;
      const uint8_t* src = smem + lr * ROW_BYTES + ((ch ^ (lr & SWZ)) << 4);
      OutT* out = static_cast<OutT*>(p.out) + static_cast<size_t>(m) * p.N;
      if (vec && n0 + PER_CHUNK <= p.N) {
        *reinterpret_cast<uint4*>(out + n0) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < PER_CHUNK && n0 + j < p.N; ++j)
          out[n0 + j] = reinterpret_cast<const OutT*>(src)[j];
      }
    }
  }

  __device__ __forceinline__ void run() {
    __shared__ int occ_s[MAX_STEPS + 1];
    __shared__ int last_s;
    const Schedule s = p.s;
    if (tid <= MAX_STEPS)
      occ_s[tid] = (p.occ == nullptr || tid >= s.num_steps) ? 1 : p.occ[tid];
    __syncthreads();
    // the fused dataflow's bit mask: all bits ungated, else the occupied
    // planes'; the bitserial passes: planes below num_steps, occupied
    unsigned mask32 = 0xFFFFFFFFu, planes = 0u;
    if (p.occ != nullptr) mask32 = 0u;
    for (int b = 0; b < s.num_steps; ++b) {
      if (occ_s[b]) planes |= 1u << b;
      if (p.occ != nullptr && occ_s[b]) mask32 |= 1u << b;
    }
    const int groups = WIDE ? 4 : 1;
    const int reps = s.fused ? 1 : s.periods;

    int acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
      const unsigned byte = ((s.fused ? mask32 : planes) >> (8 * g)) & 0xFFu;
      if (byte == 0u) continue;  // nothing of this group reaches the sum
      const unsigned fused_mask = s.fused ? byte * 0x01010101u : 0u;
      const unsigned pass_bits = s.fused ? 1u : byte;
      if (WIDE) {
        int part[MT][NT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0;
        sweep(part, g, reps, pass_bits, fused_mask);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[mt][nt][i] += static_cast<int>(
                  static_cast<unsigned>(part[mt][nt][i]) << (8 * g));
      } else {
        sweep(acc, g, reps, pass_bits, fused_mask);
      }
    }

    // fragment element (mt, nt, i) -> output (m, n)
    const int lane = tid & 31, warp = tid >> 5;
    const int wr = warp / Cfg::WARPS_C, wc = warp % Cfg::WARPS_C;
    const int row0 = (ACT_ROWS ? act_base : w_base) + wr * MT * 16 + lane / 4;
    const int col0 = (ACT_ROWS ? w_base : act_base) + wc * NT * 8 +
                     2 * (lane & 3);
    const bool split = gridDim.z > 1;
    const int div = s.fused ? 1 : s.periods;
    const bool direct_atomic = split && !EPI && div == 1;
    if (ACT_ROWS && !split) {
      store_tile(acc);
      return;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + mt * 16 + 8 * (i >> 1);
          const int c = col0 + nt * 8 + (i & 1);
          const int m = ACT_ROWS ? r : c, n = ACT_ROWS ? c : r;
          if (m >= p.M || n >= p.N) continue;
          const int v = acc[mt][nt][i];
          if (!split)
            store(m, n, v);
          else if (direct_atomic)
            atomicAdd(static_cast<int*>(p.out) +
                          static_cast<size_t>(m) * p.N + n, v);
          else
            atomicAdd(p.work + static_cast<size_t>(m) * p.N + n, v);
        }
    if (!split || direct_atomic) return;

    // split-K: the last block to arrive on this output tile finishes it
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* count = p.work + static_cast<size_t>(p.M) * p.N +
                   blockIdx.y * gridDim.x + blockIdx.x;
      last_s = atomicAdd(count, 1) == static_cast<int>(gridDim.z) - 1;
    }
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    const int w_rows = min(W_TILE, p.N - w_base);
    for (int e = tid; e < act_valid * w_rows; e += THREADS) {
      const int m = act_base + e / w_rows, n = w_base + e % w_rows;
      store(m, n, __ldcg(p.work + static_cast<size_t>(m) * p.N + n));
    }
  }
};

// One launch of KERNEL with CFG's dynamic shared memory (opted in once per
// kernel); returns the launch's error code.
template <auto KERNEL, class Cfg, class ActLoader>
inline cudaError_t launch_gemm(const ActLoader& la, const Problem& p,
                               cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (attr != cudaSuccess) return attr;
  const int act_tile = Cfg::ACT_ROWS ? Cfg::ROWS : Cfg::COLS;
  const int w_tile = Cfg::ACT_ROWS ? Cfg::COLS : Cfg::ROWS;
  const dim3 grid((p.M + act_tile - 1) / act_tile,
                  (p.N + w_tile - 1) / w_tile,
                  p.K > p.k_chunk ? (p.K + p.k_chunk - 1) / p.k_chunk : 1);
  KERNEL<<<grid, THREADS, Cfg::SMEM, stream>>>(la, p);
  return cudaGetLastError();
}

}  // namespace radix
