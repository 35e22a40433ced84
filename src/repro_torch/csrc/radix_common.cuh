// Shared tile loop of the radix kernels: the plane loop, the occupancy
// gate and the fused output-logic epilogue.
//
// Counterpart of the helpers repro/kernels/radix_conv.py imports from
// repro/kernels/radix_matmul.py (_accumulate_tile, gated, occ_mask,
// _project_levels / _epilogue_store).  Both radix_matmul.cu and
// radix_conv.cu run the same integer GEMM tile loop over
// C[M, N] = sum_k A[m, k] * W[k, n]; they differ only in how a block
// gathers its A tile (a dense row-major matrix, or an implicit-GEMM view
// of a pre-padded NHWC image).
//
// Tiling: one 256-thread block per BM x BN output tile, the K loop inside
// the block over BK-deep shared-memory tiles of levels and weights
// (widened to int32), each thread holding a TM x TN int32 accumulator in
// registers.  Ragged edges are masked with zeros on load and skipped on
// store, so callers pass logical shapes.
//
// Dataflows (identical sums, as in the reference):
//   fused     - one pass over the packed levels, masked with the occupied
//               planes' bits when an occupancy row is given;
//   bitserial - inside each K tile, T plane passes over the same
//               shared-memory tile, Horner-combined (tile = 2*tile +
//               plane . W); a pass whose plane is empty in the whole input
//               (occ[s] == 0, uniform across the block) is skipped.  The
//               phase schedule (periods > 1) replays T*periods passes with
//               weights 2^shift and floor-divides the tile by periods.
//   Both equal the product of the packed levels by linearity, so the
//   per-K-tile partial sums add up to the reference's accumulator.
//
// Epilogue (repro/kernels/radix_matmul.py:_epilogue_store): on the last K
// tile, in registers, floor(f32(acc + bias) * mult) (round-to-nearest
// int->float conversion and multiply, no contraction), clamp to
// [0, out_level], optional pow2 floor, store uint8.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace radix {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // contraction depth per shared-memory tile
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int THREADS = 256;  // (BM / TM) * (BN / TN)
constexpr int MAX_STEPS = 31; // plane bits an int32 level can carry

struct Schedule {
  int num_steps;  // plane bits the bitserial dataflow extracts
  int fused;      // 1: one pass over packed levels; 0: bitserial passes
  int periods;    // phase-schedule replay count (bitserial)
  int out_level;  // epilogue clamp ceiling
  int pow2;       // epilogue floors onto {0} | {2^k}
};

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

// One BK slice: add a's plane pass (bits masked by `mask`, scaled by
// `weight`) times W into tile.  a_s is [BK][BM], b_s is [BK][BN].
__device__ __forceinline__ void slice_pass(const int* a_s, const int* b_s,
                                           int tile[TM][TN], int row0,
                                           int col0, int shift, int mask,
                                           int weight) {
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    const int4 av = *reinterpret_cast<const int4*>(a_s + k * BM + row0);
    const int4 bv = *reinterpret_cast<const int4*>(b_s + k * BN + col0);
    const int a[TM] = {((av.x >> shift) & mask) * weight,
                       ((av.y >> shift) & mask) * weight,
                       ((av.z >> shift) & mask) * weight,
                       ((av.w >> shift) & mask) * weight};
    const int b[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) tile[i][j] += a[i] * b[j];
  }
}

// The block's whole GEMM: K loop over shared-memory tiles, the dataflow's
// passes per tile, then the int32 or epilogue store.  ALoader gathers
// eight consecutive-k A elements of one row: load(m, k0, vals).
template <class ALoader, bool EPI>
__device__ __forceinline__ void gemm_block(const ALoader& la,
                                           const int8_t* __restrict__ w,
                                           int M, int K, int N, Schedule s,
                                           const int* __restrict__ occ,
                                           const int* __restrict__ bias,
                                           const float* __restrict__ mult,
                                           void* __restrict__ out) {
  __shared__ __align__(16) int a_s[BK * BM];
  __shared__ __align__(16) int b_s[BK * BN];
  __shared__ int occ_s[MAX_STEPS + 1];

  const int tid = threadIdx.x;
  const int m_base = blockIdx.x * BM;
  const int n_base = blockIdx.y * BN;
  if (tid <= MAX_STEPS)
    occ_s[tid] = (occ == nullptr || tid >= s.num_steps) ? 1 : occ[tid];
  __syncthreads();
  // fused dataflow's mask: all bits ungated, else the occupied planes'
  int mask = -1;
  if (occ != nullptr) {
    mask = 0;
    for (int b = 0; b < s.num_steps; ++b) mask |= (occ_s[b] ? 1 : 0) << b;
  }

  const int row0 = (tid / (BN / TN)) * TM;  // this thread's output rows
  const int col0 = (tid % (BN / TN)) * TN;  // and columns, in the tile
  const int a_row = tid / (BK / 8);         // A loader: one row, 8 k's
  const int a_k = (tid % (BK / 8)) * 8;
  const int b_k = tid / (BN / 8);           // B loader: one k, 8 columns
  const int b_n = (tid % (BN / 8)) * 8;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    int vals[8];
    la.load(m_base + a_row, k0 + a_k, vals);
#pragma unroll
    for (int j = 0; j < 8; ++j) a_s[(a_k + j) * BM + a_row] = vals[j];
    const int kk = k0 + b_k;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n_base + b_n + j;
      b_s[b_k * BN + b_n + j] =
          (kk < K && n < N) ? static_cast<int>(w[(size_t)kk * N + n]) : 0;
    }
    __syncthreads();

    if (s.fused) {
      slice_pass(a_s, b_s, acc, row0, col0, 0, mask, 1);
    } else {
      int tile[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) tile[i][j] = 0;
      const int passes = s.num_steps * s.periods;
      for (int t = 0; t < passes; ++t) {
        const int shift = s.num_steps - 1 - (t % s.num_steps);
        if (s.periods == 1) {  // Horner: every step shifts, gated or not
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) tile[i][j] *= 2;
        }
        if (!occ_s[shift]) continue;  // empty plane: the pass is skipped
        slice_pass(a_s, b_s, tile, row0, col0, shift, 1,
                   s.periods == 1 ? 1 : (1 << shift));
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += s.periods == 1 ? tile[i][j]
                                      : floor_div(tile[i][j], s.periods);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m_base + row0 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n_base + col0 + j;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      if (EPI) {
        static_cast<uint8_t*>(out)[o] = epilogue(
            acc[i][j], bias ? bias[n] : 0, mult[n], s.out_level, s.pow2);
      } else {
        static_cast<int*>(out)[o] = acc[i][j];
      }
    }
  }
}

}  // namespace radix
