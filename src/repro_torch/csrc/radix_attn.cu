// Decode attention over the radix KV cache for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/radix_attn.py:radix_decode_attn_pallas, the TPU
// kernel behind every decode step of every attention layer when the LM
// serves with packed_attn: one query token per (batch, kv-head) row
// attends over the cache's T-bit levels without dequantizing them.
//
//   query   qq = rint(((q / s) + 1) * 0.5 * qlvl), s = absmax(q) + 1e-9
//   scores  s[i][j] = hd^-0.5 * qs[i] * sk[j] * (4/(qlvl*lvl) <qq_i, k_j>
//                     - 2/qlvl sum(qq_i) - 2/lvl sum(k_j) + hd)
//   softmax streaming over KV tiles: running max m from MASKED = -1e30,
//           masked p hard-zeroed, renormalized sum l
//   values  o[i] += 2/lvl * sum_j pw[i][j] v_j - sum_j pw[i][j],
//           pw = p * sv (the v-scales folded into the probabilities)
//   out     o / l, or o where l == 0 (a fully masked row gives 0)
//
// The integer dot <qq, k> is exact (qq <= 255, levels <= 255, 32-bit
// accumulate): __dp4a over four levels a word, in one pass ("fused") or
// T plane passes of (k >> s) & 0x01010101 shifted << s ("bitserial").  A
// packed cache is dotted as it lies: the hi nibbles of a word are the
// even dims and the lo nibbles the odd ones, so the block stores its
// query levels as (even, odd) word pairs.  The value sum runs the same
// schedule in f32.  Constants are rounded to f32 on the host from double,
// and every float op is an _rn intrinsic (no contracted multiply-add):
// the score algebra is the reference's plane_scores order, and each sum
// over a tile's slots, or over the splits, is a butterfly/pairwise tree,
// so the plain PyTorch version (kernels/radix_attn.py) repeats the kernel
// bit for bit.
//
// Design (split-KV, "flash-decode"): the TPU walks a sequential grid over
// KV blocks with the softmax state in VMEM scratch.  Here one block owns
// one (row = (batch, kv-head), split) pair, a split being `split`
// consecutive slots cut into 32-slot tiles, so a batch-8 decode over 512
// slots runs 128 blocks instead of 8.  The block has min(g, 8) warps for
// the row's group of g query heads, and warp w owns heads w, w + 8, ...
// (any g: GLM4-9B's 16, RecurrentGemma-2B's 10), so K/V bytes are read
// from device memory once per block whatever the group.  A head's state
// (m, l, qs, qsum, o) lives in shared memory, and each head's arithmetic
// is the same whichever warp runs it; any hd with whole 4-byte cache
// words, each lane taking units lane, lane + 32, ... of the head:
//   - each warp loads its first head's query from the caller's bf16/f32
//     q before the mask (the two latencies overlap) and quantizes its
//     heads once a tile is in flight;
//   - the mask row is read as the caller's bool bytes with one
//     __ballot_sync per tile; a tile with no valid slot is neither loaded
//     nor computed (its update would leave (m, l, o) exactly as they are),
//     and a split with none writes (MASKED, 0) and stops;
//   - tiles arrive by 16-byte cp.async (4-byte when a row is not 16-byte
//     aligned), masked slots zero-filled, double-buffered so the next
//     valid tile is in flight while this one is scored;
//   - per tile, each warp walks its heads: QK^T, lane j scoring slot j;
//     softmax: warp reductions over the 32 lanes; PV: each lane owns
//     4-dim units of the head, holds the tile's 32 levels of a unit in
//     registers and sums the 32 slots as a pairwise tree taken in
//     bit-reversed slot order (the butterfly's order); a bitserial plane
//     bit times pw is a select of pw or pw * 0, the bits of the multiply;
//   - bitserial plane passes are gated on the OR of the levels the warp
//     read in this tile (__reduce_or_sync).  An empty plane adds exactly
//     +0 to the int32 dot and to the non-negative value sums, so gating
//     on any superset of the occupied planes gives the same bits as not
//     gating, and no whole-cache occupancy prepass is needed;
//   - each split leaves (o, m, l) in a workspace; the last block of the
//     row to arrive (an int counter it resets) combines them: m = max,
//     l and o pairwise trees over the splits of x_i * exp(m_i - m)
//     (zero-padded to a power of two), then o / l.  No float atomics:
//     their order would change from run to run.  One split skips the
//     workspace and is the same bits as a combine of one.
//
// What bounds it on the card: per call it reads the valid slots of the
// cache once (packed, hd = 256: 128 B of K + 128 B of V + 8 B of scales
// per slot) and the query, so its byte bound is well under a microsecond
// at B = 8, S = 512 (3.35 TB/s).  At that size each block does one tile,
// and the time is a chain of dependent latencies: the mask row, the tile
// and query loads, one tile of work, the state write and arrival (a
// __threadfence and an atomic), then the combine's L2 round trips in the
// row's last block.  At long contexts the value sums (32 products and a
// tree per slot, dim and pass) take the larger part.
//
// C interface (bound with ctypes): pointers are device addresses, `dims`
// and `consts` host arrays (order in kernels/radix_attn.py:_DIMS), the
// stream is PyTorch's current stream; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 32;       // KV slots per tile: one per lane
constexpr int MAX_WARPS = 8;    // warps per block; each loops over heads
constexpr int MAX_LOG_SPLITS = 5;   // <= 32 splits a row
constexpr size_t MAX_SMEM = 232448;   // dynamic shared memory a block can use
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ONES = 0x01010101u;

enum Dim {
  D_HKV, D_G, D_S, D_HD, D_STEPS, D_GATE, D_QLVL, D_SPLIT, D_NSPLIT,
  D_VEC16, D_PACKED, D_FUSED, D_QBF16,
  D_QB, D_QH, D_KB, D_KS, D_KH, D_VB, D_VS, D_VH,
  D_KSB, D_KSS, D_KSH, D_VSB, D_VSS, D_VSH, D_MB, D_MS, D_ROWS
};

struct Params {
  const void* q;
  const uint8_t* kq;
  const float* ks;
  const uint8_t* vq;
  const float* vs;
  const uint8_t* mask;
  float* out;     // (B, H, hd)
  float* work;    // (N, nsplit, g, hd) o, then (N, nsplit, g, 2) (m, l)
  int* count;     // (N,) arrivals
  int hkv, g, s_len, hd, steps, gate, qlvl, split, nsplit, vec16;
  long long q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
  long long ks_b, ks_s, ks_h, vs_b, vs_s, vs_h, m_b, m_s;
  float c_sint, c_qsum, c_ksum, c_hd, c_scale, c_v;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// sum over the 32 lanes as a butterfly: the pairwise tree tree_sum repeats
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ int warp_isum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// an integer 0 <= v < 2^23 as float, exactly
__device__ __forceinline__ float int_f32(unsigned v) {
  return __fsub_rn(__int_as_float(0x4B000000 | v), 8388608.0f);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (16 or 4); zero-filled when !ok (nothing is read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int rev_bits(int p, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((p >> i) & 1) << (bits - 1 - i);
  return r;
}

// Level d (0..3) of a 4-dim unit: a packed unit is two bytes (dims 4u,
// 4u+1 in the first: hi, lo), an unpacked one a word of four bytes.
template <bool PACKED>
__device__ __forceinline__ unsigned unit_level(unsigned w, int d) {
  if (PACKED) {
    const int shift = (d >> 1) * 8 + ((d & 1) ? 0 : 4);
    return (w >> shift) & 0xFu;
  }
  return (w >> (8 * d)) & 0xFFu;
}

// t[d] = sum over the tile's 32 slots of pw[j] * f(level_d(lv[j])), a
// pairwise tree over slots taken in bit-reversed order: the warp
// butterfly's tree (t[k] + t[k + 16], then + 8, ...), bit for bit.
// PLANE < 0: the whole level; else bit PLANE of it.
template <bool PACKED>
__device__ __forceinline__ void slot_tree(const float (&pw)[SLOTS],
                                          const unsigned (&lv)[SLOTS],
                                          int plane, float (&t)[4]) {
  float st[5][4];
  float x[4];
#pragma unroll
  for (int r = 0; r < SLOTS; ++r) {
    const int j = rev_bits(r, 5);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const unsigned v = unit_level<PACKED>(lv[j], d);
      // a plane bit times pw: pw itself, or pw * 0 (the same bits as
      // __fmul_rn(pw, 0.0f or 1.0f), one select instead of a convert)
      x[d] = plane < 0 ? __fmul_rn(pw[j], int_f32(v))
             : ((v >> plane) & 1u) ? pw[j]
                                   : __fmul_rn(pw[j], 0.0f);
    }
#pragma unroll
    for (int lvl = 0; lvl < 5; ++lvl) {
      if (r & (1 << lvl)) {
#pragma unroll
        for (int d = 0; d < 4; ++d) x[d] = __fadd_rn(st[lvl][d], x[d]);
      } else {
#pragma unroll
        for (int d = 0; d < 4; ++d) st[lvl][d] = x[d];
        break;
      }
    }
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) t[d] = x[d];
}

// The row's split states merged for one head: l and o are pairwise trees
// over the 2^LOG_W (zero-padded) splits of x_i * exp(m_i - m), taken in
// bit-reversed order (tree_sum's order over the split index), then o / l.
// e_s[i] = exp(m_i - m), or < 0 where split i left no o (empty, padding);
// le_s[i] = l_i * exp(m_i - m).  Unrolled, so every split's o is in
// flight at once.
template <int LOG_W>
__device__ __forceinline__ void combine_row(const float* e_s,
                                            const float* le_s,
                                            const float* o_row, size_t stride,
                                            float* dst, int lane,
                                            int nunits) {
  constexpr int W = 1 << LOG_W;
  float lst[LOG_W + 1];
  float lt = 0.0f;
#pragma unroll
  for (int pp = 0; pp < W; ++pp) {
    float x = le_s[rev_bits(pp, LOG_W)];
#pragma unroll
    for (int lvl = 0; lvl <= LOG_W; ++lvl) {
      if ((pp >> lvl) & 1) {
        x = __fadd_rn(lst[lvl], x);
      } else {
        lst[lvl] = x;
        break;
      }
    }
    lt = x;
  }
  // every split's o of this lane's units in flight at once (one unit at a
  // time past 16 splits, to bound the registers)
  constexpr int UNITS = W <= 16 ? 2 : 1;
  for (int k0 = 0; lane + 32 * k0 < nunits; k0 += UNITS) {
    float4 v[UNITS][W];
#pragma unroll
    for (int kk = 0; kk < UNITS; ++kk) {
      const int u = lane + 32 * (k0 + kk);
#pragma unroll
      for (int pp = 0; pp < W; ++pp) {
        const int r = rev_bits(pp, LOG_W);
        v[kk][pp] = u < nunits && e_s[r] >= 0.0f
                        ? __ldcg(reinterpret_cast<const float4*>(
                              o_row + r * stride + 4 * u))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int kk = 0; kk < UNITS; ++kk) {
      const int u = lane + 32 * (k0 + kk);
      if (u >= nunits) break;
      float st[LOG_W + 1][4];
      float x[4];
#pragma unroll
      for (int pp = 0; pp < W; ++pp) {
        const float e = e_s[rev_bits(pp, LOG_W)];
        x[0] = e < 0.0f ? 0.0f : __fmul_rn(v[kk][pp].x, e);
        x[1] = e < 0.0f ? 0.0f : __fmul_rn(v[kk][pp].y, e);
        x[2] = e < 0.0f ? 0.0f : __fmul_rn(v[kk][pp].z, e);
        x[3] = e < 0.0f ? 0.0f : __fmul_rn(v[kk][pp].w, e);
#pragma unroll
        for (int lvl = 0; lvl <= LOG_W; ++lvl) {
          if ((pp >> lvl) & 1) {
#pragma unroll
            for (int d = 0; d < 4; ++d) x[d] = __fadd_rn(st[lvl][d], x[d]);
          } else {
#pragma unroll
            for (int d = 0; d < 4; ++d) st[lvl][d] = x[d];
            break;
          }
        }
      }
      *reinterpret_cast<float4*>(dst + 4 * u) = make_float4(
          lt > 0.0f ? __fdiv_rn(x[0], lt) : x[0],
          lt > 0.0f ? __fdiv_rn(x[1], lt) : x[1],
          lt > 0.0f ? __fdiv_rn(x[2], lt) : x[2],
          lt > 0.0f ? __fdiv_rn(x[3], lt) : x[3]);
    }
  }
}

// <qq, k> and sum(k) over one cache word and its query word(s).
template <bool PACKED>
__device__ __forceinline__ void dot_word(unsigned w, unsigned qa, unsigned qb,
                                         unsigned& sint, unsigned& ksum) {
  if (PACKED) {
    const unsigned hi = (w >> 4) & 0x0F0F0F0Fu, lo = w & 0x0F0F0F0Fu;
    sint = __dp4a(hi, qa, sint);
    sint = __dp4a(lo, qb, sint);
    ksum = __dp4a(hi + lo, ONES, ksum);
  } else {
    sint = __dp4a(w, qa, sint);
    ksum = __dp4a(w, ONES, ksum);
  }
}

// plane s of one cache word dotted with its query word(s)
template <bool PACKED>
__device__ __forceinline__ unsigned plane_word(unsigned w, unsigned qa,
                                               unsigned qb, int s,
                                               unsigned part) {
  if (PACKED) {
    part = __dp4a((w >> (4 + s)) & ONES, qa, part);
    return __dp4a((w >> s) & ONES, qb, part);
  }
  return __dp4a((w >> s) & ONES, qa, part);
}

template <bool PACKED, bool FUSED, typename QT>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    radix_decode_attn_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int split = blockIdx.x, row = blockIdx.y;
  const int b = row / p.hkv, h = row - b * p.hkv;
  const int g = p.g, hd = p.hd;
  const int hdp = PACKED ? hd / 2 : hd;
  const int nch = (hdp + 15) / 16;               // 16-byte chunks a row
  const int rs = (nch | 1) * 16;                 // odd chunk stride: the
                                                 // 8 lanes of a quarter
                                                 // warp hit 8 bank groups
  const int qrow = nch * 16 * (PACKED ? 2 : 1);  // query bytes a head
  const int buf_bytes = 2 * SLOTS * rs + 2 * SLOTS * 4;
  const int nunits = hd / 4;
  unsigned char* q_s = smem + 2 * buf_bytes;                  // [g][qrow]
  float* pw_s = reinterpret_cast<float*>(q_s + g * qrow);     // [g][SLOTS]
  float* o_s = pw_s + g * SLOTS;                              // [g][hd]
  float* st_s = o_s + g * hd;   // [g][4]: m, l, qs, qsum (int)
  unsigned* bits_s = reinterpret_cast<unsigned*>(st_s + 4 * g);  // tiles

  const int s0 = split * p.split;
  const int s_end = min(p.s_len, s0 + p.split);
  const int ntiles = (s_end - s0 + SLOTS - 1) / SLOTS;

  // this warp's first query head (dims lane + 32 i, i < 8), loaded before
  // the mask so the two latencies overlap; the warp's other heads, and
  // dims past 256, are read where they are quantized.  Each head's state
  // starts at (MASKED, 0, o = 0).
  const QT* qb = static_cast<const QT*>(p.q) + b * p.q_b;
  float qv[8];
  {
    const QT* qp = qb + static_cast<long long>(h * g + warp) * p.q_h;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      qv[i] = lane + 32 * i < hd ? to_f32(qp[lane + 32 * i]) : 0.0f;
  }
  for (int hh = warp; hh < g; hh += nwarps) {
    for (int u = lane; u < nunits; u += 32)
      reinterpret_cast<float4*>(o_s + hh * hd)[u] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (lane == 0) {
      st_s[4 * hh] = MASKED;
      st_s[4 * hh + 1] = 0.0f;
    }
  }

  // valid slots of each tile, one bit per slot: a ballot over the mask row
  for (int t = warp; t < ntiles; t += nwarps) {
    const int s = s0 + t * SLOTS + lane;
    const bool ok = s < s_end && p.mask[b * p.m_b + s * p.m_s] != 0;
    const unsigned bits = __ballot_sync(FULL, ok);
    if (lane == 0) bits_s[t] = bits;
  }
  __syncthreads();
  auto next_tile = [&](int t, unsigned& bits) -> int {
    for (; t < ntiles; ++t) {
      bits = bits_s[t];
      if (bits) break;
    }
    return t;
  };
  auto load_tile = [&](int t, unsigned bits, int buf) {
    unsigned char* kb = smem + buf * buf_bytes;
    unsigned char* vb = kb + SLOTS * rs;
    float* ksb = reinterpret_cast<float*>(vb + SLOTS * rs);
    float* vsb = ksb + SLOTS;
    const long long base = s0 + t * SLOTS;
    const uint8_t* krow = p.kq + b * p.k_b + h * p.k_h;
    const uint8_t* vrow = p.vq + b * p.v_b + h * p.v_h;
    if (p.vec16) {
      for (int idx = tid; idx < 2 * SLOTS * nch; idx += nthreads) {
        const int which = idx >= SLOTS * nch;
        const int e = idx - which * SLOTS * nch;
        const int j = e / nch, c = e - j * nch;
        const bool ok = (bits >> j) & 1u;
        const uint8_t* src = which ? vrow + (base + j) * p.v_s
                                   : krow + (base + j) * p.k_s;
        cp_async<16>((which ? vb : kb) + j * rs + c * 16,
                     ok ? src + c * 16 : p.kq, ok);
      }
    } else {
      const int nw = hdp / 4;
      for (int idx = tid; idx < 2 * SLOTS * nw; idx += nthreads) {
        const int which = idx >= SLOTS * nw;
        const int e = idx - which * SLOTS * nw;
        const int j = e / nw, c = e - j * nw;
        const bool ok = (bits >> j) & 1u;
        const uint8_t* src = which ? vrow + (base + j) * p.v_s
                                   : krow + (base + j) * p.k_s;
        cp_async<4>((which ? vb : kb) + j * rs + c * 4,
                    ok ? src + c * 4 : p.kq, ok);
      }
    }
    for (int idx = tid; idx < 2 * SLOTS; idx += nthreads) {
      const int which = idx >= SLOTS, j = idx - which * SLOTS;
      const bool ok = (bits >> j) & 1u;
      const float* src =
          which ? p.vs + b * p.vs_b + (base + j) * p.vs_s + h * p.vs_h
                : p.ks + b * p.ks_b + (base + j) * p.ks_s + h * p.ks_h;
      cp_async<4>((which ? vsb : ksb) + j, ok ? src : p.ks, ok);
    }
    cp_async_commit();
  };

  unsigned cur_bits = 0;
  int cur = next_tile(0, cur_bits);
  if (cur < ntiles) {
    if (hdp % 16) {   // bytes past a row's end in its last chunk read as 0
      const int pad = nch * 16 - hdp;
      for (int idx = tid; idx < 4 * SLOTS * pad; idx += nthreads) {
        const int r = idx / pad;   // (buffer, K|V, slot) row
        smem[(r / (2 * SLOTS)) * buf_bytes + (r % (2 * SLOTS)) * rs + hdp +
             idx % pad] = 0;
      }
    }
    load_tile(cur, cur_bits, 0);

    // each head of this warp quantized as quantize_q does
    const float qlvl = static_cast<float>(p.qlvl);
    for (int hh = warp; hh < g; hh += nwarps) {
      const QT* qp = qb + static_cast<long long>(h * g + hh) * p.q_h;
      const bool first = hh == warp;
      float amax = 0.0f;
      if (first) {
#pragma unroll
        for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(qv[i]));
      }
      for (int d = lane + (first ? 256 : 0); d < hd; d += 32)
        amax = fmaxf(amax, fabsf(to_f32(qp[d])));
      const float qs = __fadd_rn(warp_max(amax), 1e-9f);
      unsigned char* qr = q_s + hh * qrow;
      int qsum = 0;
      auto quantize = [&](int d, float x) {
        const float u = __fmul_rn(__fadd_rn(__fdiv_rn(x, qs), 1.0f), 0.5f);
        const int lv = static_cast<int>(
            fminf(fmaxf(rintf(__fmul_rn(u, qlvl)), 0.0f), qlvl));
        qsum += lv;
        // packed: each 8-dim group as (dims 0,2,4,6 | dims 1,3,5,7)
        const int r = d & 7;
        qr[PACKED ? (d & ~7) + ((r & 1) ? 4 : 0) + (r >> 1) : d] =
            static_cast<unsigned char>(lv);
      };
      if (first) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (lane + 32 * i < hd) quantize(lane + 32 * i, qv[i]);
      }
      for (int d = lane + (first ? 256 : 0); d < hd; d += 32)
        quantize(d, to_f32(qp[d]));
      for (int d = hd + lane; d < qrow; d += 32) qr[d] = 0;
      qsum = warp_isum(qsum);
      if (lane == 0) {
        st_s[4 * hh + 2] = qs;
        reinterpret_cast<int*>(st_s)[4 * hh + 3] = qsum;
      }
    }
    __syncwarp();

    int buf = 0;
    while (true) {
      unsigned nxt_bits = 0;
      const int nxt = next_tile(cur + 1, nxt_bits);
      if (nxt < ntiles) {
        load_tile(nxt, nxt_bits, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      const unsigned char* kb = smem + buf * buf_bytes;
      const unsigned char* vb = kb + SLOTS * rs;
      const float* ksb = reinterpret_cast<const float*>(vb + SLOTS * rs);
      const float* vsb = ksb + SLOTS;
      const bool valid = (cur_bits >> lane) & 1u;
      const unsigned char* krow = kb + lane * rs;

      for (int hh = warp; hh < g; hh += nwarps) {
        const unsigned char* qr = q_s + hh * qrow;
        const float m = st_s[4 * hh], l = st_s[4 * hh + 1];
        const float qs = st_s[4 * hh + 2];
        const int qsum = reinterpret_cast<const int*>(st_s)[4 * hh + 3];

        // QK^T: lane j scores slot j against head hh
        unsigned sint = 0, ksum = 0;
        if (FUSED) {
          for (int c = 0; c < nch; ++c) {
            const uint4 kw = *reinterpret_cast<const uint4*>(krow + c * 16);
            if (PACKED) {
              const uint4 qa = *reinterpret_cast<const uint4*>(qr + c * 32);
              const uint4 qb2 =
                  *reinterpret_cast<const uint4*>(qr + c * 32 + 16);
              dot_word<true>(kw.x, qa.x, qa.y, sint, ksum);
              dot_word<true>(kw.y, qa.z, qa.w, sint, ksum);
              dot_word<true>(kw.z, qb2.x, qb2.y, sint, ksum);
              dot_word<true>(kw.w, qb2.z, qb2.w, sint, ksum);
            } else {
              const uint4 qa = *reinterpret_cast<const uint4*>(qr + c * 16);
              dot_word<false>(kw.x, qa.x, 0, sint, ksum);
              dot_word<false>(kw.y, qa.y, 0, sint, ksum);
              dot_word<false>(kw.z, qa.z, 0, sint, ksum);
              dot_word<false>(kw.w, qa.w, 0, sint, ksum);
            }
          }
        } else {
          unsigned occ = 0;
          for (int c = 0; c < nch; ++c) {
            const uint4 kw = *reinterpret_cast<const uint4*>(krow + c * 16);
            const unsigned ws[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const unsigned w = ws[i];
              if (PACKED) {
                const unsigned hi = (w >> 4) & 0x0F0F0F0Fu,
                               lo = w & 0x0F0F0F0Fu;
                ksum = __dp4a(hi + lo, ONES, ksum);
                occ |= hi | lo;
              } else {
                ksum = __dp4a(w, ONES, ksum);
                occ |= w;
              }
            }
          }
          unsigned planes = (1u << p.steps) - 1u;
          if (p.gate) {   // planes empty in every row this warp read: skipped
            occ = __reduce_or_sync(FULL, occ);
            occ |= occ >> 16;
            occ |= occ >> 8;
            planes &= occ;
          }
          for (int s = 0; s < p.steps; ++s) {
            if (!((planes >> s) & 1u)) continue;
            unsigned part = 0;
            for (int c = 0; c < nch; ++c) {
              const uint4 kw = *reinterpret_cast<const uint4*>(krow + c * 16);
              if (PACKED) {
                const uint4 qa = *reinterpret_cast<const uint4*>(qr + c * 32);
                const uint4 qb2 =
                    *reinterpret_cast<const uint4*>(qr + c * 32 + 16);
                part = plane_word<true>(kw.x, qa.x, qa.y, s, part);
                part = plane_word<true>(kw.y, qa.z, qa.w, s, part);
                part = plane_word<true>(kw.z, qb2.x, qb2.y, s, part);
                part = plane_word<true>(kw.w, qb2.z, qb2.w, s, part);
              } else {
                const uint4 qa = *reinterpret_cast<const uint4*>(qr + c * 16);
                part = plane_word<false>(kw.x, qa.x, 0, s, part);
                part = plane_word<false>(kw.y, qa.y, 0, s, part);
                part = plane_word<false>(kw.z, qa.z, 0, s, part);
                part = plane_word<false>(kw.w, qa.w, 0, s, part);
              }
            }
            sint += part << s;
          }
        }
        const float raw = __fadd_rn(
            __fsub_rn(__fsub_rn(__fmul_rn(p.c_sint, __int2float_rn((int)sint)),
                                __fmul_rn(p.c_qsum, __int2float_rn(qsum))),
                      __fmul_rn(p.c_ksum, __int2float_rn((int)ksum))),
            p.c_hd);
        const float score =
            valid ? __fmul_rn(__fmul_rn(__fmul_rn(p.c_scale, qs), ksb[lane]),
                              raw)
                  : MASKED;

        // streaming softmax over the tile's 32 slots
        const float m_new = fmaxf(m, warp_max(score));
        const float alpha = expf(__fsub_rn(m, m_new));
        const float pr = valid ? expf(__fsub_rn(score, m_new)) : 0.0f;
        const float pwl = __fmul_rn(pr, vsb[lane]);
        const float psum = warp_sum(pr);
        const float pws = warp_sum(pwl);
        pw_s[hh * SLOTS + lane] = pwl;
        __syncwarp();   // every lane has read (m, l) and written its pw
        if (lane == 0) {
          st_s[4 * hh] = m_new;
          st_s[4 * hh + 1] = __fadd_rn(__fmul_rn(l, alpha), psum);
        }
        float pw[SLOTS];
#pragma unroll
        for (int j = 0; j < SLOTS; j += 4) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(pw_s + hh * SLOTS + j);
          pw[j] = v4.x;
          pw[j + 1] = v4.y;
          pw[j + 2] = v4.z;
          pw[j + 3] = v4.w;
        }

        // PV: this lane's 4-dim units u = lane + 32 k, two at a time (their
        // value trees are independent chains), the tile's 32 levels of a
        // unit in registers, o in shared memory; the loops are uniform
        // over the warp
        for (int k0 = 0; 32 * k0 < nunits; k0 += 2) {
#pragma unroll
          for (int k = k0; k < k0 + 2; ++k) {
            if (32 * k >= nunits) break;
            const int u = lane + 32 * k;
            const bool has = u < nunits;
            unsigned lv[SLOTS];
            unsigned occ = 0;
#pragma unroll
            for (int j = 0; j < SLOTS; ++j) {
              const unsigned char* src = vb + j * rs;
              lv[j] = !has ? 0u
                      : PACKED
                          ? *reinterpret_cast<const uint16_t*>(src + 2 * u)
                          : *reinterpret_cast<const uint32_t*>(src + 4 * u);
              occ |= lv[j];
            }
            float vint[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (FUSED) {
              slot_tree<PACKED>(pw, lv, -1, vint);
            } else {
              unsigned planes = (1u << p.steps) - 1u;
              if (p.gate) {
                if (PACKED) {
                  occ = (occ | (occ >> 4)) & 0x0F0Fu;
                  occ |= occ >> 8;
                } else {
                  occ |= occ >> 16;
                  occ |= occ >> 8;
                }
                planes &= __reduce_or_sync(FULL, occ);
              }
              for (int s = 0; s < p.steps; ++s) {
                if (!((planes >> s) & 1u)) continue;
                float t[4];
                slot_tree<PACKED>(pw, lv, s, t);
#pragma unroll
                for (int d = 0; d < 4; ++d)
                  vint[d] = __fadd_rn(
                      vint[d], __fmul_rn(t[d], static_cast<float>(1 << s)));
              }
            }
            if (has) {
              float4* op = reinterpret_cast<float4*>(o_s + hh * hd) + u;
              float4 o = *op;
              o.x = __fadd_rn(__fmul_rn(o.x, alpha),
                              __fsub_rn(__fmul_rn(p.c_v, vint[0]), pws));
              o.y = __fadd_rn(__fmul_rn(o.y, alpha),
                              __fsub_rn(__fmul_rn(p.c_v, vint[1]), pws));
              o.z = __fadd_rn(__fmul_rn(o.z, alpha),
                              __fsub_rn(__fmul_rn(p.c_v, vint[2]), pws));
              o.w = __fadd_rn(__fmul_rn(o.w, alpha),
                              __fsub_rn(__fmul_rn(p.c_v, vint[3]), pws));
              *op = o;
            }
          }
        }
      }
      __syncthreads();   // the buffer is refilled two tiles on
      if (nxt >= ntiles) break;
      cur = nxt;
      cur_bits = nxt_bits;
      buf ^= 1;
    }
  }

  const int nrows = gridDim.y;
  if (p.nsplit == 1) {   // the combine of one split is the identity
    for (int hh = warp; hh < g; hh += nwarps) {
      const float l = st_s[4 * hh + 1];
      const float4* src = reinterpret_cast<const float4*>(o_s + hh * hd);
      float4* dst = reinterpret_cast<float4*>(
          p.out + (static_cast<size_t>(row) * g + hh) * hd);
      for (int u = lane; u < nunits; u += 32) {
        float4 v = src[u];
        v.x = l > 0.0f ? __fdiv_rn(v.x, l) : v.x;
        v.y = l > 0.0f ? __fdiv_rn(v.y, l) : v.y;
        v.z = l > 0.0f ? __fdiv_rn(v.z, l) : v.z;
        v.w = l > 0.0f ? __fdiv_rn(v.w, l) : v.w;
        dst[u] = v;
      }
    }
    return;
  }

  // this split's state per head; an empty split (l == 0, o == 0) writes
  // no o
  float* ml = p.work + static_cast<size_t>(nrows) * p.nsplit * g * hd;
  for (int hh = warp; hh < g; hh += nwarps) {
    const size_t state =
        (static_cast<size_t>(row) * p.nsplit + split) * g + hh;
    const float m = st_s[4 * hh], l = st_s[4 * hh + 1];
    if (l != 0.0f) {
      const float4* src = reinterpret_cast<const float4*>(o_s + hh * hd);
      float4* dst = reinterpret_cast<float4*>(p.work + state * hd);
      for (int u = lane; u < nunits; u += 32) dst[u] = src[u];
    }
    if (lane == 0) {
      ml[2 * state] = m;
      ml[2 * state + 1] = l;
    }
  }

  // the last block of the row to arrive combines the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_s = atomicAdd(p.count + row, 1) == p.nsplit - 1;
    if (last_s) atomicExch(p.count + row, 0);   // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  int log_w = 0;
  while ((1 << log_w) < p.nsplit) ++log_w;
  const int w = 1 << log_w;
  float* e_s = reinterpret_cast<float*>(smem) + warp * 2 * w;  // [w] exp
  float* le_s = e_s + w;                                       // [w] l*exp
  const float* ml_row = ml + static_cast<size_t>(row) * p.nsplit * g * 2;
  const size_t stride = static_cast<size_t>(g) * hd;   // split to split
  for (int hh = warp; hh < g; hh += nwarps) {
    float mx = MASKED;
    for (int r = lane; r < p.nsplit; r += 32)
      mx = fmaxf(mx, __ldcg(ml_row + 2 * (r * g + hh)));
    mx = warp_max(mx);
    for (int r = lane; r < w; r += 32) {
      float e = -1.0f, le = 0.0f;   // e < 0: no o to read (empty or padding)
      if (r < p.nsplit) {
        const float mr = __ldcg(ml_row + 2 * (r * g + hh));
        const float lr = __ldcg(ml_row + 2 * (r * g + hh) + 1);
        const float er = expf(__fsub_rn(mr, mx));
        le = __fmul_rn(lr, er);
        if (lr != 0.0f) e = er;
      }
      e_s[r] = e;
      le_s[r] = le;
    }
    __syncwarp();
    const float* o_row =
        p.work + static_cast<size_t>(row) * p.nsplit * g * hd + hh * hd;
    float* dst = p.out + (static_cast<size_t>(row) * g + hh) * hd;
    const int nu = nunits;
    switch (log_w) {
      case 0: combine_row<0>(e_s, le_s, o_row, stride, dst, lane, nu); break;
      case 1: combine_row<1>(e_s, le_s, o_row, stride, dst, lane, nu); break;
      case 2: combine_row<2>(e_s, le_s, o_row, stride, dst, lane, nu); break;
      case 3: combine_row<3>(e_s, le_s, o_row, stride, dst, lane, nu); break;
      case 4: combine_row<4>(e_s, le_s, o_row, stride, dst, lane, nu); break;
      default: combine_row<5>(e_s, le_s, o_row, stride, dst, lane, nu);
    }
    __syncwarp();   // e_s is refilled for the warp's next head
  }
}

template <bool PACKED, bool FUSED, typename QT>
cudaError_t launch(const Params& p, int nrows, size_t smem,
                   cudaStream_t stream) {
  auto kernel = radix_decode_attn_kernel<PACKED, FUSED, QT>;
  if (smem > 48 * 1024) {   // past the default dynamic limit: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.nsplit, nrows);
  kernel<<<grid, 32 * (p.g < MAX_WARPS ? p.g : MAX_WARPS), smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool PACKED, bool FUSED>
cudaError_t launch_q(const Params& p, bool qbf16, int nrows, size_t smem,
                     cudaStream_t stream) {
  return qbf16 ? launch<PACKED, FUSED, __nv_bfloat16>(p, nrows, smem, stream)
               : launch<PACKED, FUSED, float>(p, nrows, smem, stream);
}

}  // namespace

extern "C" int radix_decode_attn_launch(const void* q, const void* kq,
                                        const void* ks, const void* vq,
                                        const void* vs, const void* mask,
                                        void* out, void* work, void* count,
                                        const long long* dims,
                                        const float* consts, void* stream) {
  Params p;
  p.q = q;
  p.kq = static_cast<const uint8_t*>(kq);
  p.ks = static_cast<const float*>(ks);
  p.vq = static_cast<const uint8_t*>(vq);
  p.vs = static_cast<const float*>(vs);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<float*>(out);
  p.work = static_cast<float*>(work);
  p.count = static_cast<int*>(count);
  p.hkv = static_cast<int>(dims[D_HKV]);
  p.g = static_cast<int>(dims[D_G]);
  p.s_len = static_cast<int>(dims[D_S]);
  p.hd = static_cast<int>(dims[D_HD]);
  p.steps = static_cast<int>(dims[D_STEPS]);
  p.gate = static_cast<int>(dims[D_GATE]);
  p.qlvl = static_cast<int>(dims[D_QLVL]);
  p.split = static_cast<int>(dims[D_SPLIT]);
  p.nsplit = static_cast<int>(dims[D_NSPLIT]);
  p.vec16 = static_cast<int>(dims[D_VEC16]);
  p.q_b = dims[D_QB];
  p.q_h = dims[D_QH];
  p.k_b = dims[D_KB];
  p.k_s = dims[D_KS];
  p.k_h = dims[D_KH];
  p.v_b = dims[D_VB];
  p.v_s = dims[D_VS];
  p.v_h = dims[D_VH];
  p.ks_b = dims[D_KSB];
  p.ks_s = dims[D_KSS];
  p.ks_h = dims[D_KSH];
  p.vs_b = dims[D_VSB];
  p.vs_s = dims[D_VSS];
  p.vs_h = dims[D_VSH];
  p.m_b = dims[D_MB];
  p.m_s = dims[D_MS];
  p.c_sint = consts[0];
  p.c_qsum = consts[1];
  p.c_ksum = consts[2];
  p.c_hd = consts[3];
  p.c_scale = consts[4];
  p.c_v = consts[5];
  const bool packed = dims[D_PACKED] != 0, fused = dims[D_FUSED] != 0;
  const bool qbf16 = dims[D_QBF16] != 0;
  if (p.g < 1 || p.hd < 4 || p.nsplit > (1 << MAX_LOG_SPLITS))
    return static_cast<int>(cudaErrorInvalidValue);
  // smem: two (K, V, k-scale, v-scale) tile buffers (reused by the
  // combine), then per head the query levels, the scale-folded
  // probabilities, o and (m, l, qs, qsum), then the tiles' valid-slot bits
  // (kernels/radix_attn.py:smem_bytes repeats the sum)
  const int hdp = packed ? p.hd / 2 : p.hd;
  const int nch = (hdp + 15) / 16;
  const size_t buf = 2 * SLOTS * ((nch | 1) * 16) + 2 * SLOTS * 4;
  const size_t per_head = static_cast<size_t>(nch) * 16 * (packed ? 2 : 1) +
                          SLOTS * 4 + static_cast<size_t>(p.hd) * 4 + 16;
  size_t smem = 2 * buf + static_cast<size_t>(p.g) * per_head +
                static_cast<size_t>(p.split / SLOTS) * 4;
  const size_t combine = static_cast<size_t>(MAX_WARPS) * 2 * 4 *
                         (1 << MAX_LOG_SPLITS);
  if (smem < combine) smem = combine;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(dims[D_ROWS]);   // B * Hkv
  cudaError_t e;
  if (packed)
    e = fused ? launch_q<true, true>(p, qbf16, n, smem, st)
              : launch_q<true, false>(p, qbf16, n, smem, st);
  else
    e = fused ? launch_q<false, true>(p, qbf16, n, smem, st)
              : launch_q<false, false>(p, qbf16, n, smem, st);
  return static_cast<int>(e);
}
