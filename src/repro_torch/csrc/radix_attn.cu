// Decode attention over the radix KV cache for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/radix_attn.py:radix_decode_attn_pallas, the TPU
// kernel behind every decode step of every attention layer when the LM
// serves with packed_attn: one query token per (batch, kv-head) row
// attends over the cache's T-bit levels without dequantizing them.
//
//   scores  s[i][j] = hd^-0.5 * qs[i] * sk[j] * (4/(qlvl*lvl) <qq_i, k_j>
//                     - 2/qlvl sum(qq_i) - 2/lvl sum(k_j) + hd)
//   softmax streaming over KV tiles: running max m from MASKED = -1e30,
//           masked p hard-zeroed, renormalized sum l
//   values  o[i] += 2/lvl * sum_j pw[i][j] v_j - sum_j pw[i][j],
//           pw = p * sv (the v-scales folded into the probabilities)
//   out     o / l, or o where l == 0 (a fully masked row gives 0)
//
// The integer dot <qq, k> is exact int32 (qq <= 127, levels <= 255): one
// pass over the occupancy-masked levels ("fused") or T plane passes, each
// skipped when the occupancy row says the plane is empty in the whole
// cache ("bitserial").  The value sum runs the same schedule in f32.
// Constants are rounded to f32 on the host from double, and every float
// op is an _rn intrinsic (no contracted multiply-add): the score algebra
// is the reference's plane_scores order, and each sum over a tile's slots
// is a butterfly/pairwise tree, so the plain PyTorch version
// (kernels/radix_attn.py) repeats the kernel bit for bit.
//
// Design: the TPU walks a sequential grid over KV blocks with the softmax
// state in VMEM scratch.  Hopper has no sequential grid, so one 256-thread
// block owns one (b, kv-head) row with its g query heads and loops over
// the cache itself, 32 slots per tile: the tile's K and V levels are
// staged in shared memory one byte per dim (a packed cache is unpacked in
// natural order, hi nibble = even dim, so the query needs no permutation),
// each thread forms (head, slot) scores, one warp per head runs the
// softmax update over the tile's 32 slots (one per lane), and each thread
// updates its (head, dim) entries of the f32 accumulator in shared
// memory.  Ragged edges (S not a multiple of 32, any g and hd) are masked
// in the kernel; nothing is padded on the host.
//
// What bounds it on the card: per call it reads the cache once (packed,
// S = 512, hd = 256: 128 B of K + 128 B of V + 12 B of scales and mask per
// slot), so it is memory-bound (~0.04 us per row at 3.35 TB/s).  This first
// version runs one block per row (B * Hkv blocks: 8 at batch 8 on 132
// SMs), with unpipelined tile loads and three barriers per tile, so it is
// latency-bound far above that; split-KV (flash-decode) across blocks is
// the next step.
//
// C interface (bound with ctypes): pointers are device addresses, the
// stream is PyTorch's current stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = 32;  // KV slots per tile: one per lane in the softmax
constexpr float MASKED = -1e30f;

struct Args {
  const int* qq;       // (N, g, hd) query levels
  const float* qs;     // (N, g) query scales
  const uint8_t* kq;   // (N, S, hdp) key levels
  const float* ks;     // (N, S) key scales
  const uint8_t* vq;   // (N, S, hdp) value levels
  const float* vs;     // (N, S) value scales
  const int* mask;     // (N, S) 1 = attend
  const int* occ_k;    // (1, 128) plane occupancy, or null (ungated)
  const int* occ_v;
  float* out;          // (N, g, hd)
  int g, s_len, hd, packed, num_steps, fused;
  float c_sint, c_qsum, c_ksum, c_hd, c_scale, c_v;
};

__device__ __forceinline__ int plane_bits(const int* occ, int num_steps) {
  int bits = 0;
  for (int s = 0; s < num_steps; ++s)
    bits |= ((occ == nullptr || occ[s] != 0) ? 1 : 0) << s;
  return bits;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_isum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum_j pw[j] * ((v[j] >> shift) & mask) over a tile's SLOTS slots: one
// rounded product per slot, then the pairwise tree of a warp's butterfly
// (t[k] += t[k + w], w = 16 .. 1), the order the plain version repeats.
__device__ __forceinline__ float slot_dot(const float* pw, const uint8_t* v,
                                          int stride, int shift, int mask) {
  float t[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j)
    t[j] = __fmul_rn(pw[j], (float)(((int)v[j * stride] >> shift) & mask));
#pragma unroll
  for (int w = SLOTS / 2; w > 0; w >>= 1)
#pragma unroll
    for (int k = 0; k < w; ++k) t[k] = __fadd_rn(t[k], t[k + w]);
  return t[0];
}

__global__ void __launch_bounds__(THREADS) radix_decode_attn_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = a.g, hd = a.hd;
  const int hd4 = (hd + 3) & ~3;       // dims rounded to whole words
  const int stride = hd4 + 4;          // smem bytes per slot: an odd word
                                       // count, so slot-strided reads of
                                       // one dim hit distinct banks
  const int hdp = a.packed ? hd / 2 : hd;
  int* qq_s = reinterpret_cast<int*>(smem);   // [g][hd4]
  float* o_s = reinterpret_cast<float*>(qq_s + g * hd4);  // [g][hd4]
  float* sc_s = o_s + g * hd4;         // [g][SLOTS] scores, then p * sv
  float* m_s = sc_s + g * SLOTS;       // [g] running max
  float* l_s = m_s + g;                // [g] renormalized sum
  float* alpha_s = l_s + g;            // [g] this tile's rescale
  float* pws_s = alpha_s + g;          // [g] this tile's sum of p * sv
  float* qs_s = pws_s + g;             // [g]
  int* qsum_s = reinterpret_cast<int*>(qs_s + g);     // [g]
  float* sk_s = reinterpret_cast<float*>(qsum_s + g); // [SLOTS]
  float* sv_s = sk_s + SLOTS;          // [SLOTS]
  int* valid_s = reinterpret_cast<int*>(sv_s + SLOTS);  // [SLOTS]
  uint8_t* k_s = reinterpret_cast<uint8_t*>(valid_s + SLOTS);  // [SLOTS][stride]
  uint8_t* v_s = k_s + SLOTS * stride;                          // [SLOTS][stride]

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kbits = plane_bits(a.occ_k, a.num_steps);
  const int vbits = plane_bits(a.occ_v, a.num_steps);
  // fused: mask the levels with the occupied planes (all bits ungated)
  const int kmask = a.occ_k == nullptr ? -1 : kbits;
  const int vmask = a.occ_v == nullptr ? -1 : vbits;

  for (int idx = tid; idx < g * hd4; idx += THREADS) {
    const int i = idx / hd4, d = idx - i * hd4;
    qq_s[idx] = d < hd ? a.qq[((size_t)row * g + i) * hd + d] : 0;
    o_s[idx] = 0.0f;
  }
  for (int idx = tid; idx < 2 * SLOTS * stride; idx += THREADS) k_s[idx] = 0;
  if (tid < g) {
    m_s[tid] = MASKED;
    l_s[tid] = 0.0f;
    qs_s[tid] = a.qs[(size_t)row * g + tid];
  }
  __syncthreads();
  for (int i = warp; i < g; i += WARPS) {
    int s = 0;
    for (int d = lane; d < hd; d += 32) s += qq_s[i * hd4 + d];
    s = warp_isum(s);
    if (lane == 0) qsum_s[i] = s;
  }

  const size_t base = (size_t)row * a.s_len;
  for (int j0 = 0; j0 < a.s_len; j0 += SLOTS) {
    const int nb = min(SLOTS, a.s_len - j0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < SLOTS * hdp; idx += THREADS) {
      const int j = idx / hdp, c = idx - j * hdp;
      uint8_t kb = 0, vb = 0;
      if (j < nb) {
        const size_t off = (base + j0 + j) * hdp + c;
        kb = a.kq[off];
        vb = a.vq[off];
      }
      if (a.packed) {
        k_s[j * stride + 2 * c] = kb >> 4;
        k_s[j * stride + 2 * c + 1] = kb & 0xF;
        v_s[j * stride + 2 * c] = vb >> 4;
        v_s[j * stride + 2 * c + 1] = vb & 0xF;
      } else {
        k_s[j * stride + c] = kb;
        v_s[j * stride + c] = vb;
      }
    }
    if (tid < SLOTS) {
      const bool in = tid < nb;
      sk_s[tid] = in ? a.ks[base + j0 + tid] : 0.0f;
      sv_s[tid] = in ? a.vs[base + j0 + tid] : 0.0f;
      valid_s[tid] = in && a.mask[base + j0 + tid] != 0;
    }
    __syncthreads();

    // scores: one (head, slot) pair per thread and pass
    for (int pidx = tid; pidx < g * SLOTS; pidx += THREADS) {
      const int i = pidx / SLOTS, j = pidx - i * SLOTS;
      float score = MASKED;
      if (valid_s[j]) {
        const int* q = qq_s + i * hd4;
        const uint8_t* k = k_s + j * stride;
        int sint = 0, ksum = 0;
        for (int d = 0; d < hd4; d += 4) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(k + d);
          ksum += (w & 0xFF) + ((w >> 8) & 0xFF) + ((w >> 16) & 0xFF) +
                  (w >> 24);
        }
        if (a.fused) {
          for (int d = 0; d < hd4; d += 4) {
            const int4 qv = *reinterpret_cast<const int4*>(q + d);
            const uint32_t w = *reinterpret_cast<const uint32_t*>(k + d);
            sint += qv.x * ((int)(w & 0xFF) & kmask) +
                    qv.y * ((int)((w >> 8) & 0xFF) & kmask) +
                    qv.z * ((int)((w >> 16) & 0xFF) & kmask) +
                    qv.w * ((int)(w >> 24) & kmask);
          }
        } else {
          for (int s = 0; s < a.num_steps; ++s) {
            if (!((kbits >> s) & 1)) continue;  // empty plane: skipped
            int part = 0;
            for (int d = 0; d < hd4; d += 4) {
              const int4 qv = *reinterpret_cast<const int4*>(q + d);
              const uint32_t w =
                  (*reinterpret_cast<const uint32_t*>(k + d) >> s) &
                  0x01010101u;
              part += qv.x * (int)(w & 1) + qv.y * (int)((w >> 8) & 1) +
                      qv.z * (int)((w >> 16) & 1) + qv.w * (int)(w >> 24);
            }
            sint += part << s;
          }
        }
        const float raw = __fadd_rn(
            __fsub_rn(__fsub_rn(__fmul_rn(a.c_sint, __int2float_rn(sint)),
                                __fmul_rn(a.c_qsum,
                                          __int2float_rn(qsum_s[i]))),
                      __fmul_rn(a.c_ksum, __int2float_rn(ksum))),
            a.c_hd);
        score = __fmul_rn(__fmul_rn(__fmul_rn(a.c_scale, qs_s[i]), sk_s[j]),
                          raw);
      }
      sc_s[pidx] = score;
    }
    __syncthreads();

    // streaming softmax: one warp per head, one slot per lane
    for (int i = warp; i < g; i += WARPS) {
      const float s = sc_s[i * SLOTS + lane];
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float alpha = expf(__fsub_rn(m_old, m_new));
      const float p = valid_s[lane] ? expf(__fsub_rn(s, m_new)) : 0.0f;
      const float pw = __fmul_rn(p, sv_s[lane]);
      const float psum = warp_sum(p);
      const float pwsum = warp_sum(pw);
      sc_s[i * SLOTS + lane] = pw;
      if (lane == 0) {
        m_s[i] = m_new;
        l_s[i] = __fadd_rn(__fmul_rn(l_s[i], alpha), psum);
        alpha_s[i] = alpha;
        pws_s[i] = pwsum;
      }
    }
    __syncthreads();

    // values: each thread owns (head, dim) entries of the accumulator
    for (int idx = tid; idx < g * hd; idx += THREADS) {
      const int i = idx / hd, d = idx - i * hd;
      const float* pw = sc_s + i * SLOTS;
      const uint8_t* v = v_s + d;
      float vint = 0.0f;
      if (a.fused) {
        vint = slot_dot(pw, v, stride, 0, vmask);
      } else {
        for (int s = 0; s < a.num_steps; ++s) {
          if (!((vbits >> s) & 1)) continue;  // empty plane: skipped
          vint = __fadd_rn(vint, __fmul_rn(slot_dot(pw, v, stride, s, 1),
                                           (float)(1 << s)));
        }
      }
      const float contrib = __fsub_rn(__fmul_rn(a.c_v, vint), pws_s[i]);
      float* o = o_s + i * hd4 + d;
      *o = __fadd_rn(__fmul_rn(*o, alpha_s[i]), contrib);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * hd; idx += THREADS) {
    const int i = idx / hd, d = idx - i * hd;
    const float l = l_s[i], o = o_s[i * hd4 + d];
    a.out[((size_t)row * g + i) * hd + d] = l > 0.0f ? __fdiv_rn(o, l) : o;
  }
}

}  // namespace

extern "C" int radix_decode_attn_launch(
    const void* qq, const void* qs, const void* kq, const void* ks,
    const void* vq, const void* vs, const void* mask, const void* occ_k,
    const void* occ_v, void* out, int n, int g, int s_len, int hd, int packed,
    int num_steps, int fused, int smem_bytes, float c_sint, float c_qsum,
    float c_ksum, float c_hd, float c_scale, float c_v, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        radix_decode_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Args a{static_cast<const int*>(qq),      static_cast<const float*>(qs),
               static_cast<const uint8_t*>(kq),  static_cast<const float*>(ks),
               static_cast<const uint8_t*>(vq),  static_cast<const float*>(vs),
               static_cast<const int*>(mask),    static_cast<const int*>(occ_k),
               static_cast<const int*>(occ_v),   static_cast<float*>(out),
               g, s_len, hd, packed, num_steps, fused,
               c_sint, c_qsum, c_ksum, c_hd, c_scale, c_v};
  radix_decode_attn_kernel<<<n, THREADS, smem_bytes,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
