// Radix (bit-serial) matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/radix_matmul.py:radix_matmul_pallas, the TPU
// kernel behind every linear layer and the logits layer of a compiled
// plan and behind the LM's radix FFN products: (M, K) packed levels (uint8,
// or int32 once an avg-pool carry outgrows a byte) times int8 weights held
// K-major as (N, K), in the "fused" or "bitserial" dataflow, with the
// plane-occupancy gate.  The output is one of three: raw int32
// accumulators; with `mult`, the CNN's fused output-logic epilogue storing
// uint8 levels; with `sx` (uint8 levels only), the LM's dequantize storing
// bf16 or f32, ((2/lvl * acc - colsum[n]) * sx[m]) * sw[n] in the order of
// lm/radix.py's float32 glue, bit for bit.  The mainloop is the int8
// tensor-core GEMM of radix_common.cuh.
//
// Beside it, radix_quantize_kernel makes the LM's activation levels in one
// pass (lm/radix.py:_radix_activation, which replaces no TPU kernel: the
// reference leaves it to XLA): one block a row reads the row once into
// shared memory, takes its absmax, and writes the uint8 levels of
// (x / s + 1) / 2 and the f32 scale s = absmax + 1e-9.  Its GLU variants
// read a gate and an up row instead and quantize bf16(act(g)) * u, the
// product PyTorch's `F.silu(g) * u` (or tanh-GELU) rounds, without
// writing it.  Bytes bound it: 2 read and 1 written a bf16 value (a GLU's
// 4 read), 0.06 ms for GLM4-9B's 16,384 x 4,096 rows at 3.35 TB/s.
//
// What bounds it on the card, and what the design does about it:
//   * M <= 32 (LM decode at M = 8, the CNN's linear layers at buckets 1
//     and 8): the weight stream, e.g. 33.5 MB for Gemma-2B's w_down, 10 us
//     at 3.35 TB/s.  SmallTile puts 128 weight rows on the MMA's A side and
//     the tokens on its B side, streams the K-major weights with 16-byte
//     cp.async through a 4-stage ring, and splits K until some 2 x 132
//     blocks stream them (w_down alone has 16 weight tiles).
//   * M > 32 (LM prefill, M = 16,384 for 8 prompts of 2048): operations,
//     1.84 TOP per GLM4-9B FFN product, 0.93 ms at the int8 tensor-core
//     peak; its bf16 output (0.45 GB, 0.13 ms at 3.35 TB/s) is half the
//     bytes of int32 sums.  128 x 128 outputs per block with
//     the levels and weights both streamed by cp.async: the fused dataflow
//     on wgmma u8 x s8 (WgTile), bitserial on mma.sync u8 x s8 (LargeTile),
//     which multiplies the MMA work by the T plane passes.
// The A rows come by 16-byte cp.async when K % 16 == 0 (uint8 levels),
// else by a masked byte loader; int32 levels load one byte group a sweep.
//
// C interface (bound with ctypes): pointers are device addresses, the
// stream is PyTorch's current stream; returns a CUDA error code.

#include <type_traits>

#include "radix_common.cuh"

namespace {

template <class Cfg, bool WIDE, typename OutT, typename TA>
__global__ void __launch_bounds__(radix::THREADS, WIDE ? 1 : 2)
    radix_matmul_kernel(radix::RowMatrix<TA> la, radix::Problem p) {
  extern __shared__ __align__(128) uint8_t smem[];
  radix::Gemm<Cfg, WIDE, OutT, radix::RowMatrix<TA>> gemm(la, p, smem);
  gemm.run();
}

template <typename TA, typename OutT, class Cfg>
cudaError_t run(const radix::RowMatrix<TA>& la, const radix::Problem& p,
                cudaStream_t stream) {
  constexpr bool WIDE = std::is_same<TA, int32_t>::value;
  return radix::launch_gemm<radix_matmul_kernel<Cfg, WIDE, OutT, TA>, Cfg>(
      la, p, stream);
}

// tile: the index of kernels/gemm.py TILES (0 large, 1 small, 2 mid);
// the large tile's fused dataflow runs on wgmma.
template <typename TA, typename OutT>
cudaError_t dispatch(const radix::RowMatrix<TA>& la, const radix::Problem& p,
                     int tile, cudaStream_t stream) {
  if (tile == 1) return run<TA, OutT, radix::SmallTile>(la, p, stream);
  if (tile == 2) return run<TA, OutT, radix::MidTile>(la, p, stream);
  if (p.s.fused) return run<TA, OutT, radix::WgTile>(la, p, stream);
  return run<TA, OutT, radix::LargeTile>(la, p, stream);
}

// out: 0 int32 sums (uint8 levels with `mult`), 1 bf16, 2 f32 dequantized
// (the column sums in `bias`, the column scales in `mult`)
template <typename TA>
cudaError_t dispatch_out(const radix::RowMatrix<TA>& la,
                         const radix::Problem& p, int out, int tile,
                         cudaStream_t stream) {
  if (out == 0)
    return p.mult != nullptr ? dispatch<TA, uint8_t>(la, p, tile, stream)
                             : dispatch<TA, int>(la, p, tile, stream);
  if constexpr (std::is_same<TA, uint8_t>::value) {
    if (out == 1) return dispatch<TA, __nv_bfloat16>(la, p, tile, stream);
    if (out == 2) return dispatch<TA, float>(la, p, tile, stream);
  }
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// ---------------------------------------------------------------------------
// The one-pass activation quantize.
// ---------------------------------------------------------------------------

constexpr int QTHREADS = 256;
constexpr int QUANT_SMEM = 200 * 1024;  // the longest row it holds, bytes

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// PyTorch's activations at float (ATen's ActivationSiluKernel.cu and
// ActivationGeluKernel.cu, the tanh approximation), operation for
// operation; the GELU's inner sum is one fused multiply-add, as nvcc
// contracts PyTorch's `x + kKappa * x_cube`.
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = static_cast<float>(  // M_SQRT2 * M_2_SQRTPI / 2
      1.41421356237309504880 * 1.12837916709551257390 * 0.5);
  constexpr float kKappa = 0.044715f;
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(kBeta, __fmaf_rn(kKappa, cube, x));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// ACT 1: silu(g) * u, 2: gelu_tanh(g) * u, each rounded to T as PyTorch
// rounds the activation's output and then the product.
template <int ACT, typename T>
__device__ __forceinline__ T glu(T g, T u) {
  const float a = ACT == 1 ? silu(to_float(g)) : gelu_tanh(to_float(g));
  return radix::from_float<T>(
      __fmul_rn(to_float(radix::from_float<T>(a)), to_float(u)));
}

// One block a row: the row (or its GLU product) into shared memory and its
// absmax (exact in any order), then the levels of (x / s + 1) / 2 and the
// row's scale s; `h` (tests): the row as quantized, or null.
template <typename T, int ACT>
__global__ void __launch_bounds__(QTHREADS)
    radix_quantize_kernel(const T* __restrict__ x, const T* __restrict__ up,
                          T* __restrict__ h, uint8_t* __restrict__ q,
                          float* __restrict__ s, int cols, int lvl,
                          int vec) {
  extern __shared__ __align__(16) uint8_t qsmem[];
  __shared__ float warp_max[QTHREADS / 32];
  constexpr int V = 16 / sizeof(T);  // values a 16-byte chunk holds
  T* row = reinterpret_cast<T*>(qsmem);
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  float amax = 0.0f;
  if (vec) {
    for (int c = threadIdx.x; c < cols / V; c += QTHREADS) {
      alignas(16) T v[V];
      *reinterpret_cast<uint4*>(v) =
          reinterpret_cast<const uint4*>(x + base)[c];
      if constexpr (ACT != 0) {
        alignas(16) T u[V];
        *reinterpret_cast<uint4*>(u) =
            reinterpret_cast<const uint4*>(up + base)[c];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = glu<ACT>(v[j], u[j]);
      }
      reinterpret_cast<uint4*>(row)[c] = *reinterpret_cast<const uint4*>(v);
#pragma unroll
      for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(to_float(v[j])));
    }
  } else {
    for (int j = threadIdx.x; j < cols; j += QTHREADS) {
      T v = x[base + j];
      if constexpr (ACT != 0) v = glu<ACT>(v, up[base + j]);
      row[j] = v;
      amax = fmaxf(amax, fabsf(to_float(v)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();  // the row and the warps' maxima are in shared memory
#pragma unroll
  for (int w = 0; w < QTHREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float sc = __fadd_rn(amax, 1e-9f);
  if (threadIdx.x == 0) s[blockIdx.x] = sc;
  const float fl = static_cast<float>(lvl);
  const auto level = [&](T v) -> unsigned {
    const float u =
        __fmul_rn(__fadd_rn(__fdiv_rn(to_float(v), sc), 1.0f), 0.5f);
    const float r = rintf(__fmul_rn(u, fl));
    return static_cast<unsigned>(fminf(fmaxf(r, 0.0f), fl));
  };
  if (vec) {
    for (int c = threadIdx.x; c < cols / V; c += QTHREADS) {
      alignas(16) T v[V];
      *reinterpret_cast<uint4*>(v) = reinterpret_cast<const uint4*>(row)[c];
      unsigned w[V / 4];
#pragma unroll
      for (int i = 0; i < V / 4; ++i) {
        w[i] = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) w[i] |= level(v[4 * i + j]) << (8 * j);
      }
      if constexpr (V == 8)
        reinterpret_cast<uint2*>(q + base)[c] = make_uint2(w[0], w[1]);
      else
        reinterpret_cast<unsigned*>(q + base)[c] = w[0];
    }
  } else {
    for (int j = threadIdx.x; j < cols; j += QTHREADS)
      q[base + j] = static_cast<uint8_t>(level(row[j]));
  }
  if (h != nullptr)
    for (int j = threadIdx.x; j < cols; j += QTHREADS) h[base + j] = row[j];
}

template <typename T, int ACT>
cudaError_t quantize(const void* x, const void* up, void* h, void* q, void* s,
                     int rows, int cols, int lvl, cudaStream_t stream) {
  const auto kernel = radix_quantize_kernel<T, ACT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, QUANT_SMEM);
  if (attr != cudaSuccess) return attr;
  constexpr unsigned V = 16 / sizeof(T);
  const int vec = cols % V == 0 && aligned(x, 16) &&
                  (ACT == 0 || aligned(up, 16)) && aligned(q, V);
  kernel<<<rows, QTHREADS, cols * sizeof(T), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(up), static_cast<T*>(h),
      static_cast<uint8_t*>(q), static_cast<float*>(s), cols, lvl, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t quantize_act(const void* x, const void* up, void* h, void* q,
                         void* s, int act, int rows, int cols, int lvl,
                         cudaStream_t stream) {
  if (act == 0) return quantize<T, 0>(x, up, h, q, s, rows, cols, lvl, stream);
  if (act == 1) return quantize<T, 1>(x, up, h, q, s, rows, cols, lvl, stream);
  if (act == 2) return quantize<T, 2>(x, up, h, q, s, rows, cols, lvl, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// out_kind: 0 int32 (uint8 levels with `mult`), 1 bf16, 2 f32: the
// dequantize, `bias` the weights' column sums, `mult` their scales, `sx`
// the rows' scales, `coef` 2 / lvl.
extern "C" int radix_matmul_launch(const void* x, int x_int32, const void* w,
                                   void* out, void* work, const void* bias,
                                   const void* mult, const void* occ, int M,
                                   int K, int N, int num_steps, int fused,
                                   int periods, int out_level, int pow2,
                                   int tile, int k_chunk, int out_kind,
                                   const void* sx, float coef, void* stream) {
  radix::Problem p;
  p.w = static_cast<const int8_t*>(w);
  p.M = M;
  p.N = N;
  p.K = K;
  p.k_chunk = k_chunk;
  p.w_vec = K % 16 == 0 && aligned(w, 16);
  p.s = radix::Schedule{num_steps, fused, periods, out_level, pow2};
  p.occ = static_cast<const int*>(occ);
  p.bias = static_cast<const int*>(bias);
  p.mult = static_cast<const float*>(mult);
  p.out = out;
  p.work = static_cast<int*>(work);
  p.sx = static_cast<const float*>(sx);
  p.coef = coef;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_int32) {
    const radix::RowMatrix<int32_t> la{static_cast<const int32_t*>(x), M, K,
                                       0};
    err = dispatch_out(la, p, out_kind, tile, st);
  } else {
    const radix::RowMatrix<uint8_t> la{static_cast<const uint8_t*>(x), M, K,
                                       K % 16 == 0 && aligned(x, 16)};
    err = dispatch_out(la, p, out_kind, tile, st);
  }
  return static_cast<int>(err);
}

// (rows, cols) activations (x_bf16: bf16, else f32) -> (rows, cols) uint8
// levels and (rows) f32 scales; act 1 / 2: x is the gate and `up` the up
// product of a SwiGLU / GeGLU; `h`: null, or where the quantized rows go.
extern "C" int radix_quantize_launch(const void* x, const void* up, void* h,
                                     void* q, void* s, int x_bf16, int act,
                                     int rows, int cols, int num_steps,
                                     void* stream) {
  const size_t bytes = static_cast<size_t>(cols) * (x_bf16 ? 2 : 4);
  if (rows < 0 || cols < 1 || bytes > QUANT_SMEM || num_steps < 1 ||
      num_steps > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int lvl = (1 << num_steps) - 1;
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_bf16 ? quantize_act<__nv_bfloat16>(x, up, h, q, s, act, rows, cols,
                                           lvl, st)
             : quantize_act<float>(x, up, h, q, s, act, rows, cols, lvl, st));
}
