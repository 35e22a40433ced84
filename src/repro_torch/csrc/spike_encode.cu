// Radix spike encoder for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/spike_encode.py:spike_encode_pallas, the TPU
// kernel behind ops.radix_encode: float32 -> packed radix levels (uint8),
// q = clip(floor(x * c), 0, 2^T - 1) with c = float32(2^T / scale) folded
// on the host in double, as JAX folds the Python constant.  The float op
// order is the reference kernel's (one multiply, then floor), not
// encoding.quantize's divide-then-multiply; the two can differ by a level
// at boundaries.  __fmul_rn keeps the product a single rounded multiply.
//
// What bounds it on the card: it reads 4 bytes and writes 1 per element
// and does one multiply, so it is memory-bound (5 bytes over 3.35 TB/s).
// One thread per element in a grid-stride loop keeps every warp's loads
// and stores contiguous; there is no reuse to stage.
//
// C interface (bound with ctypes): pointers are device addresses, the
// stream is PyTorch's current stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    spike_encode_kernel(const float* __restrict__ x, uint8_t* __restrict__ out,
                        int64_t n, float c, float lvl) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const float q = floorf(__fmul_rn(x[i], c));
    out[i] = static_cast<uint8_t>(fminf(fmaxf(q, 0.0f), lvl));
  }
}

}  // namespace

extern "C" int spike_encode_launch(const void* x, void* out, long long n,
                                   float c, int num_steps, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks_needed = (n + THREADS - 1) / THREADS;
  // 132 SMs x 8 resident 256-thread blocks fill the card; larger inputs
  // loop
  const int blocks = static_cast<int>(blocks_needed < 132 * 8
                                          ? blocks_needed : 132 * 8);
  spike_encode_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(out), n, c,
      static_cast<float>((1 << num_steps) - 1));
  return static_cast<int>(cudaGetLastError());
}
