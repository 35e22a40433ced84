// Radix (bit-serial) matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/radix_matmul.py:radix_matmul_pallas, the TPU
// kernel behind every linear layer and the logits layer of a compiled
// plan: (M, K) packed levels (uint8, or int32 once an avg-pool carry
// outgrows a byte) times (K, N) int8 weights, in the "fused" or
// "bitserial" dataflow, with the plane-occupancy gate and, when `mult` is
// given, the fused output-logic epilogue storing uint8 levels (else raw
// int32 accumulators).  The tile loop lives in radix_common.cuh.
//
// What bounds it on the card: at batch 8 the linear layers read their int8
// weights once per call (25088 x 4096 = 103 MB for VGG-11's fc1) for
// 2*M*K*N = 1.6 GOP, so they are memory-bound (~31 us at 3.35 TB/s).
// This first version tiles 64 x 64 outputs per block and streams each
// weight tile through shared memory once per row tile; at M <= 64 that is
// one read of the weights, but the loads are not pipelined and the
// products run on the int32 CUDA-core path, not the int8 tensor cores.
//
// C interface (bound with ctypes): pointers are device addresses, the
// stream is PyTorch's current stream; returns cudaGetLastError().

#include "radix_common.cuh"

namespace {

template <typename TA>
struct MatrixA {
  const TA* __restrict__ x;
  int M, K;
  __device__ __forceinline__ void load(int m, int k0, int vals[8]) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + j;
      vals[j] = (m < M && k < K) ? static_cast<int>(x[(size_t)m * K + k]) : 0;
    }
  }
};

template <typename TA, bool EPI>
__global__ void __launch_bounds__(radix::THREADS)
    radix_matmul_kernel(MatrixA<TA> la, const int8_t* __restrict__ w, int M,
                        int K, int N, radix::Schedule s,
                        const int* __restrict__ occ,
                        const int* __restrict__ bias,
                        const float* __restrict__ mult, void* out) {
  radix::gemm_block<MatrixA<TA>, EPI>(la, w, M, K, N, s, occ, bias, mult, out);
}

template <typename TA>
void launch(const void* x, const int8_t* w, void* out, const int* bias,
            const float* mult, const int* occ, int M, int K, int N,
            radix::Schedule s, cudaStream_t stream) {
  const dim3 grid((M + radix::BM - 1) / radix::BM,
                  (N + radix::BN - 1) / radix::BN);
  const MatrixA<TA> la{static_cast<const TA*>(x), M, K};
  if (mult != nullptr)
    radix_matmul_kernel<TA, true><<<grid, radix::THREADS, 0, stream>>>(
        la, w, M, K, N, s, occ, bias, mult, out);
  else
    radix_matmul_kernel<TA, false><<<grid, radix::THREADS, 0, stream>>>(
        la, w, M, K, N, s, occ, bias, mult, out);
}

}  // namespace

extern "C" int radix_matmul_launch(const void* x, int x_int32, const void* w,
                                   void* out, const void* bias,
                                   const void* mult, const void* occ, int M,
                                   int K, int N, int num_steps, int fused,
                                   int periods, int out_level, int pow2,
                                   void* stream) {
  const radix::Schedule s{num_steps, fused, periods, out_level, pow2};
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* b = static_cast<const int*>(bias);
  const auto* mu = static_cast<const float*>(mult);
  const auto* oc = static_cast<const int*>(occ);
  const auto st = static_cast<cudaStream_t>(stream);
  if (x_int32)
    launch<int32_t>(x, wq, out, b, mu, oc, M, K, N, s, st);
  else
    launch<uint8_t>(x, wq, out, b, mu, oc, M, K, N, s, st);
  return static_cast<int>(cudaGetLastError());
}
