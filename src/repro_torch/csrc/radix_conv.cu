// Radix (bit-serial) 2-D convolution for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/radix_conv.py:radix_conv2d_pallas, the TPU kernel
// behind every conv layer of a compiled plan: a VALID convolution of a
// pre-padded (N, Hp, Wp, Cin) image of packed levels (uint8, or int32 for
// a wide avg-pool carry) with (KH, KW, Cin, Cout) int8 weights, strided
// in-kernel, in the "fused" or "bitserial" dataflow with the occupancy
// gate and the optional fused epilogue (uint8 out; int32 without `mult`).
//
// It runs as an implicit GEMM on the tile loop of radix_common.cuh:
// M = N*Ho*Wo output pixels, N = Cout, K = KH*KW*Cin in HWIO order.  Each
// A element is gathered from the image at (oh*stride + r, ow*stride + c,
// ci); only the Ho x Wo strided outputs are computed.  The TPU kernel
// holds a whole (H, W, Cin) image per block; VGG-11's first layers at 224
// need 3.2 MB per image, far over the 227 KB of shared memory a Hopper
// block can use, so this kernel tiles output pixels instead.
//
// What bounds it on the card: the convs do 2*M*K*Cout operations on ~1-13
// MB of activations, far above the int8 ridge (1979 TOP/s over
// 3.35 TB/s), so they are compute-bound (VGG-11 conv4 at batch 8: 29.6 GOP,
// ~15 us at the int8 tensor-core peak).  This first version multiplies on
// the int32 CUDA-core path with 4x4 register tiles; wgmma with int8
// operands is the route to that bound.
//
// C interface (bound with ctypes): pointers are device addresses, the
// stream is PyTorch's current stream; returns cudaGetLastError().

#include "radix_common.cuh"

namespace {

template <typename TA>
struct ImageA {
  const TA* __restrict__ x;  // (N, Hp, Wp, Cin), pre-padded
  int M, K, Ho, Wo, Hp, Wp, Cin, KW, stride;
  __device__ __forceinline__ void load(int m, int k0, int vals[8]) const {
    if (m >= M) {
#pragma unroll
      for (int j = 0; j < 8; ++j) vals[j] = 0;
      return;
    }
    const int ow = m % Wo;
    const int t = m / Wo;
    const int oh = t % Ho;
    const int b = t / Ho;
    const TA* base =
        x + (((size_t)b * Hp + (size_t)oh * stride) * Wp + (size_t)ow * stride) *
                Cin;
    int ci = k0 % Cin;  // k = (r * KW + c) * Cin + ci
    int rc = k0 / Cin;
    int c = rc % KW;
    int r = rc / KW;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + j;
      vals[j] = k < K ? static_cast<int>(
                            base[((size_t)r * Wp + c) * Cin + ci])
                      : 0;
      if (++ci == Cin) {
        ci = 0;
        if (++c == KW) {
          c = 0;
          ++r;
        }
      }
    }
  }
};

template <typename TA, bool EPI>
__global__ void __launch_bounds__(radix::THREADS)
    radix_conv2d_kernel(ImageA<TA> la, const int8_t* __restrict__ w, int M,
                        int K, int N, radix::Schedule s,
                        const int* __restrict__ occ,
                        const int* __restrict__ bias,
                        const float* __restrict__ mult, void* out) {
  radix::gemm_block<ImageA<TA>, EPI>(la, w, M, K, N, s, occ, bias, mult, out);
}

template <typename TA>
void launch(const ImageA<TA>& la, const int8_t* w, void* out, const int* bias,
            const float* mult, const int* occ, int cout, radix::Schedule s,
            cudaStream_t stream) {
  const dim3 grid((la.M + radix::BM - 1) / radix::BM,
                  (cout + radix::BN - 1) / radix::BN);
  if (mult != nullptr)
    radix_conv2d_kernel<TA, true><<<grid, radix::THREADS, 0, stream>>>(
        la, w, la.M, la.K, cout, s, occ, bias, mult, out);
  else
    radix_conv2d_kernel<TA, false><<<grid, radix::THREADS, 0, stream>>>(
        la, w, la.M, la.K, cout, s, occ, bias, mult, out);
}

}  // namespace

extern "C" int radix_conv2d_launch(const void* x, int x_int32, const void* w,
                                   void* out, const void* bias,
                                   const void* mult, const void* occ, int n,
                                   int hp, int wp, int cin, int kh, int kw,
                                   int cout, int stride, int num_steps,
                                   int fused, int periods, int out_level,
                                   int pow2, void* stream) {
  const int ho = (hp - kh) / stride + 1;
  const int wo = (wp - kw) / stride + 1;
  const radix::Schedule s{num_steps, fused, periods, out_level, pow2};
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* b = static_cast<const int*>(bias);
  const auto* mu = static_cast<const float*>(mult);
  const auto* oc = static_cast<const int*>(occ);
  const auto st = static_cast<cudaStream_t>(stream);
  const int m = n * ho * wo;
  const int k = kh * kw * cin;
  if (x_int32) {
    const ImageA<int32_t> la{static_cast<const int32_t*>(x), m, k, ho, wo,
                             hp, wp, cin, kw, stride};
    launch<int32_t>(la, wq, out, b, mu, oc, cout, s, st);
  } else {
    const ImageA<uint8_t> la{static_cast<const uint8_t*>(x), m, k, ho, wo,
                             hp, wp, cin, kw, stride};
    launch<uint8_t>(la, wq, out, b, mu, oc, cout, s, st);
  }
  return static_cast<int>(cudaGetLastError());
}
