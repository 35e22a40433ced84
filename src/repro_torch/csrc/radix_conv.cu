// Radix (bit-serial) 2-D convolution for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/radix_conv.py:radix_conv2d_pallas, the TPU kernel
// behind every conv layer of a compiled plan: a VALID convolution of a
// pre-padded (N, Hp, Wp, Cin) image of packed levels (uint8, or int32 for
// a wide avg-pool carry) with int8 weights held K-major as (Cout, KH, KW,
// Cin), strided in-kernel, in the "fused" or "bitserial" dataflow with the
// occupancy gate and the optional fused epilogue (uint8 out; int32
// without `mult`).
//
// It runs as an implicit GEMM on the int8 tensor-core mainloop of
// radix_common.cuh: M = N*Ho*Wo output pixels, N = Cout, K = KH*KW*Cin in
// (r, c, ci) order, which is the weights' K-major row.  Each A element is
// gathered from the image at (oh*stride + r, ow*stride + c, ci); only the
// Ho x Wo strided outputs are computed.  The TPU kernel holds a whole
// (H, W, Cin) image per block; VGG-11's first layers at 224 need 3.2 MB
// per image, far over the 227 KB of shared memory a Hopper block can use,
// so this kernel tiles output pixels instead.
//
// What bounds it on the card: the convs do 2*M*K*Cout operations on ~1-13
// MB of activations, far above the int8 ridge (1979 TOP/s over
// 3.35 TB/s), so they are operation-bound (VGG-11 conv4 at batch 8: 29.6
// GOP, ~15 us at the int8 tensor-core peak).  The design: u8 x s8 tiles
// of 128 pixels x 128 output channels (fused on wgmma, WgTile; bitserial
// on mma.sync, LargeTile; 64 channels on mma.sync, MidTile, where Cout <=
// 64, as in VGG's conv1), the A gather as
// 16-byte cp.async copies when Cin % 16 == 0 (each 16-channel run of one
// tap is contiguous in NHWC), a masked byte gather where it is not (VGG's
// conv1 with Cin = 3, LeNet's Cin = 1 and 6) and for int32 levels.
//
// C interface (bound with ctypes): pointers are device addresses, the
// stream is PyTorch's current stream; returns a CUDA error code.

#include <type_traits>

#include "radix_common.cuh"

namespace {

// The implicit-GEMM A operand: row m = output pixel, k = (r, c, ci).
template <typename TA>
struct ImageA {
  const TA* __restrict__ x;  // (N, Hp, Wp, Cin), pre-padded
  int M, K, Ho, Wo, Hp, Wp, Cin, KW, stride;
  int vec;  // uint8 taps by cp.async: Cin % 16 == 0 and x aligned
  __device__ __forceinline__ long long row(int m) const {
    if (m >= M) return -1;
    const int ow = m % Wo;
    const int t = m / Wo;
    const int oh = t % Ho;
    const int b = t / Ho;
    return ((static_cast<long long>(b) * Hp + oh * stride) * Wp +
            ow * stride) * Cin;
  }
  __device__ __forceinline__ void load(uint8_t* dst, long long h, int k,
                                       int g) const {
    if (h < 0) return;  // only reaches outputs that are not stored
    if (sizeof(TA) == 1 && vec) {
      if (k >= K) {
        radix::cp_async16(dst, x, false);
        return;
      }
      const int ci = k % Cin, rc = k / Cin;
      const long long tap = (static_cast<long long>(rc / KW) * Wp + rc % KW) *
                            Cin;
      radix::cp_async16(dst, x + h + tap + ci, true);
      return;
    }
    unsigned v[4] = {0u, 0u, 0u, 0u};
    int ci = k % Cin;  // k = (r * KW + c) * Cin + ci
    int rc = k / Cin;
    int c = rc % KW;
    int r = rc / KW;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (k + j < K) {
        const TA e = x[h + (static_cast<long long>(r) * Wp + c) * Cin + ci];
        v[j >> 2] |= ((static_cast<unsigned>(e) >> (8 * g)) & 0xFFu)
                     << (8 * (j & 3));
      }
      if (++ci == Cin) {
        ci = 0;
        if (++c == KW) {
          c = 0;
          ++r;
        }
      }
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  }
};

template <class Cfg, bool WIDE, bool EPI, typename TA>
__global__ void __launch_bounds__(radix::THREADS, WIDE ? 1 : 2)
    radix_conv2d_kernel(ImageA<TA> la, radix::Problem p) {
  extern __shared__ __align__(128) uint8_t smem[];
  radix::Gemm<Cfg, WIDE, std::conditional_t<EPI, uint8_t, int>, ImageA<TA>>
      gemm(la, p, smem);
  gemm.run();
}

template <typename TA, class Cfg, bool EPI>
cudaError_t run(const ImageA<TA>& la, const radix::Problem& p,
                cudaStream_t stream) {
  constexpr bool WIDE = std::is_same<TA, int32_t>::value;
  return radix::launch_gemm<radix_conv2d_kernel<Cfg, WIDE, EPI, TA>, Cfg>(
      la, p, stream);
}

// tile: the index of kernels/gemm.py TILES (0 large, 1 small, 2 mid);
// the large tile's fused dataflow runs on wgmma.
template <typename TA>
cudaError_t dispatch(const ImageA<TA>& la, const radix::Problem& p,
                     int tile, cudaStream_t stream) {
  const bool epi = p.mult != nullptr;
  if (tile == 1)
    return epi ? run<TA, radix::SmallTile, true>(la, p, stream)
               : run<TA, radix::SmallTile, false>(la, p, stream);
  if (tile == 2)
    return epi ? run<TA, radix::MidTile, true>(la, p, stream)
               : run<TA, radix::MidTile, false>(la, p, stream);
  if (p.s.fused)
    return epi ? run<TA, radix::WgTile, true>(la, p, stream)
               : run<TA, radix::WgTile, false>(la, p, stream);
  return epi ? run<TA, radix::LargeTile, true>(la, p, stream)
             : run<TA, radix::LargeTile, false>(la, p, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int radix_conv2d_launch(const void* x, int x_int32, const void* w,
                                   void* out, void* work, const void* bias,
                                   const void* mult, const void* occ, int n,
                                   int hp, int wp, int cin, int kh, int kw,
                                   int cout, int stride, int num_steps,
                                   int fused, int periods, int out_level,
                                   int pow2, int tile, int k_chunk,
                                   void* stream) {
  const int ho = (hp - kh) / stride + 1;
  const int wo = (wp - kw) / stride + 1;
  radix::Problem p;
  p.w = static_cast<const int8_t*>(w);
  p.M = n * ho * wo;
  p.N = cout;
  p.K = kh * kw * cin;
  p.k_chunk = k_chunk;
  p.w_vec = p.K % 16 == 0 && aligned16(w);
  p.s = radix::Schedule{num_steps, fused, periods, out_level, pow2};
  p.occ = static_cast<const int*>(occ);
  p.bias = static_cast<const int*>(bias);
  p.mult = static_cast<const float*>(mult);
  p.out = out;
  p.work = static_cast<int*>(work);
  p.sx = nullptr;  // the LM's dequantize only
  p.coef = 0.f;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_int32) {
    const ImageA<int32_t> la{static_cast<const int32_t*>(x), p.M, p.K, ho,
                             wo, hp, wp, cin, kw, stride, 0};
    err = dispatch(la, p, tile, st);
  } else {
    const ImageA<uint8_t> la{static_cast<const uint8_t*>(x), p.M, p.K, ho, wo,
                             hp, wp, cin, kw, stride,
                             cin % 16 == 0 && aligned16(x)};
    err = dispatch(la, p, tile, st);
  }
  return static_cast<int>(err);
}
