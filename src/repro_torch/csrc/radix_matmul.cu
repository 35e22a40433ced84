// Radix (bit-serial) matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/radix_matmul.py:radix_matmul_pallas, the TPU
// kernel behind every linear layer and the logits layer of a compiled
// plan and behind the LM's radix FFN products: (M, K) packed levels (uint8,
// or int32 once an avg-pool carry outgrows a byte) times int8 weights held
// K-major as (N, K), in the "fused" or "bitserial" dataflow, with the
// plane-occupancy gate and, when `mult` is given, the fused output-logic
// epilogue storing uint8 levels (else raw int32 accumulators).  The
// mainloop is the int8 tensor-core GEMM of radix_common.cuh.
//
// What bounds it on the card, and what the design does about it:
//   * M <= 32 (LM decode at M = 8, the CNN's linear layers at buckets 1
//     and 8): the weight stream, e.g. 33.5 MB for Gemma-2B's w_down, 10 us
//     at 3.35 TB/s.  SmallTile puts 128 weight rows on the MMA's A side and
//     the tokens on its B side, streams the K-major weights with 16-byte
//     cp.async through a 4-stage ring, and splits K until some 2 x 132
//     blocks stream them (w_down alone has 16 weight tiles).
//   * M > 32 (LM prefill, M = 2048): operations, 137 GOP per FFN product,
//     69 us at the int8 tensor-core peak.  128 x 128 outputs per block with
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

template <class Cfg, bool WIDE, bool EPI, typename TA>
__global__ void __launch_bounds__(radix::THREADS, WIDE ? 1 : 2)
    radix_matmul_kernel(radix::RowMatrix<TA> la, radix::Problem p) {
  extern __shared__ __align__(128) uint8_t smem[];
  radix::Gemm<Cfg, WIDE, EPI, radix::RowMatrix<TA>> gemm(la, p, smem);
  gemm.run();
}

template <typename TA, class Cfg, bool EPI>
cudaError_t run(const radix::RowMatrix<TA>& la, const radix::Problem& p,
                cudaStream_t stream) {
  constexpr bool WIDE = std::is_same<TA, int32_t>::value;
  return radix::launch_gemm<radix_matmul_kernel<Cfg, WIDE, EPI, TA>, Cfg>(
      la, p, stream);
}

// tile: the index of kernels/gemm.py TILES (0 large, 1 small, 2 mid);
// the large tile's fused dataflow runs on wgmma.
template <typename TA>
cudaError_t dispatch(const radix::RowMatrix<TA>& la, const radix::Problem& p,
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

extern "C" int radix_matmul_launch(const void* x, int x_int32, const void* w,
                                   void* out, void* work, const void* bias,
                                   const void* mult, const void* occ, int M,
                                   int K, int N, int num_steps, int fused,
                                   int periods, int out_level, int pow2,
                                   int tile, int k_chunk, void* stream) {
  radix::Problem p;
  p.w = static_cast<const int8_t*>(w);
  p.M = M;
  p.N = N;
  p.K = K;
  p.k_chunk = k_chunk;
  p.w_vec = K % 16 == 0 && aligned16(w);
  p.s = radix::Schedule{num_steps, fused, periods, out_level, pow2};
  p.occ = static_cast<const int*>(occ);
  p.bias = static_cast<const int*>(bias);
  p.mult = static_cast<const float*>(mult);
  p.out = out;
  p.work = static_cast<int*>(work);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_int32) {
    const radix::RowMatrix<int32_t> la{static_cast<const int32_t*>(x), M, K,
                                       0};
    err = dispatch(la, p, tile, st);
  } else {
    const radix::RowMatrix<uint8_t> la{static_cast<const uint8_t*>(x), M, K,
                                       K % 16 == 0 && aligned16(x)};
    err = dispatch(la, p, tile, st);
  }
  return static_cast<int>(err);
}
