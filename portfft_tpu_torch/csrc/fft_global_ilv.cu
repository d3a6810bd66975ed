// K18 `global_ilv`: batched GLOBAL transform n = G1*G2 whose subs are
// g = A*128 with A = 2^a*3^b <= 16, in one cooperative launch whose
// intermediate stays in L2 (fft_global_bf.cuh holds the machinery, shared
// with K5).
//
// Replaces portfft_tpu/ops/pallas_global_ilv.py::global_ilv_raw_call (the
// tuned engine {"eng": 8}).  Its function is K5's; its slab DFTs take the
// mixed factors A = 3, 6, 9 and 12 as well (radix-3 butterflies:
// cos 2pi/3 = -1/2 exact, sqrt(3)/2 one rounded constant), so 3*2^k and
// 9*2^k subs such as 384 run single sweep.  The TPU kernel keeps (re, im)
// interleaved in its lanes so that no transpose separates them, and
// multiplies by i with a lane pair-swap; here every value is a float2 from
// load to store, as in K5, so that trick has no counterpart.  Its pass-2
// butterfly is a DIF with digit-reversed slab positions; the slab DFT here
// runs in registers in natural order, so no position map is needed.
// Bound on the H100: 16 bytes per point to and from device memory, against
// 8*(A1 + A2 + 256) flops per point.
#include "fft_global_bf.cuh"

// x (2*batch*g1*g2 floats) -> y (may equal x) through the scratch s of
// 2*chunk*g1*g2 floats; the arguments are K5's (pf_global_bf), with A1, A2
// in {1, 2, 3, 4, 6, 8, 9, 12, 16}.  Returns a cudaError_t.
extern "C" int pf_global_ilv(const float* x, float* y, float* s, int g1,
                             int g2, int t1, int t2, int sign,
                             const float* w128r, const float* w128i,
                             const float* u1r, const float* u1i,
                             const float* u2r, const float* u2i,
                             const float* gar, const float* gai,
                             const float* gbr, const float* gbi,
                             int64_t batch, int64_t chunk, float scale,
                             void* stream) {
  const pfft_bf::Bf p{reinterpret_cast<const float2*>(x),
                      reinterpret_cast<float2*>(y),
                      reinterpret_cast<float2*>(s),
                      g1, g2, t1, t2, sign, w128r, w128i, u1r, u1i, u2r, u2i,
                      gar, gai, gbr, gbi, nullptr, nullptr, nullptr, nullptr,
                      batch, chunk, scale};
  // Both factors powers of two: the slab DFT is K5's radix-2 butterfly,
  // and the kernel instantiated for those factors alone keeps three blocks
  // an SM (kMinBlocks).
  const bool pow2 = pfft_bf::factor_ok(g1, false) && pfft_bf::factor_ok(g2, false);
  return pfft_bf::launch_bf(
      pow2 ? pfft_bf::sweep_kernel<false> : pfft_bf::sweep_kernel<true>, p,
      true, static_cast<cudaStream_t>(stream));
}
