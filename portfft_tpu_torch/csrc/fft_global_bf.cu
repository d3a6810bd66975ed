// K5 `global_bf`, K5-ov `global_bf_ov` and K19 `global_bf2`: batched
// GLOBAL transform n = G1*G2, butterfly-factored, in one cooperative launch
// whose intermediate stays in L2 (fft_global_bf.cuh holds the machinery).
//
// Replace portfft_tpu/ops/pallas_global_bf.py::global_bf_raw_call,
// global_bf_ov_raw_call and global_bf2_raw_call (the tuned engines
// {"eng": 7}, {"eng": 7, "ov": 1} and {"eng": 7, "bf2": 1}).  Each sub is
// g = A*128, A a power of two <= 16.
//   K5:    per chunk, pass 1 into the slot, barrier, pass 2, barrier;
//   K5-ov: round r runs pass 1 of chunk r and pass 2 of chunk r-1 over two
//          slots, one barrier a round;
//   K19:   K5 with pass 1's low twiddle factor GB formed from B1t and B2
//          held in shared memory, where K5 streams it: (2 + 2/A1)*8n bytes
//          of device memory a transform become 2*8n.  The 128 KiB of B1t
//          leave room for one block an SM, and at 2048 points for a tile of
//          one column (cuda_global_bf.bf2_tile).
// Bound on the H100: 16 bytes per point to and from device memory (the
// scratch round trip in L2), against 8*(A1 + A2 + 256) flops per point.
#include "fft_global_bf.cuh"

namespace {

pfft_bf::Bf make_bf(const float* x, float* y, float* s, int g1, int g2, int t1,
                    int t2, int sign, const float* w128r, const float* w128i,
                    const float* u1r, const float* u1i, const float* u2r,
                    const float* u2i, const float* gar, const float* gai,
                    const float* gbr, const float* gbi, const float* b1r,
                    const float* b1i, const float* b2r, const float* b2i,
                    int64_t batch, int64_t chunk, float scale) {
  return pfft_bf::Bf{reinterpret_cast<const float2*>(x),
                     reinterpret_cast<float2*>(y), reinterpret_cast<float2*>(s),
                     g1, g2, t1, t2, sign, w128r, w128i, u1r, u1i, u2r, u2i,
                     gar, gai, gbr, gbi, b1r, b1i, b2r, b2i, batch, chunk, scale};
}

}  // namespace

// x (2*batch*g1*g2 floats) -> y (may equal x) through the scratch s: K5 and
// K19 one slot of 2*chunk*g1*g2 floats, K5-ov two.  t1, t2: columns per tile
// of pass 1 and pass 2; sign: the direction (the butterfly's constants).
// w128r/w128i: the 128-point DFT planes; u1, u2: the (A1, 128) and (A2, 128)
// digit twiddles; ga (A1, g2) and gb (128, g2): the factored inter-factor
// twiddle (K19: b1 = B1t (128, 128) and b2 = B2 (g2/128, 128) in place of
// gb).  Returns a cudaError_t (cudaErrorCooperativeLaunchTooLarge where not
// one block fits an SM).
extern "C" int pf_global_bf(const float* x, float* y, float* s, int g1, int g2,
                            int t1, int t2, int sign, const float* w128r,
                            const float* w128i, const float* u1r,
                            const float* u1i, const float* u2r,
                            const float* u2i, const float* gar,
                            const float* gai, const float* gbr,
                            const float* gbi, int64_t batch, int64_t chunk,
                            float scale, void* stream) {
  return pfft_bf::launch_bf(
      pfft_bf::sweep_kernel<false>,
      make_bf(x, y, s, g1, g2, t1, t2, sign, w128r, w128i, u1r, u1i, u2r, u2i,
              gar, gai, gbr, gbi, nullptr, nullptr, nullptr, nullptr, batch,
              chunk, scale),
      false, static_cast<cudaStream_t>(stream));
}

extern "C" int pf_global_bf_ov(const float* x, float* y, float* s, int g1,
                               int g2, int t1, int t2, int sign,
                               const float* w128r, const float* w128i,
                               const float* u1r, const float* u1i,
                               const float* u2r, const float* u2i,
                               const float* gar, const float* gai,
                               const float* gbr, const float* gbi,
                               int64_t batch, int64_t chunk, float scale,
                               void* stream) {
  return pfft_bf::launch_bf(
      pfft_bf::overlay_kernel<false>,
      make_bf(x, y, s, g1, g2, t1, t2, sign, w128r, w128i, u1r, u1i, u2r, u2i,
              gar, gai, gbr, gbi, nullptr, nullptr, nullptr, nullptr, batch,
              chunk, scale),
      false, static_cast<cudaStream_t>(stream));
}

extern "C" int pf_global_bf2(const float* x, float* y, float* s, int g1,
                             int g2, int t1, int t2, int sign,
                             const float* w128r, const float* w128i,
                             const float* u1r, const float* u1i,
                             const float* u2r, const float* u2i,
                             const float* gar, const float* gai,
                             const float* b1r, const float* b1i,
                             const float* b2r, const float* b2i,
                             int64_t batch, int64_t chunk, float scale,
                             void* stream) {
  if (b1r == nullptr || b2r == nullptr || g2 % pfft_bf::kLoT1)
    return int(cudaErrorInvalidValue);
  return pfft_bf::launch_bf(
      pfft_bf::sweep_kernel<false>,
      make_bf(x, y, s, g1, g2, t1, t2, sign, w128r, w128i, u1r, u1i, u2r, u2i,
              gar, gai, nullptr, nullptr, b1r, b1i, b2r, b2i, batch, chunk,
              scale),
      false, static_cast<cudaStream_t>(stream));
}
