// K12 `axis_m2`: the FFT over axis L1 of (re, im) float planes viewed as
// (b, L1, L2):
//   out[b, k, c] = scale * sum_j x[b, j, c] * w_L1^(j*k)
// for every b and column c < L2.  The multi-dimensional plane path runs it
// once per outer axis, with L2 the product of the axes after it.
//
// Replaces portfft_tpu/ops/pallas_global.py::fft_axis_m2_call (DIRECT,
// L1 <= 256, L1 % 8 == 0: the DFT matmul on transposed (L1, T) tiles) and
// ::fft_axis_m2_fused_call (FUSED [a, 128] with a >= 8: the two-stage
// pipeline on transposed tiles, written through a (128, a) output block).
// Here both are one pfft::Pass over the plane accessors (fft_common.cuh),
// the column walk of K10 on planes: a block loads T adjacent columns of one
// b (contiguous runs of T floats per row and plane), runs the DIRECT or
// FUSED [a, 128] sub-transform in shared memory and stores the tile back at
// the same place.  pfft::sub_dft takes any a, so FUSED [a, 128] with a not
// dividing 128 (3072 = [24, 128]) runs as a | 128 does; K10's column
// kernel is gated at a | 128 only because the JAX package's is.  Past
// pfft::kTileMax (a > 64) the transform runs as two launches through a
// float2 scratch of the input's size (pfft::launch_column), as K10 does.
//
// Bound on the H100, per complex element: 8*L1 flops (DIRECT) or
// 8*(a + 128) (FUSED) against 16 bytes of device memory; at L1 = 128 that
// is 64 flops/byte, so the kernel is bound by arithmetic (in this first
// version by shared-memory operand reads, as K10).
#include "fft_common.cuh"

// 1 when pf_axis_m2 needs a scratch of 2*bpre*m*rest floats.
extern "C" int pf_axis_m2_needs_scratch(int m) {
  return m > pfft::kTileMax ? 1 : 0;
}

// Planes (xr, xi) of bpre*m*rest elements -> (yr, yi), axis m of the
// (bpre, m, rest) view transformed, times scale.  a = 0: DIRECT, wr/wi the
// m x m DFT planes; a > 0: FUSED m = a*128, wr/wi a x a, br/bi 128 x 128,
// ur/ui the (a, 128) twiddle planes.  q: the scratch, only for m > 8192.
// Returns a cudaError_t.
extern "C" int pf_axis_m2(const float* xr, const float* xi, float* yr,
                          float* yi, float* q, int m, int a, const float* wr,
                          const float* wi, const float* br, const float* bi,
                          const float* ur, const float* ui, int64_t bpre,
                          int64_t rest, float scale, void* stream) {
  if (m < 1 || (a != 0 && a * 128 != m) || (a == 0 && m > pfft::kTileMax) ||
      bpre < 1 || rest < 1)
    return int(cudaErrorInvalidValue);
  pfft::Pass p{};
  p.sub = pfft::Sub{m, a, wr, wi, br, bi, ur, ui};
  p.nbatch = bpre;
  p.ncols = rest;
  // K10's tile (about 4096 elements): at L1 = 1024 two blocks share an SM,
  // where a tile of 8192 elements (T = 8) leaves room for one.
  p.T = pfft::fit_tile(p.sub, pfft::pick_tile(m, rest, 4096, 32));
  p.ibs = int64_t(m) * rest;
  p.iis = rest;
  p.ics = 1;
  p.obs = p.ibs;
  p.oks = rest;
  p.ocs = 1;
  p.scale = scale;
  return pfft::launch_column(p, pfft::ConstPlanes{xr, xi},
                             reinterpret_cast<float2*>(q),
                             pfft::Planes{yr, yi},
                             static_cast<cudaStream_t>(stream));
}
