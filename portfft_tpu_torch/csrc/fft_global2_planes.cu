// K14 `global2_planes`: batched GLOBAL four-step transform n = G1*G2 on
// (re, im) float planes (b, n), in two passes through a float2 scratch S,
// with an optional (G1, G2) table multiplied in pass 2.
//
// Replaces portfft_tpu/ops/pallas_global.py::global2_call, the plane GLOBAL
// engine of the JAX package's executor (SPLIT storage, GLOBAL nodes inside
// a plan tree, and the Bluestein convolution with `post`).  It is K3's
// function on planes.  With the row viewed as x[n1, n2] = x[G2*n1 + n2]:
//   pass 1: for each column n2, the G1-point transform down n1, times the
//           bank's dense ("T", G1, G2) twiddle w_n^(n2*k1), stored as
//           S[b, n2, k1];
//   pass 2: for each k1, the G2-point transform over n2, times post[k1, k2]
//           when given and the scale, stored to y[b, k1 + G1*k2] (the
//           (b, G2, G1) order, which is the natural one).
// Each sub-transform is DIRECT or FUSED [a, 128] (pfft::sub_dft, shared with
// K1-K3).  A sub past pfft::kTileMax (FUSED [128, 128] = 16384, whose column
// does not fit a block's shared memory) runs its pass as two launches
// through a second float2 scratch Q (pfft::launch_column), as K2 and K10 do
// past 8192.  The TPU engine's factored twiddles (Z, ZQ, Q tables) and its
// bf16 Karatsuba matrix products are its precision scheme on the matrix
// unit and are not carried over: the sums here are fp32 FMA on the CUDA
// cores over the root tables.
//
// Bound on the H100, per complex element: the function reads 8 bytes and
// writes 8 (plus 8 of post when given); the two passes move 40 bytes through
// S (56 with post, 72 more per split pass through Q), against 8*(G1' + G2')
// flops where G' is G for a DIRECT sub and a + 128 for FUSED: 4096 flops at
// 65536 = 256 x 256, 5248 at 2^20, so the kernel is bound by arithmetic (in
// this first version by shared-memory operand reads, as K3).
#include "fft_common.cuh"

namespace {

bool sub_ok(const pfft::Sub& s) {
  return s.m >= 1 && (s.a == 0 || s.a * 128 == s.m) &&
         (s.m <= pfft::kTileMax || s.a > 0);
}

}  // namespace

// 1 when pf_global2_planes needs the second scratch Q (2*batch*g1*g2
// floats): a sub longer than one tile.
extern "C" int pf_global2_planes_needs_scratch(int g1, int g2) {
  return g1 > pfft::kTileMax || g2 > pfft::kTileMax ? 1 : 0;
}

// Planes (xr, xi) of batch rows of n = g1*g2 -> (yr, yi) through the
// scratch s (2*batch*n floats) and, where needed, q (the same size).  Each
// sub (m, a, wr, wi, br, bi, ur, ui) as in pf_global2.  tr/ti: the (g2, g1)
// inter-pass twiddle planes; pr/pi: the (g1, g2) post planes, or nullptr.
// Returns a cudaError_t.
extern "C" int pf_global2_planes(
    const float* xr, const float* xi, float* yr, float* yi, float* s,
    float* q, int g1, int a1, const float* w1r, const float* w1i,
    const float* b1r, const float* b1i, const float* u1r, const float* u1i,
    int g2, int a2, const float* w2r, const float* w2i, const float* b2r,
    const float* b2i, const float* u2r, const float* u2i, const float* tr,
    const float* ti, const float* pr, const float* pi, int64_t batch,
    float scale, void* stream) {
  const pfft::Sub s1{g1, a1, w1r, w1i, b1r, b1i, u1r, u1i};
  const pfft::Sub s2{g2, a2, w2r, w2i, b2r, b2i, u2r, u2i};
  if (!sub_ok(s1) || !sub_ok(s2) || batch < 1 || s == nullptr ||
      (pf_global2_planes_needs_scratch(g1, g2) && q == nullptr) ||
      (pr == nullptr) != (pi == nullptr))
    return int(cudaErrorInvalidValue);
  const int64_t n = int64_t(g1) * g2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* S = reinterpret_cast<float2*>(s);
  float2* Q = reinterpret_cast<float2*>(q);

  pfft::Pass p1{};
  p1.sub = s1;
  p1.nbatch = batch;
  p1.ncols = g2;
  p1.T = pfft::fit_tile(s1, pfft::pick_tile(g1, g2, 4096, 8));
  p1.ibs = n;
  p1.iis = g2;
  p1.ics = 1;
  p1.obs = n;
  p1.oks = 1;
  p1.ocs = g1;
  p1.twr = tr;
  p1.twi = ti;
  p1.tcs = g1;
  p1.tks = 1;
  p1.scale = 1.f;
  int err = pfft::launch_column(p1, pfft::ConstPlanes{xr, xi}, Q, S, st);
  if (err) return err;

  pfft::Pass p2{};
  p2.sub = s2;
  p2.nbatch = batch;
  p2.ncols = g1;
  p2.T = pfft::fit_tile(s2, pfft::pick_tile(g2, g1, 4096, 8));
  p2.ibs = n;
  p2.iis = g1;
  p2.ics = 1;
  p2.obs = n;
  p2.oks = g1;
  p2.ocs = 1;
  p2.twr = pr;
  p2.twi = pi;
  p2.tcs = g2;
  p2.tks = 1;
  p2.scale = scale;
  return pfft::launch_column(p2, static_cast<const float2*>(S), Q,
                             pfft::Planes{yr, yi}, st);
}
