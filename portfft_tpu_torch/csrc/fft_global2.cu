// K3 `global2`: batched GLOBAL four-step transform n = G1*G2 on the PACKED
// interleaved buffer, in two passes through device memory.
//
// Replaces portfft_tpu/ops/pallas_global.py::global2_raw_call, and with
// pf_global2_ftw its factored-twiddle mode (use_ftw, the tuned engine
// {"eng": 2, "ftw": 1}: K3-ftw).  With the row viewed as x[n1, n2] =
// x[G2*n1 + n2]:
//   pass 1: for each column n2, the G1-point transform down n1, times the
//           bank's dense ("T", G1, G2) twiddle w_n^(n2*k1), stored as
//           S[b, n2, k1] in a float2 scratch buffer (2*batch*n floats) that
//           the caller allocates;
//   pass 2: for each k1, the G2-point transform over n2, stored as
//           out[b, k1 + G1*k2] = scale * (...), interleaved.
// Each sub-transform is DIRECT or FUSED [a, 128] (pfft::sub_dft, shared
// with K1 and K2): the GLOBAL plans of the whole bench ladder, 65536 (256 x
// 256) to 2^20 ([16,128] x 512).  The TPU engine keeps its intermediate as
// two f32 planes; here it is one interleaved float2 array, so every pass
// moves whole 8-byte elements.
//
// Bound on the H100, per complex element: two passes of 16 bytes each plus
// 8 bytes of twiddle read in pass 1 (40 bytes; K3-ftw forms the twiddle from
// the resident factored tables of fft_ftw.cuh and streams none, 32 bytes),
// against 8*(G1' + G2) flops
// where G1' is G1 for a DIRECT sub and a + 128 for a FUSED one: 4096 flops
// at 65536, 5248 at 2^20, so the kernel is bound by arithmetic (in this
// first version by shared-memory operand reads).  Each block takes T
// adjacent columns (T = 8 for G <= 512, 2 for G = 2048) so that its loads
// and stores cover whole 32-byte sectors of contiguous memory.
#include "fft_common.cuh"
#include "fft_ftw.cuh"

namespace {

__global__ void __launch_bounds__(pfft::kThreads)
    global2_kernel(pfft::Pass p, const float2* x, float2* y) {
  pfft::run_pass(p, x, y);
}

// K3-ftw's pass 1: K3's, with the twiddle of each tile formed from the
// factored tables into shared memory after the tile (extra) and applied in
// the store, which writes S[b][n2][k1] elements fastest.
__global__ void __launch_bounds__(pfft::kThreads)
    global2_ftw_kernel(pfft::Pass p, const float2* x, float2* y,
                       pfft_ftw::Tables tb) {
  extern __shared__ float2 smem[];
  const pfft::TileSmem sm = pfft::tile_smem(p.sub, p.T, smem);
  const int es = pfft::tile_pitch(p.T);
  float2* extra = sm.b1 + pfft::tile_rows(p.sub) * es;
  pfft::load_sub_roots(p.sub, sm);
  const int m = p.sub.m, T = p.T;
  const int64_t per_batch = (p.ncols + T - 1) / T;
  const int64_t ntiles = p.nbatch * per_batch;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b = tile / per_batch;
    const int64_t c0 = (tile - b * per_batch) * T;
    pfft_ftw::prepare(tb, p.sub, T, c0, extra);
    pfft::tile_load(p, b, c0, x, sm.b0);  // its __syncthreads shows extra
    const float2* res = pfft::sub_dft(p.sub, sm.ra, sm.rb, sm.b0, sm.b1, T, es);
    const int64_t left = p.ncols - c0;
    const int tv = left < T ? int(left) : T;
    for (int e = threadIdx.x; e < m * T; e += blockDim.x) {
      const int k = e % m, t = e / m;
      if (t >= tv) continue;
      const float2 v = res[pfft::tile_pos(p.sub, k) * es + t];
      y[b * p.obs + (c0 + t) * p.ocs + k] =
          pfft_ftw::apply(v, extra, p.sub, T, t, k);
    }
    __syncthreads();
  }
}

// The length of a sub-transform is bounded only by its tile's shared
// memory: launch_pass returns the error of a tile that does not fit, and the
// registry (fastpath.GLOBAL_SUB_MAX) declines such plans at commit.
bool sub_ok(const pfft::Sub& s) {
  return s.m >= 1 && (s.a == 0 || s.a * 128 == s.m);
}

// The two passes of K3 over `batch` rows of n = g1*g2.
pfft::Pass pass1(const pfft::Sub& s1, int g2, int64_t batch) {
  const int64_t n = int64_t(s1.m) * g2;
  pfft::Pass p1{};
  p1.sub = s1;
  p1.nbatch = batch;
  p1.ncols = g2;
  p1.T = pfft::pick_tile(s1.m, g2, 4096, 8);
  p1.ibs = n;
  p1.iis = g2;
  p1.ics = 1;
  p1.obs = n;
  p1.oks = 1;
  p1.ocs = s1.m;
  p1.scale = 1.f;
  return p1;
}

pfft::Pass pass2(const pfft::Sub& s2, int g1, int64_t batch, float scale) {
  const int64_t n = int64_t(g1) * s2.m;
  pfft::Pass p2{};
  p2.sub = s2;
  p2.nbatch = batch;
  p2.ncols = g1;
  p2.T = pfft::pick_tile(s2.m, g1, 4096, 8);
  p2.ibs = n;
  p2.iis = g1;
  p2.ics = 1;
  p2.obs = n;
  p2.oks = g1;
  p2.ocs = 1;
  p2.scale = scale;
  return p2;
}

}  // namespace

// x (2*batch*g1*g2 floats) -> y through scratch (the same size); y may
// equal x.  Sub k (k = 1, 2) has length gk; ak = 0 for DIRECT (wkr/wki:
// gk x gk DFT planes) or a for FUSED [a, 128] (wkr/wki: a x a, bkr/bki:
// 128 x 128, ukr/uki: the (a, 128) twiddle planes).  tr/ti: the (g2, g1)
// inter-pass twiddle planes.  Returns a cudaError_t.
extern "C" int pf_global2(const float* x, float* y, float* scratch, int g1,
                          int a1, const float* w1r, const float* w1i,
                          const float* b1r, const float* b1i, const float* u1r,
                          const float* u1i, int g2, int a2, const float* w2r,
                          const float* w2i, const float* b2r, const float* b2i,
                          const float* u2r, const float* u2i, const float* tr,
                          const float* ti, int64_t batch, float scale,
                          void* stream) {
  const pfft::Sub s1{g1, a1, w1r, w1i, b1r, b1i, u1r, u1i};
  const pfft::Sub s2{g2, a2, w2r, w2i, b2r, b2i, u2r, u2i};
  if (!sub_ok(s1) || !sub_ok(s2) || batch < 1 || scratch == nullptr)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pfft::Pass p1 = pass1(s1, g2, batch);
  p1.twr = tr;
  p1.twi = ti;
  p1.tcs = g1;
  p1.tks = 1;
  int err = pfft::launch_pass(global2_kernel, p1, x, scratch, st);
  if (err) return err;
  return pfft::launch_pass(global2_kernel, pass2(s2, g1, batch, scale),
                           scratch, y, st);
}

// K3-ftw: pf_global2 with the pass-1 twiddle formed from the factored
// tables q1r .. q4i (the bank's "Q" for a DIRECT G1 or "ZQ" for a FUSED
// one, at 64 columns; fft_ftw.cuh) instead of the dense tr/ti.  Returns a
// cudaError_t (cudaErrorInvalidValue where the tables do not exist for the
// plan).
extern "C" int pf_global2_ftw(
    const float* x, float* y, float* scratch, int g1, int a1, const float* w1r,
    const float* w1i, const float* b1r, const float* b1i, const float* u1r,
    const float* u1i, int g2, int a2, const float* w2r, const float* w2i,
    const float* b2r, const float* b2i, const float* u2r, const float* u2i,
    const float* q1r, const float* q1i, const float* q2r, const float* q2i,
    const float* q3r, const float* q3i, const float* q4r, const float* q4i,
    int64_t batch, float scale, void* stream) {
  const pfft::Sub s1{g1, a1, w1r, w1i, b1r, b1i, u1r, u1i};
  const pfft::Sub s2{g2, a2, w2r, w2i, b2r, b2i, u2r, u2i};
  const pfft::Pass p1 = pass1(s1, g2, batch);
  if (!sub_ok(s1) || !sub_ok(s2) || batch < 1 || scratch == nullptr ||
      !pfft_ftw::tables_ok(s1, g2) || pfft_ftw::kT1 % p1.T || q1r == nullptr)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const pfft_ftw::Tables tb{{q1r, q1i, q2r, q2i, q3r, q3i, q4r, q4i}};
  const size_t smem = pfft::pass_smem_bytes(s1, p1.T) +
                      sizeof(float2) * pfft_ftw::factor_elems(s1, p1.T);
  int err = pfft::launch_tiles(global2_ftw_kernel, smem, pfft::pass_tiles(p1),
                               st, p1, reinterpret_cast<const float2*>(x),
                               reinterpret_cast<float2*>(scratch), tb);
  if (err) return err;
  return pfft::launch_pass(global2_kernel, pass2(s2, g1, batch, scale),
                           scratch, y, st);
}
