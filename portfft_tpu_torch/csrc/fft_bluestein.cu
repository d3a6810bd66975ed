// K15 `bluestein`: the batched n-point transform of a BLUESTEIN plan whose
// convolution of length M = g1*g2 is GLOBAL, on (re, im) float planes
// (b, n), in three launches through two float2 buffers S1, S2 of b*M
// elements.
//
// Replaces portfft_tpu/ops/pallas_bluestein.py::bluestein_call.  With the
// chirp c[j] = exp(sign*pi*i*j^2/n), X = c * IDFT_M(DFT_M(x*c) * b^), and
// the convolution's directions fixed (forward -1, backward +1) whatever the
// user's sign, which lives in the tables:
//   pass 1: for each column n2 < g2, the g1-point forward DFT down
//           n1 of x[n1*g2 + n2] * BPRE[n1*g2 + n2] (zero from index n on,
//           so only the rows that hold input are read), times the
//           forward twiddle T(g1, g2, -1)[n2, k1]; S1[b, n2, k1];
//   pass 2: for each k1 < g1, the g2-point forward DFT over n2 of
//           S1[b, n2, k1], times b^[k1, k2] (BPOST, 1/M folded in), the
//           g2-point backward DFT over k2 (the first stage of the backward
//           transform factored (g2, g1), whose input index k1 + g1*k2 is
//           the forward output's), times T(g2, g1, +1)[k1, k1'];
//           S2[b, k1, k1'];
//   pass 3: for each k1' < g2, the g1-point backward DFT down k1 of
//           S2[b, k1, k1'], times BFIN[k1', k2'] (the final chirp at index
//           k1' + g2*k2', zero from n on) and the scale, stored straight to
//           y[b, k1' + g2*k2'] for the indices below n.
// The TPU kernel's lane tiles and in-VMEM transposes, and its
// (b, nv, g2) output with the slice to n in XLA, are not carried over: each
// pass here is pfft::pass_tile's column walk (pass 2 with two DFTs in one
// tile), and pass 3 writes the rows of y itself.  The sums are fp32 FMA
// over the root tables on the CUDA cores.
//
// Bound on the H100: the function moves 16 bytes per output element, but
// the three passes move 8*(n + 2*M) + 8*4*M bytes per transform through
// S1 and S2 (about 11.9 GB at n = 65537, b = 2048: 3.5 ms), and do
// 8*(2*g1' + 2*g2') flops per convolution element (g' = g for a DIRECT
// sub, a + 128 for FUSED [a, 128]; 1536 complex multiply-adds at 384 x
// 384), so the kernel is bound by arithmetic (in this first version, as
// K1-K3, by shared-memory operand reads).
#include "fft_common.cuh"

namespace pfft {

// Pass 1's input: x[j] * c[j] for j < n, zero from n on.
struct ChirpIn {
  ConstPlanes x;
  const float* cr;
  const float* ci;
  int64_t n;
};
__device__ __forceinline__ float2 ld(const ChirpIn& a, int64_t j) {
  if (j >= a.n) return make_float2(0.f, 0.f);
  return cmul(make_float2(a.x.re[j], a.x.im[j]),
              make_float2(__ldg(a.cr + j), __ldg(a.ci + j)));
}

// Pass 3's output: the indices below n of the row.
struct HeadPlanes {
  Planes y;
  int64_t n;
};
__device__ __forceinline__ void st(const HeadPlanes& o, int64_t j, float2 v) {
  if (j < o.n) {
    o.y.re[j] = v.x;
    o.y.im[j] = v.y;
  }
}

}  // namespace pfft

namespace {

__host__ __device__ int roots_len(const pfft::Sub& s) {
  return s.a ? s.a + 128 : s.m;
}

// Passes 1 and 3: the tiles of p over the b rows, with x and y given per
// row by the functions in and out.
template <class In, class Out>
__device__ void blue_tiles(const pfft::Pass& p, In in, Out out) {
  extern __shared__ float2 smem[];
  const pfft::TileSmem sm = pfft::tile_smem(p.sub, p.T, smem);
  pfft::load_sub_roots(p.sub, sm);
  const int64_t per = (p.ncols + p.T - 1) / p.T;
  const int64_t ntiles = p.nbatch * per;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b = tile / per;
    pfft::pass_tile(p, 0, (tile - b * per) * p.T, in(b), out(b), sm);
  }
}

__global__ void __launch_bounds__(pfft::kThreads)
    blue_pass1(pfft::Pass p, pfft::ConstPlanes x, const float* cr,
               const float* ci, int64_t n, float2* s1) {
  const int64_t conv = int64_t(p.sub.m) * p.ncols;
  blue_tiles(
      p,
      [=](int64_t b) {
        return pfft::ChirpIn{{x.re + b * n, x.im + b * n}, cr, ci, n};
      },
      [=](int64_t b) { return s1 + b * conv; });
}

__global__ void __launch_bounds__(pfft::kThreads)
    blue_pass3(pfft::Pass p, const float2* s2, pfft::Planes y, int64_t n) {
  const int64_t conv = int64_t(p.sub.m) * p.ncols;
  blue_tiles(
      p, [=](int64_t b) { return s2 + b * conv; },
      [=](int64_t b) {
        return pfft::HeadPlanes{{y.re + b * n, y.im + b * n}, n};
      });
}

size_t pass2_smem_bytes(const pfft::Sub& s, int T) {
  return sizeof(float2) * (2 * size_t(roots_len(s)) +
                           2 * size_t(pfft::tile_rows(s)) * pfft::tile_pitch(T));
}

// Pass 2: p walks the g1 columns k1 of S1 (sub: the forward g2 sub) and
// stores S2 with the backward twiddle; sb is the backward g2 sub.
__global__ void __launch_bounds__(pfft::kThreads)
    blue_pass2(pfft::Pass p, pfft::Sub sb, const float* hr, const float* hi,
               const float2* s1, float2* s2) {
  extern __shared__ float2 smem[];
  const pfft::Sub& sf = p.sub;
  const int R = roots_len(sf);
  pfft::TileSmem fw = pfft::tile_smem(sf, p.T, smem + R);  // b0, b1 after
  fw.ra = smem;                                            // both root sets
  fw.rb = fw.ra + (sf.a ? sf.a : sf.m);
  pfft::TileSmem bw = fw;
  bw.ra = smem + R;
  bw.rb = bw.ra + (sb.a ? sb.a : sb.m);
  pfft::load_sub_roots(sf, fw);
  pfft::load_sub_roots(sb, bw);
  const int g2 = sf.m;
  const int T = p.T;
  const int es = pfft::tile_pitch(T);
  const int64_t conv = int64_t(g2) * p.ncols;
  const int64_t per = (p.ncols + T - 1) / T;
  const int64_t ntiles = p.nbatch * per;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b = tile / per;
    const int64_t c0 = (tile - b * per) * T;
    pfft::tile_load(p, 0, c0, s1 + b * conv, fw.b0);
    float2* r = pfft::sub_dft(sf, fw.ra, fw.rb, fw.b0, fw.b1, T, es);
    float2* o = r == fw.b0 ? fw.b1 : fw.b0;
    const int64_t left = p.ncols - c0;
    const int tv = left < T ? int(left) : T;
    for (int e = threadIdx.x; e < g2 * T; e += blockDim.x) {
      const int k = e / T;
      const int t = e - k * T;
      if (t >= tv) continue;
      const int pos = pfft::tile_pos(sf, k) * es + t;
      const int64_t h = (c0 + t) * g2 + k;  // b^[k1, k2]
      r[pos] = pfft::cmul(r[pos], make_float2(__ldg(hr + h), __ldg(hi + h)));
    }
    __syncthreads();
    r = pfft::sub_dft(sb, bw.ra, bw.rb, r, o, T, es);
    pfft::tile_store(p, 0, c0, r, s2 + b * conv);
  }
}

bool sub_ok(const pfft::Sub& s) {
  return s.m >= 1 && (s.a == 0 || s.a * 128 == s.m);
}

}  // namespace

// Planes (xr, xi) of batch rows of n -> (yr, yi) through s1, s2 (2*batch*M
// floats each, M = g1*g2).  Each sub (m, a, wr, wi, br, bi, ur, ui) as in
// pf_global2: g1 forward and backward, g2 forward and backward.  pre: the
// (nv, g2) BPRE planes; twf: the (g2, g1) forward twiddle T(g1, g2, -1);
// hat: the (g1, g2) b^ planes (BPOST "f"); twb: the (g1, g2) backward
// twiddle T(g2, g1, +1); fin: the (g2, g1) BFIN planes.  Returns a
// cudaError_t.
extern "C" int pf_bluestein(
    const float* xr, const float* xi, float* yr, float* yi, float* s1,
    float* s2, int64_t n, int g1, int a1, const float* f1wr,
    const float* f1wi, const float* f1br, const float* f1bi,
    const float* f1ur, const float* f1ui, int g1b, int a1b,
    const float* b1wr, const float* b1wi, const float* b1br,
    const float* b1bi, const float* b1ur, const float* b1ui, int g2, int a2,
    const float* f2wr, const float* f2wi, const float* f2br,
    const float* f2bi, const float* f2ur, const float* f2ui, int g2b,
    int a2b, const float* b2wr, const float* b2wi, const float* b2br,
    const float* b2bi, const float* b2ur, const float* b2ui,
    const float* prer, const float* prei, const float* twfr,
    const float* twfi, const float* hatr, const float* hati,
    const float* twbr, const float* twbi, const float* finr,
    const float* fini, int64_t batch, float scale, void* stream) {
  const pfft::Sub f1{g1, a1, f1wr, f1wi, f1br, f1bi, f1ur, f1ui};
  const pfft::Sub b1{g1b, a1b, b1wr, b1wi, b1br, b1bi, b1ur, b1ui};
  const pfft::Sub f2{g2, a2, f2wr, f2wi, f2br, f2bi, f2ur, f2ui};
  const pfft::Sub b2{g2b, a2b, b2wr, b2wi, b2br, b2bi, b2ur, b2ui};
  if (!sub_ok(f1) || !sub_ok(f2) || g1b != g1 || a1b != a1 || g2b != g2 ||
      a2b != a2 || batch < 1 || n < 1 || n > int64_t(g1) * g2 ||
      s1 == nullptr || s2 == nullptr)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* S1 = reinterpret_cast<float2*>(s1);
  float2* S2 = reinterpret_cast<float2*>(s2);

  pfft::Pass p1{};
  p1.sub = f1;
  p1.nbatch = batch;
  p1.ncols = g2;
  p1.T = pfft::pick_tile(g1, g2, 4096, 8);
  p1.iis = g2;
  p1.ics = 1;
  p1.oks = 1;
  p1.ocs = g1;
  p1.twr = twfr;
  p1.twi = twfi;
  p1.tcs = g1;
  p1.tks = 1;
  p1.scale = 1.f;
  int err = pfft::launch_tiles(blue_pass1, pfft::pass_smem_bytes(f1, p1.T),
                               pfft::pass_tiles(p1), st, p1,
                               pfft::ConstPlanes{xr, xi}, prer, prei, n, S1);
  if (err) return err;

  pfft::Pass p2{};
  p2.sub = f2;
  p2.nbatch = batch;
  p2.ncols = g1;
  p2.T = pfft::pick_tile(g2, g1, 4096, 8);
  p2.iis = g1;
  p2.ics = 1;
  p2.oks = 1;
  p2.ocs = g2;
  p2.twr = twbr;
  p2.twi = twbi;
  p2.tcs = g2;
  p2.tks = 1;
  p2.scale = 1.f;
  err = pfft::launch_tiles(blue_pass2, pass2_smem_bytes(f2, p2.T),
                           pfft::pass_tiles(p2), st, p2, b2, hatr, hati,
                           static_cast<const float2*>(S1), S2);
  if (err) return err;

  pfft::Pass p3{};
  p3.sub = b1;
  p3.nbatch = batch;
  p3.ncols = g2;
  p3.T = pfft::pick_tile(g1, g2, 4096, 8);
  p3.iis = g2;
  p3.ics = 1;
  p3.oks = g2;
  p3.ocs = 1;
  p3.twr = finr;
  p3.twi = fini;
  p3.tcs = g1;
  p3.tks = 1;
  p3.scale = scale;
  return pfft::launch_tiles(blue_pass3, pfft::pass_smem_bytes(b1, p3.T),
                            pfft::pass_tiles(p3), st, p3,
                            static_cast<const float2*>(S2),
                            pfft::Planes{yr, yi}, n);
}
