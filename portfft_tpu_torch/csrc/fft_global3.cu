// K16 `global3`: the GLOBAL four-step transform n = G1*G2 on the PACKED
// interleaved buffer, in two launches on the tensor cores.
//
// Replaces portfft_tpu/ops/pallas_global3.py::build_call (its two
// pallas_calls, the JAX package's GLOBAL engine 3).  With the row viewed
// as x[n1, n2] = x[G2*n1 + n2] (the raw buffer as (batch, G1, G2)):
//   pass 1: for each tile of T adjacent columns n2, the G1-point DFT down
//           n1 (fft_mma.cuh's column pass: DIRECT G1 <= 512, or FUSED
//           [a, 128] in two stages), times the global twiddle
//           w_n^(k1*n2), stored S[b, k1, n2] in natural order (no
//           transpose) in a scratch buffer the caller allocates;
//   pass 2: for each tile of 16 rows k1 of S, the G2-point DFT along the
//           row (G2 <= 512, 128 | G2), scaled, stored O[b, k2, k1]: the
//           one transpose of the four-step.  The mma's accumulator holds
//           outputs k2 in its rows and the tile's rows k1 in its columns,
//           so each warp stores runs of 8 adjacent k1 (64 bytes) with no
//           staging; O viewed (batch, G2, G1) is out[k1 + G1*k2].
// The global twiddle follows the JAX kernel's _apply_global_twiddle: with
// n2 = m2 + n2b (m2 = n2 rounded down to a multiple of 64, the width of
// the bank's tables) and k1 = k1_lo + ga*k1_hi (pallas_global3.digit_split,
// or (a, 128) for a FUSED G1),
//   w_n^(k1*n2) = [A_lo(k1_lo) * B1[k1_lo, n2b]] * [A_hi(k1_hi) * B2[k1_hi, n2b]]
// where B1 = w_n^(k1_lo*n2b) and B2 = w_(n/ga)^(k1_hi*n2b) are the bank's
// resident tables ("G..t64", pair-expanded (ga, 128) and (gb, 128)) and
// A_lo = w_n^(k1_lo*m2), A_hi = w_(n/ga)^(k1_hi*m2) are computed per tile
// in the kernel, the exponent reduced mod n in 64-bit integers before a
// double-precision sincospi.  No dense (G1, G2) twiddle is streamed: K3
// reads one (fft_global2.cu).
//
// Bound on the H100, per complex element: 32 bytes of device memory (two
// passes of 16) against K3's 40, and 24*(G1' + G2) flops on the TF32
// tensor cores (G1' = G1 DIRECT, a + 128 FUSED): 12288 at 65536 = 256 x
// 256, 15360 at 2^20 = [16, 128] x 512, so the kernel is bound by
// operations (about 3.3 times its bytes at 65536).
#include "fft_mma.cuh"

namespace {

// The bank's table width (pallas_global3.T1_CANDIDATES' 64): n2b < 64.
constexpr int kTabT1 = 64;

struct G3Epi {
  float2* s;
  int g1, g2, ga, gb, sign;
  int64_t n;
  int T;
  const float *b1r, *b1i, *b2r, *b2i;  // pair-expanded (ga, 128), (gb, 128)
  pfft_mma::Mod mga;                   // k1 -> (k1_lo, k1_hi)

  // Per tile: C1[k1_lo][c] = A_lo(k1_lo) * B1[k1_lo, n2b] and
  // C2[k1_hi][c] = A_hi(k1_hi) * B2[k1_hi, n2b] into `extra`.
  __device__ void prepare(int64_t, int64_t c0, float2* extra) const {
    const int64_t m2 = c0 - c0 % kTabT1;  // T | 64: one m2 a tile
    const int n2b0 = int(c0 - m2);
    const int64_t nh = n / ga;
    for (int e = threadIdx.x; e < (ga + gb) * T; e += blockDim.x) {
      const bool lo = e < ga * T;
      const int r = lo ? e : e - ga * T;
      const int kk = r / T;
      const int c = r - kk * T;
      const int64_t root = lo ? n : nh;
      const int64_t ex = (int64_t(kk) * m2) % root;
      double sn, cs;
      sincospi(2.0 * double(ex) / double(root), &sn, &cs);
      const float2 av = make_float2(float(cs), float(sign * sn));
      const int ti = kk * 2 * kTabT1 + 2 * (n2b0 + c);
      const float2 bv = lo ? make_float2(__ldg(b1r + ti), __ldg(b1i + ti))
                           : make_float2(__ldg(b2r + ti), __ldg(b2i + ti));
      extra[e] = pfft::cmul(av, bv);
    }
  }
  __device__ void operator()(int64_t b, int k1, int64_t c0, int c, float2 v,
                             const float2* tw) const {
    const int hi = int(mga.div(uint32_t(k1)));
    const int lo = k1 - hi * ga;
    v = pfft::cmul(v, tw[lo * T + c]);
    v = pfft::cmul(v, tw[(ga + hi) * T + c]);
    s[(b * g1 + k1) * g2 + c0 + c] = v;
  }
};

__global__ void __launch_bounds__(pfft_mma::kThreads)
    g3_pass1(pfft_mma::Col p, const float2* x, G3Epi epi) {
  pfft_mma::column_pass(p, x, epi);
}

// Pass 2: tiles of kRows rows of S (k1), each row's G2 points in (re, im)
// planes of pitch G2 + 4 (the B-fragment reads of 8 rows x 4 depths hit 32
// banks).
constexpr int kRows = 16;

__global__ void __launch_bounds__(pfft_mma::kThreads)
    g3_pass2(const float2* s, float2* y, int g1, int g2, const float* wr,
             const float* wi, int64_t batch, float scale) {
  extern __shared__ float4 smem4[];
  float2* root = reinterpret_cast<float2*>(smem4);
  const int q = g2 + 4;
  float* sr = reinterpret_cast<float*>(root + g2);
  float* si = sr + kRows * q;
  pfft::load_roots(root, wr, wi, g2);
  const pfft_mma::Mod md(g2);
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per = g1 / kRows;
  for (int64_t tile = blockIdx.x; tile < batch * per; tile += gridDim.x) {
    const int64_t b = tile / per;
    const int k10 = int(tile - b * per) * kRows;
    __syncthreads();
    const float2* src = s + (b * g1 + k10) * g2;
    for (int e = threadIdx.x; e < kRows * g2; e += blockDim.x) {
      const int u = e / g2;
      const int j = e - u * g2;
      const float2 v = src[e];
      sr[u * q + j] = v.x;
      si[u * q + j] = v.y;
    }
    __syncthreads();
    auto ld = [&](int j, int u) {
      return make_float2(sr[u * q + j], si[u * q + j]);
    };
    float2* dst = y + b * g1 * int64_t(g2) + k10;
    auto st = [&](int k2, int u, float2 v) {
      dst[int64_t(k2) * g1 + u] = make_float2(scale * v.x, scale * v.y);
    };
    for (int item = warp; item < g2 / 16; item += nwarps)
      pfft_mma::warp_dft<1, 2>(root, md, 16 * item, 0, kRows, ld, st);
  }
}

size_t pass2_smem(int g2) {
  return sizeof(float2) * g2 + 2 * sizeof(float) * kRows * size_t(g2 + 4);
}

size_t pass1_smem(int g1, int a, int ga, int gb) {
  const size_t extra = sizeof(float2) * size_t(ga + gb) * pfft_mma::col_tile(a);
  return pfft_mma::col_smem_bytes(g1, a, extra);
}

bool shape_ok(int g1, int a1, int g2, int ga, int gb) {
  const bool sub1 = a1 == 0 ? (g1 >= 2 && g1 <= 512)
                            : (a1 >= 2 && a1 <= 128 && g1 == a1 * 128);
  const bool digits = ga >= 2 && gb >= 1 && ga * gb == g1 &&
                      (a1 == 0 || (ga == a1 && gb == 128));
  return sub1 && digits && g1 % kRows == 0 && g2 >= 16 && g2 <= 512 &&
         g2 % 16 == 0 && g2 % kTabT1 == 0;
}

}  // namespace

// x (2*batch*g1*g2 floats) -> y through scratch (the same size); y may
// equal x.  Sub 1: a1 = 0 DIRECT (w1r/w1i the g1 x g1 DFT planes) or
// FUSED g1 = a1*128 (w1r/w1i a1 x a1, b1r/b1i 128 x 128, u1r/u1i the
// (a1, 128) inner twiddle); sub 2 DIRECT, w2r/w2i g2 x g2.  t1r..t2i: the
// bank's global3 tables for (ga, gb) at width 64, pair-expanded.  Returns
// a cudaError_t.
extern "C" int pf_global3(const float* x, float* y, float* scratch, int g1,
                          int a1, const float* w1r, const float* w1i,
                          const float* b1r, const float* b1i, const float* u1r,
                          const float* u1i, int g2, const float* w2r,
                          const float* w2i, const float* t1r, const float* t1i,
                          const float* t2r, const float* t2i, int ga, int gb,
                          int sign, int64_t batch, float scale, void* stream) {
  if (!shape_ok(g1, a1, g2, ga, gb) || batch < 1 || scratch == nullptr)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = int64_t(g1) * g2;
  pfft_mma::Col p{g1, a1, pfft_mma::col_tile(a1), w1r, w1i, b1r, b1i, u1r,
                  u1i, batch, g2};
  G3Epi epi{reinterpret_cast<float2*>(scratch), g1, g2, ga, gb, sign, n, p.T,
            t1r, t1i, t2r, t2i, pfft_mma::Mod(uint32_t(ga))};
  int err = pfft_mma::launch(g3_pass1, pass1_smem(g1, a1, ga, gb),
                             batch * (g2 / p.T), st, p,
                             reinterpret_cast<const float2*>(x), epi);
  if (err) return err;
  return pfft_mma::launch(g3_pass2, pass2_smem(g2), batch * (g1 / kRows), st,
                          reinterpret_cast<const float2*>(scratch),
                          reinterpret_cast<float2*>(y), g1, g2, w2r, w2i,
                          batch, scale);
}
