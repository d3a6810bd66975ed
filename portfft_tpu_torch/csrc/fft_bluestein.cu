// K15 `bluestein`: the batched n-point transform of a BLUESTEIN plan whose
// convolution of length M = g1*g2 is GLOBAL, on (re, im) float planes
// (b, n), in three launches through two float2 buffers S1, S2 of b*M
// elements.
//
// Replaces portfft_tpu/ops/pallas_bluestein.py::bluestein_call, and with
// pf_bluestein_bf its butterfly mode (K15-bf, below).  With the
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
// pass walks the columns of fft_common.cuh's tiles (pass 2 with two
// sub-transforms in one tile), and pass 3 writes the rows of y itself.
// Every sub-transform runs on the radix stages of fft_radix.cuh (DIRECT as
// Stockham stages, FUSED [a, 128] in its two stages, a prime factor above 3
// as one generic stage), fp32 FMA over the bank's root tables.  The blocks
// stay resident and stride over the tiles; each starts its next tile's
// loads (pfft_radix::Prefetch) before this tile's stages, so they fly
// while it works.  The pointwise steps (b^, the twiddles, BFIN and the
// scale) walk the transformed tile elements fastest, so that neighbouring
// threads read neighbouring table entries; passes 1 and 2 store in the same
// walk, while pass 3, whose rows of y run along k1' and BFIN's along k2',
// puts the products back in the tile and stores it along the columns.
//
// Bound on the H100: the function moves 16 bytes per output element, but
// the three passes move 8*(n + 2*M) + 8*4*M bytes per transform through
// S1 and S2 (about 11.9 GB at n = 65537, b = 2048: 3.5 ms) against about
// 5*log2(g) flops a point of each of the four g-point sub-transforms, so
// the kernel is bound by bytes.
#include "fft_global_bf.cuh"
#include "fft_radix.cuh"

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

// K15's tiles: about kTileElems elements of kTileCols columns at most, and
// no more shared memory than lets two blocks share an SM.  Raced on the
// H100 (PERF.md): wider tiles read longer row segments in the column walks,
// and a lone block on an SM waits at every stage's barrier.
constexpr int kTileElems = 6144;
constexpr int kTileCols = 32;
using pfft_radix::kBlockSmem;
using pfft_radix::launch_resident;

__host__ __device__ int roots_len(const pfft::Sub& s) {
  return s.a ? s.a + 128 : s.m;
}

// For each element k of each column t of the tile res that holds data,
// elements fastest: put(t, k, pos, scale * res[pos] * tab[(c0 + t)*cs +
// k*ks]), pos its tile position and tab an (re, im) pair of planes; each
// thread's table loads kPrefetch at a time in flight together.  Ends with
// __syncthreads.  The arithmetic of tile_store's twiddle and scale.
template <class Put>
__device__ void times(const pfft::Pass& p, int64_t c0, const float2* res,
                      const float* re, const float* im, int64_t cs,
                      int64_t ks, float scale, Put put) {
  constexpr int K = pfft_radix::kPrefetch;
  const int m = p.sub.m;
  const int es = pfft::tile_pitch(p.T);
  const int total = m * p.T;
  const int64_t left = p.ncols - c0;
  const int tv = left < p.T ? int(left) : p.T;
  for (int e0 = threadIdx.x; e0 < total; e0 += K * blockDim.x) {
    float2 w[K];
    int at[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int e = e0 + q * blockDim.x;
      const int t = e / m;
      const int k = e - t * m;
      at[q] = e < total && t < tv ? pfft::tile_pos(p.sub, k) * es + t : -1;
      if (at[q] >= 0) {
        const int64_t i = (c0 + t) * cs + k * ks;
        w[q] = make_float2(__ldg(re + i), __ldg(im + i));
      }
    }
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (at[q] < 0) continue;
      const int e = e0 + q * blockDim.x;
      const int t = e / m;
      const float2 v = pfft::cmul(res[at[q]], w[q]);
      put(t, e - t * m, at[q], make_float2(scale * v.x, scale * v.y));
    }
  }
  __syncthreads();
}

// The pass's twiddle and scale on the transformed tile res, and its store.
// Where the output's elements are contiguous (passes 1 and 2) one walk,
// elements fastest, does both; where its columns are (pass 3: the rows of
// y run along k1', BFIN's along k2'), the product goes back to the tile
// and tile_store writes it along the columns.
template <class Y>
__device__ void finish(const pfft::Pass& p, int64_t c0, float2* res, Y y) {
  if (p.ocs != 1) {
    const int64_t ocs = p.ocs, oks = p.oks;
    times(p, c0, res, p.twr, p.twi, p.tcs, p.tks, p.scale,
          [=](int t, int k, int, float2 v) {
            pfft::st(y, (c0 + t) * ocs + k * oks, v);
          });
    return;
  }
  times(p, c0, res, p.twr, p.twi, p.tcs, p.tks, p.scale,
        [=](int, int, int pos, float2 v) { res[pos] = v; });
  pfft::Pass q = p;
  q.twr = nullptr;
  q.scale = 1.f;
  pfft::tile_store(q, 0, c0, res, y);
}

__global__ void __launch_bounds__(pfft::kThreads, 2)
    blue_pass1(pfft::Pass p, pfft::ConstPlanes x, const float* cr,
               const float* ci, int64_t n, float2* s1) {
  extern __shared__ float2 smem[];
  const pfft::TileSmem sm = pfft::tile_smem(p.sub, p.T, smem);
  pfft::load_sub_roots(p.sub, sm);
  const int64_t conv = int64_t(p.sub.m) * p.ncols;
  pfft_radix::tiles(
      p, sm.b0,
      [=](int64_t b) {
        return pfft::ChirpIn{{x.re + b * n, x.im + b * n}, cr, ci, n};
      },
      [=](const pfft::Pass& q, int64_t b, int64_t c0) {
        finish(q, c0,
               pfft_radix::sub_fft(q.sub, sm.ra, sm.rb, sm.b0, sm.b1, q.T,
                                   pfft::tile_pitch(q.T)),
               s1 + b * conv);
      });
}

__global__ void __launch_bounds__(pfft::kThreads, 2)
    blue_pass3(pfft::Pass p, const float2* s2, pfft::Planes y, int64_t n) {
  extern __shared__ float2 smem[];
  const pfft::TileSmem sm = pfft::tile_smem(p.sub, p.T, smem);
  pfft::load_sub_roots(p.sub, sm);
  const int64_t conv = int64_t(p.sub.m) * p.ncols;
  pfft_radix::tiles(
      p, sm.b0, [=](int64_t b) { return s2 + b * conv; },
      [=](const pfft::Pass& q, int64_t b, int64_t c0) {
        finish(q, c0,
               pfft_radix::sub_fft(q.sub, sm.ra, sm.rb, sm.b0, sm.b1, q.T,
                                   pfft::tile_pitch(q.T)),
               pfft::HeadPlanes{{y.re + b * n, y.im + b * n}, n});
      });
}

size_t pass2_smem_bytes(const pfft::Sub& s, int T) {
  return sizeof(float2) * (2 * size_t(roots_len(s)) +
                           2 * size_t(pfft::tile_rows(s)) * pfft::tile_pitch(T));
}

// Pass 2: p walks the g1 columns k1 of S1 (sub: the forward g2 sub) and
// stores S2 with the backward twiddle; sb is the backward g2 sub.
__global__ void __launch_bounds__(pfft::kThreads, 2)
    blue_pass2(pfft::Pass p, pfft::Sub sb, const float* hr, const float* hi,
               const float2* s1, float2* s2) {
  extern __shared__ float2 smem[];
  const int R = roots_len(p.sub);
  pfft::TileSmem fw = pfft::tile_smem(p.sub, p.T, smem + R);  // b0, b1 after
  fw.ra = smem;                                               // both root sets
  fw.rb = fw.ra + (p.sub.a ? p.sub.a : p.sub.m);
  pfft::TileSmem bw = fw;
  bw.ra = smem + R;
  bw.rb = bw.ra + (sb.a ? sb.a : sb.m);
  pfft::load_sub_roots(p.sub, fw);
  pfft::load_sub_roots(sb, bw);
  const int64_t conv = int64_t(p.sub.m) * p.ncols;
  pfft_radix::tiles(
      p, fw.b0, [=](int64_t b) { return s1 + b * conv; },
      [=](const pfft::Pass& q, int64_t b, int64_t c0) {
        const int es = pfft::tile_pitch(q.T);
        float2* r =
            pfft_radix::sub_fft(q.sub, fw.ra, fw.rb, fw.b0, fw.b1, q.T, es);
        times(q, c0, r, hr, hi, q.sub.m, 1, 1.f,  // b^[k1, k2]
              [=](int, int, int pos, float2 v) { r[pos] = v; });
        float2* o = r == fw.b0 ? fw.b1 : fw.b0;
        finish(q, c0, pfft_radix::sub_fft(sb, bw.ra, bw.rb, r, o, q.T, es),
               s2 + b * conv);
      });
}

// K15-bf: the butterfly mode (pallas_bluestein.py bluestein_call with
// PORTFFT_BLUESTEIN_BF, its blane_dif/blane_dit).  The same three passes,
// each sub-transform of length g = A*128 (A = 2^a*3^b <= 16) factored: the
// forward stages (passes 1 and 2) run the A-point slab DFT over the high
// digit iA of i = 128*iA + iB (pfft_bf::slab_dft, radix 2 and 3, snapped
// constants), the digit twiddle U[kA][iB] = w_g^(kA*iB) and the 128-point
// DFT over iB, and leave frequency kA + A*kB at position 128*kA + kB
// (digit-major, torch_fft.lane_perm); the backward stages (passes 2 and 3)
// take that order, run the 128-point DFT over each slab, the twiddle
// U[a][jB] and the A-point slab DFT across slabs, and give natural order.
// The permutations cancel inside the convolution; the tables between the
// stages (the forward twiddle BLT, b^ BLP, the backward twiddle BLB) are
// the bank's, stored permuted, so no index is ever reversed.  About
// A + 128 multiply-adds a point and stage where the dense mode sums g.
// A sub here is {g, A, -, -, br, bi = the 128-point DFT planes, ur, ui =
// U}; its tile keeps the FUSED layout (element i at i + i/128).

// The forward stage: natural tile in `in` -> digit-major tile in `out`
// (`in` is overwritten).
template <int A>
__device__ float2* bf_dif(const pfft::Sub& s, const float2* rb, float2* in,
                          float2* out, int T, int sign) {
  const int es = pfft::tile_pitch(T);
  for (int u = threadIdx.x; u < 128 * T; u += blockDim.x) {
    const int iB = u / T, t = u - iB * T;
    float2 v[A];
#pragma unroll
    for (int i = 0; i < A; ++i) v[i] = in[(129 * i + iB) * es + t];
    pfft_bf::slab_dft<A>(v, sign);
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const int w = k * 128 + iB;
      in[(129 * k + iB) * es + t] =
          pfft::cmul(v[k], make_float2(__ldg(s.ur + w), __ldg(s.ui + w)));
    }
  }
  __syncthreads();
  pfft::dft_stage(
      in, out, 128, T * A, es, rb,
      [=](int u) {
        const int ka = u / T;
        return 129 * ka * es + (u - ka * T);
      },
      [=](int u, int kb) {
        const int ka = u / T;
        return (129 * ka + kb) * es + (u - ka * T);
      },
      [](int, int, float2 y) { return y; });
  __syncthreads();
  return out;
}

// The backward stage: digit-major tile in `in` -> natural tile in `out`.
template <int A>
__device__ float2* bf_dit(const pfft::Sub& s, const float2* rb, float2* in,
                          float2* out, int T, int sign) {
  const int es = pfft::tile_pitch(T);
  pfft::dft_stage(
      in, out, 128, T * A, es, rb,
      [=](int u) {
        const int a = u / T;
        return 129 * a * es + (u - a * T);
      },
      [=](int u, int jb) {
        const int a = u / T;
        return (129 * a + jb) * es + (u - a * T);
      },
      [](int, int, float2 y) { return y; });
  __syncthreads();
  for (int u = threadIdx.x; u < 128 * T; u += blockDim.x) {
    const int jB = u / T, t = u - jB * T;
    float2 v[A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int w = a * 128 + jB;
      v[a] = pfft::cmul(out[(129 * a + jB) * es + t],
                        make_float2(__ldg(s.ur + w), __ldg(s.ui + w)));
    }
    pfft_bf::slab_dft<A>(v, sign);
#pragma unroll
    for (int j = 0; j < A; ++j) out[(129 * j + jB) * es + t] = v[j];
  }
  __syncthreads();
  return out;
}

// Passes 1 (forward stage, Dif) and 3 (backward stage): blue_tiles with the
// factored sub-transform.
template <int A, bool Dif, class In, class Out>
__device__ void bf_tiles(const pfft::Pass& p, int sign, In in, Out out) {
  extern __shared__ float2 smem[];
  float2* rb = smem;
  float2* b0 = smem + 128;
  const int es = pfft::tile_pitch(p.T);
  float2* b1 = b0 + pfft::tile_rows(p.sub) * es;
  pfft::load_roots(rb, p.sub.br, p.sub.bi, 128);
  const int64_t per = (p.ncols + p.T - 1) / p.T;
  const int64_t ntiles = p.nbatch * per;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b = tile / per;
    const int64_t c0 = (tile - b * per) * p.T;
    pfft::tile_load(p, 0, c0, in(b), b0);
    const float2* res = Dif ? bf_dif<A>(p.sub, rb, b0, b1, p.T, sign)
                            : bf_dit<A>(p.sub, rb, b0, b1, p.T, sign);
    pfft::tile_store(p, 0, c0, res, out(b));
  }
}

template <int A>
__global__ void __launch_bounds__(pfft::kThreads)
    bf_pass1(pfft::Pass p, pfft::ConstPlanes x, const float* cr,
             const float* ci, int64_t n, float2* s1) {
  const int64_t conv = int64_t(p.sub.m) * p.ncols;
  bf_tiles<A, true>(
      p, -1,
      [=](int64_t b) {
        return pfft::ChirpIn{{x.re + b * n, x.im + b * n}, cr, ci, n};
      },
      [=](int64_t b) { return s1 + b * conv; });
}

template <int A>
__global__ void __launch_bounds__(pfft::kThreads)
    bf_pass3(pfft::Pass p, const float2* s2, pfft::Planes y, int64_t n) {
  const int64_t conv = int64_t(p.sub.m) * p.ncols;
  bf_tiles<A, false>(
      p, +1, [=](int64_t b) { return s2 + b * conv; },
      [=](int64_t b) {
        return pfft::HeadPlanes{{y.re + b * n, y.im + b * n}, n};
      });
}

// Pass 2: forward stage over g2, times b^ (BLP), backward stage, stored with
// BLB by tile_store; sb is the backward g2 sub (its 128-point roots and U).
template <int A>
__global__ void __launch_bounds__(pfft::kThreads)
    bf_pass2(pfft::Pass p, pfft::Sub sb, const float* hr, const float* hi,
             const float2* s1, float2* s2) {
  extern __shared__ float2 smem[];
  const pfft::Sub& sf = p.sub;
  float2* rf = smem;
  float2* rb = smem + 128;
  float2* b0 = smem + 256;
  const int T = p.T, es = pfft::tile_pitch(T);
  float2* b1 = b0 + pfft::tile_rows(sf) * es;
  pfft::load_roots(rf, sf.br, sf.bi, 128);
  pfft::load_roots(rb, sb.br, sb.bi, 128);
  const int g2 = sf.m;
  const int64_t conv = int64_t(g2) * p.ncols;
  const int64_t per = (p.ncols + T - 1) / T;
  const int64_t ntiles = p.nbatch * per;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b = tile / per;
    const int64_t c0 = (tile - b * per) * T;
    pfft::tile_load(p, 0, c0, s1 + b * conv, b0);
    float2* r = bf_dif<A>(sf, rf, b0, b1, T, -1);
    const int64_t left = p.ncols - c0;
    const int tv = left < T ? int(left) : T;
    for (int e = threadIdx.x; e < g2 * T; e += blockDim.x) {
      const int q = e / T;
      const int t = e - q * T;
      if (t >= tv) continue;
      const int pos = pfft::tile_pos(sf, q) * es + t;
      const int64_t h = (c0 + t) * g2 + q;  // BLP[p1, q]
      r[pos] = pfft::cmul(r[pos], make_float2(__ldg(hr + h), __ldg(hi + h)));
    }
    __syncthreads();
    r = bf_dit<A>(sb, rb, r, b0, T, +1);
    pfft::tile_store(p, 0, c0, r, s2 + b * conv);
  }
}

template <int A>
int launch_bf(const pfft::Pass& p1, const pfft::Pass& p2,
              const pfft::Pass& p3, const pfft::Sub& b2,
              pfft::ConstPlanes x, const float* prer, const float* prei,
              const float* hatr, const float* hati, float2* S1, float2* S2,
              pfft::Planes y, int64_t n, cudaStream_t st, int pass) {
  const size_t tile =
      sizeof(float2) * 2 * size_t(pfft::tile_rows(pass == 2 ? p2.sub : p1.sub)) *
      pfft::tile_pitch(pass == 2 ? p2.T : p1.T);
  if (pass == 1)
    return pfft::launch_tiles(bf_pass1<A>, sizeof(float2) * 128 + tile,
                              pfft::pass_tiles(p1), st, p1, x, prer, prei, n,
                              S1);
  if (pass == 2)
    return pfft::launch_tiles(bf_pass2<A>, sizeof(float2) * 256 + tile,
                              pfft::pass_tiles(p2), st, p2, b2, hatr, hati,
                              static_cast<const float2*>(S1), S2);
  return pfft::launch_tiles(bf_pass3<A>, sizeof(float2) * 128 + tile,
                            pfft::pass_tiles(p3), st, p3,
                            static_cast<const float2*>(S2), y, n);
}

// Launches pass `pass` with the slab factor A of its sub.
int launch_bf_pass(int A, const pfft::Pass& p1, const pfft::Pass& p2,
                   const pfft::Pass& p3, const pfft::Sub& b2,
                   pfft::ConstPlanes x, const float* prer, const float* prei,
                   const float* hatr, const float* hati, float2* S1,
                   float2* S2, pfft::Planes y, int64_t n, cudaStream_t st,
                   int pass) {
#define PFFT_BF_CASE(a)                                                      \
  case a:                                                                    \
    return launch_bf<a>(p1, p2, p3, b2, x, prer, prei, hatr, hati, S1, S2,  \
                        y, n, st, pass);
  switch (A) {
    PFFT_BF_CASE(1)
    PFFT_BF_CASE(2)
    PFFT_BF_CASE(3)
    PFFT_BF_CASE(4)
    PFFT_BF_CASE(6)
    PFFT_BF_CASE(8)
    PFFT_BF_CASE(9)
    PFFT_BF_CASE(12)
    PFFT_BF_CASE(16)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef PFFT_BF_CASE
}

bool sub_ok(const pfft::Sub& s) {
  return s.m >= 1 && s.m <= pfft::kTileMax && (s.a == 0 || s.a * 128 == s.m);
}

// Columns per tile of a pass over the sub s with ncols columns (pass 2:
// two root sets in its shared memory).
int tile_of(const pfft::Sub& s, int64_t ncols, bool pass2) {
  int T = pfft::pick_tile(s.m, ncols, kTileElems, kTileCols);
  while (T > 1 && (pass2 ? pass2_smem_bytes(s, T)
                          : pfft::pass_smem_bytes(s, T)) > kBlockSmem)
    --T;
  return T;
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
  p1.T = tile_of(f1, g2, false);
  p1.iis = g2;
  p1.ics = 1;
  p1.oks = 1;
  p1.ocs = g1;
  p1.twr = twfr;
  p1.twi = twfi;
  p1.tcs = g1;
  p1.tks = 1;
  p1.scale = 1.f;
  int err = launch_resident(blue_pass1, pfft::pass_smem_bytes(f1, p1.T),
                            pfft::pass_tiles(p1), st, p1,
                            pfft::ConstPlanes{xr, xi}, prer, prei, n, S1);
  if (err) return err;

  pfft::Pass p2{};
  p2.sub = f2;
  p2.nbatch = batch;
  p2.ncols = g1;
  p2.T = tile_of(f2, g1, true);
  p2.iis = g1;
  p2.ics = 1;
  p2.oks = 1;
  p2.ocs = g2;
  p2.twr = twbr;
  p2.twi = twbi;
  p2.tcs = g2;
  p2.tks = 1;
  p2.scale = 1.f;
  err = launch_resident(blue_pass2, pass2_smem_bytes(f2, p2.T),
                        pfft::pass_tiles(p2), st, p2, b2, hatr, hati,
                        static_cast<const float2*>(S1), S2);
  if (err) return err;

  pfft::Pass p3{};
  p3.sub = b1;
  p3.nbatch = batch;
  p3.ncols = g2;
  p3.T = tile_of(b1, g2, false);
  p3.iis = g2;
  p3.ics = 1;
  p3.oks = g2;
  p3.ocs = 1;
  p3.twr = finr;
  p3.twi = fini;
  p3.tcs = g1;
  p3.tks = 1;
  p3.scale = scale;
  return launch_resident(blue_pass3, pfft::pass_smem_bytes(b1, p3.T),
                         pfft::pass_tiles(p3), st, p3,
                         static_cast<const float2*>(S2), pfft::Planes{yr, yi},
                         n);
}

// K15-bf: pf_bluestein's function in the butterfly mode.  The same
// arguments, but each sub is {g, A, unused, unused, the 128-point DFT
// planes of its direction (row 1 read), U(A, 128) of its direction}, with
// g = A*128, A = 2^a*3^b <= 16; twf, hat and twb are the bank's permuted
// BLT, BLP ("f") and BLB.  Returns a cudaError_t.
extern "C" int pf_bluestein_bf(
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
  if (a1 < 1 || a2 < 1 || g1 != 128 * a1 || g2 != 128 * a2 || g1b != g1 ||
      a1b != a1 || g2b != g2 || a2b != a2 || batch < 1 || n < 1 ||
      n > int64_t(g1) * g2 || s1 == nullptr || s2 == nullptr ||
      f1br == nullptr || f1ur == nullptr || b1br == nullptr ||
      b1ur == nullptr || f2br == nullptr || f2ur == nullptr ||
      b2br == nullptr || b2ur == nullptr)
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
  const pfft::ConstPlanes x{xr, xi};
  const pfft::Planes y{yr, yi};
  for (int pass = 1; pass <= 3; ++pass) {
    const int err = launch_bf_pass(pass == 2 ? a2 : a1, p1, p2, p3, b2, x,
                                   prer, prei, hatr, hati, S1, S2, y, n, st,
                                   pass);
    if (err) return err;
  }
  return 0;
}
