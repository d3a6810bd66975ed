// K17 `global_fused`: batched GLOBAL four-step transform n = G1*G2 on the
// PACKED interleaved buffer, both passes in one cooperative launch whose
// intermediate stays in L2.
//
// Replaces portfft_tpu/ops/pallas_global.py::global_fused_raw_call (the
// tuned engine {"eng": 6}, and {"eng": 6, "ftw": 1} with its factored
// twiddle).  Its function and its per-pass sums are K3's (fft_global2.cu),
// on the tile machinery of fft_common.cuh; with the row viewed as
// x[n1, n2] = x[G2*n1 + n2]:
//   pass 1: for each column n2, the G1-point transform down n1, times the
//           twiddle w_n^(k1*n2), stored as S[b, n2, k1] in a scratch;
//   pass 2: for each k1, the G2-point transform over n2, stored as
//           out[b, k1 + G1*k2] = scale * (...).
// A TPU core keeps the whole (G2, G1) intermediate in VMEM between the two
// passes.  An SM cannot (8 MiB at 2^20 points), so the batch runs in chunks
// whose scratch fits a quarter of L2 (cuda_global_bf.bf_chunk), as K5's
// does: per chunk pass 1, a grid-wide barrier, pass 2, a barrier; scratch
// reads bypass L1 (__ldcg).  The grid is every block the card holds at once
// with the kernel's real shared memory (the larger pass sets it: at a FUSED
// [16, 128] G1 two blocks an SM).  Each pass keeps its own tile width (K3's,
// rounded down to a power of two) and loads its own roots after the barrier.
//
// The twiddle: the bank's dense (G2, G1) table ("T", {"eng": 6}), or, in
// the factored mode, the per-tile factors of fft_ftw.cuh (the JAX
// package's "Q" or "ZQ" tables at 64 columns), formed in shared memory
// before each pass-1 tile, so that no dense twiddle is streamed.
//
// Bound on the H100, per complex element: 16 bytes in and out of device
// memory (+ 8 bytes of dense twiddle), the scratch round trip in L2, against
// 8*(G1' + G2) flops (G1' = G1 DIRECT, a + 128 FUSED): bound by the sums, as
// K3.
#include <cooperative_groups.h>

#include "fft_common.cuh"
#include "fft_ftw.cuh"

namespace {

namespace cg = cooperative_groups;

// Scratch reads: through L2 only (the scratch is rewritten between barriers).
struct FromL2 {
  const float2* p;
};
__device__ __forceinline__ float2 ld(const FromL2& x, int64_t i) {
  return __ldcg(x.p + i);
}

struct Fused {
  const float2* x;
  float2* y;
  float2* s;  // scratch: chunk*n points
  pfft::Sub s1, s2;
  int t1, t2;
  const float* twr;  // dense (g2, g1) [n2, k1]; nullptr in the factored mode
  const float* twi;
  pfft_ftw::Tables q;  // factored: tables 1r, 1i, 2r, 2i, 3r, 3i, 4r, 4i
  int64_t batch, chunk;
  float scale;
};

__host__ __device__ inline int roots_of(const pfft::Sub& s) {
  return s.a ? s.a + 128 : s.m;
}

__host__ __device__ inline int tile_elems(const pfft::Sub& s, int T) {
  return pfft::tile_rows(s) * pfft::tile_pitch(T);
}

// Shared memory in float2: the larger root table, two tiles of the larger
// pass, then (the factored mode) C1 and C2 of a pass-1 tile from
// extra_offset on.
__host__ __device__ inline int extra_offset(const Fused& p) {
  const int r1 = roots_of(p.s1), r2 = roots_of(p.s2);
  const int e1 = tile_elems(p.s1, p.t1), e2 = tile_elems(p.s2, p.t2);
  return (r1 > r2 ? r1 : r2) + 2 * (e1 > e2 ? e1 : e2);
}
__host__ __device__ inline int smem_elems(const Fused& p) {
  return extra_offset(p) + (p.twr ? 0 : pfft_ftw::factor_elems(p.s1, p.t1));
}

__device__ inline pfft::TileSmem pass_smem(const Fused& p, const pfft::Sub& s,
                                           int T, float2* smem) {
  const int r1 = roots_of(p.s1), r2 = roots_of(p.s2);
  pfft::TileSmem t;
  t.ra = smem;
  t.rb = smem + (s.a ? s.a : s.m);
  t.b0 = smem + (r1 > r2 ? r1 : r2);
  t.b1 = t.b0 + tile_elems(s, T);
  return t;
}

// Pass 1's store: S[b][n2][k1] = res[k1 of column t] * twiddle, elements
// fastest (the scratch rows are k1-contiguous); ends with __syncthreads.
__device__ void store1(const Fused& p, const pfft::Pass& ps, int64_t b,
                       int64_t c0, const float2* res, const float2* extra) {
  const pfft::Sub& s = ps.sub;
  const int m = s.m, T = ps.T, es = pfft::tile_pitch(T);
  const int64_t left = ps.ncols - c0;
  const int tv = left < T ? int(left) : T;
  for (int e = threadIdx.x; e < m * T; e += blockDim.x) {
    const int k = e % m, t = e / m;
    if (t >= tv) continue;
    float2 v = res[pfft::tile_pos(s, k) * es + t];
    if (p.twr) {
      const int64_t i = (c0 + t) * m + k;
      v = pfft::cmul(v, make_float2(__ldg(p.twr + i), __ldg(p.twi + i)));
    } else {
      v = pfft_ftw::apply(v, extra, p.s1, T, t, k);
    }
    p.s[b * ps.obs + (c0 + t) * ps.ocs + k] = v;
  }
  __syncthreads();
}

__device__ __forceinline__ int64_t chunk_len(const Fused& p, int64_t r) {
  const int64_t left = p.batch - r * p.chunk;
  return left < p.chunk ? left : p.chunk;
}

__global__ void __launch_bounds__(pfft::kThreads) fused_kernel(Fused p) {
  extern __shared__ float2 smem[];
  cg::grid_group grid = cg::this_grid();
  const int g1 = p.s1.m, g2 = p.s2.m;
  const int64_t n = int64_t(g1) * g2;
  pfft::Pass p1{};
  p1.sub = p.s1;
  p1.ncols = g2;
  p1.T = p.t1;
  p1.ibs = n;
  p1.iis = g2;
  p1.ics = 1;
  p1.obs = n;
  p1.oks = 1;
  p1.ocs = g1;
  p1.scale = 1.f;
  pfft::Pass p2{};
  p2.sub = p.s2;
  p2.ncols = g1;
  p2.T = p.t2;
  p2.ibs = n;
  p2.iis = g1;
  p2.ics = 1;
  p2.obs = n;
  p2.oks = g1;
  p2.ocs = 1;
  p2.scale = p.scale;
  const pfft::TileSmem sm1 = pass_smem(p, p.s1, p.t1, smem);
  const pfft::TileSmem sm2 = pass_smem(p, p.s2, p.t2, smem);
  float2* extra = smem + extra_offset(p);
  const int64_t tiles1 = (g2 + p.t1 - 1) / p.t1, tiles2 = (g1 + p.t2 - 1) / p.t2;
  const int64_t chunks = (p.batch + p.chunk - 1) / p.chunk;
  for (int64_t r = 0; r < chunks; ++r) {
    const int64_t nb = chunk_len(p, r);
    const float2* x = p.x + r * p.chunk * n;
    float2* y = p.y + r * p.chunk * n;
    pfft::load_sub_roots(p.s1, sm1);
    for (int64_t i = blockIdx.x; i < nb * tiles1; i += gridDim.x) {
      const int64_t b = i / tiles1, c0 = (i - b * tiles1) * p.t1;
      if (!p.twr) pfft_ftw::prepare(p.q, p.s1, p.t1, c0, extra);
      pfft::tile_load(p1, b, c0, x, sm1.b0);
      const float2* res = pfft::sub_dft(p.s1, sm1.ra, sm1.rb, sm1.b0, sm1.b1,
                                        p.t1, pfft::tile_pitch(p.t1));
      store1(p, p1, b, c0, res, extra);
    }
    grid.sync();  // the chunk's scratch is written, and pass 1's roots read
    pfft::load_sub_roots(p.s2, sm2);
    for (int64_t i = blockIdx.x; i < nb * tiles2; i += gridDim.x) {
      const int64_t b = i / tiles2;
      pfft::pass_tile(p2, b, (i - b * tiles2) * p.t2, FromL2{p.s}, y, sm2);
    }
    if (r + 1 < chunks) grid.sync();  // the scratch and pass 2's roots read
  }
}

bool sub_ok(const pfft::Sub& s) {
  return s.m >= 1 && (s.a == 0 || s.a * 128 == s.m);
}

bool tile_ok(int t) { return t == 1 || t == 2 || t == 4 || t == 8; }

}  // namespace

// x (2*batch*g1*g2 floats) -> y (may equal x) through the scratch s of
// 2*chunk*g1*g2 floats.  Sub k (k = 1, 2) has length gk; ak = 0 for DIRECT
// (wkr/wki: gk x gk DFT planes) or a for FUSED [a, 128] (wkr/wki: a x a,
// bkr/bki: 128 x 128, ukr/uki: the (a, 128) twiddle planes).  t1, t2:
// columns per tile of the two passes (1, 2, 4 or 8).  tr/ti: the dense
// (g2, g1) twiddle planes, or nullptr and q: the factored mode's eight
// table planes ("Q" or "ZQ" at 64 columns).  Returns a cudaError_t
// (cudaErrorCooperativeLaunchTooLarge where not one block fits an SM).
extern "C" int pf_global_fused(
    const float* x, float* y, float* s, int g1, int a1, const float* w1r,
    const float* w1i, const float* b1r, const float* b1i, const float* u1r,
    const float* u1i, int g2, int a2, const float* w2r, const float* w2i,
    const float* b2r, const float* b2i, const float* u2r, const float* u2i,
    int t1, int t2, const float* tr, const float* ti, const float* q1r,
    const float* q1i, const float* q2r, const float* q2i, const float* q3r,
    const float* q3i, const float* q4r, const float* q4i, int64_t batch,
    int64_t chunk, float scale, void* stream) {
  Fused p{reinterpret_cast<const float2*>(x),
          reinterpret_cast<float2*>(y),
          reinterpret_cast<float2*>(s),
          pfft::Sub{g1, a1, w1r, w1i, b1r, b1i, u1r, u1i},
          pfft::Sub{g2, a2, w2r, w2i, b2r, b2i, u2r, u2i},
          t1, t2, tr, ti,
          {{q1r, q1i, q2r, q2i, q3r, q3i, q4r, q4i}},
          batch, chunk, scale};
  const bool dense = tr != nullptr && ti != nullptr;
  if (!sub_ok(p.s1) || !sub_ok(p.s2) || !tile_ok(t1) || !tile_ok(t2) ||
      batch < 1 || chunk < 1 || s == nullptr ||
      (!dense && (q1r == nullptr || !pfft_ftw::tables_ok(p.s1, g2))))
    return int(cudaErrorInvalidValue);
  const size_t smem = sizeof(float2) * size_t(smem_elems(p));
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel,
                                                      pfft::kThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_kernel),
                                    dim3(unsigned(per_sm * sms)),
                                    dim3(pfft::kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
