// K13 `chain`: batched DIRECT or FUSED transforms of length n on (re, im)
// float planes (b, n), the leaves of the plane path's executor.
//
// Replaces portfft_tpu/ops/pallas_fft.py::fused_chain (its DIRECT kernel,
// one matmul with the n x n DFT matrix, and its two-stage [a >= 8, 128]
// kernel) and ::_generic_chain_call (any factor chain; the JAX package runs
// it in interpret mode only and leaves such chains to XLA on the TPU).
// Three modes:
//   DIRECT      one n-point DFT per row (pfft::sub_dft, as K1);
//   [a, 128]    the two-stage transform of K2, one tile per row for
//               n <= 8192, else two launches through a float2 scratch;
//   chain       the Stockham chain of the plan's factors f_0 .. f_{K-1}:
//               stage s views the row as L_s vectors of f_s*m_s elements
//               (L_s = f_0*..*f_{s-1}, m_s = n/(L_s*f_s)) and writes
//                 out[(r + L_s*k)*m_s + n2] = T_s[n2, k] *
//                     sum_n1 in[r*f_s*m_s + n1*m_s + n2] * w_f^(n1*k)
//               with T_s the bank's ("T", f_s, m_s) table (none at the
//               last stage, m = 1); after the last stage the row is in
//               natural order.  This is the JAX package's recursion
//               (xla_fft.exec_chain_xla) with the same tables, run
//               iteratively in shared memory.  Past kChainMax the first
//               factor runs as a column pass into a scratch and the rest
//               of the chain as a second launch on its contiguous vectors,
//               storing out[k + f_0*j].
// Every sum is fp32 FMA over the root tables on the CUDA cores.
//
// Bound on the H100, per complex element: 8*sum(factors) flops (8*n for
// DIRECT, 8*(a + 128) for [a, 128]) against 16 bytes of device memory, so
// the kernel is bound by arithmetic (in this first version, as K1-K3, by
// shared-memory operand reads).
#include "fft_common.cuh"

namespace {

constexpr int kMaxFactors = 12;
constexpr int kSingleMax = 8192;   // [a, 128] in one tile (K2's limit)
constexpr int kChainMax = 12288;   // a chain in one tile: 2 float2 tiles
                                   // of 12288 + roots < 227 KB

// The factors of a chain and, per stage, its f x f DFT planes (row 1: the
// roots) and its (m, f) twiddle planes (nullptr at the last stage).
struct Chain {
  int nf;
  int f[kMaxFactors];
  const float* wr[kMaxFactors];
  const float* wi[kMaxFactors];
  const float* tr[kMaxFactors];
  const float* ti[kMaxFactors];
};

template <class X, class Y>
__global__ void __launch_bounds__(pfft::kThreads)
    pass_kernel(pfft::Pass p, X x, Y y) {
  pfft::run_pass(p, x, y);
}

int roots_of(const Chain& c) {
  int r = 0;
  for (int s = 0; s < c.nf; ++s) r += c.f[s];
  return r;
}

size_t chain_smem_bytes(const Chain& c, int n, int T) {
  return sizeof(float2) *
         (size_t(roots_of(c)) + 2 * size_t(n) * pfft::tile_pitch(T));
}

// The chain on the tiles of pass p (p.sub: DIRECT of the chain's length,
// used only for the tile geometry).
template <class X, class Y>
__global__ void __launch_bounds__(pfft::kThreads)
    chain_kernel(pfft::Pass p, Chain c, X x, Y y) {
  extern __shared__ float2 smem[];
  const int n = p.sub.m;
  const int T = p.T;
  const int es = pfft::tile_pitch(T);
  int off = 0;
  for (int s = 0; s < c.nf; ++s) {
    pfft::load_roots(smem + off, c.wr[s], c.wi[s], c.f[s]);
    off += c.f[s];
  }
  float2* const t0 = smem + off;
  float2* const t1 = t0 + n * es;
  const int64_t per_batch = (p.ncols + T - 1) / T;
  const int64_t ntiles = p.nbatch * per_batch;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b = tile / per_batch;
    const int64_t c0 = (tile - b * per_batch) * T;
    pfft::tile_load(p, b, c0, x, t0);
    float2* src = t0;
    float2* dst = t1;
    int L = 1, rem = n, roff = 0;
    for (int s = 0; s < c.nf; ++s) {
      const int f = c.f[s];
      const int m = rem / f;
      const float* tr = c.tr[s];
      const float* ti = c.ti[s];
      // vector u = (r, n2, t), t fastest
      pfft::dft_stage(
          src, dst, f, L * m * T, m * es, smem + roff,
          [=](int u) {
            const int q = u / T;
            const int r = q / m;
            return (r * f * m + (q - r * m)) * es + (u - q * T);
          },
          [=](int u, int k) {
            const int q = u / T;
            const int r = q / m;
            return ((r + L * k) * m + (q - r * m)) * es + (u - q * T);
          },
          [=](int u, int k, float2 v) {
            if (tr == nullptr) return v;
            const int q = u / T;
            const int i = (q - (q / m) * m) * f + k;
            return pfft::cmul(v, make_float2(__ldg(tr + i), __ldg(ti + i)));
          });
      __syncthreads();
      float2* tmp = src;
      src = dst;
      dst = tmp;
      L *= f;
      rem = m;
      roff += f;
    }
    pfft::tile_store(p, b, c0, src, y);
  }
}

template <class X, class Y>
int launch_chain(const pfft::Pass& p, const Chain& c, X x, Y y,
                 cudaStream_t st) {
  return pfft::launch_tiles(chain_kernel<X, Y>,
                            chain_smem_bytes(c, p.sub.m, p.T),
                            pfft::pass_tiles(p), st, p, c, x, y);
}

template <class X, class Y>
int launch_sub(const pfft::Pass& p, X x, Y y, cudaStream_t st) {
  return pfft::launch_tiles(pass_kernel<X, Y>,
                            pfft::pass_smem_bytes(p.sub, p.T),
                            pfft::pass_tiles(p), st, p, x, y);
}

// A pass over `batch` rows of n: each row one column.
pfft::Pass row_pass(const pfft::Sub& s, int64_t batch) {
  pfft::Pass p{};
  p.sub = s;
  p.nbatch = 1;
  p.ncols = batch;
  p.T = pfft::pick_tile(s.m, batch, 4096, 1 << 20);
  p.iis = 1;
  p.ics = s.m;
  p.oks = 1;
  p.ocs = s.m;
  p.scale = 1.f;
  return p;
}

}  // namespace

// 1 when pf_chain of a FUSED [a, 128] transform (a > 0) needs a scratch of
// 2*batch*a*128 floats.
extern "C" int pf_chain_needs_scratch(int a) {
  return a * 128 > kSingleMax ? 1 : 0;
}

// 1 when pf_chain_general of length n needs a scratch of 2*batch*n floats.
extern "C" int pf_chain_general_needs_scratch(int n) {
  return n > kChainMax ? 1 : 0;
}

// Planes (xr, xi) of batch rows of m -> (yr, yi).  a = 0: DIRECT, wr/wi the
// m x m DFT planes; a > 0: FUSED m = a*128, wr/wi a x a, br/bi 128 x 128,
// ur/ui the (a, 128) twiddle planes.  Returns a cudaError_t.
extern "C" int pf_chain(const float* xr, const float* xi, float* yr, float* yi,
                        float* scratch, int m, int a, const float* wr,
                        const float* wi, const float* br, const float* bi,
                        const float* ur, const float* ui, int64_t batch,
                        void* stream) {
  if (m < 1 || batch < 1 || (a != 0 && a * 128 != m))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const pfft::ConstPlanes x{xr, xi};
  const pfft::Planes y{yr, yi};
  if (a == 0 || m <= kSingleMax)
    return launch_sub(row_pass(pfft::Sub{m, a, wr, wi, br, bi, ur, ui}, batch),
                      x, y, st);
  if (scratch == nullptr) return int(cudaErrorInvalidValue);
  float2* s = reinterpret_cast<float2*>(scratch);
  // K2's two launches: the a-point DFT down each column n2 with the
  // twiddle, S[b, n2, k1]; then the 128-point DFT over n2, out[k1 + a*k2].
  pfft::Pass p1{};
  p1.sub = pfft::Sub{a, 0, wr, wi, nullptr, nullptr, nullptr, nullptr};
  p1.nbatch = batch;
  p1.ncols = 128;
  p1.T = pfft::pick_tile(a, 128, 4096, 8);
  p1.ibs = m;
  p1.iis = 128;
  p1.ics = 1;
  p1.obs = m;
  p1.oks = 1;
  p1.ocs = a;
  p1.twr = ur;
  p1.twi = ui;
  p1.tcs = 1;
  p1.tks = 128;
  p1.scale = 1.f;
  int err = launch_sub(p1, x, s, st);
  if (err) return err;
  pfft::Pass p2{};
  p2.sub = pfft::Sub{128, 0, br, bi, nullptr, nullptr, nullptr, nullptr};
  p2.nbatch = batch;
  p2.ncols = a;
  p2.T = pfft::pick_tile(128, a, 4096, 8);
  p2.ibs = m;
  p2.iis = a;
  p2.ics = 1;
  p2.obs = m;
  p2.oks = a;
  p2.ocs = 1;
  p2.scale = 1.f;
  return launch_sub(p2, static_cast<const float2*>(s), y, st);
}

// Planes (xr, xi) of batch rows of n = prod(factors) -> (yr, yi) by the
// Stockham chain.  tables: 4*nf pointers, per stage wr, wi (f x f DFT
// planes), tr, ti ((m, f) twiddle planes; nullptr at the last stage).
// scratch (2*batch*n floats) only when pf_chain_general_needs_scratch says
// so.  Returns a cudaError_t.
extern "C" int pf_chain_general(const float* xr, const float* xi, float* yr,
                                float* yi, float* scratch, int nf,
                                const int* factors,
                                const float* const* tables, int64_t batch,
                                void* stream) {
  if (nf < 2 || nf > kMaxFactors || batch < 1)
    return int(cudaErrorInvalidValue);
  Chain c{};
  int n = 1;
  c.nf = nf;
  for (int s = 0; s < nf; ++s) {
    c.f[s] = factors[s];
    c.wr[s] = tables[4 * s];
    c.wi[s] = tables[4 * s + 1];
    c.tr[s] = tables[4 * s + 2];
    c.ti[s] = tables[4 * s + 3];
    n *= factors[s];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const pfft::ConstPlanes x{xr, xi};
  const pfft::Planes y{yr, yi};
  const pfft::Sub whole{n, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr};
  if (n <= kChainMax) {
    pfft::Pass p = row_pass(whole, batch);
    p.T = pfft::pick_tile(n, batch, 4096, 32);
    return launch_chain(p, c, x, y, st);
  }
  if (scratch == nullptr) return int(cudaErrorInvalidValue);
  float2* s = reinterpret_cast<float2*>(scratch);
  const int f0 = c.f[0];
  const int m0 = n / f0;
  if (m0 > kChainMax) return int(cudaErrorInvalidValue);
  // Launch 1: the f0-point DFT down each column n2 < m0, times T_0[n2, k],
  // stored S[b, k, n2] (the Stockham output of stage 0).
  pfft::Pass p1{};
  p1.sub = pfft::Sub{f0, 0, c.wr[0], c.wi[0], nullptr, nullptr, nullptr,
                     nullptr};
  p1.nbatch = batch;
  p1.ncols = m0;
  p1.T = pfft::pick_tile(f0, m0, 4096, 32);
  p1.ibs = n;
  p1.iis = m0;
  p1.ics = 1;
  p1.obs = n;
  p1.oks = m0;
  p1.ocs = 1;
  p1.twr = c.tr[0];
  p1.twi = c.ti[0];
  p1.tcs = f0;
  p1.tks = 1;
  p1.scale = 1.f;
  int err = launch_sub(p1, x, s, st);
  if (err) return err;
  // Launch 2: the rest of the chain on each vector S[b, k, :], stored
  // out[b, k + f0*j].
  Chain rest{};
  rest.nf = nf - 1;
  for (int i = 1; i < nf; ++i) {
    rest.f[i - 1] = c.f[i];
    rest.wr[i - 1] = c.wr[i];
    rest.wi[i - 1] = c.wi[i];
    rest.tr[i - 1] = c.tr[i];
    rest.ti[i - 1] = c.ti[i];
  }
  pfft::Pass p2{};
  p2.sub = pfft::Sub{m0, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr};
  p2.nbatch = batch;
  p2.ncols = f0;
  p2.T = pfft::pick_tile(m0, f0, 4096, 32);
  p2.ibs = n;
  p2.iis = 1;
  p2.ics = m0;
  p2.obs = n;
  p2.oks = f0;
  p2.ocs = 1;
  p2.scale = 1.f;
  return launch_chain(p2, rest, static_cast<const float2*>(s), y, st);
}
