// The REAL-domain kernels: K8a `untangle`, K8b `retangle` and K9
// `small_real`, on PACKED buffers of fp32.
//
// Replace portfft_tpu/ops/pallas_real.py: untangle_raw_call (K8a),
// retangle_raw_call (K8b) and small_real_raw_call (K9); and the REAL plane
// path's untangle, untangle_wide_raw_call (K8a-w, below).
//
// Half-length path (even n > 512, h = n/2).  The b*n real buffer is the
// interleaved buffer of z = x_even + i*x_odd, so K1/K2/K3 take its h-point
// transform Z with no staging, and:
//   K8a  X[k] = scale * (E[k] + W^k * O[k]),  k < h,   W = exp(-2*pi*i/n)
//        E = (Z[k] + conj Z[(h-k) mod h]) / 2,  O = -i (Z[k] - conj Z[(h-k) mod h]) / 2
//        X[h] = scale * (Re Z[0] - Im Z[0])
//   K8b  Z[k] = scale * (E2 + i * W^k * N2),  k < h,   W = exp(+2*pi*i/n)
//        E2 = X[k] + conj X[h-k],  N2 = X[k] - conj X[h-k]   (k = 0 reads X[h])
//        after which the h-point backward C2C gives the b*n reals directly.
//        With `drop` set, Im X[0] and Im X[h] are read as 0: the JAX
//        package's own route below n = 1024 (a C2C of the Hermitian
//        extension, real part kept) drops them, its retangle from n = 1024
//        on uses them, and the REAL entry sets the flag to match.
// The TPU kernels reverse the spectrum with anti-identity matmuls, because
// Mosaic cannot lower a reversal; here it is an index, (h-k) mod h.  One
// thread takes the bin pair (k, h-k): it reads both bins and both twiddles
// once and writes both results, so every byte moves once.  Rows of the half
// spectrum are (h+1) complex = 8(h+1) bytes, 16-byte aligned only for odd
// h, so all accesses are float2.
// Bound on the H100: bytes.  K8a reads 8*b*h and writes 8*b*(h+1) bytes for
// about 12 flops per bin (0.75 flop/byte, far under the ~20 flop/byte fp32
// ridge); K8b the same the other way.
//
// Small path (even n <= 512), K9: the same identities around the h-point
// FFT, in one launch a direction with the whole row in shared memory:
//   forward   X[k] = scale * sum_j x[j] * w^(j*k),  k <= h,  w = exp(-2*pi*i/n)
//             = the untangle above of Z, the h-point FFT of z = x_even + i*x_odd
//   backward  x[j] = scale * (Re X[0] + (-1)^j Re X[h]
//                             + 2 * sum_{0<k<h} Re(X[k] * w^(j*k))),  w = exp(+2*pi*i/n)
//             = the retangle above, with Im X[0] and Im X[h] dropped, then
//               the h-point inverse FFT, whose z are the row's n reals
// (irfft semantics: the imaginary parts of X[0] and X[h] are dropped, as
// the JAX package's matrix drops them.)  The TPU kernel multiplies groups of
// rows by one constant real matrix on its matrix unit, 1 MB at n = 512: too
// large for shared memory.  Here a block keeps a tile of T rows, each row's
// h complex values (forward) or h+1 bins (backward) one column of the tile
// (element i of row t at i*(T+1) + t, fft_radix.cuh's column layout), runs
// the h-point FFT of every column on fft_radix.cuh's Stockham stages
// (pfft_radix::stages(h): radix 2, 3, 4, 8 and 5 in registers, the largest
// odd prime 7 .. 23 of h too, through one kernel instantiation a prime, so
// that no kernel holds the registers of all seven; another odd prime by
// pair sums, stage_pairs), and untangles or retangles each bin pair (k,
// h-k) in place in shared memory, one thread a pair, as K8a and K8b do.
// The roots are row 1 of the bank's n x n DFT planes, W^k = root[k] and
// w_h^e = root[2e].  The scale is applied once, on the store.  Every
// device access is a float2 (a row of n reals is h float2, of h+1 bins
// h+1), in linear runs of whole rows.  The blocks stay resident, two an SM,
// and stride over the tiles; a tile lands by cp.async in a third buffer
// while the block works on the tile before, so a whole tile's loads are in
// flight and no register holds them.
// Bound on the H100, per row: 4n + 8(h+1) bytes of device memory against
// about 2.5*n*log2(n) flops of the stages and 10(h+1) of the untangle, 1 to
// 4 flops a byte (n = 2 .. 512), far under the ~20 flop/byte fp32 ridge:
// bytes.  On the H100 the loads and stores alone run at a copy's rate; the
// stages and the untangle, each a pass over the tile in shared memory with
// a barrier, add 60-75% to that at n = 32 and 512 and 120% at 180 (four
// stages: 5, 3, 3, 2).  A prime h above 23 (n = 254, 502) runs as one stage of pair sums,
// (h-1)/2 terms an output pair: bound by those sums, not by bytes.
// All index math that touches device memory is 64-bit.
//
// K9 at fp64 (pf_small_real_f64) is the same kernel body on double: double2
// elements (a row of n reals is h double2), double tables, double FMAs, 16-byte
// cp.async copies, and tiles sized for double2 (small_rows); its __global__
// functions are small_real_{fwd,bwd}_f64_kernel.
#include "fft_radix.cuh"

namespace {

using pfft::cplx;
using pfft::mkc;
using pfft::scalar_of;

template <class C>
__device__ __forceinline__ C untangle_bin(C z, C r, C w, scalar_of<C> scale) {
  using S = scalar_of<C>;
  const S er = S(0.5) * (z.x + r.x);
  const S ei = S(0.5) * (z.y - r.y);
  const S our = S(0.5) * (z.y + r.y);
  const S oui = S(-0.5) * (z.x - r.x);
  const S tr = our * w.x - oui * w.y;
  const S ti = our * w.y + oui * w.x;
  return mkc((er + tr) * scale, (ei + ti) * scale);
}

template <class C>
__device__ __forceinline__ C retangle_bin(C a, C c, C w, scalar_of<C> scale) {
  using S = scalar_of<C>;
  const S e2r = a.x + c.x;
  const S e2i = a.y - c.y;
  const S n2r = a.x - c.x;
  const S n2i = a.y + c.y;
  const S o2r = n2r * w.x - n2i * w.y;
  const S o2i = n2r * w.y + n2i * w.x;
  return mkc((e2r - o2i) * scale, (e2i + o2r) * scale);
}

__device__ __forceinline__ float2 twiddle(const float* wr, const float* wi,
                                          int k) {
  return make_float2(__ldg(wr + k), __ldg(wi + k));
}

// z: b rows of h complex; x: b rows of h+1 complex.
__global__ void __launch_bounds__(pfft::kThreads)
    untangle_kernel(const float2* __restrict__ z, float2* __restrict__ x,
                    const float* __restrict__ wr, const float* __restrict__ wi,
                    int64_t batch, int h, float scale) {
  const int64_t pairs = h / 2 + 1;
  const int64_t total = batch * pairs;
  const int64_t step = int64_t(gridDim.x) * blockDim.x;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += step) {
    const int64_t b = e / pairs;
    const int k = int(e - b * pairs);
    const int k2 = k == 0 ? 0 : h - k;
    const float2* zb = z + b * h;
    float2* xb = x + b * (h + 1);
    const float2 zk = zb[k];
    const float2 zk2 = zb[k2];
    xb[k] = untangle_bin(zk, zk2, twiddle(wr, wi, k), scale);
    if (k2 != k) xb[k2] = untangle_bin(zk2, zk, twiddle(wr, wi, k2), scale);
    if (k == 0) xb[h] = make_float2((zk.x - zk.y) * scale, 0.f);
  }
}

// x: b rows of h+1 complex; z: b rows of h complex.
__global__ void __launch_bounds__(pfft::kThreads)
    retangle_kernel(const float2* __restrict__ x, float2* __restrict__ z,
                    const float* __restrict__ wr, const float* __restrict__ wi,
                    int64_t batch, int h, float scale, int drop) {
  const int64_t pairs = h / 2 + 1;
  const int64_t total = batch * pairs;
  const int64_t step = int64_t(gridDim.x) * blockDim.x;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += step) {
    const int64_t b = e / pairs;
    const int k = int(e - b * pairs);
    const int k2 = h - k;  // k = 0 pairs with the Nyquist bin X[h]
    const float2* xb = x + b * (h + 1);
    float2* zb = z + b * h;
    float2 a = xb[k];
    float2 c = xb[k2];
    if (drop && k == 0) a.y = c.y = 0.f;
    zb[k] = retangle_bin(a, c, twiddle(wr, wi, k), scale);
    if (k != 0 && k2 != k)
      zb[k2] = retangle_bin(c, a, twiddle(wr, wi, k2), scale);
  }
}

// K8a-w `untangle_wide`: K8a's function, column-chunked for wide spectra
// (replaces pallas_real.py::untangle_wide_raw_call and its gate wide_bt_ct).
// The TPU kernel keeps a tile's Z planes persistent in VMEM and walks the
// spectrum in column chunks, flipping each chunk's mirror with matmuls.
// Here a block takes the bin pairs k = p0 .. p0+W-1 (k <= h/2) of a tile
// of R rows: it loads the run Z[p0 .. p0+W-1] and the mirror run
// Z[h-p0-W+1 .. h-p0] (index h is Z[0]: the mirror of k = 0 is k itself,
// which is why pairing chunk c with chunk nc-1-c would be one column off)
// with ascending, coalesced loads, stages both in shared memory, forms
// X[k] and X[h-k] of every pair with its two roots (loaded once per block
// and used for all R rows), and stores both runs ascending again.  Each Z
// element is read once (Z[0] and Z[h/2] twice) and each X element written
// once; the block with p0 = 0 also writes X[h].  Bound: bytes, as K8a.
constexpr int kWideW = 256;  // bin pairs per block
constexpr int kWideR = 8;    // rows per block: the reference's bt

__global__ void __launch_bounds__(pfft::kThreads)
    untangle_wide_kernel(const float2* __restrict__ z, float2* __restrict__ x,
                         const float* __restrict__ wr,
                         const float* __restrict__ wi, int64_t batch, int h,
                         float scale) {
  __shared__ float2 lo[kWideR][kWideW];  // Z[p0 + i], then X[p0 + i]
  __shared__ float2 hi[kWideR][kWideW];  // Z[h - p0 - i], then X[h - p0 - i]
  __shared__ float2 wlo[kWideW], whi[kWideW];
  const int p0 = blockIdx.x * kWideW;
  const int pairs = h / 2 + 1;
  const int cnt = pairs - p0 < kWideW ? pairs - p0 : kWideW;
  const int base = h - p0 - cnt + 1;  // first index of the mirror run
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const int j = base + i, m = j == h ? 0 : j;  // position cnt-1-i
    wlo[i] = make_float2(__ldg(wr + p0 + i), __ldg(wi + p0 + i));
    whi[cnt - 1 - i] = make_float2(__ldg(wr + m), __ldg(wi + m));
  }
  const int64_t tiles = (batch + kWideR - 1) / kWideR;
  for (int64_t tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int64_t r0 = tile * kWideR;
    const int rows = batch - r0 < kWideR ? int(batch - r0) : kWideR;
    for (int e = threadIdx.x; e < rows * cnt; e += blockDim.x) {
      const int r = e / cnt, i = e - r * cnt;
      const float2* zb = z + (r0 + r) * h;
      const int j = base + i;
      lo[r][i] = zb[p0 + i];
      hi[r][cnt - 1 - i] = zb[j == h ? 0 : j];
    }
    __syncthreads();  // also makes the roots visible
    for (int e = threadIdx.x; e < rows * cnt; e += blockDim.x) {
      const int r = e / cnt, i = e - r * cnt;
      const float2 a = lo[r][i], b = hi[r][i];  // Z[k], Z[(h - k) mod h]
      lo[r][i] = untangle_bin(a, b, wlo[i], scale);
      hi[r][i] = untangle_bin(b, a, whi[i], scale);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * cnt; e += blockDim.x) {
      const int r = e / cnt, i = e - r * cnt;
      float2* xb = x + (r0 + r) * (h + 1);
      xb[p0 + i] = lo[r][i];
      const int j = base + i;  // X[j] from position cnt-1-i; X[h-k] = X[k]
      if (j != h && j != p0 + cnt - 1 - i) xb[j] = hi[r][cnt - 1 - i];
    }
    if (p0 == 0)
      for (int r = threadIdx.x; r < rows; r += blockDim.x) {
        const float2 z0 = z[(r0 + r) * h];
        x[(r0 + r) * (h + 1) + h] = make_float2((z0.x - z0.y) * scale, 0.f);
      }
    __syncthreads();  // the tiles are read before the next rows land
  }
}

// x / d for 0 <= x < 2^31 by a multiply and a shift (CUTLASS's
// FastDivmod): K9's loops split an element index into row and column with
// it in place of an integer division.
struct FastDiv {
  int d;
  unsigned m;
  int s;
  __host__ FastDiv(int d_ = 1) : d(d_), m(0), s(0) {
    if (d > 1) {
      int l = 0;
      while ((1 << l) < d) ++l;
      m = unsigned(((uint64_t(1) << (31 + l)) + d - 1) / d);
      s = l - 1;
    }
  }
  __device__ __forceinline__ int operator()(int x) const {
    return d == 1 ? x : int(__umulhi(unsigned(x), m) >> s);
  }
};

// One element's copy from device to shared memory (8 bytes a float2, 16 a
// double2), in flight until cp_async_wait(): no register holds it.
__device__ __forceinline__ void cp_async(float2* dst, const float2* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void cp_async(double2* dst, const double2* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// K9's launch: h = n/2, T rows a tile, m_in / m_out elements (float2 or
// double2) a row read and written (h and h+1 forward, h+1 and h backward),
// and the divisions by m_in, m_out and T.
template <class S>
struct SmallRealT {
  int h, T;
  int64_t batch;
  int m_in, m_out;
  S scale;
  FastDiv div_in, div_out, div_T;
};
using SmallReal = SmallRealT<float>;

// Tiles of K9 in shared memory: three of T columns of h+1 elements (the
// tile in work, its ping-pong partner, and the next tile landing), after
// the root tables W^k = w_n^k and w_h^e = w_n^(2e) of h entries each;
// `elem` bytes an element.
size_t small_smem_bytes(int h, int T, size_t elem) {
  return elem * (2 * size_t(h) + 3 * size_t(h + 1) * pfft::tile_pitch(T));
}

// The odd prime above 5 whose stage K9 runs in registers for h: the
// largest prime factor of h if it is 7 .. 23, else 1 (none).  Radix 5
// always runs in registers; another odd prime runs on stage_pairs.
int small_odd_prime(int h) {
  int big = 1;
  for (int p = 2; h > 1; ++p)
    while (h % p == 0) h /= p, big = p;
  return big >= 7 && big <= 23 ? big : 1;
}

// Rows a tile of K9.  A stage, and the untangle, run in rounds of one work
// item a thread (kThreads a round) with a barrier after the last, so a
// round that is partly idle costs a whole one: T is the even width, from
// the most that two blocks on an SM hold down to half of it, with the
// fewest rounds a row (an even T keeps the column pitch T+1 odd, off a
// single bank).  One tile of the whole batch where it fits.  `elem` bytes
// an element.
int small_rows(int h, int64_t batch, size_t elem) {
  const int64_t fit =
      (int64_t(pfft_radix::kBlockSmem / elem) - 2 * h) / (3 * (h + 1)) - 1;
  if (batch <= fit) return int(batch);
  if (fit < 2) return 1;
  const pfft_radix::Stages st = pfft_radix::stages(h);
  const int p = small_odd_prime(h);
  const auto rounds = [](int64_t items) {
    return (items + pfft::kThreads - 1) / pfft::kThreads;
  };
  int best = 0;
  double best_cost = 0.0;
  for (int T = int(fit) & ~1; T >= 2 && T >= fit / 2; T -= 2) {
    int64_t r = 1 + rounds(int64_t(h / 2 + 1) * T);  // the tile's wait, the untangle
    for (int s = 0; s < st.n; ++s) {  // a butterfly an item; stage_pairs, a pair
      const int q = st.r[s];
      r += rounds(int64_t(h / q) * (q <= 5 || q == 8 || q == p ? 1 : q / 2 + 1) * T);
    }
    const double cost = double(r) / T;
    if (best == 0 || cost < best_cost) best = T, best_cost = cost;
  }
  return best;
}

// A stage of odd prime radix p that no register stage takes (p > 23, or a
// second odd prime of h), by stage_odd's pair sums with the pairs read from
// the tile: one work item a butterfly j and output pair (q, p-q), q <= H =
// (p-1)/2 (q = 0: y[0] alone), summing over r = 1 .. H
//   a_r = v[r] + v[p-r],  b_r = v[r] - v[p-r]  (v: the inputs times the
//   stage twiddle),  y[q] = v[0] + sum a_r*c_(rq) + i*sum b_r*s_(rq),
//   y[p-q] the same with -i,  c_e + i*s_e = w_p^e = root[(e mod p)*len/p].
// Per output pair that is 3 reads of the tile a term where stage_p takes 8,
// and a quarter of its multiply-adds.  Consecutive threads take
// consecutive vectors.
template <class C, class Base, class Out, class Post>
__device__ inline void stage_pairs(const C* src, C* dst, int len, int ns,
                                   int nvec, int step, const C* root, int p,
                                   Base base, Out out, Post post) {
  using S = scalar_of<C>;
  const int m = len / p;
  const int tw = len / (ns * p);
  const int H = (p - 1) / 2;
  const int total = m * (H + 1) * nvec;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int jq = e / nvec;
    const int u = e - jq * nvec;
    const int j = jq / (H + 1);
    const int q = jq - j * (H + 1);
    const int k = j % ns;
    const C* x = src + base(u);
    const auto in = [&](int r) {
      const C v = x[(j + r * m) * step];
      return ns > 1 ? pfft::cmul(v, root[r * k * tw]) : v;
    };
    const C v0 = x[j * step];
    C A = v0, B = mkc(S(0), S(0));
    int ei = 0;
    for (int r = 1; r <= H; ++r) {
      const C lo = in(r), hi = in(p - r);
      ei += q;
      if (ei >= p) ei -= p;
      const C w = root[ei * m];
      if (q == 0) {
        A = pfft_radix::add(A, pfft_radix::add(lo, hi));
      } else {
        A = mkc(pfft::mad(lo.x + hi.x, w.x, A.x), pfft::mad(lo.y + hi.y, w.x, A.y));
        B = mkc(pfft::mad(lo.x - hi.x, w.y, B.x), pfft::mad(lo.y - hi.y, w.y, B.y));
      }
    }
    const int d = (j - k) * p + k;
    const int o = d + q * ns;
    dst[out(u, o)] = post(u, o, mkc(A.x - B.y, A.y + B.x));
    if (q != 0) {
      const int o2 = d + (p - q) * ns;
      dst[out(u, o2)] = post(u, o2, mkc(A.x + B.y, A.y - B.x));
    }
  }
}

// pfft_radix::run_stage with radix 5 and P (if P > 5) on stage_odd and any
// other odd prime on stage_pairs: one or two odd stages' registers, where
// run_stage_odd's switch holds all seven and pushes the kernel into spills.
template <int P, class C, class Base, class Out, class Post>
__device__ inline void small_stage(int r, const C* src, C* dst, int len,
                                   int ns, int nvec, int step, const C* root,
                                   scalar_of<C> sg, Base base, Out out,
                                   Post post) {
  if (r == 5)
    pfft_radix::stage_odd<5>(src, dst, len, ns, nvec, step, root, base, out,
                             post);
  else if (P > 5 && r == P)
    pfft_radix::stage_odd<(P > 5 ? P : 5)>(src, dst, len, ns, nvec, step,
                                           root, base, out, post);
  else if (r > 5 && r % 2)  // 7 .. 23 but P, and the primes above
    stage_pairs(src, dst, len, ns, nvec, step, root, r, base, out, post);
  else
    pfft_radix::run_stage(r, src, dst, len, ns, nvec, step, root, sg, base,
                          out, post);
}

// The h-point FFT of the T columns in cur (pfft_radix::dft_odd's stages on
// small_stage), between cur and other; returns the buffer that holds it.
template <int P, class C>
__device__ inline C* small_fft(C* cur, C* other, int h, int T, int es,
                               const C* root) {
  using S = scalar_of<C>;
  const pfft_radix::Stages st = pfft_radix::stages(h);
  const S sg = h > 2 && root[1].y < S(0) ? S(-1) : S(1);
  const auto col = [](int t) { return t; };
  const pfft_radix::Strided<decltype(col)> at{col, es};
  int ns = 1;
  for (int s = 0; s < st.n; ++s) {
    small_stage<P>(st.r[s], cur, other, h, ns, T, es, root, sg, col, at,
                   pfft_radix::Keep{});
    __syncthreads();
    C* t = cur;
    cur = other;
    other = t;
    ns *= st.r[s];
  }
  return cur;
}

// The body of both K9 kernels.  The blocks stride over the tiles of T rows;
// each tile's rows land by cp.async in a third buffer while the block works
// on the tile before (the whole tile in flight, no register held), as
// columns of the tile (element i of row t at i*es + t).  Forward: the
// h-point FFT of z = x_even + i*x_odd, then the untangle of each bin pair
// in place; backward: the retangle in place, then the inverse FFT.  The
// store writes whole rows, times the scale.  wr/wi: the n x n DFT planes of
// the direction.  S: the scalar, float or double; the dynamic shared memory,
// declared float2, holds its elements.
template <class S, bool kForward, int P>
__device__ inline void small_real_tiles(const SmallRealT<S>& k,
                                        const cplx<S>* x, cplx<S>* y,
                                        const S* wr, const S* wi) {
  using C = cplx<S>;
  extern __shared__ float2 smem[];
  const int h = k.h;
  const int n = 2 * h;
  const int T = k.T;
  const int es = pfft::tile_pitch(T);
  C* const rw = reinterpret_cast<C*>(smem);
  C* const rh = rw + h;
  C* const buf[3] = {rh + h, rh + h + (h + 1) * es, rh + h + 2 * (h + 1) * es};
  for (int i = threadIdx.x; i < h; i += blockDim.x) {  // row 1 of the planes
    rw[i] = mkc(__ldg(wr + n + i), __ldg(wi + n + i));
    rh[i] = mkc(__ldg(wr + n + 2 * i), __ldg(wi + n + 2 * i));
  }
  const int64_t ntiles = (k.batch + T - 1) / T;
  const auto rows_of = [&](int64_t tile) {
    const int64_t left = k.batch - tile * T;
    return left < T ? int(left) : T;
  };
  const auto load = [&](int64_t tile, C* dst) {
    const C* src = x + tile * T * k.m_in;
    const int total = rows_of(tile) * k.m_in;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int t = k.div_in(e);
      cp_async(dst + (e - t * k.m_in) * es + t, src + e);
    }
  };
  const int pairs = h / 2 + 1;
  int cur = 0;
  if (blockIdx.x < ntiles) load(blockIdx.x, buf[0]);
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    cp_async_wait();
    __syncthreads();  // the tile has landed; the spare buffer is free
    C* const b0 = buf[cur];
    C* const b1 = buf[cur == 2 ? 0 : cur + 1];
    cur = cur == 0 ? 2 : cur - 1;
    if (tile + gridDim.x < ntiles) load(tile + gridDim.x, buf[cur]);
    C* z = b0;
    if (kForward) {
      z = small_fft<P>(b0, b1, h, T, es, rh);
      // the bin pair (q, (h-q) mod h) of row t; q = 0 also gives X[h]
      for (int e = threadIdx.x; e < pairs * T; e += blockDim.x) {
        const int q = k.div_T(e), t = e - q * T;
        const int q2 = q == 0 ? 0 : h - q;
        const C a = z[q * es + t], b = z[q2 * es + t];
        z[q * es + t] = untangle_bin(a, b, rw[q], S(1));
        if (q2 != q) z[q2 * es + t] = untangle_bin(b, a, rw[q2], S(1));
        if (q == 0) z[h * es + t] = mkc(a.x - a.y, S(0));
      }
      __syncthreads();
    } else {
      // the bin pair (q, h-q) of row t; q = 0 reads X[h] and drops Im X[0]
      // and Im X[h]
      for (int e = threadIdx.x; e < pairs * T; e += blockDim.x) {
        const int q = k.div_T(e), t = e - q * T;
        const int q2 = h - q;
        C a = b0[q * es + t], c = b0[q2 * es + t];
        if (q == 0) a.y = c.y = S(0);
        b0[q * es + t] = retangle_bin(a, c, rw[q], S(1));
        if (q != 0 && q2 != q) b0[q2 * es + t] = retangle_bin(c, a, rw[q2], S(1));
      }
      __syncthreads();
      z = small_fft<P>(b0, b1, h, T, es, rh);
    }
    C* dst = y + tile * T * k.m_out;
    const int total = rows_of(tile) * k.m_out;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int t = k.div_out(e);
      const C v = z[(e - t * k.m_out) * es + t];
      dst[e] = mkc(k.scale * v.x, k.scale * v.y);
    }
  }
}

// x: b rows of n reals (h complex z); y: b rows of h+1 complex.
template <int P>
__global__ void __launch_bounds__(pfft::kThreads, 2)
    small_real_fwd_kernel(SmallReal k, const float2* x, float2* y,
                          const float* wr, const float* wi) {
  small_real_tiles<float, true, P>(k, x, y, wr, wi);
}

// x: b rows of h+1 complex; y: b rows of n reals (h complex z).
template <int P>
__global__ void __launch_bounds__(pfft::kThreads, 2)
    small_real_bwd_kernel(SmallReal k, const float2* x, float2* y,
                          const float* wr, const float* wi) {
  small_real_tiles<float, false, P>(k, x, y, wr, wi);
}

// The same two at fp64.
template <int P>
__global__ void __launch_bounds__(pfft::kThreads, 2)
    small_real_fwd_f64_kernel(SmallRealT<double> k, const double2* x,
                              double2* y, const double* wr, const double* wi) {
  small_real_tiles<double, true, P>(k, x, y, wr, wi);
}

template <int P>
__global__ void __launch_bounds__(pfft::kThreads, 2)
    small_real_bwd_f64_kernel(SmallRealT<double> k, const double2* x,
                              double2* y, const double* wr, const double* wi) {
  small_real_tiles<double, false, P>(k, x, y, wr, wi);
}

template <class S>
using SmallKernel = void (*)(SmallRealT<S>, const cplx<S>*, cplx<S>*,
                             const S*, const S*);

// The kernel of a direction for the scalar of the tag argument.
template <int P>
SmallKernel<float> small_kernel(float, bool forward) {
  return forward ? small_real_fwd_kernel<P> : small_real_bwd_kernel<P>;
}
template <int P>
SmallKernel<double> small_kernel(double, bool forward) {
  return forward ? small_real_fwd_f64_kernel<P> : small_real_bwd_f64_kernel<P>;
}

template <class S>
SmallKernel<S> small_kernel_of(int p, bool forward) {
  switch (p) {
    case 7: return small_kernel<7>(S(), forward);
    case 11: return small_kernel<11>(S(), forward);
    case 13: return small_kernel<13>(S(), forward);
    case 17: return small_kernel<17>(S(), forward);
    case 19: return small_kernel<19>(S(), forward);
    case 23: return small_kernel<23>(S(), forward);
    default: return small_kernel<1>(S(), forward);
  }
}

// Forward (sign < 0): x (batch*n reals) -> y (batch*(n+2) scalars);
// backward: the reverse.  Returns a cudaError_t.
template <class S>
int small_real(const S* x, S* y, const S* wr, const S* wi, int64_t batch,
               int n, int sign, S scale, void* stream) {
  using C = cplx<S>;
  if (n < 2 || n % 2 || batch < 1) return int(cudaErrorInvalidValue);
  const bool forward = sign < 0;
  const int h = n / 2;
  SmallRealT<S> k{};
  k.h = h;
  k.T = small_rows(h, batch, sizeof(C));
  k.batch = batch;
  k.m_in = forward ? h : h + 1;
  k.m_out = forward ? h + 1 : h;
  k.scale = scale;
  k.div_in = FastDiv(k.m_in);
  k.div_out = FastDiv(k.m_out);
  k.div_T = FastDiv(k.T);
  return pfft_radix::launch_resident(
      small_kernel_of<S>(small_odd_prime(h), forward),
      small_smem_bytes(h, k.T, sizeof(C)), (batch + k.T - 1) / k.T,
      static_cast<cudaStream_t>(stream), k, reinterpret_cast<const C*>(x),
      reinterpret_cast<C*>(y), wr, wi);
}

unsigned grid_of(int64_t units) {
  const int64_t cap = int64_t(1) << 30;
  return unsigned(units < cap ? (units > 0 ? units : 1) : cap);
}

}  // namespace

// z (2*batch*h floats) -> x (batch*(2h+2) floats).  wr/wi: the bank's
// ("R", 2h, -1) planes of h entries.  Returns a cudaError_t.
extern "C" int pf_untangle(const float* z, float* x, const float* wr,
                           const float* wi, int64_t batch, int h, float scale,
                           void* stream) {
  if (h < 1 || batch < 1) return int(cudaErrorInvalidValue);
  const int64_t total = batch * (h / 2 + 1);
  untangle_kernel<<<grid_of((total + pfft::kThreads - 1) / pfft::kThreads),
                    pfft::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(z), reinterpret_cast<float2*>(x), wr,
      wi, batch, h, scale);
  return int(cudaGetLastError());
}

// x (batch*(2h+2) floats) -> z (2*batch*h floats).  wr/wi: the bank's
// ("R", 2h, +1) planes; drop != 0 reads Im X[0] and Im X[h] as 0.  Returns
// a cudaError_t.
extern "C" int pf_retangle(const float* x, float* z, const float* wr,
                           const float* wi, int64_t batch, int h, float scale,
                           int drop, void* stream) {
  if (h < 1 || batch < 1) return int(cudaErrorInvalidValue);
  const int64_t total = batch * (h / 2 + 1);
  retangle_kernel<<<grid_of((total + pfft::kThreads - 1) / pfft::kThreads),
                    pfft::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(z), wr,
      wi, batch, h, scale, drop);
  return int(cudaGetLastError());
}

// K8a-w: z (2*batch*h floats) -> x (batch*(2h+2) floats), the function of
// pf_untangle in column chunks.  Returns a cudaError_t.
extern "C" int pf_untangle_wide(const float* z, float* x, const float* wr,
                                const float* wi, int64_t batch, int h,
                                float scale, void* stream) {
  if (h < 2 || batch < 1) return int(cudaErrorInvalidValue);
  const int64_t tiles = (batch + kWideR - 1) / kWideR;
  const dim3 grid(unsigned((h / 2 + kWideW) / kWideW),
                  unsigned(tiles < 65535 ? tiles : 65535));
  untangle_wide_kernel<<<grid, pfft::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(z), reinterpret_cast<float2*>(x), wr,
      wi, batch, h, scale);
  return int(cudaGetLastError());
}

// Forward (sign < 0): x (batch*n reals) -> y (batch*(n+2) floats);
// backward: the reverse.  wr/wi: the bank's n x n DFT planes for the
// direction (row 1 is the root table).  Returns a cudaError_t.
extern "C" int pf_small_real(const float* x, float* y, const float* wr,
                             const float* wi, int64_t batch, int n, int sign,
                             float scale, void* stream) {
  return small_real(x, y, wr, wi, batch, n, sign, scale, stream);
}

// K9 at fp64: pf_small_real on double buffers and tables.
extern "C" int pf_small_real_f64(const double* x, double* y, const double* wr,
                                 const double* wi, int64_t batch, int n,
                                 int sign, double scale, void* stream) {
  return small_real(x, y, wr, wi, batch, n, sign, scale, stream);
}
