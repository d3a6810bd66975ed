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
// Small path (even n <= 512), K9:
//   forward   X[k] = scale * sum_j x[j] * w^(j*k),  k <= h,  w = exp(-2*pi*i/n)
//   backward  x[j] = scale * (Re X[0] + (-1)^j Re X[h]
//                             + 2 * sum_{0<k<h} Re(X[k] * w^(j*k))),  w = exp(+2*pi*i/n)
// (irfft semantics: the imaginary parts of X[0] and X[h] are dropped, as
// the JAX package's matrix drops them.)  The TPU kernel multiplies groups of
// rows by one constant real matrix on its matrix unit, 1 MB at n = 512: too
// large for shared memory.  Here a block keeps a tile of R rows (about 4096
// scalars) transposed in shared memory, with the n-entry root table (row 1
// of the bank's n x n DFT matrix, as K1 reads it), and sums directly,
// indexing w^((j*k) mod n).  Real input makes each forward term two FMAs,
// not four.  Tiles load and store as linear runs of whole rows, so device
// memory sees contiguous floats whatever the row pitch (n or n+2 floats;
// 34 at n = 32 is not 16-byte aligned).
// Bound on the H100, per row: the direct sums take 4n(h+1) flops against
// 4n + 8(h+1) bytes of device memory, 8 flops/byte at n = 32 (under the
// ~20 flops/byte fp32 ridge: bytes) and 128 at n = 512 (operations).  This
// first version is bound by shared-memory reads of the operands, as K1 is.
// All index math that touches device memory is 64-bit.
#include "fft_common.cuh"

namespace {

__device__ __forceinline__ float2 untangle_bin(float2 z, float2 r, float2 w,
                                               float scale) {
  const float er = 0.5f * (z.x + r.x);
  const float ei = 0.5f * (z.y - r.y);
  const float our = 0.5f * (z.y + r.y);
  const float oui = -0.5f * (z.x - r.x);
  const float tr = our * w.x - oui * w.y;
  const float ti = our * w.y + oui * w.x;
  return make_float2((er + tr) * scale, (ei + ti) * scale);
}

__device__ __forceinline__ float2 retangle_bin(float2 a, float2 c, float2 w,
                                               float scale) {
  const float e2r = a.x + c.x;
  const float e2i = a.y - c.y;
  const float n2r = a.x - c.x;
  const float n2i = a.y + c.y;
  const float o2r = n2r * w.x - n2i * w.y;
  const float o2i = n2r * w.y + n2i * w.x;
  return make_float2((e2r - o2i) * scale, (e2i + o2r) * scale);
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

// Rows per tile of K9: about 4096 scalars, even, so that the transposed
// tile's pitch R+1 is odd.
int small_rows(int n) {
  int r = 4096 / n;
  if (r > 1) r &= ~1;
  return r < 1 ? 1 : r;
}

size_t small_smem_bytes(int n, int R, bool forward) {
  const size_t roots = sizeof(float2) * size_t(n);
  const size_t in = forward ? size_t(n) * (R + 1) : size_t(n + 2) * (R + 1);
  const size_t out = forward ? size_t(R) * (n + 2) : size_t(R) * n;
  return roots + sizeof(float) * (in + out);
}

// x: b rows of n reals; y: b rows of n+2 floats (h+1 complex).
__global__ void __launch_bounds__(pfft::kThreads)
    small_real_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                          const float* __restrict__ wr,
                          const float* __restrict__ wi, int64_t batch, int n,
                          int R, float scale) {
  extern __shared__ float2 smem[];
  float2* roots = smem;
  float* xs = reinterpret_cast<float*>(roots + n);  // [j][row], pitch R+1
  float* ys = xs + n * (R + 1);                      // [row][n+2]
  pfft::load_roots(roots, wr, wi, n);
  const int h = n / 2;
  const int pitch = R + 1;
  const int64_t tiles = (batch + R - 1) / R;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t r0 = tile * R;
    const int rows = batch - r0 < R ? int(batch - r0) : R;
    const float* xb = x + r0 * n;
    for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
      const int row = e / n;
      xs[(e - row * n) * pitch + row] = xb[e];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < (h + 1) * R; e += blockDim.x) {
      const int k = e / R;
      const int row = e - k * R;
      if (row >= rows) continue;
      float re = 0.f, im = 0.f;
      int r = 0;
      for (int j = 0; j < n; ++j) {
        const float v = xs[j * pitch + row];
        const float2 w = roots[r];
        re = fmaf(v, w.x, re);
        im = fmaf(v, w.y, im);
        r += k;
        if (r >= n) r -= n;
      }
      ys[row * (n + 2) + 2 * k] = re * scale;
      ys[row * (n + 2) + 2 * k + 1] = im * scale;
    }
    __syncthreads();
    float* yb = y + r0 * (n + 2);
    for (int e = threadIdx.x; e < rows * (n + 2); e += blockDim.x) yb[e] = ys[e];
    __syncthreads();
  }
}

// x: b rows of n+2 floats (h+1 complex); y: b rows of n reals.
__global__ void __launch_bounds__(pfft::kThreads)
    small_real_bwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                          const float* __restrict__ wr,
                          const float* __restrict__ wi, int64_t batch, int n,
                          int R, float scale) {
  extern __shared__ float2 smem[];
  const int h = n / 2;
  const int pitch = R + 1;
  float2* roots = smem;
  float* xr = reinterpret_cast<float*>(roots + n);  // [k][row], pitch R+1
  float* xi = xr + (h + 1) * pitch;
  float* ys = xi + (h + 1) * pitch;  // [row][n]
  pfft::load_roots(roots, wr, wi, n);
  const int64_t tiles = (batch + R - 1) / R;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t r0 = tile * R;
    const int rows = batch - r0 < R ? int(batch - r0) : R;
    const float* xb = x + r0 * (n + 2);
    for (int e = threadIdx.x; e < rows * (n + 2); e += blockDim.x) {
      const int row = e / (n + 2);
      const int q = e - row * (n + 2);
      ((q & 1) ? xi : xr)[(q >> 1) * pitch + row] = xb[e];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n * R; e += blockDim.x) {
      const int j = e / R;
      const int row = e - j * R;
      if (row >= rows) continue;
      float acc = 0.f;
      int r = j;  // (j*k) mod n at k = 1
      for (int k = 1; k < h; ++k) {
        const float2 w = roots[r];
        acc = fmaf(xr[k * pitch + row], w.x, acc);
        acc = fmaf(-xi[k * pitch + row], w.y, acc);
        r += j;
        if (r >= n) r -= n;
      }
      const float nyq = xr[h * pitch + row];
      const float v = xr[row] + ((j & 1) ? -nyq : nyq) + 2.f * acc;
      ys[row * n + j] = v * scale;
    }
    __syncthreads();
    float* yb = y + r0 * n;
    for (int e = threadIdx.x; e < rows * n; e += blockDim.x) yb[e] = ys[e];
    __syncthreads();
  }
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
  if (n < 2 || n % 2 || batch < 1) return int(cudaErrorInvalidValue);
  const bool forward = sign < 0;
  const int R = small_rows(n);
  const size_t smem = small_smem_bytes(n, R, forward);
  auto kernel = forward ? small_real_fwd_kernel : small_real_bwd_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid_of((batch + R - 1) / R), pfft::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(x, y, wr, wi, batch, n, R,
                                                scale);
  return int(cudaGetLastError());
}
