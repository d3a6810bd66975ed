// K5 `global_bf` and K5-ov `global_bf_ov`: batched GLOBAL transform
// n = G1*G2, butterfly-factored, in one cooperative launch whose
// intermediate stays in L2.
//
// Replace portfft_tpu/ops/pallas_global_bf.py::global_bf_raw_call and
// global_bf_ov_raw_call (the tuned engines {"eng": 7} and {"eng": 7,
// "ov": 1}).  Each sub is g = A*128, A a power of two <= 16; with the row
// viewed as x[n1, n2] = x[G2*n1 + n2]:
//   pass 1, per column n2 (i = n1 = 128*iA + iB): a radix-A1 butterfly over
//           iA (adds and exact constants), the digit twiddle U1[kA][iB] =
//           w_G1^(kA*iB), the 128-point DFT over iB, giving k1 = kA + A1*kB
//           in natural order; times GA[kA][n2] * GB[kB][n2] = w_n^(k1*n2);
//           stored to the scratch S[k1][n2];
//   pass 2, per row k1 of S: the same over n2 with A2 and U2, stored as
//           out[k1 + G1*k2] = scale * (...).
// About A + 128 complex multiply-adds per point and pass where K3 sums G.
// Each pass is a column pass of fft_common.cuh (tile_load, tile_store) with
// this sub-transform.
//
// A TPU core keeps the whole transform in VMEM; shared memory cannot hold
// 2^20 points (8 MiB), so here the intermediate goes to a scratch in device
// memory that is small enough to stay in the 50 MB L2: the batch runs in
// chunks of `chunk` transforms (8*n*chunk bytes a slot, a quarter of L2;
// cuda_global_bf.bf_chunk).  The grid is every block the card holds at
// once (cudaLaunchCooperativeKernel); blocks share out each pass's tiles,
// and grid-wide barriers order the passes:
//   K5:    per chunk, pass 1 into the slot, barrier, pass 2, barrier;
//   K5-ov: round r runs pass 1 of chunk r into slot r%2 and pass 2 of chunk
//          r-1 from slot (r-1)%2 in one sweep of tiles, one barrier a
//          round.  An output element is written only by its transform's
//          pass 2, never before.
// Bound on the H100: 16 bytes per point to and from device memory (the
// scratch round trip in L2), against 8*(A1 + A2 + 256) flops per point.
// Scratch reads bypass L1 (__ldcg): a slot is rewritten between barriers.
#include <cooperative_groups.h>

#include "fft_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBfThreads = 256;

struct Bf {
  const float2* x;
  float2* y;
  float2* s;  // scratch: one slot (K5) or two (K5-ov) of chunk*n points
  int g1, g2, t1, t2, sign;
  const float* w128r;
  const float* w128i;
  const float* u1r;
  const float* u1i;
  const float* u2r;
  const float* u2i;
  const float* gar;
  const float* gai;
  const float* gbr;
  const float* gbi;
  int64_t batch, chunk;
  float scale;
};

// exp(sign*2*pi*i*j/16), j < 8, with exact 0 and +-1 (pallas_global_bf._snap).
__device__ __forceinline__ float2 root16(int j, int sign) {
  float c = 1.f, s = 0.f;
  switch (j) {
    case 1: c = 0.92387953251128674f; s = 0.38268343236508977f; break;
    case 2: c = 0.70710678118654752f; s = 0.70710678118654752f; break;
    case 3: c = 0.38268343236508977f; s = 0.92387953251128674f; break;
    case 4: c = 0.f; s = 1.f; break;
    case 5: c = -0.38268343236508977f; s = 0.92387953251128674f; break;
    case 6: c = -0.70710678118654752f; s = 0.70710678118654752f; break;
    case 7: c = -0.92387953251128674f; s = 0.38268343236508977f; break;
    default: break;
  }
  return make_float2(c, sign < 0 ? -s : s);
}

// The A-point DFT of v in registers: radix-2 DIT, natural order in and out.
template <int A>
__device__ __forceinline__ void butterfly(float2 (&v)[A], int sign) {
  constexpr int bits = A >= 16 ? 4 : A >= 8 ? 3 : A >= 4 ? 2 : A >= 2 ? 1 : 0;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    int r = 0;
#pragma unroll
    for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
    if (r > i) {
      const float2 t = v[i];
      v[i] = v[r];
      v[r] = t;
    }
  }
#pragma unroll
  for (int s = 2; s <= A; s <<= 1) {
#pragma unroll
    for (int b0 = 0; b0 < A; b0 += s) {
#pragma unroll
      for (int q = 0; q < s / 2; ++q) {
        const float2 t = pfft::cmul(v[b0 + q + s / 2], root16(q * (16 / s), sign));
        const float2 u = v[b0 + q];
        v[b0 + q] = make_float2(u.x + t.x, u.y + t.y);
        v[b0 + q + s / 2] = make_float2(u.x - t.x, u.y - t.y);
      }
    }
  }
}

// Scratch reads: through L2 only (a slot is rewritten between barriers).
struct FromL2 {
  const float2* p;
};
__device__ __forceinline__ float2 ld(const FromL2& x, int64_t i) {
  return __ldcg(x.p + i);
}

// One pass: its column-pass geometry, its digit twiddle, and (pass 1) the
// factored inter-factor twiddle.
struct Phase {
  pfft::Pass p;
  const float* ur;
  const float* ui;
  const float* gar;  // nullptr in pass 2
  const float* gai;
  const float* gbr;
  const float* gbi;
  int g2;  // the row length of the scratch
};

// The sub-transform of the tile in b0 (element 128*iA + iB of column t at
// (129*iA + iB)*es + t): butterfly and digit twiddle in place, then the
// 128-point DFT into b1 at natural positions.
template <int A>
__device__ void bf_sub(const Phase& ph, float2* b0, float2* b1,
                       const float2* rb, int sign) {
  const int T = ph.p.T, es = pfft::tile_pitch(T);
  for (int u = threadIdx.x; u < 128 * T; u += blockDim.x) {
    const int iB = u / T, t = u - iB * T;
    float2 v[A];
#pragma unroll
    for (int i = 0; i < A; ++i) v[i] = b0[(129 * i + iB) * es + t];
    butterfly<A>(v, sign);
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const int w = k * 128 + iB;
      b0[(129 * k + iB) * es + t] =
          pfft::cmul(v[k], make_float2(__ldg(ph.ur + w), __ldg(ph.ui + w)));
    }
  }
  __syncthreads();
  pfft::dft_stage(
      b0, b1, 128, T * A, es, rb,
      [=](int u) {
        const int k1 = u / T;
        return 129 * k1 * es + (u - k1 * T);
      },
      [=](int u, int k2) {
        const int k1 = u / T;
        const int K = k1 + A * k2;
        return (K + (K >> 7)) * es + (u - k1 * T);
      },
      [](int, int, float2 y) { return y; });
  __syncthreads();
}

// Pass 1's store: S[b][k1][n2] = Z * GA[kA][n2] * GB[kB][n2].
template <int A>
__device__ void store_scratch(const Phase& ph, int64_t b, int64_t c0,
                              const float2* res, float2* s) {
  const pfft::Pass& p = ph.p;
  const int T = p.T, es = pfft::tile_pitch(T), g2 = ph.g2;
  const int total = p.sub.m * T;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int k = e / T, t = e - k * T;
    const int n2 = int(c0) + t;
    const int ia = (k % A) * g2 + n2, ib = (k / A) * g2 + n2;
    float2 v = res[(k + (k >> 7)) * es + t];
    v = pfft::cmul(v, make_float2(__ldg(ph.gar + ia), __ldg(ph.gai + ia)));
    v = pfft::cmul(v, make_float2(__ldg(ph.gbr + ib), __ldg(ph.gbi + ib)));
    __stcg(s + b * p.obs + int64_t(k) * p.oks + n2, v);
  }
  __syncthreads();
}

template <int A, class X>
__device__ void tile_item(const Phase& ph, int64_t b, int64_t c0, X x,
                          float2* y, const float2* rb, float2* b0, int sign) {
  const pfft::Pass& p = ph.p;
  float2* b1 = b0 + pfft::tile_rows(p.sub) * pfft::tile_pitch(p.T);
  pfft::tile_load(p, b, c0, x, b0);
  bf_sub<A>(ph, b0, b1, rb, sign);
  if (ph.gar)
    store_scratch<A>(ph, b, c0, b1, y);
  else
    pfft::tile_store(p, b, c0, b1, y);
}

// Tile `item` of a pass over a chunk of transforms (x and y at the chunk).
template <class X>
__device__ void run_item(const Phase& ph, int64_t item, X x, float2* y,
                         const float2* rb, float2* b0, int sign) {
  const int64_t tiles = ph.p.ncols / ph.p.T;
  const int64_t b = item / tiles;
  const int64_t c0 = (item - b * tiles) * ph.p.T;
  switch (ph.p.sub.a) {
    case 1: tile_item<1>(ph, b, c0, x, y, rb, b0, sign); break;
    case 2: tile_item<2>(ph, b, c0, x, y, rb, b0, sign); break;
    case 4: tile_item<4>(ph, b, c0, x, y, rb, b0, sign); break;
    case 8: tile_item<8>(ph, b, c0, x, y, rb, b0, sign); break;
    default: tile_item<16>(ph, b, c0, x, y, rb, b0, sign); break;
  }
}

// Pass 1 reads x[b][n1][n2] column tiles and writes the scratch rows;
// pass 2 reads the scratch rows k1 as columns and writes out[k1 + G1*k2].
__device__ Phase pass1(const Bf& p) {
  Phase ph{};
  const int64_t n = int64_t(p.g1) * p.g2;
  ph.p.sub = pfft::Sub{p.g1, p.g1 / 128, nullptr, nullptr,
                       nullptr, nullptr, nullptr, nullptr};
  ph.p.ncols = p.g2;
  ph.p.T = p.t1;
  ph.p.ibs = n;
  ph.p.iis = p.g2;
  ph.p.ics = 1;
  ph.p.obs = n;
  ph.p.oks = p.g2;
  ph.p.ocs = 1;
  ph.p.scale = 1.f;
  ph.ur = p.u1r;
  ph.ui = p.u1i;
  ph.gar = p.gar;
  ph.gai = p.gai;
  ph.gbr = p.gbr;
  ph.gbi = p.gbi;
  ph.g2 = p.g2;
  return ph;
}

__device__ Phase pass2(const Bf& p) {
  Phase ph{};
  const int64_t n = int64_t(p.g1) * p.g2;
  ph.p.sub = pfft::Sub{p.g2, p.g2 / 128, nullptr, nullptr,
                       nullptr, nullptr, nullptr, nullptr};
  ph.p.ncols = p.g1;
  ph.p.T = p.t2;
  ph.p.ibs = n;
  ph.p.iis = 1;
  ph.p.ics = p.g2;
  ph.p.obs = n;
  ph.p.oks = p.g1;
  ph.p.ocs = 1;
  ph.p.scale = p.scale;
  ph.ur = p.u2r;
  ph.ui = p.u2i;
  ph.g2 = p.g2;
  return ph;
}

__device__ __forceinline__ int64_t chunk_len(const Bf& p, int64_t r) {
  const int64_t left = p.batch - r * p.chunk;
  return left < p.chunk ? left : p.chunk;
}

__global__ void __launch_bounds__(kBfThreads) global_bf_kernel(Bf p) {
  extern __shared__ float2 smem[];
  cg::grid_group grid = cg::this_grid();
  float2* rb = smem;
  float2* b0 = rb + 128;
  pfft::load_roots(rb, p.w128r, p.w128i, 128);
  const Phase ph1 = pass1(p), ph2 = pass2(p);
  const int64_t n = int64_t(p.g1) * p.g2;
  const int64_t tiles1 = p.g2 / p.t1, tiles2 = p.g1 / p.t2;
  const int64_t chunks = (p.batch + p.chunk - 1) / p.chunk;
  for (int64_t r = 0; r < chunks; ++r) {
    const int64_t nb = chunk_len(p, r);
    const float2* x = p.x + r * p.chunk * n;
    float2* y = p.y + r * p.chunk * n;
    for (int64_t i = blockIdx.x; i < nb * tiles1; i += gridDim.x)
      run_item(ph1, i, x, p.s, rb, b0, p.sign);
    grid.sync();  // the chunk's scratch is written
    for (int64_t i = blockIdx.x; i < nb * tiles2; i += gridDim.x)
      run_item(ph2, i, FromL2{p.s}, y, rb, b0, p.sign);
    if (r + 1 < chunks) grid.sync();  // the scratch is read
  }
}

__global__ void __launch_bounds__(kBfThreads) global_bf_ov_kernel(Bf p) {
  extern __shared__ float2 smem[];
  cg::grid_group grid = cg::this_grid();
  float2* rb = smem;
  float2* b0 = rb + 128;
  pfft::load_roots(rb, p.w128r, p.w128i, 128);
  const Phase ph1 = pass1(p), ph2 = pass2(p);
  const int64_t n = int64_t(p.g1) * p.g2;
  const int64_t tiles1 = p.g2 / p.t1, tiles2 = p.g1 / p.t2;
  const int64_t chunks = (p.batch + p.chunk - 1) / p.chunk;
  const int64_t slot = p.chunk * n;
  for (int64_t r = 0; r <= chunks; ++r) {
    // pass 1 of chunk r into slot r%2, pass 2 of chunk r-1 from the other
    const int64_t items1 = r < chunks ? chunk_len(p, r) * tiles1 : 0;
    const int64_t items2 = r > 0 ? chunk_len(p, r - 1) * tiles2 : 0;
    for (int64_t i = blockIdx.x; i < items1 + items2; i += gridDim.x) {
      if (i < items1)
        run_item(ph1, i, p.x + r * p.chunk * n, p.s + (r & 1) * slot, rb, b0,
                 p.sign);
      else
        run_item(ph2, i - items1, FromL2{p.s + ((r - 1) & 1) * slot},
                 p.y + (r - 1) * p.chunk * n, rb, b0, p.sign);
    }
    if (r < chunks) grid.sync();  // slot r%2 written, slot (r-1)%2 read
  }
}

bool factor_ok(int g) {
  const int a = g / 128;
  return g % 128 == 0 && (a == 1 || a == 2 || a == 4 || a == 8 || a == 16);
}

bool tile_ok(int t, int ncols) {
  return (t == 1 || t == 2 || t == 4 || t == 8) && ncols % t == 0;
}

// The cooperative launch: as many blocks as the card holds at once.
int launch_bf(void (*kernel)(Bf), const Bf& p, cudaStream_t stream) {
  if (!factor_ok(p.g1) || !factor_ok(p.g2) || !tile_ok(p.t1, p.g2) ||
      !tile_ok(p.t2, p.g1) || p.batch < 1 || p.chunk < 1 || p.s == nullptr)
    return int(cudaErrorInvalidValue);
  const int r1 = (p.g1 + p.g1 / 128) * (p.t1 + 1);
  const int r2 = (p.g2 + p.g2 / 128) * (p.t2 + 1);
  const size_t smem = sizeof(float2) * (128 + 2 * size_t(r1 > r2 ? r1 : r2));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kBfThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  Bf arg = p;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(unsigned(per_sm * sms)),
                                    dim3(kBfThreads), args, smem, stream);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

Bf make_bf(const float* x, float* y, float* s, int g1, int g2, int t1, int t2,
           int sign, const float* w128r, const float* w128i, const float* u1r,
           const float* u1i, const float* u2r, const float* u2i,
           const float* gar, const float* gai, const float* gbr,
           const float* gbi, int64_t batch, int64_t chunk, float scale) {
  return Bf{reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(y),
            reinterpret_cast<float2*>(s), g1, g2, t1, t2, sign, w128r, w128i,
            u1r, u1i, u2r, u2i, gar, gai, gbr, gbi, batch, chunk, scale};
}

}  // namespace

// x (2*batch*g1*g2 floats) -> y (may equal x) through the scratch s: K5 one
// slot of 2*chunk*g1*g2 floats, K5-ov two.  t1, t2: columns per tile of
// pass 1 and pass 2; sign: the direction (the butterfly's constants).
// w128r/w128i: the 128-point DFT planes; u1, u2: the (A1, 128) and (A2, 128)
// digit twiddles; ga (A1, g2) and gb (128, g2): the factored inter-factor
// twiddle.  Returns a cudaError_t (cudaErrorCooperativeLaunchTooLarge where
// not one block fits an SM).
extern "C" int pf_global_bf(const float* x, float* y, float* s, int g1, int g2,
                            int t1, int t2, int sign, const float* w128r,
                            const float* w128i, const float* u1r,
                            const float* u1i, const float* u2r,
                            const float* u2i, const float* gar,
                            const float* gai, const float* gbr,
                            const float* gbi, int64_t batch, int64_t chunk,
                            float scale, void* stream) {
  return launch_bf(global_bf_kernel,
                   make_bf(x, y, s, g1, g2, t1, t2, sign, w128r, w128i, u1r,
                           u1i, u2r, u2i, gar, gai, gbr, gbi, batch, chunk,
                           scale),
                   static_cast<cudaStream_t>(stream));
}

extern "C" int pf_global_bf_ov(const float* x, float* y, float* s, int g1,
                               int g2, int t1, int t2, int sign,
                               const float* w128r, const float* w128i,
                               const float* u1r, const float* u1i,
                               const float* u2r, const float* u2i,
                               const float* gar, const float* gai,
                               const float* gbr, const float* gbi,
                               int64_t batch, int64_t chunk, float scale,
                               void* stream) {
  return launch_bf(global_bf_ov_kernel,
                   make_bf(x, y, s, g1, g2, t1, t2, sign, w128r, w128i, u1r,
                           u1i, u2r, u2i, gar, gai, gbr, gbi, batch, chunk,
                           scale),
                   static_cast<cudaStream_t>(stream));
}
