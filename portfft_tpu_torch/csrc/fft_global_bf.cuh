// Shared machinery of the butterfly-factored single-sweep GLOBAL kernels:
// K5 `global_bf`, K5-ov `global_bf_ov` and K19 `global_bf2`
// (fft_global_bf.cu) and K18 `global_ilv` (fft_global_ilv.cu).
//
// Each computes the batched GLOBAL transform n = G1*G2 on the PACKED
// interleaved buffer with each sub factored as g = A*128; with the row viewed
// as x[n1, n2] = x[G2*n1 + n2]:
//   pass 1, per column n2 (i = n1 = 128*iA + iB): the A1-point slab DFT over
//           iA (slab_dft: radix-2 and radix-3 butterflies, exact or snapped
//           constants), the digit twiddle U1[kA][iB] = w_G1^(kA*iB), the
//           128-point DFT over iB, giving k1 = kA + A1*kB in natural order;
//           times GA[kA][n2] * GB[kB][n2] = w_n^(k1*n2); stored to the
//           scratch S[k1][n2];
//   pass 2, per row k1 of S: the same over n2 with A2 and U2, stored as
//           out[k1 + G1*k2] = scale * (...).
// About A + 128 complex multiply-adds per point and pass where K3 sums G.
// Each pass is a column pass of fft_common.cuh (tile_load, tile_store) with
// this sub-transform.  A is a power of two <= 16 (K5, K5-ov, K19) or any
// 2^a*3^b <= 16 (K18: 1, 2, 3, 4, 6, 8, 9, 12, 16).
//
// A TPU core keeps the whole transform in VMEM; shared memory cannot hold
// 2^20 points (8 MiB), so here the intermediate goes to a scratch in device
// memory that is small enough to stay in the 50 MB L2: the batch runs in
// chunks of `chunk` transforms (8*n*chunk bytes a slot, a quarter of L2;
// cuda_global_bf.bf_chunk).  The grid is every block the card holds at
// once (cudaLaunchCooperativeKernel); blocks share out each pass's tiles,
// and grid-wide barriers order the passes (sweep_kernel: per chunk, pass 1
// into the slot, barrier, pass 2, barrier; overlay_kernel: round r runs
// pass 1 of chunk r into slot r%2 and pass 2 of chunk r-1 from slot
// (r-1)%2 in one sweep of tiles, one barrier a round).  An output element is
// written only by its transform's pass 2.  Scratch reads bypass L1
// (__ldcg): a slot is rewritten between barriers.
//
// K19 does not stream GB: each block loads its two factors, B1t[kB][c] =
// w_(n/A1)^(c*kB) (128 x kLoT1) and B2[s][kB] = w_(n/A1)^(s*kLoT1*kB)
// (G2/kLoT1 x 128), into shared memory once per launch and forms
// GB[kB][c + kLoT1*s] = B1t[kB][c] * B2[s][kB] in pass 1's store.
#pragma once

#include <cooperative_groups.h>

#include "fft_common.cuh"

namespace pfft_bf {

namespace cg = cooperative_groups;

// Internal linkage: each .cu file that includes this header gets its own
// copy of the kernels and of the functions that launch them.
namespace {

constexpr int kThreads = 256;
// Blocks an SM the registers must leave room for.  The power-of-two kernels
// take three 256-thread blocks (80 registers a thread; unbounded they take
// 128, which halves the blocks at 512-point subs, whose tiles fit three:
// 2^17 x 1024 ran 32.5 ms against 28.0 bounded, H100 80GB HBM3, 700 W).
// The mixed-radix ones take two (128 registers): bounded to 80 they spill,
// and 147456 x 1024 ran 44.9 ms against 30.1.
template <bool Mixed>
constexpr int kMinBlocks = Mixed ? 2 : 3;
// K19's table width (cuda_global_bf.BF2_T1): n2 = c + kLoT1*s.
constexpr int kLoT1 = 128;

struct Bf {
  const float2* x;
  float2* y;
  float2* s;  // scratch: one slot (K5, K18, K19) or two (K5-ov) of chunk*n
  int g1, g2, t1, t2, sign;
  const float* w128r;
  const float* w128i;
  const float* u1r;
  const float* u1i;
  const float* u2r;
  const float* u2i;
  const float* gar;
  const float* gai;
  const float* gbr;  // GB (128, g2); nullptr for K19
  const float* gbi;
  const float* b1r;  // K19: B1t (128, kLoT1) and B2 (g2/kLoT1, 128), else
  const float* b1i;  // nullptr
  const float* b2r;
  const float* b2i;
  int64_t batch, chunk;
  float scale;
};

// exp(sign*2*pi*i*k/144) for the k the slab DFTs use (multiples of 144/S for
// the stage sizes S = 2, 3, 4, 6, 8, 9, 12, 16), parts snapped to exact 0
// and +-1 (torch_fft._snap).  Called with constants only, so it folds away.
__device__ __forceinline__ float2 root144(int k, int sign) {
  float c = 1.f, s = 0.f;
  switch (k) {
    case 9: c = 0.92387953251128674f; s = 0.38268343236508978f; break;
    case 12: c = 0.86602540378443871f; s = 0.49999999999999994f; break;
    case 16: c = 0.76604444311897801f; s = 0.64278760968653925f; break;
    case 18: c = 0.70710678118654757f; s = 0.70710678118654746f; break;
    case 24: c = 0.50000000000000011f; s = 0.8660254037844386f; break;
    case 27: c = 0.38268343236508984f; s = 0.92387953251128674f; break;
    case 32: c = 0.17364817766693041f; s = 0.98480775301220802f; break;
    case 36: c = 0.f; s = 1.f; break;
    case 45: c = -0.38268343236508973f; s = 0.92387953251128674f; break;
    case 48: c = -0.49999999999999978f; s = 0.86602540378443871f; break;
    case 54: c = -0.70710678118654746f; s = 0.70710678118654757f; break;
    case 60: c = -0.86602540378443849f; s = 0.50000000000000033f; break;
    case 63: c = -0.92387953251128674f; s = 0.38268343236508989f; break;
    case 64: c = -0.93969262078590832f; s = 0.34202014332566888f; break;
    case 72: c = -1.f; s = 0.f; break;
    case 80: c = -0.93969262078590843f; s = -0.34202014332566866f; break;
    case 81: c = -0.92387953251128685f; s = -0.38268343236508967f; break;
    case 84: c = -0.8660254037844386f; s = -0.50000000000000011f; break;
    case 90: c = -0.70710678118654768f; s = -0.70710678118654746f; break;
    case 96: c = -0.50000000000000044f; s = -0.86602540378443837f; break;
    case 99: c = -0.3826834323650895f; s = -0.92387953251128685f; break;
    case 108: c = 0.f; s = -1.f; break;
    case 112: c = 0.17364817766692997f; s = -0.98480775301220813f; break;
    case 117: c = 0.38268343236509f; s = -0.92387953251128663f; break;
    case 120: c = 0.49999999999999933f; s = -0.86602540378443904f; break;
    case 126: c = 0.70710678118654735f; s = -0.70710678118654768f; break;
    case 128: c = 0.76604444311897779f; s = -0.64278760968653958f; break;
    case 132: c = 0.86602540378443882f; s = -0.49999999999999967f; break;
    case 135: c = 0.92387953251128652f; s = -0.38268343236509039f; break;
    default: break;
  }
  return make_float2(c, sign < 0 ? -s : s);
}

// w_S^e = exp(sign*2*pi*i*e/S), e >= 0.
template <int S>
__device__ __forceinline__ float2 unit_root(int e, int sign) {
  return root144((e % S) * (144 / S), sign);
}

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// y = the A-point DFT of x[O + S*j], j < A, natural order in and out:
// decimation in time, radix 2 while A is even, then radix 3; with R the
// radix and M = A/R, y[q + t*M] = sum_i (sub_i[q] * w_A^(i*q)) * w_R^(i*t),
// sub_i the M-point DFT of x[O + S*i + S*R*j] (torch_fft.mixed_radix_dft).
// Every index is a constant after unrolling: all in registers.
template <int A, int S, int O, int N>
struct Dit {
  static __device__ __forceinline__ void run(const float2 (&x)[N],
                                             float2 (&y)[A], int sign) {
    if constexpr (A == 1) {
      y[0] = x[O];
    } else {
      constexpr int R = A % 2 == 0 ? 2 : 3;
      constexpr int M = A / R;
      float2 s0[M], s1[M], s2[M];
      Dit<M, S * R, O, N>::run(x, s0, sign);
      Dit<M, S * R, O + S, N>::run(x, s1, sign);
      if constexpr (R == 3) Dit<M, S * R, O + 2 * S, N>::run(x, s2, sign);
#pragma unroll
      for (int q = 0; q < M; ++q) {
        const float2 p1 = pfft::cmul(s1[q], unit_root<A>(q, sign));
        float2 p2 = p1;
        if constexpr (R == 3) p2 = pfft::cmul(s2[q], unit_root<A>(2 * q, sign));
#pragma unroll
        for (int t = 0; t < R; ++t) {
          float2 acc = add(s0[q], pfft::cmul(p1, unit_root<R>(t, sign)));
          if constexpr (R == 3)
            acc = add(acc, pfft::cmul(p2, unit_root<R>(2 * t, sign)));
          y[q + t * M] = acc;
        }
      }
    }
  }
};

// The A-point slab DFT of v in place.
template <int A>
__device__ __forceinline__ void slab_dft(float2 (&v)[A], int sign) {
  float2 y[A];
  Dit<A, 1, 0, A>::run(v, y, sign);
#pragma unroll
  for (int k = 0; k < A; ++k) v[k] = y[k];
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
  const float2* lo;  // K19: B1t then B2 in shared memory; else nullptr
  int g2;            // the row length of the scratch
};

// The sub-transform of the tile in b0 (element 128*iA + iB of column t at
// (129*iA + iB)*es + t): slab DFT and digit twiddle in place, then the
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
    slab_dft<A>(v, sign);
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
    const int kb = k / A;
    const int ia = (k - kb * A) * g2 + n2;
    float2 gb;
    if (ph.lo) {
      gb = pfft::cmul(ph.lo[kb * kLoT1 + n2 % kLoT1],
                      ph.lo[128 * kLoT1 + (n2 / kLoT1) * 128 + kb]);
    } else {
      gb = make_float2(__ldg(ph.gbr + kb * g2 + n2), __ldg(ph.gbi + kb * g2 + n2));
    }
    float2 v = res[(k + (k >> 7)) * es + t];
    v = pfft::cmul(v, make_float2(__ldg(ph.gar + ia), __ldg(ph.gai + ia)));
    v = pfft::cmul(v, gb);
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
// Mixed: the slab factors of K18 (2^a*3^b), else the powers of two.
template <bool Mixed, class X>
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
    case 16: tile_item<16>(ph, b, c0, x, y, rb, b0, sign); break;
    default:
      if constexpr (Mixed) {
        switch (ph.p.sub.a) {
          case 3: tile_item<3>(ph, b, c0, x, y, rb, b0, sign); break;
          case 6: tile_item<6>(ph, b, c0, x, y, rb, b0, sign); break;
          case 9: tile_item<9>(ph, b, c0, x, y, rb, b0, sign); break;
          default: tile_item<12>(ph, b, c0, x, y, rb, b0, sign); break;
        }
      }
      break;
  }
}

// Pass 1 reads x[b][n1][n2] column tiles and writes the scratch rows;
// pass 2 reads the scratch rows k1 as columns and writes out[k1 + G1*k2].
__device__ inline Phase pass1(const Bf& p, const float2* lo) {
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
  ph.lo = lo;
  ph.g2 = p.g2;
  return ph;
}

__device__ inline Phase pass2(const Bf& p) {
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

// Float2 elements of K19's resident tables (0 for the others).
__host__ __device__ inline int resident_elems(const Bf& p) {
  return p.b1r ? 128 * kLoT1 + (p.g2 / kLoT1) * 128 : 0;
}

// Shared memory: the 128-point roots, K19's resident tables, then the two
// tiles b0, b1 of the larger pass.  Returns b0; sets *lo (nullptr unless K19).
__device__ inline float2* setup(const Bf& p, float2* smem, const float2** lo) {
  float2* rb = smem;
  float2* res = rb + 128;
  pfft::load_roots(rb, p.w128r, p.w128i, 128);
  *lo = nullptr;
  if (p.b1r) {
    const int n1 = 128 * kLoT1, n2 = (p.g2 / kLoT1) * 128;
    for (int i = threadIdx.x; i < n1 + n2; i += blockDim.x)
      res[i] = i < n1 ? make_float2(__ldg(p.b1r + i), __ldg(p.b1i + i))
                      : make_float2(__ldg(p.b2r + i - n1), __ldg(p.b2i + i - n1));
    *lo = res;
  }
  return res + resident_elems(p);
}

// K5, K18 and K19: per chunk, pass 1 into the slot, barrier, pass 2.
template <bool Mixed>
__global__ void __launch_bounds__(kThreads, kMinBlocks<Mixed>)
    sweep_kernel(Bf p) {
  extern __shared__ float2 smem[];
  cg::grid_group grid = cg::this_grid();
  const float2* rb = smem;
  const float2* lo;
  float2* b0 = setup(p, smem, &lo);
  const Phase ph1 = pass1(p, lo), ph2 = pass2(p);
  const int64_t n = int64_t(p.g1) * p.g2;
  const int64_t tiles1 = p.g2 / p.t1, tiles2 = p.g1 / p.t2;
  const int64_t chunks = (p.batch + p.chunk - 1) / p.chunk;
  for (int64_t r = 0; r < chunks; ++r) {
    const int64_t nb = chunk_len(p, r);
    const float2* x = p.x + r * p.chunk * n;
    float2* y = p.y + r * p.chunk * n;
    for (int64_t i = blockIdx.x; i < nb * tiles1; i += gridDim.x)
      run_item<Mixed>(ph1, i, x, p.s, rb, b0, p.sign);
    grid.sync();  // the chunk's scratch is written
    for (int64_t i = blockIdx.x; i < nb * tiles2; i += gridDim.x)
      run_item<Mixed>(ph2, i, FromL2{p.s}, y, rb, b0, p.sign);
    if (r + 1 < chunks) grid.sync();  // the scratch is read
  }
}

// K5-ov: round r runs pass 1 of chunk r and pass 2 of chunk r-1.
template <bool Mixed>
__global__ void __launch_bounds__(kThreads, kMinBlocks<Mixed>)
    overlay_kernel(Bf p) {
  extern __shared__ float2 smem[];
  cg::grid_group grid = cg::this_grid();
  const float2* rb = smem;
  const float2* lo;
  float2* b0 = setup(p, smem, &lo);
  const Phase ph1 = pass1(p, lo), ph2 = pass2(p);
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
        run_item<Mixed>(ph1, i, p.x + r * p.chunk * n, p.s + (r & 1) * slot,
                        rb, b0, p.sign);
      else
        run_item<Mixed>(ph2, i - items1, FromL2{p.s + ((r - 1) & 1) * slot},
                        p.y + (r - 1) * p.chunk * n, rb, b0, p.sign);
    }
    if (r < chunks) grid.sync();  // slot r%2 written, slot (r-1)%2 read
  }
}

inline bool factor_ok(int g, bool mixed) {
  if (g % 128) return false;
  const int a = g / 128;
  if (a == 1 || a == 2 || a == 4 || a == 8 || a == 16) return true;
  return mixed && (a == 3 || a == 6 || a == 9 || a == 12);
}

inline bool tile_ok(int t, int ncols) {
  return (t == 1 || t == 2 || t == 4 || t == 8) && ncols % t == 0;
}

// The cooperative launch: as many blocks as the card holds at once, sized
// with the kernel's real shared memory.
inline int launch_bf(void (*kernel)(Bf), const Bf& p, bool mixed,
                     cudaStream_t stream) {
  if (!factor_ok(p.g1, mixed) || !factor_ok(p.g2, mixed) ||
      !tile_ok(p.t1, p.g2) || !tile_ok(p.t2, p.g1) || p.batch < 1 ||
      p.chunk < 1 || p.s == nullptr || (p.gbr == nullptr) == (p.b1r == nullptr))
    return int(cudaErrorInvalidValue);
  const int r1 = (p.g1 + p.g1 / 128) * (p.t1 + 1);
  const int r2 = (p.g2 + p.g2 / 128) * (p.t2 + 1);
  const size_t smem = sizeof(float2) * (128 + size_t(resident_elems(p)) +
                                        2 * size_t(r1 > r2 ? r1 : r2));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  Bf arg = p;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(unsigned(per_sm * sms)),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace pfft_bf
