// K4 `global_sq`: batched GLOBAL transform n = G1*G2 in one pass, each
// transform held whole in the shared memory of one thread-block cluster
// between its two sub-transform stages.
//
// Replaces portfft_tpu/ops/pallas_global.py::global_sq_raw_call (the tuned
// engine {"eng": 5}).  K3 runs the same four-step in two launches and
// sends the intermediate through device memory; here it never leaves the
// chip.  With the row viewed as x[n1, n2] = x[G2*n1 + n2], a cluster of C
// blocks (C*16384 >= n, C <= 8) takes one transform at a time:
//   stage A: block r loads columns n2 in [r*G2/C, (r+1)*G2/C), takes the
//            G1-point DFT down each, and keeps the results in registers;
//   transpose: after a cluster barrier (every block has read its own
//            share), each block writes its results (k1, n2) into the
//            shared memory of the block that owns row k1 in stage B
//            (cluster.map_shared_rank); a second barrier;
//   stage B: block r multiplies its rows k1 in [r*G1/C, (r+1)*G1/C) by the
//            bank's (G2, G1) twiddle w_n^(n2*k1), takes the G2-point DFT
//            along each and writes out[k1 + G1*k2] = scale * (...), which is
//            natural order.
// One block's share fits its shared memory twice over only past C = 16, so
// the share is held once and stage A's results wait in registers: 512
// threads each hold up to 32 points.  Both subs are DIRECT (n <= 2^17 with
// the G <= 512 DIRECT threshold).  Each thread sums four outputs at once
// that read the same input element (stage A: the same column, k1 512/cols
// apart; stage B: the same row).
//
// Bound on the H100: 16 bytes per point moved once (K3 moves 40) against
// 8*(G1 + G2) flops per point, the same arithmetic as K3: bound by the
// fp32 operations, in this first version by shared-memory operand reads.
#include <cooperative_groups.h>

#include "fft_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSqThreads = 512;
constexpr int kSqPer = 32;  // stage-A outputs a thread holds
constexpr int kSqBlockPoints = kSqThreads * kSqPer;
constexpr int kSqGroup = 4;  // outputs a thread sums at once
constexpr int kSqClusterMax = 8;  // the portable cluster size

struct Sq {
  const float2* x;
  float2* y;
  const float* w1r;
  const float* w1i;
  const float* w2r;
  const float* w2i;
  const float* tr;
  const float* ti;
  int g1, g2, C;
  int64_t batch;
  float scale;
};

// sum_j src[j*step] * root[(j*k[q]) mod len] for kSqGroup outputs q.
__device__ __forceinline__ void dft_group(const float2* src, int step, int len,
                                          const float2* root,
                                          const int (&k)[kSqGroup],
                                          float2 (&out)[kSqGroup]) {
  float re[kSqGroup], im[kSqGroup];
  int r[kSqGroup];
#pragma unroll
  for (int q = 0; q < kSqGroup; ++q) {
    re[q] = 0.f;
    im[q] = 0.f;
    r[q] = 0;
  }
  for (int j = 0; j < len; ++j) {
    const float2 v = src[j * step];
#pragma unroll
    for (int q = 0; q < kSqGroup; ++q) {
      const float2 w = root[r[q]];
      re[q] = fmaf(v.x, w.x, re[q]);
      re[q] = fmaf(-v.y, w.y, re[q]);
      im[q] = fmaf(v.x, w.y, im[q]);
      im[q] = fmaf(v.y, w.x, im[q]);
      r[q] += k[q];
      if (r[q] >= len) r[q] -= len;
    }
  }
#pragma unroll
  for (int q = 0; q < kSqGroup; ++q) out[q] = make_float2(re[q], im[q]);
}

__global__ void __launch_bounds__(kSqThreads, 1) global_sq_kernel(Sq p) {
  extern __shared__ float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.C;
  const int rank = int(cluster.block_rank());
  const int g1 = p.g1, g2 = p.g2;
  const int cols = g2 / C, rows = g1 / C, pitch = g2 + 1;
  const int E = g1 * cols;  // = rows * g2 points per block
  float2* r1 = smem;
  float2* r2 = r1 + g1;
  float2* tile = r2 + g2;  // stage A: [n1][c], pitch cols; B: [k1l][n2], pitch
  pfft::load_roots(r1, p.w1r, p.w1i, g1);
  pfft::load_roots(r2, p.w2r, p.w2i, g2);
  const int64_t n = int64_t(g1) * g2;
  const int64_t clusters = gridDim.x / C;
  const int tid = threadIdx.x;
  // Output j of a thread is point tid + j*512: stage A (k1, c) with c fixed
  // and k1 = k1_0 + j*dk1; stage B (k2, k1l) with k1l fixed.
  const int c = tid % cols, k1_0 = tid / cols, dk1 = kSqThreads / cols;
  const int k1l = tid % rows, k2_0 = tid / rows, dk2 = kSqThreads / rows;
  const float* twr = p.tr + int64_t(rank) * rows + k1l;
  const float* twi = p.ti + int64_t(rank) * rows + k1l;
  for (int64_t b = blockIdx.x / C; b < p.batch; b += clusters) {
    __syncthreads();  // the previous transform's stage B has read the tile
    const float2* xb = p.x + b * n + int64_t(rank) * cols;
    for (int e = tid; e < E; e += kSqThreads) {
      const int n1 = e / cols;
      tile[e] = xb[int64_t(n1) * g2 + (e - n1 * cols)];
    }
    __syncthreads();
    float2 acc[kSqPer];
#pragma unroll
    for (int j0 = 0; j0 < kSqPer; j0 += kSqGroup) {
      if (j0 * kSqThreads < E) {
        int k[kSqGroup];
        float2 out[kSqGroup];
#pragma unroll
        for (int q = 0; q < kSqGroup; ++q) k[q] = k1_0 + (j0 + q) * dk1;
        dft_group(tile + c, cols, g1, r1, k, out);
#pragma unroll
        for (int q = 0; q < kSqGroup; ++q) acc[j0 + q] = out[q];
      }
    }
    cluster.sync();  // every block of the cluster has read its share
#pragma unroll
    for (int j = 0; j < kSqPer; ++j) {
      if (j * kSqThreads < E) {
        const int k1 = k1_0 + j * dk1;
        const int q = k1 / rows;
        float2* dst = cluster.map_shared_rank(tile, q);
        dst[(k1 - q * rows) * pitch + rank * cols + c] = acc[j];
      }
    }
    cluster.sync();  // every share has landed
    // the inter-factor twiddle, bank layout (G2, G1) = [n2][k1]
    for (int n2 = tid / rows; n2 < g2; n2 += dk2) {
      float2& v = tile[k1l * pitch + n2];
      const int64_t t = int64_t(n2) * g1;
      v = pfft::cmul(v, make_float2(__ldg(twr + t), __ldg(twi + t)));
    }
    __syncthreads();
    float2* yb = p.y + b * n + int64_t(rank) * rows + k1l;
    for (int j0 = 0; j0 * kSqThreads < E; j0 += kSqGroup) {
      int k[kSqGroup];
      float2 out[kSqGroup];
#pragma unroll
      for (int q = 0; q < kSqGroup; ++q) k[q] = k2_0 + (j0 + q) * dk2;
      dft_group(tile + k1l * pitch, 1, g2, r2, k, out);
#pragma unroll
      for (int q = 0; q < kSqGroup; ++q)
        yb[int64_t(k[q]) * g1] =
            make_float2(p.scale * out[q].x, p.scale * out[q].y);
    }
  }
}

}  // namespace

// x (2*batch*g1*g2 floats) -> y, which may equal x.  w1r/w1i, w2r/w2i: the
// g1 x g1 and g2 x g2 DFT planes (row 1 is read); tr/ti: the (g2, g1)
// inter-factor twiddle planes.  Returns a cudaError_t: cudaErrorInvalidValue
// for a shape outside the gate (cuda_global.sq_cluster), and
// cudaErrorInvalidConfiguration where no cluster of the kernel fits the card.
extern "C" int pf_global_sq(const float* x, float* y, int g1, const float* w1r,
                            const float* w1i, int g2, const float* w2r,
                            const float* w2i, const float* tr, const float* ti,
                            int64_t batch, float scale, void* stream) {
  if (g1 < 1 || g2 < 1 || batch < 1) return int(cudaErrorInvalidValue);
  const int64_t n = int64_t(g1) * g2;
  int C = 1;
  while (int64_t(C) * kSqBlockPoints < n) C *= 2;
  if (C > kSqClusterMax || g1 % C || g2 % C) return int(cudaErrorInvalidValue);
  const int rows = g1 / C, cols = g2 / C;
  const int64_t E = n / C;
  if (E % (kSqGroup * kSqThreads) || kSqThreads % rows || kSqThreads % cols)
    return int(cudaErrorInvalidValue);
  const size_t smem = sizeof(float2) * (size_t(g1) + g2 + E + rows);
  cudaError_t err = cudaFuncSetAttribute(
      global_sq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kSqThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(
      &active, reinterpret_cast<const void*>(global_sq_kernel), &cfg);
  if (err != cudaSuccess) return int(err);
  if (active < 1) return int(cudaErrorInvalidConfiguration);
  const int64_t clusters = batch < 65535 ? batch : 65535;
  cfg.gridDim = dim3(unsigned(C * clusters));
  const Sq p{reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(y),
             w1r, w1i, w2r, w2i, tr, ti, g1, g2, C, batch, scale};
  err = cudaLaunchKernelEx(&cfg, global_sq_kernel, p);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
