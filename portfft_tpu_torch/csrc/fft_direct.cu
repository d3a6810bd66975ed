// K1 `direct`: batched DIRECT DFT, n <= 512, on the PACKED interleaved
// buffer.
//
// Replaces portfft_tpu/ops/pallas_fft.py::direct_raw_call
// (_direct_raw_kernel), which multiplies row tiles by a block-diagonal
// interleaved DFT matrix on the TPU's matrix unit.  That matrix exists to
// fill 128-lane tiles; here each block loads a tile of whole rows, as
// float2, into shared memory with the n-entry root table (row 1 of the
// bank's DFT matrix, 4 KiB at n = 512) and sums
//   y[b, k] = scale * sum_j x[b, j] * w^((j*k) mod n)
// in fp32 FMA on the CUDA cores.
//
// Bound on the H100, per complex element: 8n flops against 16 bytes of
// device memory (8 read, 8 written).  At n = 16 that is 8 flops/byte, under
// the card's ~20 flops/byte fp32 ridge: the kernel is bound by bytes.  At
// n = 256 (128 flops/byte) and n = 512 it is bound by arithmetic, and in
// this first version by shared-memory reads (two operands per complex
// multiply-add), at a fraction of the fp32 FMA rate.  The design keeps the
// bytes at their minimum (one read and one write per element, rows loaded
// and stored contiguously) and leaves the arithmetic bound to later work:
// a radix decomposition or tensor-core products.
#include "fft_common.cuh"

namespace {

__global__ void __launch_bounds__(pfft::kThreads)
    direct_kernel(pfft::Pass p, const float2* x, float2* y) {
  pfft::run_pass(p, x, y);
}

}  // namespace

// Rows of x (2*batch*n floats) -> rows of y; y may equal x.  wr/wi: the
// bank's n x n DFT planes for the direction.  Returns a cudaError_t.
extern "C" int pf_direct(const float* x, float* y, const float* wr,
                         const float* wi, int64_t batch, int n, float scale,
                         void* stream) {
  if (n < 1 || batch < 1) return int(cudaErrorInvalidValue);
  pfft::Pass p{};
  p.sub = pfft::Sub{n, 0, wr, wi, nullptr, nullptr, nullptr, nullptr};
  // Every row is one column of the pass: batch 1, ncols = batch rows.
  p.nbatch = 1;
  p.ncols = batch;
  p.T = pfft::pick_tile(n, batch, 2048, 1 << 20);
  p.ibs = 0;
  p.iis = 1;
  p.ics = n;
  p.obs = 0;
  p.oks = 1;
  p.ocs = n;
  p.scale = scale;
  return pfft::launch_pass(direct_kernel, p, x, y,
                           static_cast<cudaStream_t>(stream));
}

// Message of a code returned by any pf_* entry.
extern "C" const char* pf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
