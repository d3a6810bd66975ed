// K6 `deinterleave` / `interleave`: the PACKED interleaved buffer of m
// complex elements ((re, im) float pairs) to two float planes of m, and
// back, times a scale.
//
// Replaces portfft_tpu/ops/pallas_io.py::deinterleave and ::interleave,
// which move (128, 128) tiles through the TPU's transpose unit and take
// only m that is a multiple of 128*128 (the JAX package pads the rest).
// Here each thread moves whole elements: one 8-byte float2 read and two
// 4-byte plane writes (or the reverse), neighbouring threads on
// neighbouring elements, so every warp reads and writes contiguous runs.
// Any m is taken as it is.
//
// Bound on the H100: 16 bytes of device memory per element and no
// arithmetic beyond the scale, so the bound is bytes (m = 2^27 moves
// 2.15 GB: 0.64 ms at 3.35 TB/s).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t(132) * 32;  // a few waves of the SMs

__global__ void __launch_bounds__(kThreads)
    deinterleave_kernel(const float2* x, float* re, float* im, int64_t m) {
  const int64_t step = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < m;
       i += step) {
    const float2 v = x[i];
    re[i] = v.x;
    im[i] = v.y;
  }
}

__global__ void __launch_bounds__(kThreads)
    interleave_kernel(const float* re, const float* im, float2* y, int64_t m,
                      float scale) {
  const int64_t step = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < m;
       i += step) {
    y[i] = make_float2(scale * re[i], scale * im[i]);
  }
}

unsigned blocks_for(int64_t m) {
  const int64_t b = (m + kThreads - 1) / kThreads;
  return unsigned(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// x (2*m floats, interleaved) -> re, im (m floats each).  Returns a
// cudaError_t.
extern "C" int pf_deinterleave(const float* x, float* re, float* im,
                               int64_t m, void* stream) {
  if (m < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  deinterleave_kernel<<<blocks_for(m), kThreads, 0, st>>>(
      reinterpret_cast<const float2*>(x), re, im, m);
  return int(cudaGetLastError());
}

// re, im (m floats each) -> y (2*m floats, interleaved), times scale.
// Returns a cudaError_t.
extern "C" int pf_interleave(const float* re, const float* im, float* y,
                             int64_t m, float scale, void* stream) {
  if (m < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  interleave_kernel<<<blocks_for(m), kThreads, 0, st>>>(
      re, im, reinterpret_cast<float2*>(y), m, scale);
  return int(cudaGetLastError());
}
