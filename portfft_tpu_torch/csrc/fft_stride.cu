// K7 `destride` / `restride`: copy between a strided 1D layout and packed
// rows.  The layout is one affine map: element (b, j) of a domain's buffer
// sits at o + b*dist + j*s, for b < batch and j < n.  destride gathers it
// into the packed (batch, n) buffer; restride scatters the packed rows back
// to those addresses, and either leaves every other element of the output
// as it is (an out= buffer, an in-place transform) or writes 0 there
// (fill_gaps: a buffer the library allocates, leading offset included).
// An element is a float2 (an interleaved buffer) or a float (a plane of a
// SPLIT_COMPLEX buffer; both planes go in one launch, one per blockIdx.z
// of the row mapping or blockIdx.y of the tile mapping).
//
// Replaces portfft_tpu/ops/pallas_io.py::destride and ::restride, which
// move 128-row batch tiles through the TPU's transpose unit and take only
// batch % 128 == 0, a chunk ct | n and dist >= span: the TPU's tile rules.
// The JAX package sends every other layout to an XLA gather or masked
// merge.  Here every (o, s, dist) with s, dist >= 1 is taken, overlapping
// read rows and batch-innermost layouts included.
//
// Bound on the H100: bytes, in 32-byte sectors.  The strided side costs
// min(32, min(s, dist) * element) bytes per element (s = 2 on float2 reads
// the whole span, twice the bytes it uses); the packed side is read or
// written once.  Two mappings keep each warp's accesses in runs:
// - s <= dist (row-major, e.g. a stride-2 view of a wider tensor):
//   neighbouring threads take neighbouring j, so the strided side moves in
//   runs at stride s and the packed side contiguously.
// - dist < s (batch-innermost: BATCH_INTERLEAVED and its relatives): a
//   32 x 32 tile through shared memory; threads run along b on the strided
//   side (stride dist) and along j on the packed side.  Without it every
//   warp would touch 32 sectors at stride s per access.
// fill_gaps writes value-or-zero in one pass where the layout is a
// row-major rectangle (s <= dist, a row's span within dist): each thread
// takes one element of a dist-long output row.  Elsewhere the output is
// zeroed first (cudaMemsetAsync) and then scattered; where the rows leave
// no gap past the offset (BATCH_INTERLEAVED) only the leading offset is
// zeroed.  Addresses are int64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;      // tile edge of the batch-innermost mapping
constexpr int kTileRows = 8;   // its block is kTile x kTileRows threads
constexpr int64_t kMaxGridY = 65535;
constexpr int64_t kMaxTileBlocks = int64_t(132) * 32;  // a few waves of the SMs
constexpr int64_t kMaxRowBlocks = int64_t(132) * 32;
constexpr int64_t kMaxFillWidth = int64_t(1) << 31;    // 32-bit column math

// element (b, j) = o + b * dist + j * s
struct Map {
  int64_t o, s, dist, n, batch;
};

// up to two planes, launched together: src[p] -> dst[p]
template <typename T>
struct Planes {
  const T* src[2];
  T* dst[2];
  // plane i's pointers, selected without indexing the parameter arrays
  // (which would copy them to local memory)
  __device__ __forceinline__ const T* in(unsigned i) const {
    return i ? src[1] : src[0];
  }
  __device__ __forceinline__ T* out(unsigned i) const {
    return i ? dst[1] : dst[0];
  }
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.0f, 0.0f);
}

// Row mapping (s <= dist): threadIdx.x runs along j, threadIdx.y and the
// grid's y along b.  The grid is capped (row_grid), so each thread walks
// many rows: few blocks to schedule, and unrolled read-only loads keep
// several of a thread's reads in flight.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    destride_rows(Planes<T> p, Map m) {
  const T* x = p.in(blockIdx.z);
  T* y = p.out(blockIdx.z);
  const int64_t jstep = int64_t(gridDim.x) * blockDim.x;
  const int64_t bstep = int64_t(gridDim.y) * blockDim.y;
  for (int64_t j = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; j < m.n;
       j += jstep) {
#pragma unroll 4
    for (int64_t b = int64_t(blockIdx.y) * blockDim.y + threadIdx.y;
         b < m.batch; b += bstep) {
      y[b * m.n + j] = __ldg(x + m.o + b * m.dist + j * m.s);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    restride_rows(Planes<T> p, Map m) {
  const T* y = p.in(blockIdx.z);
  T* out = p.out(blockIdx.z);
  const int64_t jstep = int64_t(gridDim.x) * blockDim.x;
  const int64_t bstep = int64_t(gridDim.y) * blockDim.y;
  for (int64_t j = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; j < m.n;
       j += jstep) {
#pragma unroll 4
    for (int64_t b = int64_t(blockIdx.y) * blockDim.y + threadIdx.y;
         b < m.batch; b += bstep) {
      out[m.o + b * m.dist + j * m.s] = __ldg(y + b * m.n + j);
    }
  }
}

// fill_gaps on a row-major rectangle: c < width (= dist) is a column of the
// output row b at o + b * dist; it holds row b's element j = c / s where
// c % s == 0 and j < n, else 0.  Nothing at or past out_len is written
// (the tail of the last row).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    restride_fill_rows(Planes<T> p, Map m, uint32_t width, int64_t out_len) {
  const T* y = p.in(blockIdx.z);
  T* out = p.out(blockIdx.z);
  const uint32_t s = uint32_t(m.s);
  const uint32_t cstep = gridDim.x * blockDim.x;
  const int64_t bstep = int64_t(gridDim.y) * blockDim.y;
  for (uint32_t c = blockIdx.x * blockDim.x + threadIdx.x; c < width;
       c += cstep) {
    const uint32_t j = c / s;
    const bool hit = c == j * s && int64_t(j) < m.n;
#pragma unroll 4
    for (int64_t b = int64_t(blockIdx.y) * blockDim.y + threadIdx.y;
         b < m.batch; b += bstep) {
      const int64_t e = m.o + b * m.dist + c;
      if (e >= out_len) break;  // e grows with b
      out[e] = hit ? __ldg(y + b * m.n + j) : zero<T>();
    }
  }
}

// Tile mapping (dist < s): kTile x kTile tiles of (b, j), walked by a grid
// of at most kMaxTileBlocks blocks; tile t is (t % tiles_b, t / tiles_b).
template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
    destride_tile(Planes<T> p, Map m, int64_t tiles_b, int64_t tiles) {
  __shared__ T tile[kTile][kTile + 1];  // [j - j0][b - b0]
  const T* x = p.in(blockIdx.y);
  T* y = p.out(blockIdx.y);
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t b0 = (t % tiles_b) * kTile, j0 = (t / tiles_b) * kTile;
    for (int r = threadIdx.y; r < kTile; r += kTileRows) {
      const int64_t b = b0 + threadIdx.x, j = j0 + r;
      if (b < m.batch && j < m.n) {
        tile[r][threadIdx.x] = x[m.o + b * m.dist + j * m.s];
      }
    }
    __syncthreads();
    for (int r = threadIdx.y; r < kTile; r += kTileRows) {
      const int64_t b = b0 + r, j = j0 + threadIdx.x;
      if (b < m.batch && j < m.n) y[b * m.n + j] = tile[threadIdx.x][r];
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
    restride_tile(Planes<T> p, Map m, int64_t tiles_b, int64_t tiles) {
  __shared__ T tile[kTile][kTile + 1];  // [b - b0][j - j0]
  const T* y = p.in(blockIdx.y);
  T* out = p.out(blockIdx.y);
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t b0 = (t % tiles_b) * kTile, j0 = (t / tiles_b) * kTile;
    for (int r = threadIdx.y; r < kTile; r += kTileRows) {
      const int64_t b = b0 + r, j = j0 + threadIdx.x;
      if (b < m.batch && j < m.n) tile[r][threadIdx.x] = y[b * m.n + j];
    }
    __syncthreads();
    for (int r = threadIdx.y; r < kTile; r += kTileRows) {
      const int64_t b = b0 + threadIdx.x, j = j0 + r;
      if (b < m.batch && j < m.n) {
        out[m.o + b * m.dist + j * m.s] = tile[threadIdx.x][r];
      }
    }
    __syncthreads();
  }
}

bool tiled(const Map& m) { return m.batch > 1 && m.dist < m.s; }

// Row mapping geometry: threadIdx.x covers up to 256 of a row's width, the
// rest of the 256 threads take further rows; at most kMaxRowBlocks blocks
// a plane, the x extent first.
void row_grid(int64_t width, int64_t batch, int planes, dim3* grid,
              dim3* block) {
  unsigned tx = 1;
  while (tx < unsigned(kThreads) && int64_t(tx) < width) tx <<= 1;
  const unsigned ty = unsigned(kThreads) / tx;
  int64_t gx = (width + tx - 1) / tx;
  if (gx > kMaxRowBlocks) gx = kMaxRowBlocks;
  int64_t gy = (batch + ty - 1) / ty;
  const int64_t cap = kMaxRowBlocks / gx;
  if (gy > cap) gy = cap > 0 ? cap : 1;
  if (gy > kMaxGridY) gy = kMaxGridY;
  *grid = dim3(unsigned(gx), unsigned(gy), unsigned(planes));
  *block = dim3(tx, ty, 1);
}

void tile_grid(const Map& m, int planes, int64_t* tiles_b, int64_t* tiles,
               dim3* grid) {
  *tiles_b = (m.batch + kTile - 1) / kTile;
  *tiles = *tiles_b * ((m.n + kTile - 1) / kTile);
  const int64_t blocks = *tiles < kMaxTileBlocks ? *tiles : kMaxTileBlocks;
  *grid = dim3(unsigned(blocks), unsigned(planes), 1);
}

template <typename T>
int destride_launch(Planes<T> p, int planes, Map m, cudaStream_t st) {
  dim3 grid, block;
  if (tiled(m)) {
    int64_t tiles_b, tiles;
    tile_grid(m, planes, &tiles_b, &tiles, &grid);
    destride_tile<T><<<grid, dim3(kTile, kTileRows), 0, st>>>(p, m, tiles_b,
                                                              tiles);
  } else {
    row_grid(m.n, m.batch, planes, &grid, &block);
    destride_rows<T><<<grid, block, 0, st>>>(p, m);
  }
  return int(cudaGetLastError());
}

template <typename T>
int restride_launch(Planes<T> p, int planes, Map m, int64_t out_len,
                    bool fill, cudaStream_t st) {
  const int64_t span = (m.n - 1) * m.s + 1;
  const bool one_pass = fill && !tiled(m) && span <= m.dist &&
                        m.dist <= kMaxFillWidth &&
                        out_len <= m.o + m.batch * m.dist;
  if (fill) {
    // zero what the launch below leaves: the leading offset, and the gaps
    // unless the one-pass kernel writes them or the rows leave none
    const bool dense = m.batch * m.n == out_len - m.o;
    const int64_t upto = (one_pass || dense) ? m.o : out_len;
    for (int i = 0; i < planes && upto > 0; ++i) {
      const cudaError_t err =
          cudaMemsetAsync(p.dst[i], 0, size_t(upto) * sizeof(T), st);
      if (err != cudaSuccess) return int(err);
    }
  }
  dim3 grid, block;
  if (one_pass) {
    row_grid(m.dist, m.batch, planes, &grid, &block);
    restride_fill_rows<T><<<grid, block, 0, st>>>(p, m, uint32_t(m.dist),
                                                  out_len);
  } else if (tiled(m)) {
    int64_t tiles_b, tiles;
    tile_grid(m, planes, &tiles_b, &tiles, &grid);
    restride_tile<T><<<grid, dim3(kTile, kTileRows), 0, st>>>(p, m, tiles_b,
                                                              tiles);
  } else {
    row_grid(m.n, m.batch, planes, &grid, &block);
    restride_rows<T><<<grid, block, 0, st>>>(p, m);
  }
  return int(cudaGetLastError());
}

bool valid(int width, const float* second, Map m) {
  return (width == 2 ? second == nullptr : width == 1) && m.o >= 0 &&
         m.s >= 1 && m.dist >= 1 && m.n >= 1 && m.batch >= 1;
}

}  // namespace

// x -> y, packed (batch, n).  width 2: one interleaved buffer of float2
// elements (x0, y0); width 1: float planes, x1/y1 the second plane or null.
// Returns a cudaError_t.
extern "C" int pf_destride(const float* x0, const float* x1, float* y0,
                           float* y1, int width, int64_t o, int64_t s,
                           int64_t dist, int64_t n, int64_t batch,
                           void* stream) {
  const Map m{o, s, dist, n, batch};
  if (!valid(width, x1, m)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width == 2) {
    Planes<float2> p{{reinterpret_cast<const float2*>(x0), nullptr},
                     {reinterpret_cast<float2*>(y0), nullptr}};
    return destride_launch(p, 1, m, st);
  }
  Planes<float> p{{x0, x1}, {y0, y1}};
  return destride_launch(p, x1 ? 2 : 1, m, st);
}

// y, packed (batch, n) -> out at the layout's addresses; out holds out_len
// elements.  fill_gaps != 0 writes 0 to every other element of out.
// Returns a cudaError_t.
extern "C" int pf_restride(const float* y0, const float* y1, float* out0,
                           float* out1, int width, int64_t o, int64_t s,
                           int64_t dist, int64_t n, int64_t batch,
                           int64_t out_len, int fill_gaps, void* stream) {
  const Map m{o, s, dist, n, batch};
  if (!valid(width, y1, m) || out_len < o + (batch - 1) * dist + (n - 1) * s + 1) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width == 2) {
    Planes<float2> p{{reinterpret_cast<const float2*>(y0), nullptr},
                     {reinterpret_cast<float2*>(out0), nullptr}};
    return restride_launch(p, 1, m, out_len, fill_gaps != 0, st);
  }
  Planes<float> p{{y0, y1}, {out0, out1}};
  return restride_launch(p, y1 ? 2 : 1, m, out_len, fill_gaps != 0, st);
}
