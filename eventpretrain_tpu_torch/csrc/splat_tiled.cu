// K6 — tiled splat: (B, C, E) f32 weights of tile-bucketed events summed at
// integer (y, x) into a (B, H, W, C) f32 grid.
//
// Replaces eventpretrain_tpu/ops/pallas_voxel.py::splat_mxu_tiled (and
// voxelize_batch_mxu_tiled, whose bin weights the Python wrapper computes).
// The host bucketer (native/__init__.py) groups the events by 128x128 tile:
// each chunk of `chunk` slots belongs to one tile, the chunk table is
// nondecreasing, and pads carry out-of-frame sentinels. The TPU kernel
// turns each chunk into one-hot matrix products into its tile's block,
// carrying the weights as a bf16 hi+lo pair; that is the TPU's way around
// having no scatter unit, not part of the function.
//
// Here one block owns one (sample, tile, bin) plane: it zeroes the tile's
// tile_h x tile_w f32 plane in shared memory (64 KB at 128x128), finds its
// tile's chunks in the nondecreasing table by binary search, skips the
// chunks whose bin range excludes its bin, adds each in-tile event's
// weight with a shared-memory atomicAdd, and writes the plane once,
// cropped to H x W. So the output needs no zero-fill and no global atomic,
// and an event outside its chunk's tile, or past row H or column W, adds
// nothing, as in the TPU kernel. The sums are exact f32 up to the order of
// the additions, which varies from run to run.
//
// What bounds it: the bytes. The grid's bins of one tile are adjacent
// blocks, so a tile's coordinates are read from device memory about once
// and from L2 by the other bins; each weight is read once, each output
// cell written once (stride C apart: one block writes one channel).
#include "common.cuh"

__global__ void splat_tiled_kernel(const int* __restrict__ y,
                                   const int* __restrict__ x,
                                   const float* __restrict__ w,
                                   const int* __restrict__ table,
                                   const int* __restrict__ bin_range,
                                   float* __restrict__ out, int C, int E,
                                   int n_chunks, int chunk, int H, int W,
                                   int tile_h, int tile_w, int tiles_x) {
  extern __shared__ float plane[];
  const int c = blockIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int cells = tile_h * tile_w;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) plane[i] = 0.0f;

  // the chunks of tile t: [first with table >= t, first with table > t)
  const int* tab = table + static_cast<long long>(b) * n_chunks;
  int lo = 0, hi = n_chunks;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tab[mid] < t) lo = mid + 1; else hi = mid;
  }
  const int j0 = lo;
  hi = n_chunks;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tab[mid] <= t) lo = mid + 1; else hi = mid;
  }
  const int j1 = lo;
  __syncthreads();

  const int ty0 = (t / tiles_x) * tile_h;
  const int tx0 = (t % tiles_x) * tile_w;
  const int ylim = min(tile_h, H - ty0);  // rows past H are cropped
  const int xlim = min(tile_w, W - tx0);
  const long long base = static_cast<long long>(b) * E;
  const float* wc = w + (static_cast<long long>(b) * C + c) * E;
  for (int j = j0; j < j1; ++j) {
    if (bin_range != nullptr) {
      const int* br = bin_range + (static_cast<long long>(b) * n_chunks + j) * 2;
      if (c < br[0] || c > br[1]) continue;  // uniform across the block
    }
    for (int k = threadIdx.x; k < chunk; k += blockDim.x) {
      const long long e = static_cast<long long>(j) * chunk + k;
      const int ly = y[base + e] - ty0;
      const int lx = x[base + e] - tx0;
      if (ly < 0 || ly >= ylim || lx < 0 || lx >= xlim) continue;
      const float v = wc[e];
      if (v != 0.0f) atomicAdd(plane + ly * tile_w + lx, v);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < ylim * xlim; i += blockDim.x) {
    const int ly = i / xlim;
    const int lx = i - ly * xlim;
    out[((static_cast<long long>(b) * H + ty0 + ly) * W + tx0 + lx) * C + c] =
        plane[ly * tile_w + lx];
  }
}

extern "C" int splat_tiled_f32(const void* y, const void* x, const void* w,
                               const void* table, const void* bin_range,
                               void* out, int B, int C, int E, int chunk,
                               int H, int W, int tile_h, int tile_w,
                               void* stream) {
  if (B == 0 || C == 0 || H == 0 || W == 0) return 0;
  const int tiles_y = (H + tile_h - 1) / tile_h;
  const int tiles_x = (W + tile_w - 1) / tile_w;
  const int smem = tile_h * tile_w * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      splat_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(C, tiles_y * tiles_x, B);
  splat_tiled_kernel<<<grid, 512, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(y), static_cast<const int*>(x),
      static_cast<const float*>(w), static_cast<const int*>(table),
      static_cast<const int*>(bin_range), static_cast<float*>(out), C, E,
      E / chunk, chunk, H, W, tile_h, tile_w, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
