// Throughput of the adds a splat can use, on one card: shared f32 atomics
// (atomicAdd and red.shared), shared int atomics, f32 red into the other
// CTA of a 2-CTA cluster (distributed shared memory), and global f32 atomics
// into a 21 MB grid (K3's grid at B=64). 132 CTAs of 512 threads, each
// thread 2000 adds at hashed addresses.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o build/splat_adds eventpretrain_tpu_torch/tools/splat_adds.cu
//   build/splat_adds
#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
constexpr int kCells = 40960;  // 160 KB of f32
__device__ __forceinline__ unsigned hashu(unsigned x) {
  x ^= x >> 16; x *= 0x7feb352d; x ^= x >> 15; x *= 0x846ca68b; x ^= x >> 16;
  return x;
}
template <int MODE>
__global__ void __cluster_dims__(2, 1, 1) bench(float* g, int iters, int gcells) {
  extern __shared__ float sm[];
  for (int i = threadIdx.x; i < kCells; i += blockDim.x) sm[i] = 0.f;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(sm));
  unsigned other;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(other) : "r"(base), "r"((int)(cl.block_rank() ^ 1)));
  unsigned h = hashu(blockIdx.x * blockDim.x + threadIdx.x + 1);
  for (int it = 0; it < iters; ++it) {
    h = hashu(h);
    const unsigned c = h % kCells;
    const float v = (h & 255) * 1e-3f;
    if (MODE == 0) atomicAdd(sm + c, v);
    if (MODE == 1) asm volatile("red.shared.add.f32 [%0], %1;" ::"r"(base + 4 * c), "f"(v) : "memory");
    if (MODE == 2) atomicAdd(reinterpret_cast<int*>(sm) + c, 1);
    if (MODE == 3) asm volatile("red.shared::cluster.add.f32 [%0], %1;" ::"r"(other + 4 * c), "f"(v) : "memory");
    if (MODE == 4) atomicAdd(g + (h % gcells), v);
  }
  cl.sync();
  if (threadIdx.x == 0) g[blockIdx.x] += sm[0];
}
template <int MODE>
float run(float* g, int iters, int gcells, int blocks) {
  auto k = bench<MODE>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kCells * 4);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  k<<<blocks, 512, kCells * 4>>>(g, iters, gcells);
  cudaEventRecord(a);
  k<<<blocks, 512, kCells * 4>>>(g, iters, gcells);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  cudaError_t e = cudaGetLastError();
  if (e) printf("error %s\n", cudaGetErrorString(e));
  return ms;
}
int main() {
  const int gcells = 64 * 128 * 128 * 5, blocks = 132, iters = 2000;
  float* g; cudaMalloc(&g, gcells * 4); cudaMemset(g, 0, gcells * 4);
  const double ops = double(blocks) * 512 * iters;
  const char* names[] = {"shared atomicAdd f32", "red.shared f32", "shared atomicAdd int", "red.shared::cluster f32 (other CTA)", "global atomicAdd f32 (21 MB)"};
  float t[5] = {run<0>(g, iters, gcells, blocks), run<1>(g, iters, gcells, blocks), run<2>(g, iters, gcells, blocks), run<3>(g, iters, gcells, blocks), run<4>(g, iters, gcells, blocks)};
  for (int i = 0; i < 5; ++i) printf("%-40s %8.3f ms  %8.2f G adds/s  (%.2f per SM per ns)\n", names[i], t[i], ops / (t[i] * 1e6), ops / (t[i] * 1e6) / 132);
  return 0;
}
