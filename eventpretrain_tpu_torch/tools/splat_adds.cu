// Throughput of the adds a splat can use, on one card: shared f32 atomics
// (atomicAdd and red.shared), shared int atomics, f32 red into the other
// CTA of a 2-CTA cluster (distributed shared memory), global f32 atomics
// into a 21 MB grid (K3's grid at B=64, it stays in the 50 MB L2) and into
// a 90 MB one (K8's at DSEC's shape, B=16: most adds miss L2), and the
// vector reductions red.global.add.v2.f32 / .v4.f32 (sm_90, PTX 8.1) into
// both. 132 CTAs of 512 threads, each thread 2000 adds (or vector
// reductions, each counted once) at hashed, aligned addresses.
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
    if (MODE == 5) asm volatile("red.global.add.f32 [%0], %1;" ::"l"(g + (h % gcells)), "f"(v) : "memory");
    if (MODE == 6) asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(g + 2 * (h % (gcells / 2))), "f"(v), "f"(v) : "memory");
    if (MODE == 7) asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(g + 4 * (h % (gcells / 4))), "f"(0.f), "f"(v), "f"(v), "f"(0.f) : "memory");
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
  // K3's grid at B=64 (21 MB) and K8's at DSEC's shape (90 MB)
  const int small = 64 * 128 * 128 * 5, big = 16 * 440 * 640 * 5;
  const int blocks = 132, iters = 2000;
  float* g; cudaMalloc(&g, big * 4ll); cudaMemset(g, 0, big * 4ll);
  const double ops = double(blocks) * 512 * iters;
  struct Row { const char* name; float ms; };
  const Row rows[] = {
      {"shared atomicAdd f32", run<0>(g, iters, small, blocks)},
      {"red.shared f32", run<1>(g, iters, small, blocks)},
      {"shared atomicAdd int", run<2>(g, iters, small, blocks)},
      {"red.shared::cluster f32 (other CTA)", run<3>(g, iters, small, blocks)},
      {"global atomicAdd f32 (21 MB)", run<4>(g, iters, small, blocks)},
      {"global atomicAdd f32 (90 MB)", run<4>(g, iters, big, blocks)},
      {"red.global.add.f32 (21 MB)", run<5>(g, iters, small, blocks)},
      {"red.global.add.f32 (90 MB)", run<5>(g, iters, big, blocks)},
      {"red.global.add.v2.f32 (21 MB)", run<6>(g, iters, small, blocks)},
      {"red.global.add.v4.f32 (21 MB)", run<7>(g, iters, small, blocks)},
      {"red.global.add.v2.f32 (90 MB)", run<6>(g, iters, big, blocks)},
      {"red.global.add.v4.f32 (90 MB)", run<7>(g, iters, big, blocks)},
  };
  for (const Row& r : rows) printf("%-40s %8.3f ms  %8.2f G ops/s  (%.2f per SM per ns)\n", r.name, r.ms, ops / (r.ms * 1e6), ops / (r.ms * 1e6) / 132);
  return 0;
}
