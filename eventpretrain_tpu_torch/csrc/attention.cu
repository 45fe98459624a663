// The attention core of K1 and K4: per (sample, head),
// softmax(q k^T * scale) v over packed qkv rows.
//
// Replaces the per-head loop inside eventpretrain_tpu/ops/
// fused_attn_layer.py::_attention_heads (:73-100), with its rounding points:
// f32 scores, f32 softmax (max-subtracted exp, divided by the row sum), p
// rounded to bf16 before p.v, p.v accumulated in f32 and rounded to bf16.
//
// One block per (sample, head) stages that head's q, k^T and v (L x D bf16)
// in dynamic shared memory. The f32 score matrix of a head does not fit (at
// L=196 it is 150 KB), so it is never formed: each warp streams one query
// row at a time, keeping the row's scores in registers (lane j holds keys
// j, j+32, ...; L <= 256 gives at most 8 per lane) and only the bf16-rounded
// probabilities of its current row in shared memory for the p.v product.
// Shared memory is 3*L*D*2 + 8*L*4 bytes (45.5 KB at L=196, D=32); the
// wrapper refuses shapes above the 227 KB a block may use. The products run
// on the CUDA cores in f32 (no tensor cores yet): this kernel is bound by
// FMA issue rate, about 4*L*L*D flops per head.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxKeysPerLane = 8;  // L <= 256

__global__ void __launch_bounds__(kWarps * 32)
    attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     int L, int H, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [L][D]
  bf16* skt = sq + L * D;                    // [D][L]
  bf16* sv = skt + D * L;                    // [L][D]
  float* sp = reinterpret_cast<float*>(sv + L * D);  // [kWarps][L]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int C = H * D;
  const bf16* base = qkv + (long long)b * L * 3 * C + h * D;

  const int chunks = D / 8;
  for (int c = threadIdx.x; c < L * chunks; c += blockDim.x) {
    const int j = c / chunks;
    const int d0 = (c % chunks) * 8;
    const bf16* row = base + (long long)j * 3 * C + d0;
    const uint4 q = *reinterpret_cast<const uint4*>(row);
    const uint4 k = *reinterpret_cast<const uint4*>(row + C);
    const uint4 v = *reinterpret_cast<const uint4*>(row + 2 * C);
    *reinterpret_cast<uint4*>(sq + j * D + d0) = q;
    *reinterpret_cast<uint4*>(sv + j * D + d0) = v;
    const bf16* ke = reinterpret_cast<const bf16*>(&k);
#pragma unroll
    for (int t = 0; t < 8; ++t) skt[(d0 + t) * L + j] = ke[t];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = sp + warp * L;
  for (int i = warp; i < L; i += kWarps) {
    const bf16* qi = sq + i * D;
    float s[kMaxKeysPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      float acc = 0.0f;
      if (j < L) {
        for (int d = 0; d < D; ++d) {
          acc += __bfloat162float(qi[d]) * __bfloat162float(skt[d * L + j]);
        }
        acc *= scale;
        mx = fmaxf(mx, acc);
      }
      s[t] = acc;
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      if (lane + 32 * t < L) {
        s[t] = expf(s[t] - mx);
        sum += s[t];
      }
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < L) p[j] = __bfloat162float(__float2bfloat16(s[t] / sum));
    }
    __syncwarp();
    bf16* orow = out + ((long long)b * L + i) * C + h * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < L; ++j) acc += p[j] * __bfloat162float(sv[j * D + d]);
      orow[d] = __float2bfloat16(acc);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" long long attention_smem_bytes(int L, int D) {
  return 3LL * L * D * 2 + (long long)kWarps * L * 4;
}

// qkv (B, L, 3*H*D) bf16 packed [q | k | v] with head h at columns h*D;
// out (B, L, H*D) bf16. Requires L <= 256 and D % 8 == 0 (wrapper checks).
extern "C" int attention_bf16(const void* qkv, void* out, int B, int L, int H,
                              int D, float scale, void* stream) {
  if (B == 0) return 0;
  const int smem = static_cast<int>(attention_smem_bytes(L, D));
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_kernel<<<B * H, kWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), L, H, D, scale);
  return static_cast<int>(cudaGetLastError());
}
