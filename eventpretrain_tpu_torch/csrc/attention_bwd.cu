// The attention core of K1's and K4's backward: per (sample, head), from
// the packed qkv rows and the head outputs' gradient do, the gradients dq,
// dk, dv.
//
// Replaces the per-head loop of eventpretrain_tpu/ops/fused_attn_layer.py::
// _layer_bwd (:138-164), with its rounding points:
//
//   p  = softmax(q k^T * scale)                     (recomputed, f32)
//   dv = bf16(p)^T . do                             (f32 sum, rounded)
//   dp = do . v^T                                   (f32)
//   ds = bf16(p * (dp - rowsum(dp * p)) * scale)
//   dq = ds . k,  dk = ds^T . q                     (f32 sums, rounded)
//
// One block per (sample, head) stages that head's q, k, v and do (L x D
// bf16) in dynamic shared memory, rows padded to D + 2 elements: the row
// stride is then an odd number of 32-bit words, so a warp whose lanes read
// 32 different rows hits 32 different banks. The (L, L) matrices p, dp and
// ds are never formed (at L=196 one bf16 copy of p and ds takes 154 KB, and
// at D=64 with q, k, v, do beside them that is past the 227 KB a block may
// use). Instead the kernel makes two passes:
//
//   rows     a warp per query row i, a lane per key: the row's scores,
//            softmax statistics (max, sum) and D_i = rowsum(dp * p) stay in
//            registers and shared memory; the rounded ds row goes to a
//            per-warp buffer, and dq_i = ds_i . K is summed in key order.
//   columns  a warp per key j, a lane per query in chunks of 32: p_ij and
//            ds_ij are recomputed from the saved statistics with the same
//            code (so bit for bit the values of the row pass), then a lane
//            per feature d sums dv_j and dk_j over the queries in order.
//
// No atomics: every sum has a fixed order, so the result is the same on
// every run. Shared memory is 4 * L * (D + 2) * 2 + 4 * (3 * L + 8 *
// max(L, 64)) bytes (112 KB at L=196, D=64); the wrapper gates shapes above
// the 227 KB a block may use. The products run on the CUDA cores in f32 (no
// tensor cores yet), about 7 * L * L * D multiply-adds per head, so this
// kernel is bound by the CUDA cores' FMA throughput.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxKeysPerLane = 8;  // L <= 256
constexpr int kMaxDPerLane = 8;     // D <= 256

// dot of two bf16 rows of length D (D even), in feature order. Both passes
// call it with the same operands in the same order, so a score computed in
// the row pass and recomputed in the column pass agree bit for bit.
__device__ __forceinline__ float dot_row(const bf16* a, const bf16* b, int D) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(b);
  float acc = 0.0f;
  for (int d = 0; d < D / 2; ++d) {
    const float2 x = __bfloat1622float2(a2[d]);
    const float2 y = __bfloat1622float2(b2[d]);
    acc = __fmaf_rn(x.x, y.x, acc);
    acc = __fmaf_rn(x.y, y.y, acc);
  }
  return acc;
}

__device__ __forceinline__ float ds_value(float p, float dp, float dd,
                                          float scale) {
  return round_bf16(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, dd)), scale));
}

__global__ void __launch_bounds__(kWarps * 32)
    attention_bwd_kernel(const bf16* __restrict__ qkv,
                         const bf16* __restrict__ dout,
                         bf16* __restrict__ dqkv, int L, int H, int D,
                         float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = D + 2;  // padded row stride (elements)
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + L * S;
  bf16* sv = sk + L * S;
  bf16* sdo = sv + L * S;
  float* s_max = reinterpret_cast<float*>(sdo + L * S);
  float* s_sum = s_max + L;
  float* s_dd = s_sum + L;
  float* sbuf = s_dd + L;  // [kWarps][max(L, 64)]
  const int buf = L > 64 ? L : 64;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int C = H * D;
  const bf16* base = qkv + (long long)b * L * 3 * C + h * D;
  const bf16* dbase = dout + (long long)b * L * C + h * D;

  const int chunks = D / 8;
  for (int c = threadIdx.x; c < L * chunks; c += blockDim.x) {
    const int j = c / chunks;
    const int d0 = (c % chunks) * 8;
    const bf16* row = base + (long long)j * 3 * C + d0;
    const uint4 src[4] = {
        *reinterpret_cast<const uint4*>(row),
        *reinterpret_cast<const uint4*>(row + C),
        *reinterpret_cast<const uint4*>(row + 2 * C),
        *reinterpret_cast<const uint4*>(dbase + (long long)j * C + d0),
    };
    bf16* dst[4] = {sq, sk, sv, sdo};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const unsigned int* w = reinterpret_cast<const unsigned int*>(&src[m]);
      unsigned int* o = reinterpret_cast<unsigned int*>(dst[m] + j * S + d0);
#pragma unroll
      for (int t = 0; t < 4; ++t) o[t] = w[t];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  bf16* drow_base = dqkv + (long long)b * L * 3 * C + h * D;

  // ---- row pass: softmax statistics, D_i, ds rows and dq
  float* dsrow = sbuf + warp * buf;
  for (int i = warp; i < L; i += kWarps) {
    const bf16* qi = sq + i * S;
    const bf16* doi = sdo + i * S;
    float p[kMaxKeysPerLane], dp[kMaxKeysPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      p[t] = 0.0f;
      if (j < L) {
        p[t] = __fmul_rn(dot_row(qi, sk + j * S, D), scale);
        mx = fmaxf(mx, p[t]);
      }
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      if (lane + 32 * t < L) {
        p[t] = expf(__fsub_rn(p[t], mx));
        sum += p[t];
      }
    }
    sum = warp_sum(sum);
    float dd = 0.0f;
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      dp[t] = 0.0f;
      if (j < L) {
        p[t] = __fdiv_rn(p[t], sum);
        dp[t] = dot_row(doi, sv + j * S, D);
        dd += dp[t] * p[t];
      }
    }
    dd = warp_sum(dd);
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < L) dsrow[j] = ds_value(p[t], dp[t], dd, scale);
    }
    if (lane == 0) {
      s_max[i] = mx;
      s_sum[i] = sum;
      s_dd[i] = dd;
    }
    __syncwarp();
    bf16* dq = drow_base + (long long)i * 3 * C;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < L; ++j) {
        acc = fmaf(dsrow[j], __bfloat162float(sk[j * S + d]), acc);
      }
      dq[d] = __float2bfloat16(acc);
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- column pass: dv and dk, summed over the queries in order
  float* pbuf = sbuf + warp * buf;  // [32] rounded p, then [32] ds
  float* dsbuf = pbuf + 32;
  for (int j = warp; j < L; j += kWarps) {
    const bf16* kj = sk + j * S;
    const bf16* vj = sv + j * S;
    float dv[kMaxDPerLane], dk[kMaxDPerLane];
#pragma unroll
    for (int u = 0; u < kMaxDPerLane; ++u) dv[u] = dk[u] = 0.0f;
    for (int i0 = 0; i0 < L; i0 += 32) {
      const int i = i0 + lane;
      if (i < L) {
        const float s = __fmul_rn(dot_row(sq + i * S, kj, D), scale);
        const float pij = __fdiv_rn(expf(__fsub_rn(s, s_max[i])), s_sum[i]);
        const float dpij = dot_row(sdo + i * S, vj, D);
        pbuf[lane] = round_bf16(pij);
        dsbuf[lane] = ds_value(pij, dpij, s_dd[i], scale);
      }
      __syncwarp();
      const int n = min(32, L - i0);
      for (int ii = 0; ii < n; ++ii) {
        const int row = i0 + ii;
        const float pv = pbuf[ii];
        const float dsv = dsbuf[ii];
#pragma unroll
        for (int u = 0; u < kMaxDPerLane; ++u) {
          const int d = lane + 32 * u;
          if (d < D) {
            dv[u] = fmaf(pv, __bfloat162float(sdo[row * S + d]), dv[u]);
            dk[u] = fmaf(dsv, __bfloat162float(sq[row * S + d]), dk[u]);
          }
        }
      }
      __syncwarp();
    }
    bf16* dkrow = drow_base + (long long)j * 3 * C + C;
#pragma unroll
    for (int u = 0; u < kMaxDPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < D) {
        dkrow[d] = __float2bfloat16(dk[u]);
        dkrow[C + d] = __float2bfloat16(dv[u]);
      }
    }
  }
}

}  // namespace

extern "C" long long attention_bwd_smem_bytes(int L, int D) {
  const long long buf = L > 64 ? L : 64;
  return 4LL * L * (D + 2) * 2 + 4LL * (3LL * L + kWarps * buf);
}

// qkv (B, L, 3*H*D) bf16 packed [q | k | v] with head h at columns h*D;
// dout (B, L, H*D) bf16 the gradient of the concatenated head outputs;
// dqkv (B, L, 3*H*D) bf16 in the same packing. Requires L <= 256,
// D % 8 == 0, D <= 256 (the wrapper checks).
extern "C" int attention_bwd_bf16(const void* qkv, const void* dout,
                                  void* dqkv, int B, int L, int H, int D,
                                  float scale, void* stream) {
  if (B == 0) return 0;
  const int smem = static_cast<int>(attention_bwd_smem_bytes(L, D));
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_kernel<<<B * H, kWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dqkv), L, H, D, scale);
  return static_cast<int>(cudaGetLastError());
}
