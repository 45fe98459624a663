// The GEMM under the port's K1 and K2 sub-block kernels:
//
//     out[M, N] = epilogue(prologue(A)[M, K] . W[N, K]^T + bias[N])
//
// bf16 operands, f32 accumulation on the tensor cores (WMMA 16x16x16 tiles),
// W row-major (N, K) so the (out, in) torch weights are used as they are.
//
// * Prologue (use_ln): LayerNorm of each A row, with the numerics of the TPU
//   kernels' ln_forward (eventpretrain_tpu/ops/pallas_common.py:68-78): f32
//   statistics with var = E[x^2] - mean^2, xhat * gamma + beta in f32, the
//   normalised row rounded to bf16 as it is staged into shared memory.
// * Epilogue, in f32 on the accumulator, rounded to bf16 once at the end:
//     0  bias                 (qkv projection, fused_attn_layer.py:106-107)
//     1  bias + GELU          (fc1, fused_mlp.py:262-264). The TPU kernel
//        approximates erf with Abramowitz-Stegun 7.1.26 (|err| < 1.5e-7,
//        fused_mlp.py:81-92); this uses CUDA's erff, i.e. the exact GELU.
//     2  bias + f32 residual  (out projection / fc2 plus the skip,
//        fused_attn_layer.py:111-112,324 and fused_mlp.py:265-267)
//
// Why not the TPU design: the Pallas kernels keep whole weight matrices
// resident in VMEM; at C=384 Wqkv alone is 884 KB, four times the 227 KB of
// shared memory a Hopper block may use. So each sub-block is split into a
// few launches and this GEMM streams 64x32 tiles of A and W through shared
// memory. Its bound on the card is the tensor-core rate of a simple
// synchronous-load WMMA loop (no TMA, no wgmma, no pipelining yet); the LN
// statistics are recomputed by every column block of a row tile (reads
// served from L2).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int PAD = 8;  // bf16 elements of row padding: keeps WMMA ldm % 8
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v / 1.4142135623730951f));
}

template <bool kLn>
__global__ void __launch_bounds__(THREADS)
    ln_gemm_kernel(const bf16* __restrict__ a, const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b, float eps,
                   const bf16* __restrict__ w, const bf16* __restrict__ bias,
                   const bf16* __restrict__ residual, bf16* __restrict__ out,
                   int M, int N, int K, int epilogue) {
  __shared__ __align__(32) bf16 sa[BM][BK + PAD];
  __shared__ __align__(32) bf16 sw[BN][BK + PAD];
  __shared__ __align__(32) float sc[BM][BN + 4];
  __shared__ float s_mu[BM];
  __shared__ float s_rstd[BM];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (kLn) {
    for (int r = warp; r < BM; r += WARPS) {
      const int m = m0 + r;
      float s = 0.0f, ss = 0.0f;
      if (m < M) {
        const __nv_bfloat162* row =
            reinterpret_cast<const __nv_bfloat162*>(a + (long long)m * K);
        for (int k2 = lane; k2 < K / 2; k2 += 32) {
          const float2 v = __bfloat1622float2(row[k2]);
          s += v.x + v.y;
          ss += v.x * v.x + v.y * v.y;
        }
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      if (lane == 0) {
        const float mu = s / K;
        const float var = ss / K - mu * mu;
        s_mu[r] = mu;
        s_rstd[r] = rsqrtf(var + eps);
      }
    }
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8);
      const int kc = (c % (BK / 8)) * 8;
      const int m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) {
        v = *reinterpret_cast<const uint4*>(a + (long long)m * K + k0 + kc);
        if (kLn) {
          bf16* e = reinterpret_cast<bf16*>(&v);
          const float mu = s_mu[r];
          const float rs = s_rstd[r];
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int k = k0 + kc + t;
            const float xhat = (__bfloat162float(e[t]) - mu) * rs;
            e[t] = __float2bfloat16(xhat * ln_w[k] + ln_b[k]);
          }
        }
      }
      *reinterpret_cast<uint4*>(&sa[r][kc]) = v;
    }
    for (int c = tid; c < BN * BK / 8; c += THREADS) {
      const int r = c / (BK / 8);
      const int kc = (c % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(&sw[r][kc]) = *reinterpret_cast<const uint4*>(
          w + (long long)(n0 + r) * K + k0 + kc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sa[wm + i * 16][kk], BK + PAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sw[wn + j * 16][kk], BK + PAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&sc[wm + i * 16][wn + j * 16], acc[i][j],
                              BN + 4, wmma::mem_row_major);
  __syncthreads();

  for (int c = tid; c < BM * BN; c += THREADS) {
    const int r = c / BN;
    const int col = c % BN;
    const int m = m0 + r;
    if (m >= M) continue;
    const int n = n0 + col;
    float v = sc[r][col] + __bfloat162float(bias[n]);
    if (epilogue == kBiasGelu) {
      v = gelu_erf(v);
    } else if (epilogue == kBiasResidual) {
      v = __bfloat162float(residual[(long long)m * N + n]) + v;
    }
    out[(long long)m * N + n] = __float2bfloat16(v);
  }
}

}  // namespace

// a (M, K), w (N, K), bias (N,), residual and out (M, N): bf16, row-major,
// 16-byte aligned. ln_w, ln_b (K,) f32, read only when use_ln. Requires
// K % 32 == 0, N % 64 == 0 (the wrapper checks); M is ragged.
extern "C" int ln_gemm_bf16(const void* a, const void* ln_w, const void* ln_b,
                            float eps, int use_ln, const void* w,
                            const void* bias, const void* residual, void* out,
                            int M, int N, int K, int epilogue, void* stream) {
  if (M == 0) return 0;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* pa = static_cast<const bf16*>(a);
  const float* pg = static_cast<const float*>(ln_w);
  const float* pb = static_cast<const float*>(ln_b);
  const bf16* pw = static_cast<const bf16*>(w);
  const bf16* pbias = static_cast<const bf16*>(bias);
  const bf16* pres = static_cast<const bf16*>(residual);
  bf16* pout = static_cast<bf16*>(out);
  if (use_ln) {
    ln_gemm_kernel<true><<<grid, THREADS, 0, s>>>(
        pa, pg, pb, eps, pw, pbias, pres, pout, M, N, K, epilogue);
  } else {
    ln_gemm_kernel<false><<<grid, THREADS, 0, s>>>(
        pa, pg, pb, eps, pw, pbias, pres, pout, M, N, K, epilogue);
  }
  return static_cast<int>(cudaGetLastError());
}
