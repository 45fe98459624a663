// The GEMM under the port's K1/K2 sub-block kernels and their bare K4/K5
// twins (no LayerNorm prologue, no residual), forward and backward:
//
//     out[M, N] = epilogue(prologue(A)[M, K] . B[K, N] + bias[N])
//
// bf16 operands, f32 accumulation on the tensor cores (WMMA 16x16x16 tiles).
// Three operand layouts, one template:
//
//   forward  A (M, K) row-major, B given as W (N, K) row-major, i.e. A . W^T
//            (the (out, in) torch weights as they are);
//   dgrad    A (M, K) row-major, B given as W (K, N) row-major, i.e. dY . W
//            (the input gradient through a Linear: the WMMA matrix_b
//            layout flag flips from col_major to row_major);
//   wgrad    A given as dY (K, M) row-major and B as X (K, N) row-major,
//            i.e. dW = dY^T . X, the weight gradient reduced over the K
//            tokens in f32 by one block per output tile, in token order
//            (deterministic; no atomics, no split-K). K may be ragged: rows
//            past it are zero-filled.
//
// * Prologue (use_ln, forward layout only): LayerNorm of each A row, with
//   the numerics of the TPU kernels' ln_forward
//   (eventpretrain_tpu/ops/pallas_common.py:68-78, common.cuh ln_row_stats),
//   the normalised row rounded to bf16 as it is staged into shared memory.
// * Epilogue, in f32 on the accumulator (bias optional: a null pointer adds
//   nothing):
//     0  bias, rounded                 (qkv, K4/K5's proj and fc2,
//                                       do = dy.Wo, dW, K4/K5's dx)
//     1  bias + GELU, rounded          (fc1, fused_mlp.py:262-264)
//     2  bias + bf16 residual, rounded (proj / fc2 plus the skip)
//     3  bias, f32 out, no rounding    (d_yln = dqkv.Wqkv, fused_attn_layer
//        .py:170-173; h_pre, fused_mlp.py:295-297); with out2 it also
//        writes round(GELU(v)), the forward's h, from the same accumulator
//     4  x gelu'(aux[m, n]), rounded   (dh_pre = dh * gelu'(h_pre),
//        fused_mlp.py:307), aux the f32 h_pre
//
// Why not the TPU design: the Pallas kernels keep whole weight matrices
// resident in VMEM; at C=384 Wqkv alone is 884 KB, four times the 227 KB of
// shared memory a Hopper block may use, and their backward carries f32 dW
// accumulators across the sequential batch grid, which Hopper's unordered
// blocks cannot do. So each sub-block is split into a few launches and this
// GEMM streams 64x32 tiles of A and B through shared memory; the weight
// gradient gets its own launch whose blocks each own one output tile. Its
// bound on the card is the tensor-core rate of a simple synchronous-load
// WMMA loop (no TMA, no wgmma, no pipelining yet); the LN statistics are
// recomputed by every column block of a row tile (reads served from L2).
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int PAD = 8;  // bf16 elements of row padding: keeps WMMA ldm % 8
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// one buffer serves both staging layouts of an operand
constexpr int SA_ELEMS = BM * (BK + PAD) > BK * (BM + PAD) ? BM * (BK + PAD)
                                                           : BK * (BM + PAD);
constexpr int SB_ELEMS = BN * (BK + PAD) > BK * (BN + PAD) ? BN * (BK + PAD)
                                                           : BK * (BN + PAD);

enum Epilogue {
  kBias = 0,
  kBiasGelu = 1,
  kBiasResidual = 2,
  kF32 = 3,
  kDGelu = 4,
};

template <bool kLn, bool kATrans, bool kBKN>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(const bf16* __restrict__ a, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, float eps,
                const bf16* __restrict__ w, const bf16* __restrict__ bias,
                const bf16* __restrict__ residual,
                const float* __restrict__ aux, void* __restrict__ out,
                bf16* __restrict__ out2, int M, int N, int K, int epilogue) {
  __shared__ __align__(32) bf16 sa[SA_ELEMS];
  __shared__ __align__(32) bf16 sb[SB_ELEMS];
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
      float mu = 0.0f, rstd = 0.0f;
      if (m < M) {
        ln_row_stats(a + (long long)m * K, K, eps, lane, &mu, &rstd);
      }
      if (lane == 0) {
        s_mu[r] = mu;
        s_rstd[r] = rstd;
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
    if (!kATrans) {
      // sa[BM][BK + PAD]: rows m, columns k
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
              e[t] = __float2bfloat16(
                  ln_apply(__bfloat162float(e[t]), mu, rs, ln_w[k], ln_b[k]));
            }
          }
        }
        *reinterpret_cast<uint4*>(&sa[r * (BK + PAD) + kc]) = v;
      }
    } else {
      // sa[BK][BM + PAD]: rows k (tokens), columns m; A stored (K, M)
      for (int c = tid; c < BK * BM / 8; c += THREADS) {
        const int kr = c / (BM / 8);
        const int mc = (c % (BM / 8)) * 8;
        const int k = k0 + kr;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k < K) {
          v = *reinterpret_cast<const uint4*>(a + (long long)k * M + m0 + mc);
        }
        *reinterpret_cast<uint4*>(&sa[kr * (BM + PAD) + mc]) = v;
      }
    }
    if (!kBKN) {
      // sb[BN][BK + PAD]: rows n, columns k; W stored (N, K)
      for (int c = tid; c < BN * BK / 8; c += THREADS) {
        const int r = c / (BK / 8);
        const int kc = (c % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(&sb[r * (BK + PAD) + kc]) =
            *reinterpret_cast<const uint4*>(w + (long long)(n0 + r) * K + k0 +
                                            kc);
      }
    } else {
      // sb[BK][BN + PAD]: rows k, columns n; B stored (K, N)
      for (int c = tid; c < BK * BN / 8; c += THREADS) {
        const int kr = c / (BN / 8);
        const int nc = (c % (BN / 8)) * 8;
        const int k = k0 + kr;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k < K) {
          v = *reinterpret_cast<const uint4*>(w + (long long)k * N + n0 + nc);
        }
        *reinterpret_cast<uint4*>(&sb[kr * (BN + PAD) + nc]) = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      typedef typename std::conditional<kATrans, wmma::col_major,
                                        wmma::row_major>::type LayoutA;
      typedef typename std::conditional<kBKN, wmma::row_major,
                                        wmma::col_major>::type LayoutB;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (kATrans) {
          wmma::load_matrix_sync(fa[i], &sa[kk * (BM + PAD) + wm + i * 16],
                                 BM + PAD);
        } else {
          wmma::load_matrix_sync(fa[i], &sa[(wm + i * 16) * (BK + PAD) + kk],
                                 BK + PAD);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (kBKN) {
          wmma::load_matrix_sync(fb[j], &sb[kk * (BN + PAD) + wn + j * 16],
                                 BN + PAD);
        } else {
          wmma::load_matrix_sync(fb[j], &sb[(wn + j * 16) * (BK + PAD) + kk],
                                 BK + PAD);
        }
      }
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
    const long long idx = (long long)m * N + n;
    float v = sc[r][col];
    if (bias != nullptr) v += __bfloat162float(bias[n]);
    if (epilogue == kF32) {
      static_cast<float*>(out)[idx] = v;
      if (out2 != nullptr) out2[idx] = __float2bfloat16(gelu_erf(v));
      continue;
    }
    if (epilogue == kBiasGelu) {
      v = gelu_erf(v);
    } else if (epilogue == kBiasResidual) {
      v = __bfloat162float(residual[idx]) + v;
    } else if (epilogue == kDGelu) {
      v = v * gelu_erf_grad(aux[idx]);
    }
    static_cast<bf16*>(out)[idx] = __float2bfloat16(v);
  }
}

}  // namespace

// out[M, N] = epilogue([LN](A) . B + bias). Layouts (see the top of the
// file): a_trans=0, b_kn=0 forward; a_trans=0, b_kn=1 dgrad; a_trans=1,
// b_kn=1 wgrad; use_ln only with the forward layout. All bf16 operands
// row-major and 16-byte aligned; ln_w, ln_b (K,) f32; aux (M, N) f32; out
// bf16, or f32 for epilogue 3; out2 (M, N) bf16 or null; bias (N,) or null.
// Requires N % 64 == 0, and K % 32 == 0 unless a_trans (the wrapper
// checks); with a_trans, M % 64 == 0 and K is ragged, otherwise M is.
extern "C" int gemm_bf16(const void* a, const void* ln_w, const void* ln_b,
                         float eps, int use_ln, int a_trans, int b_kn,
                         const void* w, const void* bias, const void* residual,
                         const void* aux, void* out, void* out2, int M, int N,
                         int K, int epilogue, void* stream) {
  if (M == 0) return 0;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* pa = static_cast<const bf16*>(a);
  const float* pg = static_cast<const float*>(ln_w);
  const float* pb = static_cast<const float*>(ln_b);
  const bf16* pw = static_cast<const bf16*>(w);
  const bf16* pbias = static_cast<const bf16*>(bias);
  const bf16* pres = static_cast<const bf16*>(residual);
  const float* paux = static_cast<const float*>(aux);
  bf16* pout2 = static_cast<bf16*>(out2);
  if (use_ln && !a_trans && !b_kn) {
    gemm_kernel<true, false, false><<<grid, THREADS, 0, s>>>(
        pa, pg, pb, eps, pw, pbias, pres, paux, out, pout2, M, N, K,
        epilogue);
  } else if (use_ln) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (!a_trans && !b_kn) {
    gemm_kernel<false, false, false><<<grid, THREADS, 0, s>>>(
        pa, pg, pb, eps, pw, pbias, pres, paux, out, pout2, M, N, K,
        epilogue);
  } else if (!a_trans && b_kn) {
    gemm_kernel<false, false, true><<<grid, THREADS, 0, s>>>(
        pa, pg, pb, eps, pw, pbias, pres, paux, out, pout2, M, N, K,
        epilogue);
  } else if (a_trans && b_kn) {
    gemm_kernel<false, true, true><<<grid, THREADS, 0, s>>>(
        pa, pg, pb, eps, pw, pbias, pres, paux, out, pout2, M, N, K,
        epilogue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
