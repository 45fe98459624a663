// The attention core of K1's and K4's backward: per (sample, head), from
// the packed qkv rows and the head outputs' gradient do, the gradients dq,
// dk, dv, on the tensor cores.
//
// Replaces the per-head loop of eventpretrain_tpu/ops/fused_attn_layer.py::
// _layer_bwd (:142-164), with its rounding points:
//
//   p  = softmax(q k^T * scale)                     (recomputed, f32)
//   dv = bf16(p)^T . do                             (f32 sum, rounded)
//   dp = do . v^T                                   (f32)
//   dd = rowsum(dp * p)                             (f32; not rowsum(do * o))
//   ds = bf16(p * (dp - dd) * scale)
//   dq = ds . k,  dk = ds^T . q                     (f32 sums, rounded)
//
// Every product is a bf16 mma.sync.m16n8k16; the scalar steps use expf and
// the _rn intrinsics, so nothing is contracted into an FMA that the plain
// version rounds in two steps. Two kernels, each a block of 4 warps on 64
// rows of one (sample, head), grid (row blocks, heads, samples):
//
//   dq    a warp owns 16 query rows and every key (L <= 256, so Lp / 2 f32
//         scores a thread). It computes s and p once, as the forward does,
//         then dp = do . v^T one 16-key step at a time, twice: once for dd,
//         once for ds, which it keeps in registers as bf16 A fragments; then
//         dq = ds . k, 64 columns at a time. It saves (max, sum, dd) of each
//         row in a (3, B, H, L) f32 scratch.
//   dk/dv a warp owns 16 keys and loops over the queries 16 at a time:
//         s^T = k . q^T and p from the saved statistics, dv += bf16(p)^T .
//         do; dp^T = v . do^T, ds^T, dk += ds^T . q; 64 output columns at a
//         time (s^T and dp^T are recomputed per 64 columns when D > 64).
//
// Each block stages its own 64 rows and the head's other operands (Lp rows,
// zero past L and past D) in shared memory with 16-byte cp.async straight
// from the packed rows; fragments come from ldmatrix (.trans where the
// operand is used as it is). Shared memory: 4 (64 + Lp)(Dp + 8) + 16 Lp
// bytes, Dp = D rounded up to 16 (47 KB at L = 196, D = 32). No sum crosses
// a warp: there are no atomics, every sum has a fixed order, and the result
// repeats bit for bit.
//
// p is computed as the forward computes it (mma.cuh softmax_rows in the dq
// kernel; the same expf and reciprocal-based exact division per query in
// the dk/dv kernel). What bounds it on this card: at the repo's shapes (L <=
// 196, D <= 64) a head is about 16 L^2 D multiply-adds on the tensor cores
// (dp twice and s in both kernels) and 2 L^2 exp and divisions, on 0.1 MB
// of operands, so the scalar softmax steps and latency take the time, not
// the tensor cores' rate or device memory.
#include <math.h>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query (dq) or key (dk/dv) rows a block
constexpr int kPad = 8;             // bf16 of padding per shared-memory row

__host__ __device__ constexpr int round16(int n) {
  return (n + 15) / 16 * 16;
}

// As attention.cu: rows [row0, row0 + nrows) of one head's D columns into
// dst[nrows][ld], zero past L and past D, as 16-byte cp.async.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src,
                                           long long stride, int row0,
                                           int nrows, int L, int D, int DP) {
  const int per_row = DP / 8;
  for (int i = threadIdx.x; i < nrows * per_row; i += kThreads) {
    const int r = i / per_row, c = i % per_row * 8;
    const int row = row0 + r;
    const bool ok = row < L && c < D;
    cp_async16(dst + r * ld + c, ok ? src + row * stride + c : src, ok);
  }
}

__device__ __forceinline__ float ds_value(float p, float dp, float dd,
                                          float scale) {
  return round_bf16(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, dd)), scale));
}

// acc (16 x 16, two n8 tiles) = X[m0:m0+16] . Y[n0:n0+16]^T over DP columns
__device__ __forceinline__ void product_nt16(float acc[2][4], const bf16* x,
                                             const bf16* y, int ld, int m0,
                                             int n0, int DP, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  for (int k0 = 0; k0 < DP; k0 += 16) {
    uint32_t a[4], bb[4];
    ldsm_a(a, x, ld, m0, k0, lane);
    ldsm_b_nk(bb, y, ld, n0, k0, lane);
    mma_bf16(acc[0], a, bb);
    mma_bf16(acc[1], a, bb + 2);
  }
}

// Store rows m0.. (16) and columns c0 + [0, nc) of f32 accumulators, rounded,
// into a packed row block (row stride `stride`), rows < L and columns < D.
__device__ __forceinline__ void store_tile(bf16* dst, long long stride,
                                           const float acc[8][4], int row0,
                                           int c0, int nc, int L, int D,
                                           int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c0 + 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (8 * j < nc && col < D && row < L) {
        *reinterpret_cast<uint32_t*>(dst + row * stride + col) =
            pack_f32(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

template <int KT>  // KT * 16 >= Lp: the score tiles a thread holds
__global__ void __launch_bounds__(kThreads)
    attention_dq_kernel(const bf16* __restrict__ qkv,
                        const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                        float* __restrict__ stats, int B, int L, int H, int D,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DP = round16(D), ld = DP + kPad;
  const int nkt = (L + 15) / 16, Lp = nkt * 16;
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [kRows][ld]
  bf16* sdo = sq + kRows * ld;               // [kRows][ld]
  bf16* sk = sdo + kRows * ld;               // [Lp][ld]
  bf16* sv = sk + Lp * ld;                   // [Lp][ld]

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const long long stride = 3LL * C;
  const long long row_b = static_cast<long long>(b) * L;
  const bf16* head = qkv + row_b * stride + h * D;
  stage_rows(sq, ld, head, stride, q0, kRows, L, D, DP);
  stage_rows(sk, ld, head + C, stride, 0, Lp, L, D, DP);
  cp_async_commit();
  stage_rows(sdo, ld, dout + row_b * C + h * D, C, q0, kRows, L, D, DP);
  stage_rows(sv, ld, head + 2 * C, stride, 0, Lp, L, D, DP);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const bool active = q0 + m0 < L;

  // s = q . k^T and p, as attention.cu computes them
  float p[2 * KT][4];
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = 0.0f;
  }
  float ms[2][2] = {};  // (max, sum) of rows g and g + 8
  if (active) {
    for (int k0 = 0; k0 < DP; k0 += 16) {
      uint32_t a[4];
      ldsm_a(a, sq, ld, m0, k0, lane);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        if (kt < nkt) {
          uint32_t bb[4];
          ldsm_b_nk(bb, sk, ld, kt * 16, k0, lane);
          mma_bf16(p[2 * kt], a, bb);
          mma_bf16(p[2 * kt + 1], a, bb + 2);
        }
      }
    }
    softmax_rows<KT>(p, nkt, L, t, scale, ms);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  // dd = rowsum(dp * p), dp = do . v^T one 16-key step at a time
  float dd[2] = {0.0f, 0.0f};
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt < nkt) {
      float dp[2][4];
      product_nt16(dp, sdo, sv, ld, m0, kt * 16, DP, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dd[e >> 1] = __fadd_rn(dd[e >> 1],
                                 __fmul_rn(dp[j][e], p[2 * kt + j][e]));
        }
      }
    }
  }
  dd[0] = quad_sum(dd[0]);
  dd[1] = quad_sum(dd[1]);

  // ds = bf16(p * (dp - dd) * scale), dp recomputed with the same
  // instructions, kept as the A fragments of ds . k
  uint32_t dsa[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt < nkt) {
      float dp[2][4];
      product_nt16(dp, sdo, sv, ld, m0, kt * 16, DP, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[j][e] = ds_value(p[2 * kt + j][e], dp[j][e], dd[e >> 1], scale);
        }
      }
      acc_to_a(dsa[kt], dp[0], dp[1]);
    }
  }

  // dq = ds . k, 64 columns at a time
  bf16* dq = dqkv + row_b * stride + h * D;
  for (int c0 = 0; c0 < DP; c0 += 64) {
    const int nc = min(64, DP - c0);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < nkt) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp * 16 < nc) {
            uint32_t bb[4];
            ldsm_b_kn(bb, sk, ld, kt * 16, c0 + jp * 16, lane);
            mma_bf16(acc[2 * jp], dsa[kt], bb);
            mma_bf16(acc[2 * jp + 1], dsa[kt], bb + 2);
          }
        }
      }
    }
    store_tile(dq, stride, acc, q0 + m0, c0, nc, L, D, g, t);
  }

  if (t == 0) {
    const long long bhl = static_cast<long long>(B) * H * L;
    const long long base = (static_cast<long long>(b) * H + h) * L;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + m0 + g + 8 * r;
      if (row < L) {
        stats[base + row] = ms[r][0];
        stats[bhl + base + row] = ms[r][1];
        stats[2 * bhl + base + row] = dd[r];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    attention_dkdv_kernel(const bf16* __restrict__ qkv,
                          const bf16* __restrict__ dout,
                          bf16* __restrict__ dqkv,
                          const float* __restrict__ stats, int B, int L,
                          int H, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DP = round16(D), ld = DP + kPad;
  const int Lp = round16(L);
  bf16* sk = reinterpret_cast<bf16*>(smem);  // [kRows][ld]
  bf16* sv = sk + kRows * ld;                // [kRows][ld]
  bf16* sq = sv + kRows * ld;                // [Lp][ld]
  bf16* sdo = sq + Lp * ld;                  // [Lp][ld]
  float* smx = reinterpret_cast<float*>(sdo + Lp * ld);  // [Lp]
  float* ssum = smx + Lp;
  float* sdd = ssum + Lp;
  float* srs = sdd + Lp;  // __frcp_rn of each row sum

  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const long long stride = 3LL * C;
  const long long row_b = static_cast<long long>(b) * L;
  const bf16* head = qkv + row_b * stride + h * D;
  stage_rows(sk, ld, head + C, stride, k0, kRows, L, D, DP);
  stage_rows(sv, ld, head + 2 * C, stride, k0, kRows, L, D, DP);
  stage_rows(sq, ld, head, stride, 0, Lp, L, D, DP);
  stage_rows(sdo, ld, dout + row_b * C + h * D, C, 0, Lp, L, D, DP);
  cp_async_commit();
  const long long bhl = static_cast<long long>(B) * H * L;
  const long long base = (static_cast<long long>(b) * H + h) * L;
  for (int i = threadIdx.x; i < Lp; i += kThreads) {
    const bool ok = i < L;
    smx[i] = ok ? stats[base + i] : 0.0f;
    ssum[i] = ok ? stats[bhl + base + i] : 1.0f;
    sdd[i] = ok ? stats[2 * bhl + base + i] : 0.0f;
    srs[i] = __frcp_rn(ssum[i]);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  if (k0 + m0 >= L) return;

  bf16* dk = dqkv + row_b * stride + C + h * D;
  for (int c0 = 0; c0 < DP; c0 += 64) {
    const int nc = min(64, DP - c0);
    float acc_k[8][4], acc_v[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.0f;
    }
    for (int i0 = 0; i0 < Lp; i0 += 16) {
      // rows are keys, columns the queries i0 + 8j + 2t + (e & 1)
      float st[2][4], dpt[2][4];
      product_nt16(st, sk, sq, ld, m0, i0, DP, lane);   // s^T = k . q^T
      product_nt16(dpt, sv, sdo, ld, m0, i0, DP, lane); // dp^T = v . do^T
      // p = exp(s * scale - max) / sum as the dq kernel computes it
      bool exact = true;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = i0 + 8 * j + 2 * t + (e & 1);
          st[j][e] = expf(__fsub_rn(__fmul_rn(st[j][e], scale), smx[c]));
          exact &= div_rcp_exact(st[j][e]);
        }
      }
      if (exact) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = i0 + 8 * j + 2 * t + (e & 1);
            st[j][e] = div_rcp(st[j][e], ssum[c], srs[c]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[j][e] = __fdiv_rn(st[j][e], ssum[i0 + 8 * j + 2 * t + (e & 1)]);
          }
        }
      }
      // ds^T; p and ds are 0 for the queries past L
      const bool tail = i0 + 16 > L;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = i0 + 8 * j + 2 * t + (e & 1);
          const bool live = !tail || c < L;
          dpt[j][e] = live ? ds_value(st[j][e], dpt[j][e], sdd[c], scale)
                           : 0.0f;
          st[j][e] = live ? st[j][e] : 0.0f;
        }
      }
      uint32_t pa[4], dsa[4];
      acc_to_a(pa, st[0], st[1]);
      acc_to_a(dsa, dpt[0], dpt[1]);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (jp * 16 < nc) {
          uint32_t bb[4];
          ldsm_b_kn(bb, sdo, ld, i0, c0 + jp * 16, lane);  // bf16(p)^T . do
          mma_bf16(acc_v[2 * jp], pa, bb);
          mma_bf16(acc_v[2 * jp + 1], pa, bb + 2);
          ldsm_b_kn(bb, sq, ld, i0, c0 + jp * 16, lane);   // ds^T . q
          mma_bf16(acc_k[2 * jp], dsa, bb);
          mma_bf16(acc_k[2 * jp + 1], dsa, bb + 2);
        }
      }
    }
    store_tile(dk, stride, acc_k, k0 + m0, c0, nc, L, D, g, t);
    store_tile(dk + C, stride, acc_v, k0 + m0, c0, nc, L, D, g, t);
  }
}

template <int KT>
int launch_dq(const bf16* qkv, const bf16* dout, bf16* dqkv, float* stats,
              int B, int L, int H, int D, float scale, int smem,
              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_dq_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  attention_dq_kernel<KT><<<grid, kThreads, smem, stream>>>(
      qkv, dout, dqkv, stats, B, L, H, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long attention_bwd_smem_bytes(int L, int D) {
  const long long lp = round16(L);
  return 4LL * (kRows + lp) * (round16(D) + kPad) + 16LL * lp;
}

// qkv (B, L, 3*H*D) bf16 packed [q | k | v] with head h at columns h*D;
// dout (B, L, H*D) bf16 the gradient of the concatenated head outputs;
// dqkv (B, L, 3*H*D) bf16 in the same packing; stats (3, B, H, L) f32
// scratch: the dq kernel writes each row's max, sum and dd, and the dk/dv
// kernel after it on the same stream reads them. Requires L <= 256, D % 8
// == 0, D <= 256, H*D % 128 == 0 and 16-byte aligned pointers (the wrapper
// checks).
extern "C" int attention_bwd_bf16(const void* qkv, const void* dout,
                                  void* dqkv, void* stats, int B, int L,
                                  int H, int D, float scale, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (L > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(attention_bwd_smem_bytes(L, D));
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* d = static_cast<const bf16*>(dout);
  bf16* dx = static_cast<bf16*>(dqkv);
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nkt = (L + 15) / 16;
  int code;
  if (nkt <= 4) {
    code = launch_dq<4>(q, d, dx, st, B, L, H, D, scale, smem, s);
  } else if (nkt <= 8) {
    code = launch_dq<8>(q, d, dx, st, B, L, H, D, scale, smem, s);
  } else if (nkt <= 13) {
    code = launch_dq<13>(q, d, dx, st, B, L, H, D, scale, smem, s);
  } else {
    code = launch_dq<16>(q, d, dx, st, B, L, H, D, scale, smem, s);
  }
  if (code != 0) return code;
  cudaError_t err = cudaFuncSetAttribute(
      attention_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  attention_dkdv_kernel<<<grid, kThreads, smem, s>>>(q, d, dx, st, B, L, H,
                                                     D, scale);
  return static_cast<int>(cudaGetLastError());
}
