// K7 — fused multi-head attention softmax(q k^T * scale) v over strided
// (B, L, H, D) bf16 operands, forward and backward, on the tensor cores.
//
// Replaces eventpretrain_tpu/ops/pallas_attention.py::_fwd_kernel (:40) and
// _bwd_kernel (:54) (the custom VJP :119-133), with their rounding points:
//   forward   s = (q.k^T accumulated in f32) * scale; p = exp(s - max) / sum
//             in f32; p rounded to bf16; o = p.v accumulated in f32, rounded.
//   backward  p recomputed the same way; dv = bf16(p)^T.do; dp = do.v^T (f32);
//             ds = bf16(p * (dp - rowsum(dp * p)) * scale); dq = ds.k;
//             dk = ds^T.q; each accumulated in f32 and rounded once.
// Every product is a bf16 mma.sync.m16n8k16 with f32 accumulation; the
// scalar steps use the _rn intrinsics, so nothing is contracted into an FMA
// that the plain version rounds in two steps.
//
// The TPU kernel keeps one head's whole (L, L) f32 score tile in VMEM; at
// L = 1024 that is 4 MB, and a Hopper block may use 227 KB of shared memory.
// So nothing of size L x L is ever stored. Every kernel works on 64-row tiles
// (4 warps of 16 rows), zero-padded in shared memory to L and to D rounded up
// to 16, with the key tail masked, so it takes the whole JAX gate (L <= 1024,
// D <= 256, ragged L, any D):
//   forward  one block per (query tile, head, sample). Pass 1 runs over the
//            key tiles for the row max and the row sum (online: the sum is
//            rescaled when the max grows). Pass 2 recomputes s and
//            accumulates the normalised, rounded p times v, 64 output columns
//            at a time (s is recomputed per 64 columns when D > 64, which
//            keeps the accumulators in registers at D = 256). It saves the
//            row max and sum, (2, B, H, L) f32, for the backward.
//   dq       one block per (query tile, head, sample): pass A over the key
//            tiles for rowsum(dp * p) (saved for dk/dv), pass B accumulates
//            dq = ds.k.
//   dk, dv   one block per (key tile, head, sample), looping over the query
//            tiles; then p and ds are transposed products (s^T = k.q^T).
// No sum crosses blocks, so there are no atomics and the result repeats bit
// for bit. Operands are read through their strides (q, k and v are slices of
// the packed qkv projection): 16 bytes at a time where the rows allow it (D a
// multiple of 8, 16-byte aligned rows), one bf16 at a time otherwise.
//
// What bounds it on this card: at the shapes of the repo (L <= 196, D <= 64)
// the work per (sample, head) is small (4*L*L*D = 4.9 MFLOP at L=196, D=32),
// so the kernels are bound by latency: the scalar strided tile loads, the
// two block barriers per tile and the recomputed score products (the forward
// computes q.k^T twice, the backward four times), not by the tensor cores'
// rate or by device memory. A faster version would stage tiles with cp.async
// or TMA and keep the statistics pass out of the forward.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;   // rows of a query tile and of a key tile
constexpr int kChunk = 64;  // output columns accumulated at once
constexpr int kPad = 8;     // bf16 of padding per shared-memory row

struct Operand {  // a strided (B, L, H, D) bf16 tensor
  const bf16* p;
  long long sb, sl, sh, sd;
  int vec;  // rows are 16-byte aligned runs of D % 8 == 0 elements
};

Operand make_operand(const void* p, long long sb, long long sl, long long sh,
                     long long sd, int D) {
  const bool vec = sd == 1 && D % 8 == 0 && sb % 8 == 0 && sl % 8 == 0 &&
                   sh % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return Operand{static_cast<const bf16*>(p), sb, sl, sh, sd, vec ? 1 : 0};
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragments of mma.m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// lane = 4 * g + t. A (16 x 16) from row-major X[m][k]:
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* x, int ld,
                                       int m0, int k0, int g, int t) {
  const bf16* r0 = x + (m0 + g) * ld + k0 + 2 * t;
  const bf16* r1 = r0 + 8 * ld;
  a[0] = ld32(r0);
  a[1] = ld32(r1);
  a[2] = ld32(r0 + 8);
  a[3] = ld32(r1 + 8);
}

// B (16 x 8), B(k, n) = Y[n][k]: a row-major operand used transposed.
__device__ __forceinline__ void frag_b_nk(uint32_t b[2], const bf16* y,
                                          int ld, int n0, int k0, int g,
                                          int t) {
  const bf16* r = y + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(r);
  b[1] = ld32(r + 8);
}

// B (16 x 8), B(k, n) = Z[k][n]: a row-major operand used as it is.
__device__ __forceinline__ void frag_b_kn(uint32_t b[2], const bf16* z,
                                          int ld, int k0, int n0, int g,
                                          int t) {
  const bf16* c = z + (k0 + 2 * t) * ld + n0 + g;
  b[0] = pack_bf16(c[0], c[ld]);
  b[1] = pack_bf16(c[8 * ld], c[9 * ld]);
}

// The f32 accumulators of two neighbouring n8 tiles, rounded to bf16, as the
// A fragment of the next product (its k = their n).
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4],
                                         const float hi[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [row0, row0 + kTile) and columns [col0, col0 + ncols) of one
// (sample, head) slice into s[kTile][ld], zero past L and past D. Each
// thread issues kBatch loads before it stores any, so they are in flight
// together: 16 bytes each where the operand allows (x.vec; ncols and col0
// are then multiples of 8, and ld keeps smem rows 16-byte aligned), one
// bf16 each through the strides otherwise.
constexpr int kBatch = 4;

__device__ void load_tile(bf16* s, int ld, const Operand& x, int b, int h,
                          int row0, int col0, int ncols, int L, int D) {
  const bf16* base = x.p + b * x.sb + h * x.sh;
  if (x.vec) {
    const int per_row = ncols / 8;
    const int total = kTile * per_row;
    for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        const int row = row0 + i / per_row, col = col0 + i % per_row * 8;
        v[u] = (i < total && row < L && col < D)
                   ? *reinterpret_cast<const uint4*>(base + row * x.sl + col)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < total) {
          *reinterpret_cast<uint4*>(s + i / per_row * ld + i % per_row * 8) =
              v[u];
        }
      }
    }
    return;
  }
  const bf16 zero = __float2bfloat16(0.0f);
  const int total = kTile * ncols;
  for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kBatch * 4) {
    bf16 v[kBatch * 4];
#pragma unroll
    for (int u = 0; u < kBatch * 4; ++u) {
      const int i = i0 + u * kThreads;
      const int row = row0 + i / ncols, col = col0 + i % ncols;
      v[u] = (i < total && row < L && col < D)
                 ? base[row * x.sl + col * x.sd]
                 : zero;
    }
#pragma unroll
    for (int u = 0; u < kBatch * 4; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) s[i / ncols * ld + i % ncols] = v[u];
    }
  }
}

// acc[j] (j < 8) = X[m0:m0+16] . Y[0:64]^T over DP columns: 16 x 64 scores.
__device__ __forceinline__ void products_nt(float acc[8][4], const bf16* x,
                                            const bf16* y, int ld, int m0,
                                            int DP, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  for (int k0 = 0; k0 < DP; k0 += 16) {
    uint32_t a[4];
    frag_a(a, x, ld, m0, k0, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bb[2];
      frag_b_nk(bb, y, ld, j * 8, k0, g, t);
      mma_bf16(acc[j], a, bb);
    }
  }
}

// out[j] += P . Z[0:64][n0 + 8j] for the n8 tiles j < ncols / 8, P the 16 x
// 64 accumulators p rounded to bf16.
__device__ __forceinline__ void products_pv(float out[8][4],
                                            const float p[8][4],
                                            const bf16* z, int ld, int n0,
                                            int ncols, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j * 8 < ncols) {
        uint32_t bb[2];
        frag_b_kn(bb, z, ld, kk * 16, n0 + j * 8, g, t);
        mma_bf16(out[j], a, bb);
      }
    }
  }
}

// Row r of the thread's accumulator element e: g + 8 * (e >= 2); column:
// 8 * j + 2 * t + (e & 1).
__device__ __forceinline__ void store_rows(bf16* out, const float acc[8][4],
                                           int b, int h, int row0, int col0,
                                           int ncols, int L, int H, int D,
                                           int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
      const int c = j * 8 + 2 * t + (e & 1);
      const int col = col0 + c;
      if (c < ncols && row < L && col < D) {
        out[((static_cast<long long>(b) * L + row) * H + h) * D + col] =
            __float2bfloat16(acc[j][e]);
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(float acc[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
}

// s * scale for keys < L, -inf past the key tail.
__device__ __forceinline__ void scale_mask(float s[8][4], float scale,
                                           int key0, int L, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + j * 8 + 2 * t + (e & 1);
      s[j][e] = key < L ? __fmul_rn(s[j][e], scale) : -INFINITY;
    }
  }
}

// p = exp(s - max) / sum, rows g and g + 8 with their own statistics.
__device__ __forceinline__ void probs_rows(float s[8][4], const float mx[2],
                                           const float sum[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      s[j][e] = __fdiv_rn(expf(__fsub_rn(s[j][e], mx[r])), sum[r]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    mha_fwd_kernel(Operand q, Operand k, Operand v, bf16* __restrict__ out,
                   float* __restrict__ stats, int B, int L, int H, int D,
                   int DP, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = DP + kPad;
  const int ldv = kChunk + kPad;
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [kTile][ld]
  bf16* sk = sq + kTile * ld;                // [kTile][ld]
  bf16* sv = sk + kTile * ld;                // [kTile][ldv]

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const int ntiles = (L + kTile - 1) / kTile;

  load_tile(sq, ld, q, b, h, q0, 0, DP, L, D);
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float s[8][4];
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    load_tile(sk, ld, k, b, h, kt * kTile, 0, DP, L, D);
    __syncthreads();
    products_nt(s, sq, sk, ld, m0, DP, g, t);
    scale_mask(s, scale, kt * kTile, L, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      }
      const float mnew = fmaxf(mx[r], quad_max(tmax));
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        part += expf(__fsub_rn(s[j][2 * r], mnew)) +
                expf(__fsub_rn(s[j][2 * r + 1], mnew));
      }
      sum[r] = sum[r] * expf(__fsub_rn(mx[r], mnew)) + quad_sum(part);
      mx[r] = mnew;
    }
  }

  float o[8][4];
  for (int c0 = 0; c0 < DP; c0 += kChunk) {
    const int nc = min(kChunk, DP - c0);
    zero_acc(o);
    for (int kt = 0; kt < ntiles; ++kt) {
      __syncthreads();
      load_tile(sk, ld, k, b, h, kt * kTile, 0, DP, L, D);
      load_tile(sv, ldv, v, b, h, kt * kTile, c0, nc, L, D);
      __syncthreads();
      products_nt(s, sq, sk, ld, m0, DP, g, t);
      scale_mask(s, scale, kt * kTile, L, t);
      probs_rows(s, mx, sum);
      products_pv(o, s, sv, ldv, 0, nc, g, t);
    }
    store_rows(out, o, b, h, q0 + m0, c0, nc, L, H, D, g, t);
  }
  if (t == 0) {
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + m0 + g + 8 * r;
      if (row < L) {
        const long long i = (static_cast<long long>(b) * H + h) * L + row;
        stats[i] = mx[r];
        stats[static_cast<long long>(B) * H * L + i] = sum[r];
      }
    }
  }
}

// dq, and rowsum(dp * p) into delta (B, H, L) for the dk/dv kernel.
__global__ void __launch_bounds__(kThreads)
    mha_dq_kernel(Operand q, Operand k, Operand v, Operand dout,
                  const float* __restrict__ stats, float* __restrict__ delta,
                  bf16* __restrict__ dq, int B, int L, int H, int D, int DP,
                  float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = DP + kPad;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kTile * ld;
  bf16* sk = sdo + kTile * ld;
  bf16* sv = sk + kTile * ld;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const int ntiles = (L + kTile - 1) / kTile;

  load_tile(sq, ld, q, b, h, q0, 0, DP, L, D);
  load_tile(sdo, ld, dout, b, h, q0, 0, DP, L, D);
  float mx[2], sum[2];
  const long long bhl = static_cast<long long>(B) * H * L;
  for (int r = 0; r < 2; ++r) {
    const int row = min(q0 + m0 + g + 8 * r, L - 1);
    const long long i = (static_cast<long long>(b) * H + h) * L + row;
    mx[r] = stats[i];
    sum[r] = stats[bhl + i];
  }

  float s[8][4], dp[8][4];
  float dsum[2] = {0.0f, 0.0f};
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    load_tile(sk, ld, k, b, h, kt * kTile, 0, DP, L, D);
    load_tile(sv, ld, v, b, h, kt * kTile, 0, DP, L, D);
    __syncthreads();
    products_nt(s, sq, sk, ld, m0, DP, g, t);
    scale_mask(s, scale, kt * kTile, L, t);
    probs_rows(s, mx, sum);
    products_nt(dp, sdo, sv, ld, m0, DP, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dsum[e >> 1] += dp[j][e] * s[j][e];
    }
  }
  for (int r = 0; r < 2; ++r) dsum[r] = quad_sum(dsum[r]);
  if (t == 0) {
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + m0 + g + 8 * r;
      if (row < L) delta[(static_cast<long long>(b) * H + h) * L + row] =
          dsum[r];
    }
  }

  float acc[8][4];
  for (int c0 = 0; c0 < DP; c0 += kChunk) {
    const int nc = min(kChunk, DP - c0);
    zero_acc(acc);
    for (int kt = 0; kt < ntiles; ++kt) {
      __syncthreads();
      load_tile(sk, ld, k, b, h, kt * kTile, 0, DP, L, D);
      load_tile(sv, ld, v, b, h, kt * kTile, 0, DP, L, D);
      __syncthreads();
      products_nt(s, sq, sk, ld, m0, DP, g, t);
      scale_mask(s, scale, kt * kTile, L, t);
      probs_rows(s, mx, sum);
      products_nt(dp, sdo, sv, ld, m0, DP, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = __fsub_rn(dp[j][e], dsum[e >> 1]);
          s[j][e] = __fmul_rn(__fmul_rn(s[j][e], d), scale);
        }
      }
      products_pv(acc, s, sk, ld, c0, nc, g, t);  // ds . k
    }
    store_rows(dq, acc, b, h, q0 + m0, c0, nc, L, H, D, g, t);
  }
}

// dk and dv of one key tile, over every query tile.
__global__ void __launch_bounds__(kThreads)
    mha_dkdv_kernel(Operand q, Operand k, Operand v, Operand dout,
                    const float* __restrict__ stats,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int B, int L, int H, int D,
                    int DP, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = DP + kPad;
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kTile * ld;
  bf16* sq = sv + kTile * ld;
  bf16* sdo = sq + kTile * ld;
  float* smx = reinterpret_cast<float*>(sdo + kTile * ld);  // [kTile]
  float* ssum = smx + kTile;
  float* sdel = ssum + kTile;

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const int ntiles = (L + kTile - 1) / kTile;
  const long long bh = (static_cast<long long>(b) * H + h) * L;
  const long long bhl = static_cast<long long>(B) * H * L;

  load_tile(sk, ld, k, b, h, k0, 0, DP, L, D);
  load_tile(sv, ld, v, b, h, k0, 0, DP, L, D);

  float st[8][4], dpt[8][4], acc_k[8][4], acc_v[8][4];
  for (int c0 = 0; c0 < DP; c0 += kChunk) {
    const int nc = min(kChunk, DP - c0);
    zero_acc(acc_k);
    zero_acc(acc_v);
    for (int qt = 0; qt < ntiles; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile(sq, ld, q, b, h, q0, 0, DP, L, D);
      load_tile(sdo, ld, dout, b, h, q0, 0, DP, L, D);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const int row = q0 + i;
        const bool ok = row < L;
        smx[i] = ok ? stats[bh + row] : 0.0f;
        ssum[i] = ok ? stats[bhl + bh + row] : 1.0f;
        sdel[i] = ok ? delta[bh + row] : 0.0f;
      }
      __syncthreads();
      // s^T = k . q^T: rows are keys, columns queries
      products_nt(st, sk, sq, ld, m0, DP, g, t);
      products_nt(dpt, sv, sdo, ld, m0, DP, g, t);  // dp^T = v . do^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          const float p =
              q0 + c < L
                  ? __fdiv_rn(expf(__fsub_rn(__fmul_rn(st[j][e], scale),
                                             smx[c])),
                              ssum[c])
                  : 0.0f;
          st[j][e] = p;
          const float d = __fsub_rn(dpt[j][e], sdel[c]);
          dpt[j][e] = __fmul_rn(__fmul_rn(p, d), scale);
        }
      }
      products_pv(acc_v, st, sdo, ld, c0, nc, g, t);   // bf16(p)^T . do
      products_pv(acc_k, dpt, sq, ld, c0, nc, g, t);   // bf16(ds)^T . q
    }
    store_rows(dk, acc_k, b, h, k0 + m0, c0, nc, L, H, D, g, t);
    store_rows(dv, acc_v, b, h, k0 + m0, c0, nc, L, H, D, g, t);
  }
}

int round16(int d) { return (d + 15) / 16 * 16; }

}  // namespace

extern "C" long long mha_fwd_smem_bytes(int D) {
  const int ld = round16(D) + kPad;
  return (2LL * kTile * ld + kTile * (kChunk + kPad)) * 2;
}

extern "C" long long mha_bwd_smem_bytes(int D) {
  const int ld = round16(D) + kPad;
  return 4LL * kTile * ld * 2 + 3LL * kTile * 4;
}

// q, k, v: strided (B, L, H, D) bf16, each with its four element strides;
// out (B, L, H, D) bf16 contiguous; stats (2, B, H, L) f32: the row max and
// the row sum of exp. Requires L <= 1024 and D <= 256 (the wrapper checks).
extern "C" int mha_fwd_bf16(const void* q, long long qsb, long long qsl,
                            long long qsh, long long qsd, const void* k,
                            long long ksb, long long ksl, long long ksh,
                            long long ksd, const void* v, long long vsb,
                            long long vsl, long long vsh, long long vsd,
                            void* out, void* stats, int B, int L, int H,
                            int D, float scale, void* stream) {
  if (B == 0 || L == 0 || H == 0 || D == 0) return 0;
  const int smem = static_cast<int>(mha_fwd_smem_bytes(D));
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Operand oq = make_operand(q, qsb, qsl, qsh, qsd, D);
  const Operand ok = make_operand(k, ksb, ksl, ksh, ksd, D);
  const Operand ov = make_operand(v, vsb, vsl, vsh, vsd, D);
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  mha_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      oq, ok, ov, static_cast<bf16*>(out), static_cast<float*>(stats), B, L,
      H, D, round16(D), scale);
  return static_cast<int>(cudaGetLastError());
}

// The backward for the forward's saved stats: dq, dk, dv (B, L, H, D) bf16
// contiguous; delta (B, H, L) f32 scratch. The dq kernel writes delta, the
// dk/dv kernel after it on the same stream reads it.
extern "C" int mha_bwd_bf16(const void* q, long long qsb, long long qsl,
                            long long qsh, long long qsd, const void* k,
                            long long ksb, long long ksl, long long ksh,
                            long long ksd, const void* v, long long vsb,
                            long long vsl, long long vsh, long long vsd,
                            const void* dout, long long dsb, long long dsl,
                            long long dsh, long long dsd, const void* stats,
                            void* delta, void* dq, void* dk, void* dv, int B,
                            int L, int H, int D, float scale, void* stream) {
  if (B == 0 || L == 0 || H == 0 || D == 0) return 0;
  const int smem = static_cast<int>(mha_bwd_smem_bytes(D));
  cudaError_t err = cudaFuncSetAttribute(
      mha_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      mha_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Operand oq = make_operand(q, qsb, qsl, qsh, qsd, D);
  const Operand ok = make_operand(k, ksb, ksl, ksh, ksd, D);
  const Operand ov = make_operand(v, vsb, vsl, vsh, vsd, D);
  const Operand od = make_operand(dout, dsb, dsl, dsh, dsd, D);
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mha_dq_kernel<<<grid, kThreads, smem, s>>>(
      oq, ok, ov, od, static_cast<const float*>(stats),
      static_cast<float*>(delta), static_cast<bf16*>(dq), B, L, H, D,
      round16(D), scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_dkdv_kernel<<<grid, kThreads, smem, s>>>(
      oq, ok, ov, od, static_cast<const float*>(stats),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, L, H, D, round16(D), scale);
  return static_cast<int>(cudaGetLastError());
}
