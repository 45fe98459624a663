// The one-pass attention, forward and backward, as __device__ bodies of one
// block each: softmax(q k^T * scale) v per (sample, head) on the tensor
// cores, for L <= 256. Two callers wrap them in thin __global__ kernels:
//
//   the attention core of K1 and K4 (attention.cu, attention_bwd.cu), over
//     packed qkv rows: q at qkv, k at qkv + C, v at qkv + 2C, row stride 3C,
//     head stride D; the head outputs and their gradient at row stride C;
//     dqkv packed as qkv;
//   K7's one-pass route (mha.cu), over strided (B, L, H, D) q, k, v (and
//     do) given as operand descriptors (pointer; batch, row and head
//     strides), with contiguous outputs, and the row statistics that its
//     tiled backward can read.
//
// A wrapper resolves its operands at (sample, head) to one head's rows (In,
// Out: the pointer to row 0, column 0 and the row stride in elements,
// columns contiguous), so the bodies never see a layout. Every row is
// staged with 16-byte cp.async: each stride is a multiple of 8 elements
// and each pointer 16-byte aligned (the wrappers' callers check).
//
// The JAX kernels they replace (fused_attn_layer.py::_attention_heads :83
// and the head loop of _layer_bwd :142-164 for the core; pallas_attention.py
// ::_fwd_kernel :40 and ::_bwd_kernel :54 for K7) share one function and its
// rounding points:
//
//   s  = q.k^T accumulated in f32, times scale
//   p  = exp(s - max) / sum in f32, normalised, then rounded to bf16
//   o  = bf16(p).v accumulated in f32, rounded once
//   dv = bf16(p)^T . do;  dp = do . v^T (f32);  dd = rowsum(dp * p)
//   ds = bf16(p * (dp - dd) * scale);  dq = ds . k;  dk = ds^T . q
//
// Every product is a bf16 mma.sync.m16n8k16; the scalar steps use expf and
// the _rn intrinsics, so nothing is contracted into an FMA that the plain
// versions round in two steps.
//
// At L <= 256 one warp holds a whole score row block in registers: a warp
// owns 16 query rows and every key, Lp = L rounded up to 16, as Lp / 2 f32
// accumulators a thread (104 at L = 196), in key-tile buckets KT = 4, 8,
// 13, 16 (every index a constant, nothing in local memory). A block is 4
// warps, 64 rows of one (sample, head); the grid is (row blocks, heads,
// samples).
//
//   forward  The block stages its q rows and the head's k and v (Lp rows
//            each, zero past L and past D) in shared memory, v in its own
//            cp.async group so that it lands while q.k^T runs; fragments
//            come from ldmatrix (.trans for v), rows padded by 8 bf16 so
//            that ldmatrix is free of bank conflicts. q.k^T is computed
//            once; the softmax is exact in one pass (mma.cuh softmax_rows:
//            the key tail masked to -inf before the row max, the exact sum
//            over the final max in a fixed order, p = x / sum as __fdiv_rn's
//            quotient through one correctly rounded reciprocal of the sum);
//            the rounded p is repacked in registers as the A fragments of
//            p.v, accumulated 64 output columns at a time. Shared memory:
//            (64 + 2 Lp)(Dp + 8) * 2 bytes, Dp = D rounded up to 16.
//   dq       s and p once, as the forward; then dp = do . v^T one 16-key
//            step at a time, twice (for dd, then for ds, which it keeps as
//            bf16 A fragments); dq = ds . k, 64 columns at a time. It saves
//            (max, sum, dd) of each row in a (3, B, H, L) f32 scratch.
//   dk/dv    a warp owns 16 keys and loops over the queries 16 at a time:
//            s^T = k . q^T and p from the saved statistics (the same expf
//            and reciprocal-based exact division), dv += bf16(p)^T . do;
//            dp^T = v . do^T, ds^T, dk += ds^T . q. Shared memory for the
//            two: 4 (64 + Lp)(Dp + 8) + 16 Lp bytes.
//
// No sum crosses a warp: there are no atomics, every sum has a fixed order,
// and the result repeats bit for bit. What bounds them on this card: at the
// repo's shapes (L <= 196, D <= 64) a head is 4 L^2 D = 4.9 MFLOP forward
// and about 16 L^2 D backward on 75-130 KB of operands, far from either
// peak; the scalar softmax steps of every score (expf, the exact division)
// and each block's wait for its staged rows take the time.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace onepass {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query (or key) rows of a block
constexpr int kPad = 8;             // bf16 of padding per shared-memory row

inline long long fwd_smem_bytes(int L, int D) {
  return (kRows + 2LL * round16(L)) * (round16(D) + kPad) * 2;
}

inline long long bwd_smem_bytes(int L, int D) {
  const long long lp = round16(L);
  return 4LL * (kRows + lp) * (round16(D) + kPad) + 16LL * lp;
}

// f(std::integral_constant<int, KT>{}) for the smallest key-tile bucket
// that holds L's 16-key tiles.
template <class F>
int with_key_tiles(int L, F f) {
  const int nkt = (L + 15) / 16;
  if (nkt <= 4) return f(std::integral_constant<int, 4>{});
  if (nkt <= 8) return f(std::integral_constant<int, 8>{});
  if (nkt <= 13) return f(std::integral_constant<int, 13>{});
  return f(std::integral_constant<int, 16>{});
}

// One head's rows: row 0, column 0 and the row stride in elements.
struct In {
  const bf16* p;
  long long ld;
};
struct Out {
  bf16* p;
  long long ld;
};

// Where a kernel saves its row statistics: this head's row 0 of the first
// (L,) plane of a (planes, B, H, L) f32 array and the distance between
// planes, B * H * L; or p null for none.
struct Stats {
  float* p;
  long long plane;
};

// Rows [row0, row0 + nrows) of one head's D columns into dst[nrows][ld],
// zero past L and past D, as 16-byte cp.async of this thread; the caller
// commits the group.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, In src,
                                           int row0, int nrows, int L, int D,
                                           int DP) {
  const int per_row = DP / 8;
  for (int i = threadIdx.x; i < nrows * per_row; i += kThreads) {
    const int r = i / per_row, c = i % per_row * 8;
    const int row = row0 + r;
    const bool ok = row < L && c < D;
    cp_async16(dst + r * ld + c, ok ? src.p + row * src.ld + c : src.p, ok);
  }
}

// Rows row0.. (16) and columns c0 + [0, nc) of f32 accumulators, rounded,
// into one head's rows, rows < L and columns < D.
__device__ __forceinline__ void store_tile(Out dst, const float acc[8][4],
                                           int row0, int c0, int nc, int L,
                                           int D, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c0 + 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (8 * j < nc && col < D && row < L) {
        *reinterpret_cast<uint32_t*>(dst.p + row * dst.ld + col) =
            pack_f32(acc[j][2 * r], acc[j][2 * r + 1]);
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

// s (2 * KT n8 tiles of 16 x 8 scores; tile j holds keys 8j + 2t + (e & 1)
// of rows g (e < 2) and g + 8 (e >= 2)) = X[m0:m0+16] . K^T over DP columns
template <int KT>
__device__ __forceinline__ void scores(float s[2 * KT][4], const bf16* x,
                                       const bf16* sk, int ld, int m0,
                                       int nkt, int DP, int lane) {
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
  }
  for (int k0 = 0; k0 < DP; k0 += 16) {
    uint32_t af[4];
    ldsm_a(af, x, ld, m0, k0, lane);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < nkt) {
        uint32_t bb[4];
        ldsm_b_nk(bb, sk, ld, kt * 16, k0, lane);
        mma_bf16(s[2 * kt], af, bb);
        mma_bf16(s[2 * kt + 1], af, bb + 2);
      }
    }
  }
}

// out (16 rows x 64 columns c0..) = A . Z[0:Lp][c0 + [0, nc)], A the bf16
// fragments of every key tile
template <int KT>
__device__ __forceinline__ void times_rows(float out[8][4],
                                           const uint32_t a[KT][4],
                                           const bf16* z, int ld, int nkt,
                                           int c0, int nc, int lane) {
  zero_acc(out);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt < nkt) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (jp * 16 < nc) {
          uint32_t bb[4];
          ldsm_b_kn(bb, z, ld, kt * 16, c0 + jp * 16, lane);
          mma_bf16(out[2 * jp], a[kt], bb);
          mma_bf16(out[2 * jp + 1], a[kt], bb + 2);
        }
      }
    }
  }
}

// The forward of the block (blockIdx.x) of 64 query rows of one head: o,
// and each row's max and sum of exp in the planes stats_at() names (none
// when its p is null). out_rows() gives o's rows, which are contiguous
// (row stride H * D <= 65535 * 256). Both are called where they are used,
// o's row offsets are 32-bit and the statistics are stored last, so that
// nothing of them holds a register through the scores: at KT = 13 that
// keeps the kernel at 128 registers, 4 blocks an SM, with and without
// statistics (129 leaves room for 3, about 9% slower).
template <int KT, class OutRows, class StatsAt>
__device__ __forceinline__ void forward_block(In q, In k, In v,
                                              OutRows out_rows,
                                              StatsAt stats_at, int L, int D,
                                              float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DP = round16(D), ld = DP + kPad;
  const int nkt = (L + 15) / 16, Lp = nkt * 16;
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [kRows][ld]
  bf16* sk = sq + kRows * ld;                // [Lp][ld]
  bf16* sv = sk + Lp * ld;                   // [Lp][ld]

  const int q0 = blockIdx.x * kRows;
  stage_rows(sq, ld, q, q0, kRows, L, D, DP);
  stage_rows(sk, ld, k, 0, Lp, L, D, DP);
  cp_async_commit();
  stage_rows(sv, ld, v, 0, Lp, L, D, DP);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const bool active = q0 + m0 < L;

  uint32_t pa[KT][4];  // bf16(p) as the A fragments of p . v
  float ms[2][2];      // (max, sum) of rows g and g + 8
  if (active) {
    float s[2 * KT][4];  // s = q . k^T
    scores<KT>(s, sq, sk, ld, m0, nkt, DP, lane);
    softmax_rows<KT>(s, nkt, L, t, scale, ms);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < nkt) acc_to_a(pa[kt], s[2 * kt], s[2 * kt + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  // o = bf16(p) . v, 64 output columns at a time
  const Out o = out_rows();
  const unsigned ldo = static_cast<unsigned>(o.ld);
  bf16* orow = o.p + static_cast<unsigned>(q0 + m0) * ldo;  // < 2^32
  for (int c0 = 0; c0 < DP; c0 += 64) {
    const int nc = min(64, DP - c0);
    float acc[8][4];
    times_rows<KT>(acc, pa, sv, ld, nkt, c0, nc, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * j + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r;
        if (8 * j < nc && col < D && q0 + m0 + row < L) {
          *reinterpret_cast<uint32_t*>(orow + row * ldo + col) =
              pack_f32(acc[j][2 * r], acc[j][2 * r + 1]);
        }
      }
    }
  }
  // each row's (max, sum), for a backward that reads them
  const Stats st = stats_at();
  if (st.p != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + m0 + g + 8 * r;
      if (row < L) {
        st.p[row] = ms[r][0];
        st.p[st.plane + row] = ms[r][1];
      }
    }
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

// The dq kernel's block of 64 query rows of one head: dq, and each row's
// (max, sum, dd) at stats[row], stats[plane + row], stats[2 plane + row].
template <int KT>
__device__ __forceinline__ void dq_block(In q, In k, In v, In dout, Out dq,
                                         float* stats, long long plane,
                                         int L, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DP = round16(D), ld = DP + kPad;
  const int nkt = (L + 15) / 16, Lp = nkt * 16;
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [kRows][ld]
  bf16* sdo = sq + kRows * ld;               // [kRows][ld]
  bf16* sk = sdo + kRows * ld;               // [Lp][ld]
  bf16* sv = sk + Lp * ld;                   // [Lp][ld]

  const int q0 = blockIdx.x * kRows;
  stage_rows(sq, ld, q, q0, kRows, L, D, DP);
  stage_rows(sk, ld, k, 0, Lp, L, D, DP);
  cp_async_commit();
  stage_rows(sdo, ld, dout, q0, kRows, L, D, DP);
  stage_rows(sv, ld, v, 0, Lp, L, D, DP);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const bool active = q0 + m0 < L;

  // s = q . k^T and p, as the forward computes them
  float p[2 * KT][4];
  float ms[2][2] = {};  // (max, sum) of rows g and g + 8
  if (active) {
    scores<KT>(p, sq, sk, ld, m0, nkt, DP, lane);
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
  for (int c0 = 0; c0 < DP; c0 += 64) {
    const int nc = min(64, DP - c0);
    float acc[8][4];
    times_rows<KT>(acc, dsa, sk, ld, nkt, c0, nc, lane);
    store_tile(dq, acc, q0 + m0, c0, nc, L, D, g, t);
  }

  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + m0 + g + 8 * r;
      if (row < L) {
        stats[row] = ms[r][0];
        stats[plane + row] = ms[r][1];
        stats[2 * plane + row] = dd[r];
      }
    }
  }
}

// The dk/dv kernel's block of 64 keys of one head, from the dq kernel's
// statistics (laid out as dq_block writes them).
__device__ __forceinline__ void dkdv_block(In q, In k, In v, In dout, Out dk,
                                           Out dv, const float* stats,
                                           long long plane, int L, int D,
                                           float scale) {
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

  const int k0 = blockIdx.x * kRows;
  stage_rows(sk, ld, k, k0, kRows, L, D, DP);
  stage_rows(sv, ld, v, k0, kRows, L, D, DP);
  stage_rows(sq, ld, q, 0, Lp, L, D, DP);
  stage_rows(sdo, ld, dout, 0, Lp, L, D, DP);
  cp_async_commit();
  for (int i = threadIdx.x; i < Lp; i += kThreads) {
    const bool ok = i < L;
    smx[i] = ok ? stats[i] : 0.0f;
    ssum[i] = ok ? stats[plane + i] : 1.0f;
    sdd[i] = ok ? stats[2 * plane + i] : 0.0f;
    srs[i] = __frcp_rn(ssum[i]);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  if (k0 + m0 >= L) return;

  for (int c0 = 0; c0 < DP; c0 += 64) {
    const int nc = min(64, DP - c0);
    float acc_k[8][4], acc_v[8][4];
    zero_acc(acc_k);
    zero_acc(acc_v);
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
    store_tile(dk, acc_k, k0 + m0, c0, nc, L, D, g, t);
    store_tile(dv, acc_v, k0 + m0, c0, nc, L, D, g, t);
  }
}

}  // namespace onepass
