// The attention core of K1 and K4: per (sample, head),
// softmax(q k^T * scale) v over packed qkv rows, on the tensor cores.
//
// Replaces the per-head loop inside eventpretrain_tpu/ops/
// fused_attn_layer.py::_attention_heads (:83, with _head_softmax :73), with
// its rounding points: s = q.k^T accumulated in f32, times scale; p =
// exp(s - max) / sum in f32, normalised and then rounded to bf16; o =
// bf16(p).v accumulated in f32 and rounded once. Every product is a bf16
// mma.sync.m16n8k16; the scalar steps use expf and the _rn intrinsics, so
// nothing is contracted into an FMA that the plain version rounds in two
// steps.
//
// The gate stops at L = 256 (ops/common.py MAX_FUSED_SEQ_LEN), so one warp
// holds a whole score row block in registers: a warp owns 16 query rows and
// every key, Lp = L rounded up to 16, as Lp / 2 f32 accumulators a thread
// (104 at L = 196). The softmax is exact in one pass (mma.cuh
// softmax_rows): the key tail is masked to -inf before the row max, the max
// and the sum are quad shuffles, p = x / sum is __fdiv_rn's quotient taken
// through one correctly rounded reciprocal of the sum, and the normalised,
// rounded p is repacked in registers as the A fragments of p.v. q.k^T is
// computed once.
//
// A block is 4 warps, 64 query rows of one (sample, head); the grid is
// (row blocks, heads, samples), so L = 196 gives 4 blocks a head and B = 16
// at 12 heads 768 blocks. The block stages its q rows and the head's k and
// v (Lp rows each, zero past L and past D) in shared memory with 16-byte
// cp.async straight from the packed rows, v in its own group so that it
// lands while q.k^T runs; fragments come from ldmatrix (.trans for v).
// Rows are padded by 8 bf16, which makes ldmatrix free of bank conflicts.
// Output columns are accumulated 64 at a time, so D up to 256 stays in
// registers. Shared memory: (64 + 2 Lp)(Dp + 8) * 2 bytes, Dp = D rounded
// up to 16 (38.4 KB at L = 196, D = 32).
//
// What bounds it on this card: at the repo's shapes (L <= 196, D <= 64) a
// head is 4 L^2 D = 4.9 MFLOP and 75 KB of q, k, v, o, far from either
// peak; the scalar softmax steps of every score (expf, the exact division)
// and each block's wait for its k and v take the time. Staging the next
// sample's k and v while one is computed (two stages of shared memory) was
// slower: it halves the blocks an SM holds.
#include <math.h>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows of a block
constexpr int kPad = 8;             // bf16 of padding per shared-memory row

__host__ __device__ constexpr int round16(int n) {
  return (n + 15) / 16 * 16;
}

// Rows [row0, row0 + nrows) of one head's D columns (src points at row 0,
// column 0 of the head; rows are `stride` elements apart) into
// dst[nrows][ld], zero past L and past D (D % 8 == 0, DP % 16 == 0), as
// 16-byte cp.async of this thread; the caller commits the group.
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

// KT * 16 >= Lp: the score tiles a thread holds. ptxas's default target,
// 3 blocks an SM, spills at KT = 16; one block an SM as the floor lets it
// take what it needs there.
template <int KT>
__global__ void __launch_bounds__(kThreads, KT > 13 ? 1 : 3)
    attention_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                         int L, int H, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DP = round16(D), ld = DP + kPad;
  const int nkt = (L + 15) / 16, Lp = nkt * 16;
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [kRows][ld]
  bf16* sk = sq + kRows * ld;                // [Lp][ld]
  bf16* sv = sk + Lp * ld;                   // [Lp][ld]

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const long long stride = 3LL * C;
  const bf16* head = qkv + static_cast<long long>(b) * L * stride + h * D;
  stage_rows(sq, ld, head, stride, q0, kRows, L, D, DP);
  stage_rows(sk, ld, head + C, stride, 0, Lp, L, D, DP);
  cp_async_commit();
  stage_rows(sv, ld, head + 2 * C, stride, 0, Lp, L, D, DP);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const bool active = q0 + m0 < L;

  // s = q . k^T: 2 * KT n8 tiles of 16 x 8 scores; tile j holds keys
  // 8j + 2t + (e & 1) of rows g (e < 2) and g + 8 (e >= 2)
  float s[2 * KT][4];
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
  }
  uint32_t pa[KT][4];  // bf16(p) as the A fragments of p . v
  if (active) {
    for (int k0 = 0; k0 < DP; k0 += 16) {
      uint32_t a[4];
      ldsm_a(a, sq, ld, m0, k0, lane);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        if (kt < nkt) {
          uint32_t bb[4];
          ldsm_b_nk(bb, sk, ld, kt * 16, k0, lane);
          mma_bf16(s[2 * kt], a, bb);
          mma_bf16(s[2 * kt + 1], a, bb + 2);
        }
      }
    }
    softmax_rows<KT>(s, nkt, L, t, scale, nullptr);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < nkt) acc_to_a(pa[kt], s[2 * kt], s[2 * kt + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  // o = bf16(p) . v, 64 output columns at a time
  bf16* orow = out + (static_cast<long long>(b) * L + q0 + m0) * C + h * D;
  for (int c0 = 0; c0 < DP; c0 += 64) {
    const int nc = min(64, DP - c0);
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < nkt) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp * 16 < nc) {
            uint32_t bb[4];
            ldsm_b_kn(bb, sv, ld, kt * 16, c0 + jp * 16, lane);
            mma_bf16(o[2 * jp], pa[kt], bb);
            mma_bf16(o[2 * jp + 1], pa[kt], bb + 2);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * j + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r;
        if (8 * j < nc && col < D && q0 + m0 + row < L) {
          *reinterpret_cast<uint32_t*>(orow + row * C + col) =
              pack_f32(o[j][2 * r], o[j][2 * r + 1]);
        }
      }
    }
  }
}

template <int KT>
int launch(const bf16* qkv, bf16* out, int B, int L, int H, int D,
           float scale, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  attention_fwd_kernel<KT><<<grid, kThreads, smem, stream>>>(qkv, out, L, H,
                                                             D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long attention_smem_bytes(int L, int D) {
  return (kRows + 2LL * round16(L)) * (round16(D) + kPad) * 2;
}

// qkv (B, L, 3*H*D) bf16 packed [q | k | v] with head h at columns h*D;
// out (B, L, H*D) bf16. Requires L <= 256, D % 8 == 0, D <= 256, H*D % 128
// == 0 and 16-byte aligned pointers (the wrapper checks).
extern "C" int attention_bf16(const void* qkv, void* out, int B, int L, int H,
                              int D, float scale, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (L > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(attention_smem_bytes(L, D));
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nkt = (L + 15) / 16;
  if (nkt <= 4) return launch<4>(q, o, B, L, H, D, scale, smem, s);
  if (nkt <= 8) return launch<8>(q, o, B, L, H, D, scale, smem, s);
  if (nkt <= 13) return launch<13>(q, o, B, L, H, D, scale, smem, s);
  return launch<16>(q, o, B, L, H, D, scale, smem, s);
}
