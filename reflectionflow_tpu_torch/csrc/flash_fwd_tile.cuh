// The first forward flash-attention pipeline of the port (mma.sync), which now serves only K7a,
// the ring-chunk forward (flash_fwd.cu). K1, K8b and K9b run on the Hopper pipeline of
// flash_fwd_sm90.cuh instead.
//
// One block owns (batch*head, kBlockM query rows); each of its eight warps owns 16 rows. The raw
// bf16 Q tile is copied into shared memory once, then kBlockN-key K/V tiles stream through
// double-buffered shared memory with cp.async, so the next tile's copy overlaps this tile's
// math. Per tile the kernel's score functor fills the warp's 16 x kBlockN logits in the base-2
// domain (`bias_mask` applies the structural cross-segment bias and the ragged-tail mask); the
// online softmax runs in fp32, and P, rounded to bf16, stays in registers as the A operand of the
// bf16 mma.sync P.V (the S accumulator layout is P's A-operand layout). The epilogue writes
// out = acc / max(l, 1e-20) and the lse rows. The Q step, the K copy and the score step are
// passed in as functors (flash_rows).

#pragma once

#include "flash_common.cuh"

namespace {

constexpr int kBlockM = 128;  // query rows per block
constexpr int kBlockN = 64;   // keys per streamed tile
constexpr int kWarps = kBlockM / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTileElems = kBlockN * kHeadDim;  // one bf16 K or V tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A warp's 16 x kBlockN logits in the mma C layout.
using ScoreTile = float[kBlockN / 8][4];

// Element strides of q, k (or the kernel's K workspace) and v over (batch, row, head).
struct Strides {
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh;
};

// Per-thread softmax state. A thread holds two query rows of its warp's 16, lane / 4 and
// lane / 4 + 8, as the mma C layout places them.
struct RowState {
  float o[kHeadDim / 8][4];  // unnormalised output
  float m[2];                // running max, log2 domain
  float l[2];                // this thread's share of the running sum
};

// The bf16 A fragments of the warp's 16 rows of a swizzled Q tile.
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[kHeadDim / 16][4], const bf16* sQ,
                                             int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    ldmatrix_x4(qf[kk], sQ + swz(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
}

// S = Q K^T for the warp's 16 rows x kBlockN keys of the swizzled bf16 K tile tK.
__device__ __forceinline__ void qk_bf16(ScoreTile& sc, const uint32_t (&qf)[kHeadDim / 16][4],
                                        const bf16* tK, int lane) {
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < kBlockN / 16; ++np) {
      uint32_t bk[4];
      ldmatrix_x4(bk, tK + swz(np * 16 + ((lane >> 4) << 3) + (lane & 7),
                               kk * 2 + ((lane >> 3) & 1)));
      mma_bf16(sc[2 * np], qf[kk], bk[0], bk[1]);
      mma_bf16(sc[2 * np + 1], qf[kk], bk[2], bk[3]);
    }
  }
}

__device__ __forceinline__ void scale_tile(ScoreTile& sc, float f) {
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] *= f;
  }
}

// After the scale, in the TPU kernels' order: a query and a key on opposite sides of the cond
// boundary get `bias` (in the units of sc) when has_cross, and keys >= L are masked. A tile with
// neither is left as it is. row_a is the thread's first query row. The boundary is given in
// local rows for each side, q_main for queries and k_main for keys: a ring chunk (K7a) passes
// main_len less each side's ring-global start, so the predicate compares global positions while
// the padding mask stays local.
__device__ __forceinline__ void bias_mask(ScoreTile& sc, int k0, int row_a, int L, int q_main,
                                          int k_main, int has_cross, float bias, int lane) {
  if (!has_cross && k0 + kBlockN <= L) return;
  const int t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = k0 + n * 8 + t4 * 2 + (e & 1);
      const int qpos = e < 2 ? row_a : row_a + 8;
      if (has_cross && ((qpos >= q_main) != (kpos >= k_main))) sc[n][e] += bias;
      if (kpos >= L) sc[n][e] = kNegInf;
    }
  }
}

// The online-softmax update with one tile of base-2 logits, then O += P V over the swizzled bf16
// V tile tV. P is rounded to bf16 for the product; the row sums take it in fp32.
__device__ __forceinline__ void softmax_pv(RowState& st, const ScoreTile& sc, const bf16* tV,
                                           int lane) {
  // the new running max per row, reduced over the 4 threads of a row
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[n][0], sc[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[n][2], sc[n][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  const float corr[2] = {exp2f(st.m[0] - mx[0]), exp2f(st.m[1] - mx[1])};
  st.m[0] = mx[0];
  st.m[1] = mx[1];

  uint32_t pf[kBlockN / 16][4];
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
    const float p0 = exp2f(sc[n][0] - mx[0]), p1 = exp2f(sc[n][1] - mx[0]);
    const float p2 = exp2f(sc[n][2] - mx[1]), p3 = exp2f(sc[n][3] - mx[1]);
    rs[0] += p0 + p1;
    rs[1] += p2 + p3;
    pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
    pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
  st.l[0] = st.l[0] * corr[0] + rs[0];
  st.l[1] = st.l[1] * corr[1] + rs[1];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
    st.o[n][0] *= corr[0];
    st.o[n][1] *= corr[0];
    st.o[n][2] *= corr[1];
    st.o[n][3] *= corr[1];
  }

#pragma unroll
  for (int ks = 0; ks < kBlockN / 16; ++ks) {
#pragma unroll
    for (int dp = 0; dp < kHeadDim / 16; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, tV + swz(ks * 16 + (((lane >> 3) & 1) << 3) + (lane & 7),
                                     dp * 2 + (lane >> 4)));
      mma_bf16(st.o[2 * dp], pf[ks], bv[0], bv[1]);
      mma_bf16(st.o[2 * dp + 1], pf[ks], bv[2], bv[3]);
    }
  }
}

// The block's pipeline over one head's keys.
//   load_kv(buf, row0)      issues the cp.async copies of the K/V tile from key row0 into
//                           buffer buf (0 or 1);
//   prepare_q()             runs once the raw Q tile is in sQ: each warp turns its 16 rows into
//                           the A fragments its score functor reads;
//   scores(buf, k0, sc)     fills sc with the base-2 logits of the K tile in buffer buf, whose
//                           first key is k0, biased and masked.
// sV holds the two bf16 V buffers the softmax/P.V update reads.
template <class LoadKV, class PrepareQ, class Scores>
__device__ __forceinline__ void flash_rows(RowState& st, bf16* sQ, const bf16* qp,
                                           long long q_row_stride, int q0, int L, const bf16* sV,
                                           LoadKV&& load_kv, PrepareQ&& prepare_q,
                                           Scores&& scores) {
  const int tid = threadIdx.x, lane = tid & 31;
  load_tile<kBlockM, kThreads>(sQ, qp, q_row_stride, q0, L, tid);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait_prev();  // the Q tile has landed; K/V tile 0 may still be in flight
  __syncthreads();
  prepare_q();

#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) st.o[n][0] = st.o[n][1] = st.o[n][2] = st.o[n][3] = 0.f;
  st.m[0] = st.m[1] = kNegInf;
  st.l[0] = st.l[1] = 0.f;

  const int n_tiles = (L + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) load_kv(buf ^ 1, (j + 1) * kBlockN);
    cp_async_commit();  // an empty group on the last tile keeps the wait count uniform
    cp_async_wait_prev();
    __syncthreads();
    ScoreTile sc;
    scores(buf, j * kBlockN, sc);
    softmax_pv(st, sc, sV + buf * kTileElems, lane);
    __syncthreads();  // the next iteration refills the buffers read here
  }
}

// The epilogue: full row sums, then out = o / max(l, 1e-20) into (B, L, H, 128) for the thread's
// rows below L, and the lse = m ln2 + log(max(l, 1e-20)) rows into lse (the (b, h) row of a
// (B*H, L) array).
__device__ __forceinline__ void store_rows(RowState& st, bf16* __restrict__ out,
                                           float* __restrict__ lse, int b, int h, int L, int H,
                                           int row_a, int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
  }
  const int rows[2] = {row_a, row_a + 8};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    const float l_safe = fmaxf(st.l[r], 1e-20f);
    const float inv = 1.f / l_safe;
    bf16* orow = out + ((static_cast<long long>(b) * L + rows[r]) * H + h) * kHeadDim;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t4 * 2) =
          pack_bf16(st.o[n][2 * r] * inv, st.o[n][2 * r + 1] * inv);
    }
    if (t4 == 0) lse[rows[r]] = st.m[r] * kLn2 + logf(l_safe);
  }
}

}  // namespace
