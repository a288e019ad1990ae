// K6a and K6b: flash-attention backward for Hopper (sm_90a), bf16 in and out, fp32 sums.
//
// Replaces reflectionflow_tpu/ops/pallas_attention.py::_flash_dq_kernel (K6a, :126) and
// ::_flash_dkv_kernel (K6b, :175), the TPU kernels behind the custom VJP of
// joint_attention(impl="pallas") (`_bwd_impl` :638). Both recompute the probabilities
// from the forward's logsumexp rows instead of storing the (L, L) matrix:
//   p  = exp(q.k^T * scale + cross bias - lse)     (keys >= L masked in K6a, q rows >= L in K6b)
//   dp = dO.v^T,   ds = p * (dp - delta),   delta = rowsum(dO * O) (computed by the caller)
//   K6a: dQ = bf16(ds) . K * scale
//   K6b: dV = bf16(p)^T . dO,   dK = bf16(ds)^T . Q * scale
// with ds and p rounded to bf16 exactly where the TPU kernels round them (:166, :216, :221)
// and scale applied at the end, so the fp32 plain version with the same casts is a tight
// yardstick.
//
// What bounds them on an H100: tensor-core FLOPs. K6a does three products per (q, k) pair
// (6 * L^2 * D per head), K6b four (8 * L^2 * D): at the training shape (8, 2560, 24, 128)
// that is 0.97 and 1.29 TFLOP against ~0.3 GB of operands, far above the card's ~295
// FLOP/byte balance point.
//
// Design, against that bound and against what the TPU version leans on:
//   * The TPU kernels hold a head's whole K/V (K6a) or Q/dO (K6b) stripe in VMEM, padded to
//     512-row blocks. Here a block owns 64 rows (four warps of 16): K6a its q rows, K6b its
//     k rows. The rows it owns sit in shared memory for the whole block; the other side
//     streams through double-buffered shared-memory tiles filled with cp.async, so the next
//     tile's copy overlaps this tile's math.
//   * Two kernels, no atomics: K6a writes each dQ tile once, K6b each dK/dV tile once, so the
//     results are deterministic. (A single kernel with atomic dQ adds is a later choice.)
//   * All four products run on mma.sync m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix
//     from XOR-swizzled tiles. The recomputed S and dP stay in registers; p and ds are packed
//     to bf16 in the accumulator layout, which is the A-operand layout of the next product, so
//     they never touch shared memory. A operands of the resident rows are re-read from shared
//     memory per tile instead of held in registers, which keeps the accumulators unspilled.
//   * q, k, v and dO are read in their (B, L, H, D) layout through strides (views of the qkv
//     panels); the ragged tail is masked in the kernel (rows past L load as zeros and are
//     never stored, K6a masks keys >= L, K6b zeroes p for q rows >= L). No padding copies.
//   * Exponentials run in the base-2 domain (exp2 of logits pre-scaled by log2(e)).
// wgmma, TMA and warp specialisation are left for later work.
//
// K7b and K7c, the ring-chunk backward, are the same bodies with two more runtime scalars. They
// replace _flash_dq_kernel and _flash_dkv_kernel with dyn_offsets=True (pallas_attention.py:136-160,
// :185-212), reached through flash_chunk_bwd (:815): one Q chunk against one K/V shard, from the
// RING-GLOBAL lse and delta rows, so the chunks' dQ/dK/dV sum to the full-sequence gradients. The
// cross-segment predicate compares global positions with main_len; the padding masks stay local.
// The offsets enter as the local boundaries q_main = main_len - q_off and k_main = main_len - k_off,
// so K6a/K6b (both main_len) compile as before.
//
// Built without --use_fast_math (ops/kernel_build.py): exp2f keeps its accurate path, so p
// and ds round to bf16 where the plain version's do, at a cost that is small next to the four
// products. On an H100 the outputs stay within 4e-3 of max |ref| (PERF.md).

#include "flash_common.cuh"

namespace {

constexpr int kRows = 64;              // resident rows per block (q rows in K6a, k rows in K6b)
constexpr int kWarps = kRows / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kDqKeys = 64;  // K6a: keys per streamed K/V tile
constexpr int kKvQ = 32;     // K6b: q rows per streamed Q/dO tile
constexpr int kDqSmemBytes = (2 * kRows + 4 * kDqKeys) * kHeadDim * 2;  // Q, dO + 2 x (K, V)
constexpr int kKvSmemBytes = (2 * kRows + 4 * kKvQ) * kHeadDim * 2      // K, V + 2 x (Q, dO)
                             + 4 * kKvQ * 4;                            // 2 x (lse, delta)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh, ob, ol, oh;
};

// A fragments (16 rows x 16 of D, chunk pair kk) of this warp's resident rows.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* tile, int warp, int lane,
                                       int kk) {
  ldmatrix_x4(r, tile + swz(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
}

// B fragments of a row-major [n][D] tile read as its transpose: rows np*16.., D chunk pair kk.
__device__ __forceinline__ void load_b_nt(uint32_t (&r)[4], const bf16* tile, int lane, int np,
                                          int kk) {
  ldmatrix_x4(r, tile + swz(np * 16 + ((lane >> 4) << 3) + (lane & 7), kk * 2 + ((lane >> 3) & 1)));
}

// B fragments of a row-major [k][D] tile as is: k rows ks*16.., D columns dp*16...
__device__ __forceinline__ void load_b_nn(uint32_t (&r)[4], const bf16* tile, int lane, int ks,
                                          int dp) {
  ldmatrix_x4_trans(r, tile + swz(ks * 16 + (((lane >> 3) & 1) << 3) + (lane & 7), dp * 2 + (lane >> 4)));
}

// K6a / K7b: one block owns (batch*head, 64 q rows) and streams K/V tiles of 64 keys. The cond
// boundary is local row q_main among queries, k_main among keys (both main_len for K6a).
__device__ __forceinline__ void dq_block(unsigned char* smem_raw, const bf16* __restrict__ q,
                                         const bf16* __restrict__ k, const bf16* __restrict__ v,
                                         const bf16* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, bf16* __restrict__ dq,
                                         int L, int H, const Strides& s, int q_main, int k_main,
                                         int has_cross, float cross_bias_log2, float scale_log2,
                                         float scale) {
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + kRows * kHeadDim;
  bf16* sK = sO + kRows * kHeadDim;  // [2][kDqKeys][kHeadDim]
  bf16* sV = sK + 2 * kDqKeys * kHeadDim;
  constexpr int kTile = kDqKeys * kHeadDim;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const bf16* qp = q + b * s.qb + h * s.qh;
  const bf16* kp = k + b * s.kb + h * s.kh;
  const bf16* vp = v + b * s.vb + h * s.vh;
  const bf16* op = dout + b * s.ob + h * s.oh;

  load_tile<kRows, kThreads>(sQ, qp, s.ql, q0, L, tid);
  load_tile<kRows, kThreads>(sO, op, s.ol, q0, L, tid);
  load_tile<kDqKeys, kThreads>(sK, kp, s.kl, 0, L, tid);
  load_tile<kDqKeys, kThreads>(sV, vp, s.vl, 0, L, tid);
  cp_async_commit();

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};  // this thread's q rows
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < L;
    lse_r[r] = ok ? lse[(long long)bh * L + rows[r]] * kLog2e : 0.f;
    dlt_r[r] = ok ? delta[(long long)bh * L + rows[r]] : 0.f;
  }

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int n_tiles = (L + kDqKeys - 1) / kDqKeys;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<kDqKeys, kThreads>(sK + (buf ^ 1) * kTile, kp, s.kl, (j + 1) * kDqKeys, L, tid);
      load_tile<kDqKeys, kThreads>(sV + (buf ^ 1) * kTile, vp, s.vl, (j + 1) * kDqKeys, L, tid);
    }
    cp_async_commit();  // an empty group on the last tile keeps the wait count uniform
    cp_async_wait_prev();
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    const bf16* tK = sK + buf * kTile;
    const bf16* tV = sV + buf * kTile;
    float sc[kDqKeys / 8][4], dp[kDqKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kDqKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      uint32_t qa[4], oa[4];
      load_a(qa, sQ, warp, lane, kk);
      load_a(oa, sO, warp, lane, kk);
#pragma unroll
      for (int np = 0; np < kDqKeys / 16; ++np) {
        uint32_t bk[4], bv[4];
        load_b_nt(bk, tK, lane, np, kk);
        mma_bf16(sc[2 * np], qa, bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], qa, bk[2], bk[3]);
        load_b_nt(bv, tV, lane, np, kk);
        mma_bf16(dp[2 * np], oa, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], oa, bv[2], bv[3]);
      }
    }

    // p = exp(s * scale + bias - lse), keys >= L masked; ds = p (dp - delta) rounded to bf16
    const int k0 = j * kDqKeys;
    const bool masked = has_cross || k0 + kDqKeys > L;
    uint32_t dsf[kDqKeys / 16][4];
#pragma unroll
    for (int n = 0; n < kDqKeys / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = sc[n][e] * scale_log2;
        if (masked) {
          const int kpos = k0 + n * 8 + t4 * 2 + (e & 1);
          if (has_cross && ((rows[r] >= q_main) != (kpos >= k_main))) x += cross_bias_log2;
          if (kpos >= L) x = kNegInf;
        }
        const float p = exp2f(x - lse_r[r]);
        ds[e] = p * (dp[n][e] - dlt_r[r]);
      }
      dsf[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K
#pragma unroll
    for (int ks = 0; ks < kDqKeys / 16; ++ks) {
#pragma unroll
      for (int dpi = 0; dpi < kHeadDim / 16; ++dpi) {
        uint32_t bk[4];
        load_b_nn(bk, tK, lane, ks, dpi);
        mma_bf16(acc[2 * dpi], dsf[ks], bk[0], bk[1]);
        mma_bf16(acc[2 * dpi + 1], dsf[ks], bk[2], bk[3]);
      }
    }
    __syncthreads();  // the next iteration refills the buffer read here
  }

  // epilogue: dQ * scale, stored (B, L, H, D)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    bf16* drow = dq + (((long long)b * L + rows[r]) * H + h) * kHeadDim;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      *reinterpret_cast<uint32_t*>(drow + n * 8 + t4 * 2) =
          pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

// K6b / K7c: one block owns (batch*head, 64 k rows) and streams Q/dO tiles of 32 q rows with
// their lse and delta values; q_main and k_main as in dq_block.
__device__ __forceinline__ void dkv_block(unsigned char* smem_raw, const bf16* __restrict__ q,
                                          const bf16* __restrict__ k, const bf16* __restrict__ v,
                                          const bf16* __restrict__ dout,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, bf16* __restrict__ dk,
                                          bf16* __restrict__ dv, int L, int H, const Strides& s,
                                          int q_main, int k_main, int has_cross,
                                          float cross_bias_log2, float scale_log2, float scale) {
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kRows * kHeadDim;
  bf16* sQ = sV + kRows * kHeadDim;  // [2][kKvQ][kHeadDim]
  bf16* sO = sQ + 2 * kKvQ * kHeadDim;
  float* sL = reinterpret_cast<float*>(sO + 2 * kKvQ * kHeadDim);  // [2][kKvQ]
  float* sD = sL + 2 * kKvQ;
  constexpr int kTile = kKvQ * kHeadDim;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const bf16* qp = q + b * s.qb + h * s.qh;
  const bf16* kp = k + b * s.kb + h * s.kh;
  const bf16* vp = v + b * s.vb + h * s.vh;
  const bf16* op = dout + b * s.ob + h * s.oh;
  const float* lp = lse + (long long)bh * L;
  const float* dlp = delta + (long long)bh * L;

  // lse and delta of q rows [q0, q0 + kKvQ): threads 0..31 copy lse, 32..63 delta
  auto load_rows = [&](int slot, int q0) {
    if (tid < 2 * kKvQ) {
      const int i = tid % kKvQ;
      const bool valid = q0 + i < L;
      const float* src = tid < kKvQ ? lp : dlp;
      float* dst = (tid < kKvQ ? sL : sD) + slot * kKvQ + i;
      cp_async_4(dst, valid ? src + q0 + i : src, valid);
    }
  };

  load_tile<kRows, kThreads>(sK, kp, s.kl, k0, L, tid);
  load_tile<kRows, kThreads>(sV, vp, s.vl, k0, L, tid);
  load_tile<kKvQ, kThreads>(sQ, qp, s.ql, 0, L, tid);
  load_tile<kKvQ, kThreads>(sO, op, s.ol, 0, L, tid);
  load_rows(0, 0);
  cp_async_commit();

  const int rows[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};  // this thread's k rows
  float dka[kHeadDim / 8][4], dva[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  }
  const int n_tiles = (L + kKvQ - 1) / kKvQ;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<kKvQ, kThreads>(sQ + (buf ^ 1) * kTile, qp, s.ql, (j + 1) * kKvQ, L, tid);
      load_tile<kKvQ, kThreads>(sO + (buf ^ 1) * kTile, op, s.ol, (j + 1) * kKvQ, L, tid);
      load_rows(buf ^ 1, (j + 1) * kKvQ);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 k rows x 32 q rows
    const bf16* tQ = sQ + buf * kTile;
    const bf16* tO = sO + buf * kTile;
    const float* tL = sL + buf * kKvQ;
    const float* tD = sD + buf * kKvQ;
    float st[kKvQ / 8][4], dpt[kKvQ / 8][4];
#pragma unroll
    for (int n = 0; n < kKvQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, sK, warp, lane, kk);
      load_a(va, sV, warp, lane, kk);
#pragma unroll
      for (int np = 0; np < kKvQ / 16; ++np) {
        uint32_t bq[4], bo[4];
        load_b_nt(bq, tQ, lane, np, kk);
        mma_bf16(st[2 * np], ka, bq[0], bq[1]);
        mma_bf16(st[2 * np + 1], ka, bq[2], bq[3]);
        load_b_nt(bo, tO, lane, np, kk);
        mma_bf16(dpt[2 * np], va, bo[0], bo[1]);
        mma_bf16(dpt[2 * np + 1], va, bo[2], bo[3]);
      }
    }

    // p^T = exp(s * scale + bias - lse), 0 for q rows >= L; ds^T = p^T (dp^T - delta)
    const int q0 = j * kKvQ;
    uint32_t pf[kKvQ / 16][4], dsf[kKvQ / 16][4];
#pragma unroll
    for (int n = 0; n < kKvQ / 8; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t4 * 2 + (e & 1);
        const int qpos = q0 + col;
        float x = st[n][e] * scale_log2;
        if (has_cross && ((rows[e >> 1] >= k_main) != (qpos >= q_main))) x += cross_bias_log2;
        p[e] = qpos < L ? exp2f(x - tL[col] * kLog2e) : 0.f;
        ds[e] = p[e] * (dpt[n][e] - tD[col]);
      }
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsf[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO and dK += dS^T Q
#pragma unroll
    for (int ks = 0; ks < kKvQ / 16; ++ks) {
#pragma unroll
      for (int dpi = 0; dpi < kHeadDim / 16; ++dpi) {
        uint32_t bo[4], bq[4];
        load_b_nn(bo, tO, lane, ks, dpi);
        mma_bf16(dva[2 * dpi], pf[ks], bo[0], bo[1]);
        mma_bf16(dva[2 * dpi + 1], pf[ks], bo[2], bo[3]);
        load_b_nn(bq, tQ, lane, ks, dpi);
        mma_bf16(dka[2 * dpi], dsf[ks], bq[0], bq[1]);
        mma_bf16(dka[2 * dpi + 1], dsf[ks], bq[2], bq[3]);
      }
    }
    __syncthreads();
  }

  // epilogue: dK * scale and dV, stored (B, L, H, D)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    const long long off = (((long long)b * L + rows[r]) * H + h) * kHeadDim;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + t4 * 2) =
          pack_bf16(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + t4 * 2) =
          pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

#define DQ_PARAMS                                                                              \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,           \
      const bf16 *__restrict__ dout, const float *__restrict__ lse,                             \
      const float *__restrict__ delta, bf16 *__restrict__ dq, int L, int H, Strides s,          \
      int q_main, int k_main, int has_cross, float cross_bias_log2, float scale_log2, float scale
#define DKV_PARAMS                                                                             \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,           \
      const bf16 *__restrict__ dout, const float *__restrict__ lse,                             \
      const float *__restrict__ delta, bf16 *__restrict__ dk, bf16 *__restrict__ dv, int L,     \
      int H, Strides s, int q_main, int k_main, int has_cross, float cross_bias_log2,           \
      float scale_log2, float scale

// K6a: q_main and k_main are both main_len (the entry passes it twice).
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(DQ_PARAMS) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  dq_block(smem_raw, q, k, v, dout, lse, delta, dq, L, H, s, q_main, q_main, has_cross,
           cross_bias_log2, scale_log2, scale);
}

// K7b
__global__ void __launch_bounds__(kThreads) flash_chunk_bwd_dq_kernel(DQ_PARAMS) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  dq_block(smem_raw, q, k, v, dout, lse, delta, dq, L, H, s, q_main, k_main, has_cross,
           cross_bias_log2, scale_log2, scale);
}

// K6b
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(DKV_PARAMS) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  dkv_block(smem_raw, q, k, v, dout, lse, delta, dk, dv, L, H, s, q_main, q_main, has_cross,
            cross_bias_log2, scale_log2, scale);
}

// K7c
__global__ void __launch_bounds__(kThreads) flash_chunk_bwd_dkv_kernel(DKV_PARAMS) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  dkv_block(smem_raw, q, k, v, dout, lse, delta, dk, dv, L, H, s, q_main, k_main, has_cross,
            cross_bias_log2, scale_log2, scale);
}

Strides make_strides(const long long* st) {
  return Strides{st[0], st[1], st[2], st[3], st[4],  st[5],
                 st[6], st[7], st[8], st[9], st[10], st[11]};
}

int launch_dq(void (*kernel)(DQ_PARAMS), const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta, void* dq, int B, int L, int H,
              const long long* strides, int q_main, int k_main, float cross_bias, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kRows - 1) / kRows, B * H);
  const float scale = 1.f / sqrtf(static_cast<float>(kHeadDim));
  kernel<<<grid, kThreads, kDqSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), L, H, make_strides(strides),
      q_main, k_main, cross_bias != 0.f ? 1 : 0, cross_bias * kLog2e, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv(void (*kernel)(DKV_PARAMS), const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta, void* dk, void* dv, int B,
               int L, int H, const long long* strides, int q_main, int k_main, float cross_bias,
               void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kKvSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kRows - 1) / kRows, B * H);
  const float scale = 1.f / sqrtf(static_cast<float>(kHeadDim));
  kernel<<<grid, kThreads, kKvSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, H,
      make_strides(strides), q_main, k_main, cross_bias != 0.f ? 1 : 0, cross_bias * kLog2e,
      scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout: (B, L, H, 128) bf16 with unit stride on the last dim and 16-byte aligned
// rows; `strides` holds their (batch, row, head) element strides in that order (12 values).
// lse, delta: contiguous (B*H, L) fp32. dq, dk, dv: contiguous (B, L, H, 128) bf16. Each
// launches on `stream` and returns cudaGetLastError(); none synchronises. The chunk entries
// (K7b, K7c) take the ring-global cond boundary main_len and the ring-global positions q_off /
// k_off of the chunk's first query and first key; lse and delta are the ring-global rows.
extern "C" int flash_bwd_dq_bf16_d128(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int L, int H, const long long* strides,
                                      int main_len, float cross_bias, void* stream) {
  return launch_dq(flash_bwd_dq_kernel, q, k, v, dout, lse, delta, dq, B, L, H, strides, main_len,
                   main_len, cross_bias, stream);
}

extern "C" int flash_bwd_dkv_bf16_d128(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int L, int H,
                                       const long long* strides, int main_len, float cross_bias,
                                       void* stream) {
  return launch_dkv(flash_bwd_dkv_kernel, q, k, v, dout, lse, delta, dk, dv, B, L, H, strides,
                    main_len, main_len, cross_bias, stream);
}

extern "C" int flash_chunk_bwd_dq_bf16_d128(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dq, int B, int L, int H,
                                            const long long* strides, int main_len, int q_off,
                                            int k_off, float cross_bias, void* stream) {
  return launch_dq(flash_chunk_bwd_dq_kernel, q, k, v, dout, lse, delta, dq, B, L, H, strides,
                   main_len - q_off, main_len - k_off, cross_bias, stream);
}

extern "C" int flash_chunk_bwd_dkv_bf16_d128(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse, const void* delta,
                                             void* dk, void* dv, int B, int L, int H,
                                             const long long* strides, int main_len, int q_off,
                                             int k_off, float cross_bias, void* stream) {
  return launch_dkv(flash_chunk_bwd_dkv_kernel, q, k, v, dout, lse, delta, dk, dv, B, L, H,
                    strides, main_len - q_off, main_len - k_off, cross_bias, stream);
}
