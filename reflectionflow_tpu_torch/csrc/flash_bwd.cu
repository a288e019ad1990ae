// K6a and K6b: flash-attention backward for Hopper (sm_90a), bf16 in and out, fp32 sums; and K7b
// and K7c, the ring-chunk backward.
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
// (6 * B * H * L^2 * D operations), K6b four (8 * B * H * L^2 * D): at the training shape
// (8, 2560, 24, 128) that is 0.97 and 1.29 TFLOP, 0.98 and 1.30 ms at the bf16 peak, against
// ~0.3 GB of operands, far above the card's ~295 FLOP/byte balance point.
//
// Design (K6a, K6b and K7c), against that bound and against what the TPU version leans on:
//   * The TPU kernels hold a head's whole K/V (K6a) or Q/dO (K6b) stripe in VMEM, padded to
//     512-row blocks. Here both run the warp-specialised Hopper pipeline of flash_bwd_sm90.cuh:
//     a block owns (batch*head, 128 rows), K6a its q rows, K6b its keys, held in shared memory
//     for the whole block (K6a: Q and dO; K6b: K and V); one producer thread streams the other
//     side in 64-row tiles (K6a: K and V; K6b: Q and dO) by TMA through a 3-stage mbarrier ring,
//     so the next tiles' copies run under this tile's math. Two consumer warpgroups of 64 rows
//     run the score products (S and dP, or their transposes for K6b) as m64n64k16 wgmma from
//     shared memory, and the gradient products as m64n128k16 wgmma with p and ds, rounded to bf16
//     in the accumulator layout, as the A operand in registers.
//   * Two kernels, no atomics: K6a writes each dQ tile once, K6b each dK/dV tile once, so the
//     results are the same every run. A fused kernel would compute S and dP once (5 products
//     against 3 + 4) but add dQ with fp32 atomics in an order that changes from run to run.
//   * lse and delta: K6a's consumer threads read their rows' values once into registers; K6b
//     needs 64 of each per streamed tile, which a producer warp copies into the stage with plain
//     loads (a (B*H, L) fp32 row starts on 16 bytes only when L % 4 == 0, and TMA needs that).
//   * q, k, v and dO are read in their (B, L, H, D) layout through 4-D tensor maps at the
//     caller's strides (views of the qkv panels); rows past L arrive as zeros from TMA and are
//     never stored, K6a masks keys >= L, K6b zeroes p for q rows >= L. No padding copies.
//   * Exponentials run in the base-2 domain (exp2 of logits pre-scaled by log2(e)).
//
// K7c is K6b's function and K6b's block on one ring chunk; K7b keeps the earlier design: one
// block of four warps owns 64 q rows and streams 64-key tiles through cp.async double buffers,
// all three products on mma.sync m16n8k16 fed by ldmatrix from XOR-swizzled tiles, ds in
// registers as the last product's A operand. They replace _flash_dq_kernel and _flash_dkv_kernel
// with dyn_offsets=True (pallas_attention.py:136-160, :185-212), reached through flash_chunk_bwd
// (:815): one Q chunk against one K/V shard, from the RING-GLOBAL lse and delta rows (the chunk's
// contiguous (B*H, L) slice of them), so the chunks' dQ/dK/dV sum to the full-sequence gradients.
// The cross-segment predicate compares global positions with main_len; the padding masks stay
// local. The offsets enter as the local boundaries q_main = main_len - q_off among query rows and
// k_main = main_len - k_off among keys: in K7c's score tile the rows are keys and the columns
// query rows, so its row boundary is k_main and its column boundary q_main. K7c's four tensor
// maps are encoded at the chunk views' bases and strides with the chunk's own length as L, so
// TMA zero-fills past the chunk instead of reading the next chunk's rows.
//
// Built without --use_fast_math (ops/kernel_build.py): exp2f keeps its accurate path (not the
// forward header's ex2.approx), so p and ds round to bf16 where the plain version's do, at a cost
// that is small next to the products. On an H100 the outputs stay within 4e-3 of max |ref|
// (PERF.md).

#include "flash_bwd_sm90.cuh"

namespace {

constexpr int kRows = 64;  // K7b: q rows per block
constexpr int kWarps = kRows / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kDqKeys = 64;  // K7b: keys per streamed K/V tile
constexpr int kDqSmemBytes = (2 * kRows + 4 * kDqKeys) * kHeadDim * 2;  // Q, dO + 2 x (K, V)
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

// K7b: one block owns (batch*head, 64 q rows) and streams K/V tiles of 64 keys. The cond
// boundary is local row q_main among queries, k_main among keys.
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

// K7b
__global__ void __launch_bounds__(kThreads)
flash_chunk_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dq, int L, int H, Strides s, int q_main, int k_main,
                          int has_cross, float cross_bias_log2, float scale_log2, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  dq_block(smem_raw, q, k, v, dout, lse, delta, dq, L, H, s, q_main, k_main, has_cross,
           cross_bias_log2, scale_log2, scale);
}

Strides make_strides(const long long* st) {
  return Strides{st[0], st[1], st[2], st[3], st[4],  st[5],
                 st[6], st[7], st[8], st[9], st[10], st[11]};
}

// K6a
__global__ void __launch_bounds__(sm90::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int L, int H, int main_len, int has_cross,
                    float cross_bias_log2, float scale_log2, float scale) {
  // not smem_raw: K7b's declaration of the same dynamic shared memory asks for another alignment
  extern __shared__ __align__(1024) unsigned char smem_ws[];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * sm90::kBlockM;
  sm90::dq_ws(
      smem_ws,
      [&](uint32_t dst, uint32_t bar) {
        sm90::mbar_expect_tx(bar, 2 * sm90::kTileBytes);
        sm90::tma_rows<sm90::kBlockM>(dst, &tq, bar, h, q0, b);
        sm90::tma_rows<sm90::kBlockM>(dst + sm90::kTileBytes, &to, bar, h, q0, b);
      },
      [&](uint32_t dst, uint32_t bar, int k0) {
        sm90::mbar_expect_tx(bar, 2 * sm90::kHalfTileBytes);
        sm90::tma_rows<sm90::kTileRows>(dst, &tk, bar, h, k0, b);
        sm90::tma_rows<sm90::kTileRows>(dst + sm90::kHalfTileBytes, &tv, bar, h, k0, b);
      },
      lse, delta, dq, q0, b, h, L, H, main_len, has_cross, cross_bias_log2, scale_log2, scale);
}

// K6b and K7c: dK and dV of the block's 128 keys; the cond boundary is local row q_main among
// queries, k_main among keys.
__device__ __forceinline__ void dkv_block(unsigned char* smem, const CUtensorMap* tq,
                                          const CUtensorMap* tk, const CUtensorMap* tv,
                                          const CUtensorMap* to, const float* __restrict__ lse,
                                          const float* __restrict__ delta, bf16* __restrict__ dk,
                                          bf16* __restrict__ dv, int L, int H, int q_main,
                                          int k_main, int has_cross, float cross_bias_log2,
                                          float scale_log2, float scale) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * sm90::kBlockM;
  const float* lrow = lse + static_cast<long long>(bh) * L;
  const float* drow = delta + static_cast<long long>(bh) * L;
  sm90::dkv_ws(
      smem,
      [&](uint32_t dst, uint32_t bar) {
        sm90::mbar_expect_tx(bar, 2 * sm90::kTileBytes);
        sm90::tma_rows<sm90::kBlockM>(dst, tk, bar, h, k0, b);
        sm90::tma_rows<sm90::kBlockM>(dst + sm90::kTileBytes, tv, bar, h, k0, b);
      },
      [&](uint32_t dst, uint32_t bar, int q0) {
        sm90::mbar_expect_tx(bar, 2 * sm90::kHalfTileBytes);
        sm90::tma_rows<sm90::kTileRows>(dst, tq, bar, h, q0, b);
        sm90::tma_rows<sm90::kTileRows>(dst + sm90::kHalfTileBytes, to, bar, h, q0, b);
      },
      [&](float* vals, int q0, int lane) {  // lse * log2 e, then delta, of rows q0 .. q0 + 63
        for (int i = lane; i < sm90::kTileRows; i += 32) {
          const bool ok = q0 + i < L;
          vals[i] = ok ? lrow[q0 + i] * sm90::kLog2e : 0.f;
          vals[sm90::kTileRows + i] = ok ? drow[q0 + i] : 0.f;
        }
      },
      dk, dv, k0, b, h, L, H, k_main, q_main, has_cross, cross_bias_log2, scale_log2, scale);
}

// K6b
__global__ void __launch_bounds__(sm90::kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H, int main_len,
                     int has_cross, float cross_bias_log2, float scale_log2, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_ws[];
  dkv_block(smem_ws, &tq, &tk, &tv, &to, lse, delta, dk, dv, L, H, main_len, main_len, has_cross,
            cross_bias_log2, scale_log2, scale);
}

// K7c
__global__ void __launch_bounds__(sm90::kThreads, 1)
flash_chunk_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to, const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int L, int H, int q_main, int k_main,
                           int has_cross, float cross_bias_log2, float scale_log2, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_ws[];
  dkv_block(smem_ws, &tq, &tk, &tv, &to, lse, delta, dk, dv, L, H, q_main, k_main, has_cross,
            cross_bias_log2, scale_log2, scale);
}

// The four tensor maps of a K6 or K7c launch: the resident pair at 128-row boxes, the streamed
// pair at 64-row boxes (q, k, v, dout strides in `st`, three each).
bool encode_bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                     const void* dout, int B, int L, int H, const long long* st, bool q_resident) {
  const int rq = q_resident ? sm90::kBlockM : sm90::kTileRows;
  const int rk = q_resident ? sm90::kTileRows : sm90::kBlockM;
  return sm90::encode_rows(&m[0], q, B, L, H, st[0], st[1], st[2], rq) &&
         sm90::encode_rows(&m[1], k, B, L, H, st[3], st[4], st[5], rk) &&
         sm90::encode_rows(&m[2], v, B, L, H, st[6], st[7], st[8], rk) &&
         sm90::encode_rows(&m[3], dout, B, L, H, st[9], st[10], st[11], rq);
}

template <class Kernel, class... Args>
int launch_ws(Kernel kernel, int B, int L, int H, void* stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::kBwdSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + sm90::kBlockM - 1) / sm90::kBlockM, B * H);
  kernel<<<grid, sm90::kThreads, sm90::kBwdSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int L, int H, const long long* strides,
              int q_main, int k_main, float cross_bias, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_chunk_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kRows - 1) / kRows, B * H);
  const float scale = 1.f / sqrtf(static_cast<float>(kHeadDim));
  flash_chunk_bwd_dq_kernel<<<grid, kThreads, kDqSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), L, H, make_strides(strides),
      q_main, k_main, cross_bias != 0.f ? 1 : 0, cross_bias * kLog2e, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout: (B, L, H, 128) bf16 with unit stride on the last dim, strides that are
// multiples of 8 elements and 16-byte aligned bases (TMA's terms for K6a, K6b and K7c; K7b needs
// only 16-byte aligned rows); `strides` holds their (batch, row, head) element strides in that
// order (12 values). lse, delta: contiguous (B*H, L) fp32. dq, dk, dv: contiguous (B, L, H, 128)
// bf16. Each launches on `stream` and returns the first cudaError (cudaErrorInvalidValue if a
// tensor map cannot be encoded); none synchronises. The chunk entries
// (K7b, K7c) take the ring-global cond boundary main_len and the ring-global positions q_off /
// k_off of the chunk's first query and first key; lse and delta are the ring-global rows.
extern "C" int flash_bwd_dq_bf16_d128(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int L, int H, const long long* strides,
                                      int main_len, float cross_bias, void* stream) {
  CUtensorMap m[4];
  if (B < 1 || L < 1 || H < 1 || !encode_bwd_maps(m, q, k, v, dout, B, L, H, strides, true))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_ws(flash_bwd_dq_kernel, B, L, H, stream, m[0], m[1], m[2], m[3],
                   static_cast<const float*>(lse), static_cast<const float*>(delta),
                   static_cast<bf16*>(dq), L, H, main_len, cross_bias != 0.f ? 1 : 0,
                   cross_bias * kLog2e, kLog2e / sqrtf(static_cast<float>(kHeadDim)),
                   1.f / sqrtf(static_cast<float>(kHeadDim)));
}

extern "C" int flash_bwd_dkv_bf16_d128(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int L, int H,
                                       const long long* strides, int main_len, float cross_bias,
                                       void* stream) {
  CUtensorMap m[4];
  if (B < 1 || L < 1 || H < 1 || !encode_bwd_maps(m, q, k, v, dout, B, L, H, strides, false))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_ws(flash_bwd_dkv_kernel, B, L, H, stream, m[0], m[1], m[2], m[3],
                   static_cast<const float*>(lse), static_cast<const float*>(delta),
                   static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, H, main_len,
                   cross_bias != 0.f ? 1 : 0, cross_bias * kLog2e,
                   kLog2e / sqrtf(static_cast<float>(kHeadDim)),
                   1.f / sqrtf(static_cast<float>(kHeadDim)));
}

extern "C" int flash_chunk_bwd_dq_bf16_d128(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dq, int B, int L, int H,
                                            const long long* strides, int main_len, int q_off,
                                            int k_off, float cross_bias, void* stream) {
  return launch_dq(q, k, v, dout, lse, delta, dq, B, L, H, strides,
                   main_len - q_off, main_len - k_off, cross_bias, stream);
}

extern "C" int flash_chunk_bwd_dkv_bf16_d128(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse, const void* delta,
                                             void* dk, void* dv, int B, int L, int H,
                                             const long long* strides, int main_len, int q_off,
                                             int k_off, float cross_bias, void* stream) {
  CUtensorMap m[4];
  if (B < 1 || L < 1 || H < 1 || !encode_bwd_maps(m, q, k, v, dout, B, L, H, strides, false))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_ws(flash_chunk_bwd_dkv_kernel, B, L, H, stream, m[0], m[1], m[2], m[3],
                   static_cast<const float*>(lse), static_cast<const float*>(delta),
                   static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, H, main_len - q_off,
                   main_len - k_off, cross_bias != 0.f ? 1 : 0, cross_bias * kLog2e,
                   kLog2e / sqrtf(static_cast<float>(kHeadDim)),
                   1.f / sqrtf(static_cast<float>(kHeadDim)));
}
