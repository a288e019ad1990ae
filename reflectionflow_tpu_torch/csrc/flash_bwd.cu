// K6a and K6b: flash-attention backward for Hopper (sm_90a), bf16 in and out, fp32 sums; and K7b
// and K7c, the same two kernels on one ring chunk.
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
// Design, against that bound and against what the TPU version leans on:
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
// K7b and K7c are K6a's and K6b's functions and blocks (dq_block, dkv_block) on one ring chunk,
// each with its own __global__. They replace _flash_dq_kernel and _flash_dkv_kernel with
// dyn_offsets=True (pallas_attention.py:136-160, :185-212), reached through flash_chunk_bwd
// (:815): one Q chunk against one K/V shard, from the RING-GLOBAL lse and delta rows (the chunk's
// contiguous (B*H, L) slice of them), so the chunks' dQ/dK/dV sum to the full-sequence gradients.
// The cross-segment predicate compares global positions with main_len; the padding masks stay
// local. The offsets enter as the local boundaries q_main = main_len - q_off among query rows and
// k_main = main_len - k_off among keys: in K7b's score tile the rows are query rows and the
// columns keys, in K7c's the rows are keys and the columns query rows. Their four tensor maps are
// encoded at the chunk views' bases and strides with the chunk's own length as L, so TMA
// zero-fills past the chunk instead of reading the next chunk's rows.
//
// Built without --use_fast_math (ops/kernel_build.py): exp2f keeps its accurate path (not the
// forward header's ex2.approx), so p and ds round to bf16 where the plain version's do, at a cost
// that is small next to the products. On an H100 the outputs stay within 4e-3 of max |ref|
// (PERF.md).

#include "flash_bwd_sm90.cuh"

namespace {

// K6a and K7b: dQ of the block's 128 query rows; the cond boundary is local row q_main among
// queries, k_main among keys.
__device__ __forceinline__ void dq_block(unsigned char* smem, const CUtensorMap* tq,
                                         const CUtensorMap* tk, const CUtensorMap* tv,
                                         const CUtensorMap* to, const float* __restrict__ lse,
                                         const float* __restrict__ delta, bf16* __restrict__ dq,
                                         int L, int H, int q_main, int k_main, int has_cross,
                                         float cross_bias_log2, float scale_log2, float scale) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * sm90::kBlockM;
  sm90::dq_ws(
      smem,
      [&](uint32_t dst, uint32_t bar) {
        sm90::mbar_expect_tx(bar, 2 * sm90::kTileBytes);
        sm90::tma_rows<sm90::kBlockM>(dst, tq, bar, h, q0, b);
        sm90::tma_rows<sm90::kBlockM>(dst + sm90::kTileBytes, to, bar, h, q0, b);
      },
      [&](uint32_t dst, uint32_t bar, int k0) {
        sm90::mbar_expect_tx(bar, 2 * sm90::kHalfTileBytes);
        sm90::tma_rows<sm90::kTileRows>(dst, tk, bar, h, k0, b);
        sm90::tma_rows<sm90::kTileRows>(dst + sm90::kHalfTileBytes, tv, bar, h, k0, b);
      },
      lse, delta, dq, q0, b, h, L, H, q_main, k_main, has_cross, cross_bias_log2, scale_log2,
      scale);
}

// K6a
__global__ void __launch_bounds__(sm90::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int L, int H, int main_len, int has_cross,
                    float cross_bias_log2, float scale_log2, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_ws[];
  dq_block(smem_ws, &tq, &tk, &tv, &to, lse, delta, dq, L, H, main_len, main_len, has_cross,
           cross_bias_log2, scale_log2, scale);
}

// K7b
__global__ void __launch_bounds__(sm90::kThreads, 1)
flash_chunk_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq, int L, int H,
                          int q_main, int k_main, int has_cross, float cross_bias_log2,
                          float scale_log2, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_ws[];
  dq_block(smem_ws, &tq, &tk, &tv, &to, lse, delta, dq, L, H, q_main, k_main, has_cross,
           cross_bias_log2, scale_log2, scale);
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

// Launches a K6 or K7 kernel on B * H x ceil(L / 128) blocks with its four tensor maps (q, k, v,
// dout at the `st` strides, three each), then `args`, then the scalars of `cross_bias` and the
// head dim: has_cross, the bias and the softmax scale in the base-2 domain, and 1 / sqrt(D). The
// resident pair of maps has 128-row boxes, the streamed pair 64-row boxes; q_resident: the dQ
// kernels (K6a, K7b).
template <class Kernel, class... Args>
int launch_bwd(Kernel kernel, bool q_resident, const void* q, const void* k, const void* v,
               const void* dout, int B, int L, int H, const long long* st, float cross_bias,
               void* stream, Args... args) {
  const int rq = q_resident ? sm90::kBlockM : sm90::kTileRows;
  const int rk = q_resident ? sm90::kTileRows : sm90::kBlockM;
  CUtensorMap m[4];
  if (B < 1 || L < 1 || H < 1 || !sm90::encode_rows(&m[0], q, B, L, H, st[0], st[1], st[2], rq) ||
      !sm90::encode_rows(&m[1], k, B, L, H, st[3], st[4], st[5], rk) ||
      !sm90::encode_rows(&m[2], v, B, L, H, st[6], st[7], st[8], rk) ||
      !sm90::encode_rows(&m[3], dout, B, L, H, st[9], st[10], st[11], rq))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::kBwdSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float root_d = sqrtf(static_cast<float>(kHeadDim));
  const dim3 grid((L + sm90::kBlockM - 1) / sm90::kBlockM, B * H);
  kernel<<<grid, sm90::kThreads, sm90::kBwdSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], args..., cross_bias != 0.f ? 1 : 0, cross_bias * sm90::kLog2e,
      sm90::kLog2e / root_d, 1.f / root_d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout: (B, L, H, 128) bf16 with unit stride on the last dim, strides that are
// multiples of 8 elements and 16-byte aligned bases (TMA's terms); `strides` holds their
// (batch, row, head) element strides in that order (12 values). lse, delta: contiguous
// (B*H, L) fp32. dq, dk, dv: contiguous (B, L, H, 128) bf16. Each launches on `stream` and
// returns the first cudaError (cudaErrorInvalidValue if a tensor map cannot be encoded); none
// synchronises. The chunk entries (K7b, K7c) take the ring-global cond boundary main_len and the
// ring-global positions q_off / k_off of the chunk's first query and first key; lse and delta are
// the ring-global rows.
extern "C" int flash_bwd_dq_bf16_d128(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int L, int H, const long long* strides,
                                      int main_len, float cross_bias, void* stream) {
  return launch_bwd(flash_bwd_dq_kernel, true, q, k, v, dout, B, L, H, strides, cross_bias,
                    stream, static_cast<const float*>(lse), static_cast<const float*>(delta),
                    static_cast<bf16*>(dq), L, H, main_len);
}

extern "C" int flash_bwd_dkv_bf16_d128(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int L, int H,
                                       const long long* strides, int main_len, float cross_bias,
                                       void* stream) {
  return launch_bwd(flash_bwd_dkv_kernel, false, q, k, v, dout, B, L, H, strides, cross_bias,
                    stream, static_cast<const float*>(lse), static_cast<const float*>(delta),
                    static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, H, main_len);
}

extern "C" int flash_chunk_bwd_dq_bf16_d128(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dq, int B, int L, int H,
                                            const long long* strides, int main_len, int q_off,
                                            int k_off, float cross_bias, void* stream) {
  return launch_bwd(flash_chunk_bwd_dq_kernel, true, q, k, v, dout, B, L, H, strides,
                    cross_bias, stream, static_cast<const float*>(lse),
                    static_cast<const float*>(delta), static_cast<bf16*>(dq), L, H,
                    main_len - q_off, main_len - k_off);
}

extern "C" int flash_chunk_bwd_dkv_bf16_d128(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse, const void* delta,
                                             void* dk, void* dv, int B, int L, int H,
                                             const long long* strides, int main_len, int q_off,
                                             int k_off, float cross_bias, void* stream) {
  return launch_bwd(flash_chunk_bwd_dkv_kernel, false, q, k, v, dout, B, L, H, strides,
                    cross_bias, stream, static_cast<const float*>(lse),
                    static_cast<const float*>(delta), static_cast<bf16*>(dk),
                    static_cast<bf16*>(dv), L, H, main_len - q_off, main_len - k_off);
}
