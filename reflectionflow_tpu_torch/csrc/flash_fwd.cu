// K1: flash-attention forward for Hopper (sm_90a), bf16 in and out, fp32 softmax state.
//
// Replaces reflectionflow_tpu/ops/pallas_attention.py::_flash_fwd_kernel, the TPU
// kernel behind joint_attention(impl="pallas"): online-softmax attention over the
// joint [txt | img] sequence with scale 1/sqrt(D), a structural cross-segment bias
// (q and k on opposite sides of `main_len` get `cross_bias`, applied only when it is
// non-zero), keys >= L masked with -1e30, p rounded to bf16 before P.V, and the
// logsumexp rows lse = m + log(max(l, 1e-20)).
//
// What bounds it on an H100: tensor-core FLOPs. One call at FLUX.1-dev 1024px is
// 4 * L^2 * D * H * B ~= 0.26 TFLOP per batch element (L = 4608, D = 128, H = 24)
// against ~2.4 MB of K/V per head, far above the card's ~295 FLOP/byte balance point.
//
// Design, against that bound and against what the TPU version leans on:
//   * The TPU kernel keeps a head's whole K/V stripe in VMEM and pads L on the host.
//     Here one block owns (batch*head, 128 query rows) and runs the warp-specialised
//     Hopper pipeline of flash_fwd_sm90.cuh: one producer thread brings Q once and
//     128-key K/V tiles through a two-stage mbarrier ring by TMA, so the logits never
//     leave registers and the next tiles' copies run under this tile's math; two consumer
//     warpgroups of 64 rows run Q K^T and P V on wgmma (bf16 in, fp32 accumulate), each
//     overlapping one tile's softmax with the previous tile's P V. K1 is the pipeline's
//     plainest user: no Q step, qk_wgmma as the score step, and the lse rows (which K6a/K6b
//     read) in the epilogue.
//   * q, k and v are read in their (B, L, H, D) layout through 4-D tensor maps at the
//     caller's strides, which saves the (B*H, L, D) transpose copy the TPU path gets for
//     free from XLA; the wrapper refuses a layout TMA cannot read.
//   * The ragged tail is masked in the kernel: rows past L arrive as zeros from TMA and
//     are never stored; no host-side padding.
//   * Softmax runs in the base-2 domain (exp2 of logits pre-scaled by log2(e)).
//
// K7a, the ring-chunk forward, stays on the earlier design of flash_fwd_tile.cuh (eight warps of
// 16 rows, 64-key tiles by cp.async, mma.sync from ldmatrix). It replaces _flash_fwd_kernel with
// dyn_offsets=True (pallas_attention.py:73-82, :103), reached through flash_chunk_fwd (:789):
// one Q chunk against one K/V shard of a sequence that ring attention splits across a mesh. The
// cross-segment predicate compares RING-GLOBAL positions (local row plus the chunk's start, q_off
// or k_off) with main_len; the padding mask (keys >= L) stays local. The offsets enter as the
// local boundaries q_main = main_len - q_off and k_main = main_len - k_off. Its output is the
// normalised chunk attention in bf16 and the chunk's lse rows, which the ring merges in fp32.

#include "flash_fwd_sm90.cuh"
#include "flash_fwd_tile.cuh"

namespace {

constexpr int kTileSmemBytes = (kBlockM * kHeadDim + 4 * kTileElems) * 2;  // K7a: Q + 2 x (K, V)

// K1
__global__ void __launch_bounds__(sm90::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                 float* __restrict__ lse, int L, int H, int main_len, int has_cross,
                 float cross_bias_log2, float scale_log2) {
  // not smem_raw: K7a's declaration of the same dynamic shared memory asks for another alignment
  extern __shared__ __align__(1024) unsigned char smem_ws[];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * sm90::kBlockM;
  sm90::flash_ws(
      smem_ws, (L + sm90::kBlockN - 1) / sm90::kBlockN,
      [&](uint32_t dst, uint32_t bar) { sm90::load_rows(dst, &tq, bar, h, q0, b); },
      [&](uint32_t dst, uint32_t bar, int k0) { sm90::load_rows(dst, &tk, bar, h, k0, b); },
      [&](uint32_t dst, uint32_t bar, int k0) { sm90::load_rows(dst, &tv, bar, h, k0, b); },
      [](bf16*, int, int) {},
      [&](uint32_t q, uint32_t k, sm90::ScoreTile& sc) { sm90::qk_wgmma(sc, q, k); },
      [&](int k0, int wg, uint32_t, sm90::ScoreTile& sc) {
        const int t = threadIdx.x & 127;
        sm90::fence_acc(sc);
        sm90::scale_bias_mask(sc, scale_log2, k0, sm90::first_row(q0, wg, t), L, main_len,
                              has_cross, cross_bias_log2, t & 31);
      },
      [&](int wg, int t, sm90::RowState& st) {
        sm90::store_rows(st, out, b, h, L, H, sm90::first_row(q0, wg, t), t & 31,
                         lse + static_cast<long long>(bh) * L);
      });
}

// K7a: one block's rows of a ring chunk; the cond boundary is local row q_main among queries,
// k_main among keys.
__global__ void __launch_bounds__(kThreads)
flash_chunk_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                       int L, int H, Strides s, int q_main, int k_main, int has_cross,
                       float cross_bias_log2, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBlockM * kHeadDim;  // [2][kBlockN][kHeadDim]
  bf16* sV = sK + 2 * kTileElems;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBlockM;
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const bf16* kp = k + b * s.kb + h * s.kh;
  const bf16* vp = v + b * s.vb + h * s.vh;
  uint32_t qf[kHeadDim / 16][4];
  RowState st;
  flash_rows(
      st, sQ, q + b * s.qb + h * s.qh, s.ql, q0, L, sV,
      [&](int buf, int row0) {
        load_tile<kBlockN, kThreads>(sK + buf * kTileElems, kp, s.kl, row0, L, tid);
        load_tile<kBlockN, kThreads>(sV + buf * kTileElems, vp, s.vl, row0, L, tid);
      },
      [&] { load_q_frags(qf, sQ, warp, lane); },
      [&](int buf, int k0, ScoreTile& sc) {
        qk_bf16(sc, qf, sK + buf * kTileElems, lane);
        scale_tile(sc, scale_log2);
        bias_mask(sc, k0, row_a, L, q_main, k_main, has_cross, cross_bias_log2, lane);
      });
  store_rows(st, out, lse + static_cast<long long>(bh) * L, b, h, L, H, row_a, lane);
}

}  // namespace

// q, k, v: (B, L, H, 128) bf16 with unit stride on the last dim, strides that are multiples of 8
// elements and 16-byte aligned bases (TMA's terms; K7a needs only 16-byte aligned rows). out:
// contiguous (B, L, H, 128) bf16. lse: contiguous (B*H, L) fp32. Each entry launches on `stream`
// and returns the first cudaError (K1: cudaErrorInvalidValue if a tensor map cannot be
// encoded); neither synchronises.
extern "C" int flash_fwd_bf16_d128(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int B, int L, int H, long long q_sb, long long q_sl,
                                   long long q_sh, long long k_sb, long long k_sl, long long k_sh,
                                   long long v_sb, long long v_sl, long long v_sh, int main_len,
                                   float cross_bias, void* stream) {
  if (B < 1 || L < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!sm90::encode_rows(&tq, q, B, L, H, q_sb, q_sl, q_sh) ||
      !sm90::encode_rows(&tk, k, B, L, H, k_sb, k_sl, k_sh) ||
      !sm90::encode_rows(&tv, v, B, L, H, v_sb, v_sl, v_sh))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + sm90::kBlockM - 1) / sm90::kBlockM, B * H);
  flash_fwd_kernel<<<grid, sm90::kThreads, sm90::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), L, H, main_len,
      cross_bias != 0.f ? 1 : 0, cross_bias * sm90::kLog2e,
      sm90::kLog2e / sqrtf(static_cast<float>(kHeadDim)));
  return static_cast<int>(cudaGetLastError());
}

// K7a: as flash_fwd_bf16_d128 on one ring chunk; main_len is the ring-global cond boundary and
// q_off / k_off the ring-global positions of the chunk's first query and first key.
extern "C" int flash_chunk_fwd_bf16_d128(const void* q, const void* k, const void* v, void* out,
                                         void* lse, int B, int L, int H, long long q_sb,
                                         long long q_sl, long long q_sh, long long k_sb,
                                         long long k_sl, long long k_sh, long long v_sb,
                                         long long v_sl, long long v_sh, int main_len, int q_off,
                                         int k_off, float cross_bias, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_chunk_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides s{q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  const dim3 grid((L + kBlockM - 1) / kBlockM, B * H);
  flash_chunk_fwd_kernel<<<grid, kThreads, kTileSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), L, H, s, main_len - q_off,
      main_len - k_off, cross_bias != 0.f ? 1 : 0, cross_bias * kLog2e,
      kLog2e / sqrtf(static_cast<float>(kHeadDim)));
  return static_cast<int>(cudaGetLastError());
}
