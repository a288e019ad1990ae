// K1: flash-attention forward for Hopper (sm_90a), bf16 in and out, fp32 softmax state; and
// K7a, the same body on one ring chunk.
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
// K7a, the ring-chunk forward, is K1's function and K1's block on one Q chunk against one K/V
// shard of a sequence that ring attention splits across a mesh. It replaces _flash_fwd_kernel with
// dyn_offsets=True (pallas_attention.py:73-82, :103), reached through flash_chunk_fwd (:789). The
// cross-segment predicate compares RING-GLOBAL positions (local row plus the chunk's start, q_off
// or k_off) with main_len; the padding mask (keys >= L) stays local. The offsets enter the score
// step as two local boundaries, q_main = main_len - q_off among the block's query rows and
// k_main = main_len - k_off among the keys (K1 passes main_len for both). A chunk is a view into
// the whole (B, L, H, D) sequence: its three tensor maps are encoded at the view's base and
// strides with the chunk's own length as L, so TMA zero-fills past the chunk and never reads the
// next chunk's rows as keys. Its outputs are the normalised chunk attention, rounded to bf16 as
// the TPU kernel's output and written as fp32 (the JAX entry upcasts that output; here the
// epilogue does, which saves a separate cast pass over it), and the chunk's lse rows, which the
// ring merges in fp32. A row that the -1e30 bias hides from the whole
// shard ends with m ln2 ~ -1e30 (or, in a ragged chunk, with the -1e30 of the padded keys, whose
// zero-filled V gives out = 0), so its lse stays far below -1e29 and its merge weight is 0.

#include "flash_fwd_sm90.cuh"

namespace {

// One block: the 128 query rows [q0, q0 + 128) of head h of batch b; the cond boundary is local
// row q_main among queries, k_main among keys. out: bf16 (K1) or fp32 (K7a).
template <class T>
__device__ __forceinline__ void fwd_block(unsigned char* smem, const CUtensorMap* tq,
                                          const CUtensorMap* tk, const CUtensorMap* tv,
                                          T* __restrict__ out, float* __restrict__ lse, int L,
                                          int H, int q_main, int k_main, int has_cross,
                                          float cross_bias_log2, float scale_log2) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * sm90::kBlockM;
  sm90::flash_ws(
      smem, (L + sm90::kBlockN - 1) / sm90::kBlockN,
      [&](uint32_t dst, uint32_t bar) { sm90::load_rows(dst, tq, bar, h, q0, b); },
      [&](uint32_t dst, uint32_t bar, int k0) { sm90::load_rows(dst, tk, bar, h, k0, b); },
      [&](uint32_t dst, uint32_t bar, int k0) { sm90::load_rows(dst, tv, bar, h, k0, b); },
      [](bf16*, int, int) {},
      [&](uint32_t q, uint32_t k, sm90::ScoreTile& sc) { sm90::qk_wgmma(sc, q, k); },
      [&](int k0, int wg, uint32_t, sm90::ScoreTile& sc) {
        const int t = threadIdx.x & 127;
        sm90::fence_acc(sc);
        sm90::scale_bias_mask(sc, scale_log2, k0, sm90::first_row(q0, wg, t), L, q_main, k_main,
                              has_cross, cross_bias_log2, t & 31);
      },
      [&](int wg, int t, sm90::RowState& st) {
        sm90::store_rows(st, out, b, h, L, H, sm90::first_row(q0, wg, t), t & 31,
                         lse + static_cast<long long>(bh) * L);
      });
}

// K1
__global__ void __launch_bounds__(sm90::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                 float* __restrict__ lse, int L, int H, int main_len, int has_cross,
                 float cross_bias_log2, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  fwd_block(smem_raw, &tq, &tk, &tv, out, lse, L, H, main_len, main_len, has_cross,
            cross_bias_log2, scale_log2);
}

// K7a
__global__ void __launch_bounds__(sm90::kThreads, 1)
flash_chunk_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, float* __restrict__ out,
                       float* __restrict__ lse, int L, int H, int q_main, int k_main,
                       int has_cross, float cross_bias_log2, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  fwd_block(smem_raw, &tq, &tk, &tv, out, lse, L, H, q_main, k_main, has_cross, cross_bias_log2,
            scale_log2);
}

// The three tensor maps of a launch: L rows of q, k and v at their (batch, row, head) strides.
bool encode_fwd_maps(CUtensorMap (&m)[3], const void* q, const void* k, const void* v, int B,
                     int L, int H, const long long (&st)[9]) {
  return B >= 1 && L >= 1 && H >= 1 && sm90::encode_rows(&m[0], q, B, L, H, st[0], st[1], st[2]) &&
         sm90::encode_rows(&m[1], k, B, L, H, st[3], st[4], st[5]) &&
         sm90::encode_rows(&m[2], v, B, L, H, st[6], st[7], st[8]);
}

template <class Kernel, class... Args>
int launch(Kernel kernel, int B, int L, int H, void* stream, Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + sm90::kBlockM - 1) / sm90::kBlockM, B * H);
  kernel<<<grid, sm90::kThreads, sm90::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

const float kScaleLog2 = sm90::kLog2e / sqrtf(static_cast<float>(kHeadDim));

}  // namespace

// q, k, v: (B, L, H, 128) bf16 with unit stride on the last dim, strides that are multiples of 8
// elements and 16-byte aligned bases (TMA's terms). out: contiguous (B, L, H, 128), bf16 for K1
// and fp32 for K7a. lse: contiguous (B*H, L) fp32. Each entry launches on `stream` and returns the first cudaError
// (cudaErrorInvalidValue if a tensor map cannot be encoded); neither synchronises.
extern "C" int flash_fwd_bf16_d128(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int B, int L, int H, long long q_sb, long long q_sl,
                                   long long q_sh, long long k_sb, long long k_sl, long long k_sh,
                                   long long v_sb, long long v_sl, long long v_sh, int main_len,
                                   float cross_bias, void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  CUtensorMap m[3];
  if (!encode_fwd_maps(m, q, k, v, B, L, H, st)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(flash_fwd_kernel, B, L, H, stream, m[0], m[1], m[2], static_cast<bf16*>(out),
                static_cast<float*>(lse), L, H, main_len, cross_bias != 0.f ? 1 : 0,
                cross_bias * sm90::kLog2e, kScaleLog2);
}

// K7a: as flash_fwd_bf16_d128 on one ring chunk of L rows (q, k and v views of the whole
// sequence); main_len is the ring-global cond boundary and q_off / k_off the ring-global
// positions of the chunk's first query and first key.
extern "C" int flash_chunk_fwd_bf16_d128(const void* q, const void* k, const void* v, void* out,
                                         void* lse, int B, int L, int H, long long q_sb,
                                         long long q_sl, long long q_sh, long long k_sb,
                                         long long k_sl, long long k_sh, long long v_sb,
                                         long long v_sl, long long v_sh, int main_len, int q_off,
                                         int k_off, float cross_bias, void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  CUtensorMap m[3];
  if (!encode_fwd_maps(m, q, k, v, B, L, H, st)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(flash_chunk_fwd_kernel, B, L, H, stream, m[0], m[1], m[2],
                static_cast<float*>(out), static_cast<float*>(lse), L, H, main_len - q_off,
                main_len - k_off, cross_bias != 0.f ? 1 : 0, cross_bias * sm90::kLog2e,
                kScaleLog2);
}
