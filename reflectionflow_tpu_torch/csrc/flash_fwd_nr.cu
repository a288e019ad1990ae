// K9: flash-attention forward with the serving QK-norm and split RoPE fused in, for
// Hopper (sm_90a), bf16 in and out, fp32 softmax state.
//
// Replaces reflectionflow_tpu/ops/pallas_attention.py::_flash_fwd_nr_kernel, the TPU kernel
// behind attn_impl="pallas_nr" (flash_attention_nr). It takes the RAW q/k/v projections of
// the joint [txt | img | cond] sequence and, per row of q and of k:
//   y = bf16(x * rsqrt(mean(x^2) + eps) * sc)      (fp32 until the one cast; sc is the fp32
//                                                   norm scale row 0 for positions < txt_len,
//                                                   row 1 after)
//   out[:64] = y1 * cos[:64] - y2 * sin[:64],  out[64:] = y2 * cos[64:] + y1 * sin[64:]
// with every product and sum of the rotation rounded to bf16, then attends: scale 1/sqrt(D),
// the structural cross-segment bias (q and k on opposite sides of `main_len` get
// `cross_bias`, applied only when non-zero), keys >= L masked, p rounded to bf16 before P.V,
// out = acc / max(l, 1e-20). No lse (serving only, no backward).
// The fp32 scale multiplies before the cast; K2 (norm_rope.cu) casts first and multiplies
// by the bf16 scale, so the two transforms are written separately.
//
// What bounds it on an H100: tensor-core FLOPs (4 * L^2 * D * H * B; at L = 5632, B = 2,
// H = 24 that is 0.78 TFLOP, 0.79 ms at the bf16 peak, against ~70 MB of q/k/v/out).
//
// Design:
//   * Two launches per call. K9a normalises and rotates K once per (token, head) into a bf16
//     (B, L, H, 128) workspace (16 lanes per row, no shared memory). The TPU kernel builds
//     that K stripe once per head in VMEM and reuses it across the head's q tiles because its
//     grid runs them in order. The H100 runs a head's q tiles concurrently (44 blocks a head
//     at L = 5632): transforming each K tile in every block would repeat the work 44 times a
//     head on the CUDA cores, beside the tensor-core work it must hide under. So the stripe
//     goes through device memory once: 69.2 MB written and read back at (2, 5632), about
//     42 us at the card's memory rate, against ~0.8 ms of attention.
//   * K9b runs the warp-specialised Hopper pipeline of flash_fwd_sm90.cuh: TMA brings raw Q,
//     the normed K from the workspace and V (read at their own strides through 4-D tensor
//     maps, so panel slices need no copy) into 128B-swizzled shared memory; two consumer
//     warpgroups run wgmma for Q K^T and P V, each overlapping one tile's softmax with the
//     previous tile's P V. The q transform is its Q step: once the raw
//     Q tile lands, each consumer warpgroup norms and rotates its own 64 rows in place, 16
//     lanes a row, each lane holding 4 columns of the first half and the same 4 of the second
//     half (the rotation partner of column d is d + 64: the same swizzled offset in the other
//     box), so the transformed q never goes to device memory.
//   * The ragged tail is masked in the kernel; nothing is padded.
//   * Built without --use_fast_math: the norm uses correctly rounded intrinsics so the bf16
//     values round as the plain version's do. The softmax alone takes ex2.approx (as K1 gets
//     from fast math).

#include "flash_fwd_sm90.cuh"

namespace {

constexpr int kPrepWarps = 8;  // K9a: 2 rows per warp, 16 rows per block

// The per-row transform, 16 lanes a row: lane i (0..15 within its half-warp) holds
// x1 = x[4i .. 4i + 3] and x2 = x[64 + 4i .. 64 + 4i + 3] of a 128-wide row at position pos,
// and the table values of the same columns (c1/s1, c2/s2). Overwrites x1 and x2. All 32 lanes
// must call it (the row's sum of squares is reduced by shuffles within each half-warp).
__device__ __forceinline__ void norm_rot(float (&x1)[4], float (&x2)[4], const float (&c1)[4],
                                         const float (&c2)[4], const float (&s1)[4],
                                         const float (&s2)[4], const float* __restrict__ scale,
                                         int pos, int txt_len, float eps, int i) {
  float ss = __fmul_rn(x1[0], x1[0]);
#pragma unroll
  for (int j = 1; j < 4; ++j) ss = __fadd_rn(ss, __fmul_rn(x1[j], x1[j]));
#pragma unroll
  for (int j = 0; j < 4; ++j) ss = __fadd_rn(ss, __fmul_rn(x2[j], x2[j]));
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, static_cast<float>(kHeadDim)), eps));
  const float* sc = scale + (pos < txt_len ? 0 : kHeadDim) + 4 * i;
  const float4 a = *reinterpret_cast<const float4*>(sc);
  const float4 b = *reinterpret_cast<const float4*>(sc + kHeadDim / 2);
  const float sa[4] = {a.x, a.y, a.z, a.w}, sb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float y1 = round_bf16(__fmul_rn(__fmul_rn(x1[j], r), sa[j]));
    const float y2 = round_bf16(__fmul_rn(__fmul_rn(x2[j], r), sb[j]));
    const float a1 = round_bf16(__fmul_rn(y1, c1[j])), b1 = round_bf16(__fmul_rn(y2, s1[j]));
    const float a2 = round_bf16(__fmul_rn(y2, c2[j])), b2 = round_bf16(__fmul_rn(y1, s2[j]));
    x1[j] = round_bf16(__fsub_rn(a1, b1));
    x2[j] = round_bf16(__fadd_rn(a2, b2));
  }
}

// The table values of columns 4i.. and 64 + 4i.. at position pos (zeros past L).
__device__ __forceinline__ void load_tables(const bf16* __restrict__ cos, long long cs,
                                            const bf16* __restrict__ sin, long long ss, int pos,
                                            bool valid, int i, float (&c1)[4], float (&c2)[4],
                                            float (&s1)[4], float (&s2)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) c1[j] = c2[j] = s1[j] = s2[j] = 0.f;
  if (!valid) return;
  const bf16* c = cos + pos * cs + 4 * i;
  const bf16* s = sin + pos * ss + 4 * i;
  load4(c, c1);
  load4(c + kHeadDim / 2, c2);
  load4(s, s1);
  load4(s + kHeadDim / 2, s2);
}

// K9a: normalise and rotate every (token, head) row of raw k into kn (B, L, H, 128).
__global__ void __launch_bounds__(kPrepWarps * 32)
nr_prep_k_kernel(const bf16* __restrict__ k, long long kb, long long kl, long long kh,
                 const bf16* __restrict__ cos, long long cs, const bf16* __restrict__ sin,
                 long long ss, const float* __restrict__ scale_k, bf16* __restrict__ kn, int L,
                 int H, long long n_items, int txt_len, float eps) {
  const int lane = threadIdx.x & 31, i = lane & 15;
  const long long item =
      (static_cast<long long>(blockIdx.x) * kPrepWarps + (threadIdx.x >> 5)) * 2 + (lane >> 4);
  const bool valid = item < n_items;  // every lane stays for the shuffles
  const long long it = valid ? item : 0;
  const int h = static_cast<int>(it % H);
  const long long row = it / H;
  const int b = static_cast<int>(row / L), l = static_cast<int>(row % L);
  const bf16* src = k + b * kb + l * kl + h * kh + 4 * i;
  float x1[4], x2[4], c1[4], c2[4], s1[4], s2[4];
  load4(src, x1);
  load4(src + kHeadDim / 2, x2);
  load_tables(cos, cs, sin, ss, l, true, i, c1, c2, s1, s2);
  norm_rot(x1, x2, c1, c2, s1, s2, scale_k, l, txt_len, eps, i);
  if (!valid) return;
  bf16* dst = kn + (row * H + h) * kHeadDim + 4 * i;
  store4(dst, x1);
  store4(dst + kHeadDim / 2, x2);
}

// K9b: attention over raw q (normed and rotated in the kernel), the normed kn and v.
__global__ void __launch_bounds__(sm90::kThreads, 1)
flash_fwd_nr_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ cos,
                    long long cs, const bf16* __restrict__ sin, long long ss,
                    const float* __restrict__ scale_q, bf16* __restrict__ out, int L, int H,
                    int txt_len, int main_len, int has_cross, float cross_bias_log2,
                    float scale_log2, float eps) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * sm90::kBlockM;
  sm90::flash_ws(
      smem_raw, (L + sm90::kBlockN - 1) / sm90::kBlockN,
      [&](uint32_t dst, uint32_t bar) { sm90::load_rows(dst, &tq, bar, h, q0, b); },
      [&](uint32_t dst, uint32_t bar, int k0) { sm90::load_rows(dst, &tk, bar, h, k0, b); },
      [&](uint32_t dst, uint32_t bar, int k0) { sm90::load_rows(dst, &tv, bar, h, k0, b); },
      [&](bf16* sq, int wg, int t) {
        // the warpgroup's 64 raw rows, two per warp at a time: half-warp lane>>4 takes a row,
        // lane i = lane & 15 its 16-byte chunk i/2 (half i&1) in both boxes
        const int lane = t & 31, i = lane & 15;
        for (int r = 0; r < 16; r += 2) {
          const int row = wg * sm90::kRowsWG + (t >> 5) * 16 + r + (lane >> 4), pos = q0 + row;
          bf16* p1 = sq + row * sm90::kBoxCols + (((i >> 1) ^ (row & 7)) << 3) + (i & 1) * 4;
          bf16* p2 = p1 + sm90::kBoxBytes / 2;  // the same offset in the second box
          float x1[4], x2[4], c1[4], c2[4], s1[4], s2[4];
          load4(p1, x1);
          load4(p2, x2);
          load_tables(cos, cs, sin, ss, pos, pos < L, i, c1, c2, s1, s2);
          norm_rot(x1, x2, c1, c2, s1, s2, scale_q, pos, txt_len, eps, i);
          store4(p1, x1);
          store4(p2, x2);
        }
      },
      [&](uint32_t q, uint32_t k, sm90::ScoreTile& sc) { sm90::qk_wgmma(sc, q, k); },
      [&](int k0, int wg, uint32_t, sm90::ScoreTile& sc) {
        const int t = threadIdx.x & 127;
        sm90::fence_acc(sc);
        sm90::scale_bias_mask(sc, scale_log2, k0, sm90::first_row(q0, wg, t), L, main_len,
                              main_len, has_cross, cross_bias_log2, t & 31);
      },
      [&](int wg, int t, sm90::RowState& st) {
        sm90::store_rows(st, out, b, h, L, H, sm90::first_row(q0, wg, t), t & 31);
      });
}

}  // namespace

// q, k, v: (B, L, H, 128) bf16 raw projections with unit stride on the last dim, strides that
// are multiples of 8 elements and 16-byte aligned bases (TMA's terms). cos, sin: (L, 128) bf16
// split-layout tables with row strides cs/ss. scale_q, scale_k: contiguous (2, 128) fp32 norm
// scales [rows < txt_len, the rest]. kn: contiguous (B, L, H, 128) bf16 workspace. out:
// contiguous (B, L, H, 128) bf16. Encodes the three tensor maps, launches K9a then K9b on
// `stream` and returns the first cudaError (cudaErrorInvalidValue if a map cannot be encoded);
// does not synchronise.
extern "C" int flash_fwd_nr_bf16_d128(const void* q, const void* k, const void* v, const void* cos,
                                      long long cs, const void* sin, long long ss,
                                      const void* scale_q, const void* scale_k, void* kn, void* out,
                                      int B, int L, int H, long long q_sb, long long q_sl,
                                      long long q_sh, long long k_sb, long long k_sl, long long k_sh,
                                      long long v_sb, long long v_sl, long long v_sh, int txt_len,
                                      int main_len, float cross_bias, float eps, void* stream) {
  if (B < 1 || L < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long kn_l = static_cast<long long>(H) * kHeadDim;
  CUtensorMap tq, tk, tv;
  if (!sm90::encode_rows(&tq, q, B, L, H, q_sb, q_sl, q_sh) ||
      !sm90::encode_rows(&tk, kn, B, L, H, L * kn_l, kn_l, kHeadDim) ||
      !sm90::encode_rows(&tv, v, B, L, H, v_sb, v_sl, v_sh))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_items = static_cast<long long>(B) * L * H;
  const long long prep_blocks = (n_items + 2 * kPrepWarps - 1) / (2 * kPrepWarps);
  if (prep_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  nr_prep_k_kernel<<<static_cast<unsigned>(prep_blocks), kPrepWarps * 32, 0, st>>>(
      static_cast<const bf16*>(k), k_sb, k_sl, k_sh, static_cast<const bf16*>(cos), cs,
      static_cast<const bf16*>(sin), ss, static_cast<const float*>(scale_k),
      static_cast<bf16*>(kn), L, H, n_items, txt_len, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_fwd_nr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sm90::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + sm90::kBlockM - 1) / sm90::kBlockM, B * H);
  flash_fwd_nr_kernel<<<grid, sm90::kThreads, sm90::kSmemBytes, st>>>(
      tq, tk, tv, static_cast<const bf16*>(cos), cs, static_cast<const bf16*>(sin), ss,
      static_cast<const float*>(scale_q), static_cast<bf16*>(out), L, H, txt_len, main_len,
      cross_bias != 0.f ? 1 : 0, cross_bias * sm90::kLog2e,
      sm90::kLog2e / sqrtf(static_cast<float>(kHeadDim)), eps);
  return static_cast<int>(cudaGetLastError());
}
