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
// with every product and sum of the rotation rounded to bf16, then runs K1's attention:
// scale 1/sqrt(D), the structural cross-segment bias (q and k on opposite sides of
// `main_len` get `cross_bias`, applied only when non-zero), keys >= L masked, p rounded to
// bf16 before P.V, out = acc / max(l, 1e-20). No lse (serving only, no backward).
// The fp32 scale multiplies before the cast; K2 (norm_rope.cu) casts first and multiplies
// by the bf16 scale, so the two transforms are written separately.
//
// What bounds it on an H100: tensor-core FLOPs, as K1 (4 * L^2 * D * H * B; at L = 5632,
// B = 2, H = 24 that is 0.78 TFLOP against ~70 MB of q/k/v/out).
//
// Design:
//   * Two launches per call. K9a normalises and rotates K once per (token, head) into a bf16
//     (B, L, H, 128) workspace (one warp per row, no shared memory). The TPU kernel builds
//     that K stripe once per head in VMEM and reuses it across the head's q tiles because its
//     grid runs them in order; the H100 runs a head's q tiles concurrently, so the stripe
//     goes through device memory (2 x 28 MB at the corrector shape, ~3% of the attention
//     kernel's time at the card's memory rate).
//   * K9b is K1's attention (flash_fwd_tile.cuh: one block per (batch*head, 128 query rows),
//     64-key K/V tiles double-buffered with cp.async, mma.sync m16n8k16 bf16 from XOR-swizzled
//     ldmatrix tiles, P in registers) with the q transform as the pipeline's Q step: after the
//     raw Q tile lands in shared memory each warp normalises and rotates its own 16 rows in place (lane i holds
//     elements 4i..4i+3; the rotation partner 64 elements away is lane i^16), so the
//     transformed q never goes to device memory. This keeps K1's register budget.
//   * The ragged tail is masked in the kernel; nothing is padded.
//   * Built without --use_fast_math: the norm uses correctly rounded intrinsics so the bf16
//     values round as the plain version's do.
// The fully fused form (K tiles transformed after they land in shared memory, no workspace)
// and wgmma/TMA are left for later work.

#include "flash_fwd_tile.cuh"

namespace {

constexpr int kSmemBytes = (kBlockM * kHeadDim + 4 * kTileElems) * 2;  // Q + 2 x (K, V)
constexpr int kPrepWarps = 8;  // K9a: rows per block

// The per-row transform on one warp: lane holds x[4*lane .. 4*lane + 3] of a 128-wide row
// at position `pos`; the row's table values c/s are in the same lanes. Overwrites x.
__device__ __forceinline__ void norm_rot(float (&x)[4], const float (&c)[4], const float (&s)[4],
                                         const float* __restrict__ scale, int pos, int txt_len,
                                         float eps, int lane) {
  float ss = __fmul_rn(x[0], x[0]);
#pragma unroll
  for (int j = 1; j < 4; ++j) ss = __fadd_rn(ss, __fmul_rn(x[j], x[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, static_cast<float>(kHeadDim)), eps));
  const float4 sc = *reinterpret_cast<const float4*>(scale + (pos < txt_len ? 0 : kHeadDim) + 4 * lane);
  const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
  float y[4], partner[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = round_bf16(__fmul_rn(__fmul_rn(x[j], r), scv[j]));
#pragma unroll
  for (int j = 0; j < 4; ++j) partner[j] = __shfl_xor_sync(0xffffffffu, y[j], 16);
  // lanes 0..15 hold y1 (out = y1 c - y2 s), lanes 16..31 hold y2 (out = y2 c + y1 s)
  const bool first = lane < 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float a = round_bf16(__fmul_rn(y[j], c[j]));
    const float p = round_bf16(__fmul_rn(partner[j], s[j]));
    x[j] = round_bf16(first ? __fsub_rn(a, p) : __fadd_rn(a, p));
  }
}

// K9a: normalise and rotate every (token, head) row of raw k into kn (B, L, H, 128).
__global__ void __launch_bounds__(kPrepWarps * 32)
nr_prep_k_kernel(const bf16* __restrict__ k, long long kb, long long kl, long long kh,
                 const bf16* __restrict__ cos, long long cs, const bf16* __restrict__ sin,
                 long long ss, const float* __restrict__ scale_k, bf16* __restrict__ kn, int L,
                 int H, long long n_items, int txt_len, float eps) {
  const long long item = static_cast<long long>(blockIdx.x) * kPrepWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(item % H);
  const long long row = item / H;
  const int b = static_cast<int>(row / L), l = static_cast<int>(row % L);
  float x[4], c[4], s[4];
  load4(k + b * kb + l * kl + h * kh + 4 * lane, x);
  load4(cos + l * cs + 4 * lane, c);
  load4(sin + l * ss + 4 * lane, s);
  norm_rot(x, c, s, scale_k, l, txt_len, eps, lane);
  store4(kn + (row * H + h) * kHeadDim + 4 * lane, x);
}

// K9b: K1's attention over raw q (transformed in the kernel) and the transformed kn.
__global__ void __launch_bounds__(kThreads)
flash_fwd_nr_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kn,
                    const bf16* __restrict__ v, const bf16* __restrict__ cos, long long cs,
                    const bf16* __restrict__ sin, long long ss, const float* __restrict__ scale_q,
                    bf16* __restrict__ out, int L, int H, Strides s, int txt_len, int main_len,
                    int has_cross, float cross_bias_log2, float scale_log2, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBlockM * kHeadDim;  // [2][kBlockN][kHeadDim]
  bf16* sV = sK + 2 * kTileElems;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBlockM;
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const bf16* kp = kn + b * s.kb + h * s.kh;
  const bf16* vp = v + b * s.vb + h * s.vh;
  uint32_t qf[kHeadDim / 16][4];
  RowState st;
  flash_rows(
      st, sQ, q + b * s.qb + h * s.qh, s.ql, q0, L, sV,
      [&](int buf, int row0) {
        load_tile<kBlockN, kThreads>(sK + buf * kTileElems, kp, s.kl, row0, L, tid);
        load_tile<kBlockN, kThreads>(sV + buf * kTileElems, vp, s.vl, row0, L, tid);
      },
      [&] {
        // each warp normalises and rotates its own 16 raw q rows in place
        for (int r = 0; r < 16; ++r) {
          const int row = warp * 16 + r, pos = q0 + row;
          bf16* p = sQ + swz(row, lane >> 1) + (lane & 1) * 4;
          float x[4], c[4] = {0.f, 0.f, 0.f, 0.f}, sn[4] = {0.f, 0.f, 0.f, 0.f};
          load4(p, x);
          if (pos < L) {
            load4(cos + pos * cs + 4 * lane, c);
            load4(sin + pos * ss + 4 * lane, sn);
          }
          norm_rot(x, c, sn, scale_q, pos, txt_len, eps, lane);
          store4(p, x);
        }
        __syncwarp();
        load_q_frags(qf, sQ, warp, lane);
      },
      [&](int buf, int k0, ScoreTile& sc) {
        qk_bf16(sc, qf, sK + buf * kTileElems, lane);
        scale_tile(sc, scale_log2);
        bias_mask(sc, k0, row_a, L, main_len, main_len, has_cross, cross_bias_log2, lane);
      });
  store_rows(st, out, nullptr, b, h, L, H, row_a, lane);
}

}  // namespace

// q, k, v: (B, L, H, 128) bf16 raw projections with unit stride on the last dim and 16-byte
// aligned rows. cos, sin: (L, 128) bf16 split-layout tables with row strides cs/ss.
// scale_q, scale_k: contiguous (2, 128) fp32 norm scales [rows < txt_len, the rest].
// kn: contiguous (B, L, H, 128) bf16 workspace. out: contiguous (B, L, H, 128) bf16.
// Launches K9a then K9b on `stream` and returns the first cudaError; does not synchronise.
extern "C" int flash_fwd_nr_bf16_d128(const void* q, const void* k, const void* v, const void* cos,
                                      long long cs, const void* sin, long long ss,
                                      const void* scale_q, const void* scale_k, void* kn, void* out,
                                      int B, int L, int H, long long q_sb, long long q_sl,
                                      long long q_sh, long long k_sb, long long k_sl, long long k_sh,
                                      long long v_sb, long long v_sl, long long v_sh, int txt_len,
                                      int main_len, float cross_bias, float eps, void* stream) {
  if (B < 1 || L < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_items = static_cast<long long>(B) * L * H;
  const long long prep_blocks = (n_items + kPrepWarps - 1) / kPrepWarps;
  if (prep_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  nr_prep_k_kernel<<<static_cast<unsigned>(prep_blocks), kPrepWarps * 32, 0, st>>>(
      static_cast<const bf16*>(k), k_sb, k_sl, k_sh, static_cast<const bf16*>(cos), cs,
      static_cast<const bf16*>(sin), ss, static_cast<const float*>(scale_k),
      static_cast<bf16*>(kn), L, H, n_items, txt_len, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_fwd_nr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long kn_l = static_cast<long long>(H) * kHeadDim;
  const Strides s{q_sb, q_sl, q_sh, L * kn_l, kn_l, kHeadDim, v_sb, v_sl, v_sh};
  const dim3 grid((L + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_nr_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kn), static_cast<const bf16*>(v),
      static_cast<const bf16*>(cos), cs, static_cast<const bf16*>(sin), ss,
      static_cast<const float*>(scale_q), static_cast<bf16*>(out), L, H, s, txt_len, main_len,
      cross_bias != 0.f ? 1 : 0, cross_bias * kLog2e, kLog2e / sqrtf(static_cast<float>(kHeadDim)),
      eps);
  return static_cast<int>(cudaGetLastError());
}
