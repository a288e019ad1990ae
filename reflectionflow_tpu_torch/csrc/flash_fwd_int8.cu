// K8: flash-attention forward with int8 Q.K^T for Hopper (sm_90a), bf16 in and out.
//
// Replaces reflectionflow_tpu/ops/pallas_attention.py::_flash_fwd_int8_kernel, the TPU kernel
// behind attn_impl="pallas_int8" (flash_attention_int8), SageAttention-style:
//   * K is mean-centred over the sequence (the q.mean(K) shift of every logit of a row
//     cancels in the softmax), then quantized per token:
//       mean = sum(k) * (1/L); kc = k - mean; amax = max(max|kc|, 1e-12);
//       k8 = rint(kc * (127 / amax)) (round half to even); ks = amax * (1/127);
//   * each q row is quantized per token the same way (without centring), with the softmax
//     scale folded into its scale: qs = amax_q * (scale / 127);
//   * logits = float(int32 Q8.K8^T) * qs * ks, then the structural cross-segment bias (q and k
//     on opposite sides of `main_len` get `cross_bias`, applied only when non-zero), keys >= L
//     masked, online softmax in fp32, p rounded to bf16 for a bf16 P.V, and
//     out = acc / max(l, 1e-20). No lse (serving only, no backward).
//
// What bounds it on an H100: tensor-core operations. Q.K^T is 2 * L^2 * D * H * B int8
// operations at the 1979 TOP/s int8 peak and P.V the same count of bf16 FLOPs at 989 TFLOP/s,
// against ~70 MB of q/k/v/out at the corrector shape (B = 2, L = 5632, H = 24).
//
// Design:
//   * Two launches per call. K8a prepares K once per (batch, head), which takes two passes over
//     the head's rows (the mean, then the centred rows): a cluster of 8 blocks shares a head,
//     each block one slice of its rows, and the blocks add up the head's mean from each
//     other's slice sums through distributed shared memory. Its warps centre and quantize one
//     row each, with 8 rows' loads in flight a warp, writing an int8 (B*H, L, 128) workspace
//     and B*H rows of L fp32 scales (about 17 MB at the corrector shape). The TPU kernel
//     quantizes a head's K stripe once into VMEM because its grid runs the head's q tiles in
//     order; the H100 runs them concurrently, so the stripe goes through device memory. (With
//     one block a head and one row in flight a warp, K8a waited on memory latency.)
//   * K8b runs the warp-specialised Hopper pipeline of flash_fwd_sm90.cuh (one block per
//     (batch*head, 128 query rows): a producer thread, two wgmma consumer warpgroups of 64
//     rows, a two-stage mbarrier ring of 128-key tiles brought by TMA). Its seams:
//       - the Q step: once the raw bf16 Q tile lands, each warp quantizes its own 16 rows in
//         place into the int8 tile that box 0 then holds ([128][128 B], the 128B swizzle), with
//         the row scales kept in registers by the threads that own those rows;
//       - the K-tile source: one TMA box of 128 keys x 128 bytes from K8a's workspace (a 3-D
//         map, 128B swizzle, zeros past L) and the tile's 128 fp32 key scales (a 2-D map over
//         the heads' rows of scales, zeros past L; the rows are padded to a multiple of 4
//         values because a TMA box must start on 16 bytes) into the same kTileBytes stage, on
//         one "full" mbarrier;
//       - the score step: wgmma m64n128k32 s8 x s8 -> s32, both operands K-major from
//         shared-memory descriptors, into an int32 tile of its own; the finish dequantizes it
//         in the TPU kernel's order (float(acc) * qs * ks, each correctly rounded; the cross
//         bias in natural units; the key mask; then x log2(e)) into the pipeline's fp32 tile.
//     P.V stays bf16 on wgmma, as in K1.
//   * The ragged tail is masked in the kernel; nothing is padded.
//   * Built without --use_fast_math: the quantizers use correctly rounded division so the
//     int8 codes match the plain version's. The softmax alone takes ex2.approx.

#include <cooperative_groups.h>

#include "flash_fwd_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPrepThreads = 512;
constexpr int kPrepWarps = kPrepThreads / 32;
constexpr int kPrepBatch = 8;   // K8a: rows a warp keeps in flight
constexpr int kPrepSplit = 8;   // K8a: blocks (one cluster) per (batch, head)

// Per-token int8 of one 128-wide row held 4 values per lane: returns the four codes packed
// little-endian and sets amax = max(max|x|, 1e-12) (the same on every lane).
__device__ __forceinline__ uint32_t quant_row(const float (&x)[4], float& amax) {
  float a = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  amax = fmaxf(a, 1e-12f);
  const float f = __fdiv_rn(127.f, amax);
  uint32_t packed = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    packed |= (static_cast<uint32_t>(__float2int_rn(__fmul_rn(x[j], f))) & 0xffu) << (8 * j);
  return packed;
}

// A warp's rows l = l_begin + warp, + kPrepWarps, ... below l_end of one head, kPrepBatch at a
// time: the batch's loads are all issued before f(l, x) runs on each row in order, so a warp
// keeps kPrepBatch rows in flight.
template <class F>
__device__ __forceinline__ void for_rows(const bf16* base, long long kl, int l_begin, int l_end,
                                         int warp, F&& f) {
  for (int l0 = l_begin + warp; l0 < l_end; l0 += kPrepBatch * kPrepWarps) {
    uint2 raw[kPrepBatch];
#pragma unroll
    for (int i = 0; i < kPrepBatch; ++i) {
      const int l = l0 + i * kPrepWarps;
      if (l < l_end) raw[i] = *reinterpret_cast<const uint2*>(base + l * kl);
    }
#pragma unroll
    for (int i = 0; i < kPrepBatch; ++i) {
      const int l = l0 + i * kPrepWarps;
      if (l >= l_end) break;
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[i].x));
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[i].y));
      float x[4] = {a.x, a.y, c.x, c.y};
      f(l, x);
    }
  }
}

// float(v) for |v| < 2^22, exactly, on the FP32 pipe: v added to the bits of 1.5 * 2^23 (whose
// ulp is 1) is the float 1.5 * 2^23 + v. I2F runs on the slower conversion pipe, and the score
// step converts every int32 score.
__device__ __forceinline__ float int_to_float(int v) {
  return __fsub_rn(__int_as_float(v + 0x4B400000), 12582912.f);
}

// K8a: one cluster of kPrepSplit blocks per (batch, head), each on its own slice of the L rows:
// the column sums of its slice, the head's mean from the cluster's slice sums (read through
// distributed shared memory, slices in order, so the result does not depend on scheduling),
// then the centred per-token int8 rows of its slice into k8 (B*H, L, 128) and their scales into
// row bh of ks (B*H rows, ks_ld apart).
__global__ void __cluster_dims__(kPrepSplit, 1, 1) __launch_bounds__(kPrepThreads)
int8_prep_k_kernel(const bf16* __restrict__ k, long long kb, long long kl, long long kh,
                   int8_t* __restrict__ k8, float* __restrict__ ks, long long ks_ld, int L, int H,
                   float inv_len) {
  __shared__ float part[kPrepWarps][kHeadDim];
  __shared__ float slice_sum[kHeadDim];
  __shared__ float mean[kHeadDim];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x / kPrepSplit, b = bh / H, h = bh % H;
  const int rows = (L + kPrepSplit - 1) / kPrepSplit;
  const int l_begin = min(L, static_cast<int>(cluster.block_rank()) * rows);
  const int l_end = min(L, l_begin + rows);
  const bf16* base = k + b * kb + h * kh + 4 * lane;

  // column sums of the slice: warp w sums its rows in order, then the warps in order
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for_rows(base, kl, l_begin, l_end, warp, [&](int, float (&x)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += x[j];
  });
#pragma unroll
  for (int j = 0; j < 4; ++j) part[warp][4 * lane + j] = acc[j];
  __syncthreads();
  if (tid < kHeadDim) {
    float s = part[0][tid];
#pragma unroll
    for (int w = 1; w < kPrepWarps; ++w) s += part[w][tid];
    slice_sum[tid] = s;
  }
  cluster.sync();
  if (tid < kHeadDim) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kPrepSplit; ++r) s += cluster.map_shared_rank(slice_sum, r)[tid];
    mean[tid] = s * inv_len;
  }
  cluster.sync();  // mean is ready, and no block leaves while another reads its slice_sum

  float mu[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) mu[j] = mean[4 * lane + j];
  for_rows(base, kl, l_begin, l_end, warp, [&](int l, float (&x)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __fsub_rn(x[j], mu[j]);
    float amax;
    const uint32_t codes = quant_row(x, amax);
    const long long row = static_cast<long long>(bh) * L + l;
    reinterpret_cast<uint32_t*>(k8 + row * kHeadDim)[lane] = codes;
    if (lane == 0) ks[bh * ks_ld + l] = __fmul_rn(amax, 1.f / 127.f);
  });
}

// K8b: attention with the Q.K^T product in int8, over raw q, K8a's int8 rows and scales (tk,
// ts) and v.
__global__ void __launch_bounds__(sm90::kThreads, 1)
flash_fwd_int8_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap ts, const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ out, int L, int H, int main_len, int has_cross,
                      float cross_bias, float q_scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * sm90::kBlockM;
  float qs[2];          // the scales of the thread's two query rows (the Q step sets them)
  int acc[16][4];       // the int32 Q8 K8^T tile of the score step
  sm90::flash_ws(
      smem_raw, (L + sm90::kBlockN - 1) / sm90::kBlockN,
      [&](uint32_t dst, uint32_t bar) { sm90::load_rows(dst, &tq, bar, h, q0, b); },
      [&](uint32_t dst, uint32_t bar, int k0) {
        sm90::mbar_expect_tx(bar, sm90::kInt8TileBytes + sm90::kBlockN * 4);
        sm90::tma_load_3d(dst, &tk, bar, 0, k0, bh);
        sm90::tma_load_2d(dst + sm90::kInt8TileBytes, &ts, bar, k0, bh);
      },
      [&](uint32_t dst, uint32_t bar, int k0) { sm90::load_rows(dst, &tv, bar, h, k0, b); },
      [&](bf16* sq, int wg, int t) {
        // the warp's 16 rows, one at a time: lane i holds columns 4i .. 4i + 3 (box i / 16,
        // 16-byte chunk (i % 16) / 2, half i % 2); all codes are made before any is stored,
        // since each int8 row overwrites the first half of its own bf16 row
        const int lane = t & 31, g = lane >> 2, i = lane & 15;
        const int row0 = wg * sm90::kRowsWG + (t >> 5) * 16;
        uint32_t codes[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const int row = row0 + r;
          float x[4];
          load4(sq + (lane >> 4) * (sm90::kBoxBytes / 2) + row * sm90::kBoxCols +
                    (((i >> 1) ^ (row & 7)) << 3) + (i & 1) * 4,
                x);
          float amax;
          codes[r] = quant_row(x, amax);
          const float s = __fmul_rn(amax, q_scale);
          if (r == g) qs[0] = s;
          if (r == g + 8) qs[1] = s;
        }
        __syncwarp();
        unsigned char* q8 = reinterpret_cast<unsigned char*>(sq);
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const int row = row0 + r;
          *reinterpret_cast<uint32_t*>(q8 + row * kHeadDim + (((lane >> 2) ^ (row & 7)) << 4) +
                                       (lane & 3) * 4) = codes[r];
        }
      },
      [&](uint32_t q, uint32_t k, sm90::ScoreTile&) { sm90::qk_wgmma_s8(acc, q, k); },
      [&](int k0, int wg, uint32_t k, sm90::ScoreTile& sc) {
        // in the TPU kernel's order: float(acc) * qs * ks (each correctly rounded), the cross
        // bias in natural units, the key mask, then log2 units; one pass, so the int and fp32
        // tiles share their registers
        const int t = threadIdx.x & 127, t4 = t & 3;
        sm90::fence_acc(acc);
        const uint32_t ks = k + sm90::kInt8TileBytes;
        if (!has_cross && k0 + sm90::kBlockN <= L) {
#pragma unroll
          for (int n = 0; n < sm90::kBlockN / 8; ++n) {
            const float2 kn = sm90::lds_f2(ks + (n * 8 + t4 * 2) * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[n][e] = __fmul_rn(__fmul_rn(__fmul_rn(int_to_float(acc[n][e]), qs[e >> 1]),
                                             e & 1 ? kn.y : kn.x),
                                   sm90::kLog2e);
          }
          return;
        }
        const int row = sm90::first_row(q0, wg, t);
#pragma unroll
        for (int n = 0; n < sm90::kBlockN / 8; ++n) {
          const float2 kn = sm90::lds_f2(ks + (n * 8 + t4 * 2) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + n * 8 + t4 * 2 + (e & 1);
            const bool cross = ((e < 2 ? row : row + 8) >= main_len) != (kpos >= main_len);
            float x = __fmul_rn(__fmul_rn(int_to_float(acc[n][e]), qs[e >> 1]),
                                e & 1 ? kn.y : kn.x);
            if (has_cross && cross) x = __fadd_rn(x, cross_bias);
            sc[n][e] = __fmul_rn(kpos >= L ? sm90::kNegInf : x, sm90::kLog2e);
          }
        }
      },
      [&](int wg, int t, sm90::RowState& st) {
        sm90::store_rows(st, out, b, h, L, H, sm90::first_row(q0, wg, t), t & 31);
      });
}

}  // namespace

// K8a. k: (B, L, H, 128) bf16 with unit stride on the last dim and 8-byte aligned rows.
// k8: contiguous (B*H, L, 128) int8; ks: B*H rows of L fp32, ks_ld apart (>= L, a multiple of 4
// for K8b's tensor map); both written here. inv_len = fp32(1/L), as the plain version rounds
// it. Returns the launch's cudaError.
extern "C" int int8_prep_k_d128(const void* k, long long k_sb, long long k_sl, long long k_sh,
                                void* k8, void* ks, long long ks_ld, int B, int L, int H,
                                float inv_len, void* stream) {
  if (B < 1 || L < 1 || H < 1 || ks_ld < L) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_prep_k_kernel<<<B * H * kPrepSplit, kPrepThreads, 0, st>>>(
      static_cast<const bf16*>(k), k_sb, k_sl, k_sh, static_cast<int8_t*>(k8),
      static_cast<float*>(ks), ks_ld, L, H, inv_len);
  return static_cast<int>(cudaGetLastError());
}

// K8b. q, v: (B, L, H, 128) bf16 with unit stride on the last dim, strides that are multiples of
// 8 elements and 16-byte aligned bases (TMA's terms); k8, ks (rows ks_ld apart): K8a's output.
// out: contiguous (B, L, H, 128) bf16. q_scale = fp32(1/sqrt(128)/127), as the plain version
// rounds it. Encodes the four tensor maps, launches on `stream` and returns the first cudaError
// (cudaErrorInvalidValue if a map cannot be encoded); does not synchronise.
extern "C" int flash_fwd_int8_d128(const void* q, const void* k8, const void* ks, long long ks_ld,
                                   const void* v, void* out, int B, int L, int H, long long q_sb,
                                   long long q_sl, long long q_sh, long long v_sb, long long v_sl,
                                   long long v_sh, int main_len, float cross_bias, float q_scale,
                                   void* stream) {
  if (B < 1 || L < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, ts, tv;
  if (!sm90::encode_rows(&tq, q, B, L, H, q_sb, q_sl, q_sh) ||
      !sm90::encode_int8_rows(&tk, k8, B * H, L) ||
      !sm90::encode_float_rows(&ts, ks, B * H, L, ks_ld) ||
      !sm90::encode_rows(&tv, v, B, L, H, v_sb, v_sl, v_sh))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + sm90::kBlockM - 1) / sm90::kBlockM, B * H);
  flash_fwd_int8_kernel<<<grid, sm90::kThreads, sm90::kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      tq, tk, ts, tv, static_cast<bf16*>(out), L, H, main_len, cross_bias != 0.f ? 1 : 0,
      cross_bias, q_scale);
  return static_cast<int>(cudaGetLastError());
}
