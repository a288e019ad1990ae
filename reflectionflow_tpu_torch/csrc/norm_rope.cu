// K2: the serving QK-norm + split-layout RoPE of one q or k panel, for Hopper
// (sm_90a), bf16 in and out.
//
// Replaces reflectionflow_tpu/ops/pallas_quant.py::_norm_rope_kernel (norm_rope): for
// every (token, head) of a (B, L, H*128) panel, an RMS norm over the head's 128
// values (fp32 mean of squares, eps 1e-6), rounded to the storage dtype and times the
// learned scale, then the half-split rotation
//   out[:64] = x1 * cos[:64] - x2 * sin[:64],  out[64:] = x2 * cos[64:] + x1 * sin[64:]
// with (L, 128) cos/sin tables in the permuted split layout. As in the TPU kernel and
// the serving forward, every product and sum after the norm rounds to bf16.
//
// What bounds it on an H100: HBM bandwidth. The panel is read once and written once
// (12 MB each way per stream at L = 4096), with ~10 FLOPs per element. To run at that
// bound an SM needs ~20 KB of loads in flight at all times, while each (token, head)
// ends in a serial chain (shuffles, a square root and a reciprocal, bf16 roundings)
// before its store: the loads have to be wide and issued ahead of that chain, and the
// chain's instructions (~20 an element) have to stay under the bytes' time.
//
// Design, against that bound:
//   * One block of 128 threads per token row. A head is 16 lanes; lane i of a head
//     holds elements 8i..8i+7 (one 16-byte load and one 16-byte store), so a
//     half-warp reads a head's 256 contiguous bytes and the block's 8 half-warps
//     cover 8 heads at a time.
//   * Each thread loads the x vectors of kPasses heads (24 heads at once for FLUX's
//     H = 24) before any arithmetic, so ~6 KB a block is in flight from its start.
//   * cos, sin and scale are the same for all of a token's heads: each thread loads
//     its 16 bytes of each once, for all its heads.
//   * The mean of squares is 8 products summed in sequence, then a 4-step xor-shuffle
//     tree over the head's 16 lanes; the rotation partner of element e is e +- 64,
//     8 lanes away: one __shfl_xor_sync(..., 8) per pair of bf16 values.
//   * The panel is a strided slice of the qkv (row stride 3H) or in_proj (row stride
//     3H + M) matmul output and is read through its strides, without a copy; the cos
//     and sin tables likewise (row offset for the txt/img halves of the joint table).
//   * Arithmetic uses the correctly rounded intrinsics, and the sum of squares runs in
//     a fixed order (8 in sequence, then the shuffle tree), which
//     ops/fused_quant.py::norm_rope_ref reproduces: the kernel and its plain version
//     agree bit for bit on the same inputs. Built without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 128;
constexpr int kPerLane = 8;                            // bf16 per lane: one 16-byte vector
constexpr int kLanesPerHead = kHeadDim / kPerLane;     // 16
constexpr int kThreads = 128;                          // a block: one token row
constexpr int kHeadsPerPass = kThreads / kLanesPerHead;  // 8
constexpr int kPasses = 3;                             // heads a thread loads before its math

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[kPerLane]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kPerLane / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// two floats rounded to bf16, packed (one F2FP)
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// RN_bf16(a * b) for two pairs, back in fp32
__device__ __forceinline__ float2 mul_bf16(float2 a, float b0, float b1) {
  return unpack2(pack2(__fmul_rn(a.x, b0), __fmul_rn(a.y, b1)));
}

// One head's 8 values of this lane: norm, scale, rotate; returns the 16 output bytes.
// `sn` holds -sin on the head's first 8 lanes, so that both halves add.
__device__ __forceinline__ uint4 norm_rope8(const uint4& raw, const float (&sc)[kPerLane],
                                           const float (&c)[kPerLane], const float (&sn)[kPerLane],
                                           float eps) {
  float v[kPerLane];
  unpack8(raw, v);
  float ss = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int j = 1; j < kPerLane; ++j) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
#pragma unroll
  for (int o = kLanesPerHead / 2; o > 0; o >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  // var = ss / 128 and r = 1 / sqrt(var + eps), each correctly rounded
  const float r = __frcp_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(ss, 1.f / kHeadDim), eps)));

  uint32_t xs[kPerLane / 2];
#pragma unroll
  for (int i = 0; i < kPerLane / 2; ++i) {
    const float2 n = unpack2(pack2(__fmul_rn(v[2 * i], r), __fmul_rn(v[2 * i + 1], r)));
    xs[i] = pack2(__fmul_rn(n.x, sc[2 * i]), __fmul_rn(n.y, sc[2 * i + 1]));
  }
  // lanes 0..7 of a head hold x1 (out = x1 c - x2 s), lanes 8..15 hold x2 (out = x2 c + x1 s);
  // the partner of element e is e +- 64, 8 lanes away
  uint32_t res[kPerLane / 2];
#pragma unroll
  for (int i = 0; i < kPerLane / 2; ++i) {
    const uint32_t partner = __shfl_xor_sync(0xffffffffu, xs[i], kLanesPerHead / 2);
    const float2 a = mul_bf16(unpack2(xs[i]), c[2 * i], c[2 * i + 1]);
    const float2 p = mul_bf16(unpack2(partner), sn[2 * i], sn[2 * i + 1]);
    res[i] = pack2(__fadd_rn(a.x, p.x), __fadd_rn(a.y, p.y));
  }
  return make_uint4(res[0], res[1], res[2], res[3]);
}

__device__ __forceinline__ void store16(bf16* p, const uint4& v) {
  asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z),
               "r"(v.w)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
    norm_rope_kernel(const bf16* __restrict__ x, long long sxb, long long sxl,
                     const bf16* __restrict__ scale, const bf16* __restrict__ cos, long long scl,
                     const bf16* __restrict__ sin, long long ssl, bf16* __restrict__ out, int L,
                     int n_heads, float eps) {
  const long long row = blockIdx.x;  // b * L + l
  const int b = static_cast<int>(row / L), l = static_cast<int>(row % L);
  const int sub = threadIdx.x % kLanesPerHead, slot = threadIdx.x / kLanesPerHead;
  const int col = sub * kPerLane;
  const bf16* xr = x + b * sxb + l * sxl + col;
  bf16* outr = out + row * (static_cast<long long>(n_heads) * kHeadDim) + col;

  float sc[kPerLane], c[kPerLane], sn[kPerLane];
  unpack8(__ldg(reinterpret_cast<const uint4*>(scale + col)), sc);
  unpack8(__ldg(reinterpret_cast<const uint4*>(cos + l * scl + col)), c);
  unpack8(__ldg(reinterpret_cast<const uint4*>(sin + l * ssl + col)), sn);
  if (sub < kLanesPerHead / 2) {  // x1 c - x2 s = x1 c + x2 (-s): RN_bf16 is odd, so exact
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) sn[j] = -sn[j];
  }

  // Every lane runs every pass (a head past n_heads computes on zeros and is not
  // stored), so that the shuffles are warp-wide.
  for (int h0 = slot; h0 - slot < n_heads; h0 += kHeadsPerPass * kPasses) {
    uint4 raw[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {  // 16-byte loads by intrinsic (nvcc split the plain
      const int h = h0 + p * kHeadsPerPass;  // uint4 loads here in four)
      raw[p] = h < n_heads ? __ldg(reinterpret_cast<const uint4*>(xr + h * kHeadDim))
                           : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int h = h0 + p * kHeadsPerPass;
      const uint4 o = norm_rope8(raw[p], sc, c, sn, eps);
      if (h < n_heads) store16(outr + h * kHeadDim, o);
    }
  }
}

}  // namespace

// x: (B, L, n_heads * 128) bf16 with strides (sxb, sxl, 1); scale: (128,) bf16;
// cos/sin: (L, 128) bf16 with row strides scl/ssl; out: (B, L, n_heads * 128) bf16
// contiguous. Needs 16-byte aligned rows. Returns the cudaError_t of the launch.
extern "C" int norm_rope_bf16_d128(const void* x, long long sxb, long long sxl, const void* scale,
                                   const void* cos, long long scl, const void* sin, long long ssl,
                                   void* out, int B, int L, int n_heads, float eps,
                                   void* stream) {
  const long long rows = static_cast<long long>(B) * L;
  if (B < 1 || L < 1 || n_heads < 1 || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  norm_rope_kernel<<<static_cast<unsigned>(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), sxb, sxl, static_cast<const bf16*>(scale),
      static_cast<const bf16*>(cos), scl, static_cast<const bf16*>(sin), ssl,
      static_cast<bf16*>(out), L, n_heads, eps);
  return static_cast<int>(cudaGetLastError());
}
