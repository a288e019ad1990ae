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
// (12 MB each way per stream at L = 4096), with ~10 FLOPs per element.
//
// Design, against that bound:
//   * One warp per (token, head): lane i holds elements 4i..4i+3 (one 8-byte load),
//     so a warp reads a head's 256 contiguous bytes. The mean of squares is a 5-step
//     xor-shuffle reduction; no shared memory, no __syncthreads.
//   * The rotation partner of element e is e +- 64, four lanes of 16 away:
//     one __shfl_xor_sync(..., 16) brings the partner's four values.
//   * The panel is a strided slice of the qkv (row stride 3H) or in_proj (row stride
//     3H + M) matmul output and is read through its strides, without a copy; the cos
//     and sin tables likewise (row offset for the txt/img halves of the joint table).
//   * Arithmetic uses the correctly rounded intrinsics, and the per-lane sum of squares
//     runs in a fixed order (4 in sequence, then the shuffle tree), which
//     ops/fused_quant.py::norm_rope_ref reproduces: the kernel and its plain version
//     agree bit for bit on the same inputs. Built without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 128;
constexpr int kPerLane = kHeadDim / 32;  // 4
constexpr int kWarps = 8;                // warps (token-heads) per block

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load4(const bf16* p, float (&f)[kPerLane]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

__global__ void norm_rope_kernel(const bf16* __restrict__ x, long long sxb, long long sxl,
                                 const bf16* __restrict__ scale, const bf16* __restrict__ cos,
                                 long long scl, const bf16* __restrict__ sin, long long ssl,
                                 bf16* __restrict__ out, int L, int n_heads,
                                 long long n_items, float eps) {
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(item % n_heads);
  const long long row = item / n_heads;
  const int b = static_cast<int>(row / L), l = static_cast<int>(row % L);
  const int col = lane * kPerLane;

  float v[kPerLane], sc[kPerLane], c[kPerLane], sn[kPerLane];
  load4(x + b * sxb + l * sxl + h * kHeadDim + col, v);
  load4(scale + col, sc);
  load4(cos + l * scl + col, c);
  load4(sin + l * ssl + col, sn);

  float ss = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int j = 1; j < kPerLane; ++j) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  const float var = __fdiv_rn(ss, static_cast<float>(kHeadDim));
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));

  float xs[kPerLane], partner[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) xs[j] = round_bf16(__fmul_rn(round_bf16(__fmul_rn(v[j], r)), sc[j]));
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) partner[j] = __shfl_xor_sync(0xffffffffu, xs[j], 16);

  // lanes 0..15 hold x1 (out = x1 c - x2 s), lanes 16..31 hold x2 (out = x2 c + x1 s)
  const bool first = lane < 16;
  union {
    bf16 h[kPerLane];
    uint2 u;
  } res;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const float a = round_bf16(__fmul_rn(xs[j], c[j]));
    const float p = round_bf16(__fmul_rn(partner[j], sn[j]));
    res.h[j] = __float2bfloat16_rn(first ? __fsub_rn(a, p) : __fadd_rn(a, p));
  }
  *reinterpret_cast<uint2*>(out + row * (static_cast<long long>(n_heads) * kHeadDim) +
                            h * kHeadDim + col) = res.u;
}

}  // namespace

// x: (B, L, n_heads * 128) bf16 with strides (sxb, sxl, 1); scale: (128,) bf16;
// cos/sin: (L, 128) bf16 with row strides scl/ssl; out: (B, L, n_heads * 128) bf16
// contiguous. Needs 8-byte aligned rows. Returns the cudaError_t of the launch.
extern "C" int norm_rope_bf16_d128(const void* x, long long sxb, long long sxl, const void* scale,
                                   const void* cos, long long scl, const void* sin, long long ssl,
                                   void* out, int B, int L, int n_heads, float eps,
                                   void* stream) {
  if (B < 1 || L < 1 || n_heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_items = static_cast<long long>(B) * L * n_heads;
  const long long blocks = (n_items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  norm_rope_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), sxb, sxl, static_cast<const bf16*>(scale),
      static_cast<const bf16*>(cos), scl, static_cast<const bf16*>(sin), ssl,
      static_cast<bf16*>(out), L, n_heads, n_items, eps);
  return static_cast<int>(cudaGetLastError());
}
