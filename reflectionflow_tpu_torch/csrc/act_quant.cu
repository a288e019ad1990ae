// K3, K4, K5: the fused activation prologues of the W8A8 block linears, for Hopper
// (sm_90a). bf16 rows in; int8 rows and one fp32 scale per row out.
//
// Replaces, in reflectionflow_tpu/ops/pallas_quant.py:
//   K3 _adaln_quant_kernel (adaln_quant): non-affine LayerNorm (var = E[x^2] - mu^2,
//      clamped at 0, eps 1e-6), * (1 + scale) + shift, per-token absmax int8;
//   K4 _gelu_quant_kernel (gelu_quant): tanh-GELU, per-token absmax int8;
//   K5 _rowquant_kernel (rowquant): per-token absmax int8.
// All three end in the same row-quant epilogue: s = max(amax, 1e-12) / 127 and
// q = round-half-even(RN(y / s)), in fp32; the division by 127 is the product with
// fp32(1/127), as the compiled JAX kernels compute it.
//
// What bounds it on an H100: HBM bandwidth, if the per-element arithmetic stays under
// it. A row is read once (6 KB at H = 3072, 24 KB at M = 12288) and written once as
// int8. A correctly rounded division per element (a reciprocal, a check, a slow-path
// call), an F2I conversion and libdevice tanhf are about four operations an element on
// the unit that does MUFU and conversions at 16 a clock per SM: at K4's 113 M elements
// that unit alone takes longer than the bytes (PERF.md: K4 at 48% of its byte bound,
// K5 on the same view at 86%). So the epilogue and the GELU below avoid all three.
//
// Design, against that bound:
//   * One block per row. Each thread holds up to kMaxVec 16-byte vectors (8 bf16
//     each) of the row in registers, so the row is read from memory once although the
//     epilogue needs two reductions (mean/variance, then absmax) before it can write.
//     Neighbouring threads load neighbouring 16-byte vectors.
//   * Row statistics: per-thread fp32 partial sums, warp shuffles, then a 32-float
//     shared-memory combine across warps.
//   * The row is addressed through (batch, row) strides, so the strided panel slices
//     of the serving forward (gelu input fused[..., 3H:], attention-output views,
//     modulation chunks for shift/scale) are read in place, without a copy.
//   * The epilogue, per row one correctly rounded reciprocal inv = RN(1/s); per
//     element t = RN(y * inv), r = RN(t + 1.5 * 2^23), whose low byte is the int8
//     n = rhe(t), and d = t - (r - 1.5 * 2^23) = t - n (both exact). Four bytes are
//     packed with byte permutes. No division and no F2I an element.
//   * Exactness of that epilogue. Let Q = y / s (real), q = RN(Q), |Q| <= 127 * (1 +
//     2^-22) since |y| <= amax. Then |t - Q| <= |Q| * 2^-24 (from inv) + 2^-18 (half an
//     ulp below 128) < 1.2e-5, and |q - Q| <= 2^-18. If |d| < 1/2 - 2^-15, t lies more
//     than 2^-15 from every k + 1/2, so Q lies on t's side more than 1.8e-5 from it,
//     and q, within 3.9e-6 of Q, on the same side and not on the boundary: rhe(q) = n.
//     Otherwise (about 2 * 2^-15 of the elements, and any NaN, which max.NaN carries
//     into the thread's test) the thread writes that element's vector again, from the
//     correctly rounded division and F2I, as the plain version computes it. The int8
//     values are therefore bit for bit those of the plain division. Each vector is
//     stored as soon as it is packed; the rare second write follows it in program order.
//   * K4's GELU as x / (1 + 2^a), a = -2 sqrt(2/pi) log2(e) (x + 0.044715 x^3), which
//     is 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))) without the cancellation of
//     1 + tanh: one MUFU.EX2 and one MUFU.RCP an element in place of tanhf. Its
//     relative error is a few 2^-24 (tanh.approx's 2^-11 would move ~1% of the int8
//     values); against the plain version int8 values move by 1 on ~3e-5 of elements.
//   * Division, square root and the elementwise chain of K3 use the correctly rounded
//     intrinsics, and this file is built without --use_fast_math, so that K3 and K5
//     round as their plain versions (K5 bit for bit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kVec = 8;       // bf16 per 16-byte vector
constexpr int kMaxVec = 4;    // vectors held per thread
constexpr int kMaxThreads = 1024;
constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
constexpr float kWindow = 0x1p-15f;   // |t - (k + 1/2)| below this takes the exact path

enum Op { kAdaLN = 0, kGelu = 1, kRow = 2 };

__device__ __forceinline__ void load8(const bf16* p, float (&f)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Sum (or max) over the block; every thread gets the result. blockDim.x is a
// multiple of 32.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : __fadd_rn(v, w);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous reduction's readers are done with smem
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? smem[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : __fadd_rn(v, w);
  }
  return v;
}

// tanh-GELU, 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), as x / (1 + 2^a).
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kA = static_cast<float>(-2.0 * 0.7978845608028654 * 1.4426950408889634);
  constexpr float kB = static_cast<float>(-2.0 * 0.7978845608028654 * 0.044715 * 1.4426950408889634);
  const float a = x * fmaf(kB, x * x, kA);
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(a));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return x * r;
}

// max(a, b) that returns NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// The int8 of y / step for one element, exactly as the plain version computes it.
__device__ __forceinline__ uint32_t quant_exact(float y, float step) {
  return static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(__fdiv_rn(y, step))));
}

template <int kOp>
__device__ __forceinline__ void act_quant_row(const bf16* __restrict__ x, long long sxb,
                                              long long sxl, const bf16* __restrict__ shift,
                                              long long sshb, const bf16* __restrict__ scale,
                                              long long sscb, int8_t* __restrict__ q,
                                              float* __restrict__ s, int L, int W, float eps) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const int b = static_cast<int>(row / L), l = static_cast<int>(row % L);
  const bf16* xr = x + b * sxb + l * sxl;
  const int nvec = W / kVec;

  float y[kMaxVec][kVec];
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      load8(xr + c * kVec, y[i]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) y[i][j] = 0.f;
    }
  }

  if (kOp == kAdaLN) {
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i)
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        sum = __fadd_rn(sum, y[i][j]);
        sq = __fadd_rn(sq, __fmul_rn(y[i][j], y[i][j]));
      }
    sum = block_reduce<false>(sum, red);
    sq = block_reduce<false>(sq, red);
    const float mu = __fdiv_rn(sum, static_cast<float>(W));
    const float var = __fsub_rn(__fdiv_rn(sq, static_cast<float>(W)), __fmul_rn(mu, mu));
    const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(fmaxf(var, 0.f), eps)));
    const bf16* shr = shift + b * sshb;
    const bf16* scr = scale + b * sscb;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c >= nvec) continue;
      float sh[kVec], sc[kVec];
      load8(shr + c * kVec, sh);
      load8(scr + c * kVec, sc);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float ln = __fmul_rn(__fsub_rn(y[i][j], mu), r);
        y[i][j] = __fadd_rn(__fmul_rn(ln, __fadd_rn(1.f, sc[j])), sh[j]);
      }
    }
  } else if (kOp == kGelu) {
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i)
#pragma unroll
      for (int j = 0; j < kVec; ++j) y[i][j] = gelu_tanh(y[i][j]);
  }

  // row-quant epilogue (padding lanes hold 0 and do not move the absmax)
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i)
#pragma unroll
    for (int j = 0; j < kVec; ++j) amax = fmaxf(amax, fabsf(y[i][j]));
  amax = block_reduce<true>(amax, red);
  const float step = __fmul_rn(fmaxf(amax, 1e-12f), 1.f / 127.f);
  const float inv = __frcp_rn(step);
  int8_t* qr = q + row * W;
  float dmax = 0.f;  // the largest |t - rhe(t)| of this thread's elements
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    uint32_t packed[2];
#pragma unroll
    for (int j = 0; j < kVec; j += 4) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float t = __fmul_rn(y[i][j + k], inv);
        const float r = __fadd_rn(t, kMagic);
        dmax = max_nan(dmax, fabsf(__fsub_rn(t, __fsub_rn(r, kMagic))));
        w[k] = __float_as_uint(r);
      }
      packed[j / 4] = __byte_perm(__byte_perm(w[0], w[1], 0x0040), __byte_perm(w[2], w[3], 0x0040),
                                  0x5410);
    }
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) *reinterpret_cast<uint2*>(qr + c * kVec) = make_uint2(packed[0], packed[1]);
  }
  if (!(dmax < 0.5f - kWindow)) {
    // An element near a rounding boundary (or NaN): its vector is written again, from the
    // exact division. t again as fma(y, inv, +0): the same value but for the sign of a zero
    // (which does not move d), and not the same instruction, so the compiler recomputes it
    // rather than keeping the loop's 32 products live in registers until here.
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      bool near = false;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float t = __fmaf_rn(y[i][j], inv, 0.f);
        near |= !(fabsf(__fsub_rn(t, __fsub_rn(__fadd_rn(t, kMagic), kMagic))) < 0.5f - kWindow);
      }
      if (near) {  // padding vectors hold zeros and are never near
        uint32_t packed[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < kVec; ++j) packed[j / 4] |= quant_exact(y[i][j], step) << (8 * (j % 4));
        *reinterpret_cast<uint2*>(qr + (threadIdx.x + i * blockDim.x) * kVec) =
            make_uint2(packed[0], packed[1]);
      }
    }
  }
  if (threadIdx.x == 0) s[row] = step;
}

#define ACT_QUANT_ARGS                                                                         \
  const bf16 *__restrict__ x, long long sxb, long long sxl, const bf16 *__restrict__ shift,   \
      long long sshb, const bf16 *__restrict__ scale, long long sscb, int8_t *__restrict__ q, \
      float *__restrict__ s, int L, int W, float eps
#define ACT_QUANT_PASS x, sxb, sxl, shift, sshb, scale, sscb, q, s, L, W, eps

// One entry point per op, so that ptxas's report and the SASS name each kernel.
__global__ void act_quant_adaln_kernel(ACT_QUANT_ARGS) { act_quant_row<kAdaLN>(ACT_QUANT_PASS); }
__global__ void act_quant_gelu_kernel(ACT_QUANT_ARGS) { act_quant_row<kGelu>(ACT_QUANT_PASS); }
__global__ void act_quant_row_kernel(ACT_QUANT_ARGS) { act_quant_row<kRow>(ACT_QUANT_PASS); }

}  // namespace

// op: 0 = adaln_quant (K3), 1 = gelu_quant (K4), 2 = rowquant (K5).
// x: (B, L, W) bf16 with strides (sxb, sxl, 1); shift/scale: (B, W) bf16 with batch
// strides (K3 only; may be null otherwise); q: (B, L, W) int8 contiguous; s: (B*L,) fp32.
// Needs W % 8 == 0, W <= 8 * kMaxVec * kMaxThreads and 16-byte aligned rows.
// Returns the cudaError_t of the launch.
extern "C" int act_quant_bf16(int op, const void* x, long long sxb, long long sxl,
                              const void* shift, long long sshb, const void* scale,
                              long long sscb, void* q, void* s, int B, int L, int W, float eps,
                              void* stream) {
  const int nvec = W / kVec;
  if (W % kVec != 0 || nvec > kMaxVec * kMaxThreads || B < 1 || L < 1 || op < 0 || op > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_thread = (nvec + kMaxVec - 1) / kMaxVec;
  const int threads = ((per_thread + 31) / 32) * 32;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(B) * L));
  void (*kernel)(ACT_QUANT_ARGS) = op == kAdaLN ? act_quant_adaln_kernel
                                  : op == kGelu  ? act_quant_gelu_kernel
                                                 : act_quant_row_kernel;
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), sxb, sxl, static_cast<const bf16*>(shift), sshb,
      static_cast<const bf16*>(scale), sscb, static_cast<int8_t*>(q), static_cast<float*>(s), L, W,
      eps);
  return static_cast<int>(cudaGetLastError());
}
