// K3, K4, K5: the fused activation prologues of the W8A8 block linears, for Hopper
// (sm_90a). bf16 rows in; int8 rows and one fp32 scale per row out.
//
// Replaces, in reflectionflow_tpu/ops/pallas_quant.py:
//   K3 _adaln_quant_kernel (adaln_quant): non-affine LayerNorm (var = E[x^2] - mu^2,
//      clamped at 0, eps 1e-6), * (1 + scale) + shift, per-token absmax int8;
//   K4 _gelu_quant_kernel (gelu_quant): tanh-GELU, per-token absmax int8;
//   K5 _rowquant_kernel (rowquant): per-token absmax int8.
// All three end in the same row-quant epilogue: s = max(amax, 1e-12) / 127 and
// q = round-half-even(y / s), in fp32; the division by 127 is the product with
// fp32(1/127), as the compiled JAX kernels compute it.
//
// What bounds it on an H100: HBM bandwidth. A row is read once (6 KB at H = 3072,
// 24 KB at M = 12288) and written once as int8, for a few FLOPs per byte, far under
// the card's ~295 FLOP/byte balance point.
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
//   * The TPU kernels tile rows in blocks of 8..256 for VMEM; here any L works.
//   * Division and square root use the correctly rounded intrinsics, and the
//     elementwise chain the _rn ones, so the int8 values round as the plain PyTorch
//     version's do (this file is built without --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kVec = 8;       // bf16 per 16-byte vector
constexpr int kMaxVec = 4;    // vectors held per thread
constexpr int kMaxThreads = 1024;

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

// tanh-GELU as PyTorch writes it: 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

template <int kOp>
__global__ void act_quant_kernel(const bf16* __restrict__ x, long long sxb, long long sxl,
                                 const bf16* __restrict__ shift, long long sshb,
                                 const bf16* __restrict__ scale, long long sscb,
                                 int8_t* __restrict__ q, float* __restrict__ s, int L, int W,
                                 float eps) {
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
  int8_t* qr = q + row * W;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c >= nvec) continue;
    union {
      int8_t b[kVec];
      uint2 u;
    } out;
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      out.b[j] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(y[i][j], step)));
    *reinterpret_cast<uint2*>(qr + c * kVec) = out.u;
  }
  if (threadIdx.x == 0) s[row] = step;
}

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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* shp = static_cast<const bf16*>(shift);
  const bf16* scp = static_cast<const bf16*>(scale);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  if (op == kAdaLN)
    act_quant_kernel<kAdaLN><<<grid, threads, 0, st>>>(xp, sxb, sxl, shp, sshb, scp, sscb, qp,
                                                       sp, L, W, eps);
  else if (op == kGelu)
    act_quant_kernel<kGelu><<<grid, threads, 0, st>>>(xp, sxb, sxl, shp, sshb, scp, sscb, qp, sp,
                                                      L, W, eps);
  else
    act_quant_kernel<kRow><<<grid, threads, 0, st>>>(xp, sxb, sxl, shp, sshb, scp, sscb, qp, sp,
                                                     L, W, eps);
  return static_cast<int>(cudaGetLastError());
}
