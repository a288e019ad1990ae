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
//   * Two launches per call. K8a prepares K once per (batch, head): one block sums the head's
//     L rows for the mean, then its warps centre and quantize one row each, writing an int8
//     (B*H, L, 128) workspace and fp32 (B*H, L) scales (about 17 MB at the corrector shape).
//     The TPU kernel quantizes a head's K stripe once into VMEM because its grid runs the
//     head's q tiles in order; the H100 runs them concurrently, so the stripe goes through
//     device memory. K8a's grid is only B*H blocks: a faster prologue is later work.
//   * K8b is K1's pipeline (flash_fwd_tile.cuh: one block per (batch*head, 128 query rows),
//     64-key tiles double-buffered with cp.async, XOR-swizzled tiles read by ldmatrix, P in
//     registers). As its Q step each warp quantizes its own 16 q rows into an int8
//     shared-memory tile once; the scores run on mma.sync m16n8k32 s8 x s8 -> s32, whose A/B
//     fragment layouts are byte for byte those of the bf16 m16n8k16, so the same ldmatrix
//     addressing serves 32 int8 columns as 16 bf16 ones. P.V is K1's bf16 mma.sync.
//   * The ragged tail is masked in the kernel; nothing is padded.
//   * Built without --use_fast_math: the quantizers use correctly rounded division so the
//     int8 codes match the plain version's.
// wgmma, TMA and warp specialisation are left for later work.

#include "flash_fwd_tile.cuh"

namespace {

constexpr int kChunks8 = kHeadDim / 16;  // 16-byte chunks in an int8 row
constexpr int kPrepThreads = 512;
constexpr int kPrepWarps = kPrepThreads / 32;
// shared memory of K8b: raw Q (bf16), Q8, 2 x K8, 2 x V (bf16), 2 x ks, qs
constexpr int kQ16Bytes = kBlockM * kHeadDim * 2;
constexpr int kQ8Bytes = kBlockM * kHeadDim;
constexpr int kK8Bytes = kBlockN * kHeadDim;
constexpr int kVBytes = kTileElems * 2;
constexpr int kSmemBytes = kQ16Bytes + kQ8Bytes + 2 * kK8Bytes + 2 * kVBytes +
                           2 * kBlockN * 4 + kBlockM * 4;

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled [rows][128] int8 tile (the
// bf16 tiles use `swz`, the same XOR pattern over 256-byte rows).
__device__ __forceinline__ int swz8(int row, int chunk) {
  return row * kHeadDim + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// K8a: one block per (batch, head): the mean over the L rows, then the centred per-token
// int8 rows into k8 (B*H, L, 128) and their scales into ks (B*H, L).
__global__ void __launch_bounds__(kPrepThreads)
int8_prep_k_kernel(const bf16* __restrict__ k, long long kb, long long kl, long long kh,
                   int8_t* __restrict__ k8, float* __restrict__ ks, int L, int H, float inv_len) {
  __shared__ float part[kPrepWarps][kHeadDim];
  __shared__ float mean[kHeadDim];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const bf16* base = k + b * kb + h * kh + 4 * lane;

  // column sums: warp w sums rows w, w + 16, ... of its lane's four columns
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int l = warp; l < L; l += kPrepWarps) {
    float x[4];
    load4(base + l * kl, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += x[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) part[warp][4 * lane + j] = acc[j];
  __syncthreads();
  if (tid < kHeadDim) {
    float s = part[0][tid];
#pragma unroll
    for (int w = 1; w < kPrepWarps; ++w) s += part[w][tid];
    mean[tid] = s * inv_len;
  }
  __syncthreads();

  float mu[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) mu[j] = mean[4 * lane + j];
  for (int l = warp; l < L; l += kPrepWarps) {
    float x[4];
    load4(base + l * kl, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __fsub_rn(x[j], mu[j]);
    float amax;
    const uint32_t codes = quant_row(x, amax);
    const long long row = static_cast<long long>(bh) * L + l;
    reinterpret_cast<uint32_t*>(k8 + row * kHeadDim)[lane] = codes;
    if (lane == 0) ks[row] = __fmul_rn(amax, 1.f / 127.f);
  }
}

// K8b: attention with the Q.K^T product in int8. k8/ks are K8a's workspace, read through the
// k strides of `s`.
__global__ void __launch_bounds__(kThreads)
flash_fwd_int8_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ k8,
                      const float* __restrict__ ks, const bf16* __restrict__ v,
                      bf16* __restrict__ out, int L, int H, Strides s, int main_len, int has_cross,
                      float cross_bias, float q_scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ16 = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* sQ8 = smem_raw + kQ16Bytes;
  unsigned char* sK8 = sQ8 + kQ8Bytes;                                 // [2][kBlockN][128] int8
  bf16* sV = reinterpret_cast<bf16*>(sK8 + 2 * kK8Bytes);              // [2][kBlockN][128]
  float* sKs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sV) + 2 * kVBytes);
  float* sQs = sKs + 2 * kBlockN;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBlockM;
  const int row_a = q0 + warp * 16 + g;
  const int8_t* kp = k8 + b * s.kb + h * s.kh;
  const float* ksp = ks + static_cast<long long>(bh) * L;
  const bf16* vp = v + b * s.vb + h * s.vh;
  uint32_t qa[kHeadDim / 32][4];
  float qs[2];
  RowState st;
  flash_rows(
      st, sQ16, q + b * s.qb + h * s.qh, s.ql, q0, L, sV,
      [&](int buf, int row0) {
        unsigned char* tK = sK8 + buf * kK8Bytes;
#pragma unroll
        for (int i = 0; i < kBlockN * kChunks8 / kThreads; ++i) {
          const int c = tid + i * kThreads;
          const int row = c / kChunks8, chunk = c % kChunks8;
          const bool valid = row0 + row < L;
          const int8_t* src = valid ? kp + (row0 + row) * s.kl + chunk * 16 : kp;
          cp_async_16(tK + swz8(row, chunk), src, valid);
        }
        load_tile<kBlockN, kThreads>(sV + buf * kTileElems, vp, s.vl, row0, L, tid);
        if (tid < kBlockN) {
          const bool valid = row0 + tid < L;
          cp_async_4(sKs + buf * kBlockN + tid, valid ? ksp + row0 + tid : ksp, valid);
        }
      },
      [&] {
        // each warp quantizes its own 16 q rows into the int8 tile
        for (int r = 0; r < 16; ++r) {
          const int row = warp * 16 + r;
          float x[4];
          load4(sQ16 + swz(row, lane >> 1) + (lane & 1) * 4, x);
          float amax;
          const uint32_t codes = quant_row(x, amax);
          *reinterpret_cast<uint32_t*>(sQ8 + swz8(row, lane >> 2) + (lane & 3) * 4) = codes;
          if (lane == 0) sQs[row] = __fmul_rn(amax, q_scale);
        }
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < kHeadDim / 32; ++kk)
          ldmatrix_x4(qa[kk], sQ8 + swz8(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
        qs[0] = sQs[warp * 16 + g];
        qs[1] = sQs[warp * 16 + g + 8];
      },
      [&](int buf, int k0, ScoreTile& sc) {
        // S = Q8 K8^T for this warp's 16 rows x 64 keys, in int32
        const unsigned char* tK = sK8 + buf * kK8Bytes;
        int acc[kBlockN / 8][4];
#pragma unroll
        for (int n = 0; n < kBlockN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
#pragma unroll
        for (int kk = 0; kk < kHeadDim / 32; ++kk) {
#pragma unroll
          for (int np = 0; np < kBlockN / 16; ++np) {
            uint32_t bk[4];
            ldmatrix_x4(bk, tK + swz8(np * 16 + ((lane >> 4) << 3) + (lane & 7),
                                      kk * 2 + ((lane >> 3) & 1)));
            mma_s8(acc[2 * np], qa[kk], bk[0], bk[1]);
            mma_s8(acc[2 * np + 1], qa[kk], bk[2], bk[3]);
          }
        }
        // rescale, cross-segment bias, ragged-tail mask (the TPU kernel's order), then log2 units
        const float* tKs = sKs + buf * kBlockN;
#pragma unroll
        for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float kscale = tKs[n * 8 + (lane & 3) * 2 + (e & 1)];
            sc[n][e] = __fmul_rn(__fmul_rn(static_cast<float>(acc[n][e]), qs[e >> 1]), kscale);
          }
        }
        bias_mask(sc, k0, row_a, L, main_len, main_len, has_cross, cross_bias, lane);
        scale_tile(sc, kLog2e);
      });
  store_rows(st, out, nullptr, b, h, L, H, row_a, lane);
}

}  // namespace

// K8a. k: (B, L, H, 128) bf16 with unit stride on the last dim and 8-byte aligned rows.
// k8: contiguous (B*H, L, 128) int8, ks: contiguous (B*H, L) fp32, both written here.
// inv_len = fp32(1/L), as the plain version rounds it. Returns the launch's cudaError.
extern "C" int int8_prep_k_d128(const void* k, long long k_sb, long long k_sl, long long k_sh,
                                void* k8, void* ks, int B, int L, int H, float inv_len,
                                void* stream) {
  if (B < 1 || L < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  int8_prep_k_kernel<<<B * H, kPrepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(k), k_sb, k_sl, k_sh, static_cast<int8_t*>(k8),
      static_cast<float*>(ks), L, H, inv_len);
  return static_cast<int>(cudaGetLastError());
}

// K8b. q, v: (B, L, H, 128) bf16 with unit stride on the last dim and 16-byte aligned rows;
// k8, ks: K8a's output. out: contiguous (B, L, H, 128) bf16. q_scale = fp32(1/sqrt(128)/127),
// as the plain version rounds it. Launches on `stream` and returns the cudaError; does not
// synchronise.
extern "C" int flash_fwd_int8_d128(const void* q, const void* k8, const void* ks, const void* v,
                                   void* out, int B, int L, int H, long long q_sb, long long q_sl,
                                   long long q_sh, long long v_sb, long long v_sl, long long v_sh,
                                   int main_len, float cross_bias, float q_scale, void* stream) {
  if (B < 1 || L < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long k8_l = kHeadDim, k8_h = static_cast<long long>(L) * kHeadDim;
  const Strides s{q_sb, q_sl, q_sh, H * k8_h, k8_l, k8_h, v_sb, v_sl, v_sh};
  const dim3 grid((L + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_int8_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(k8), static_cast<const float*>(ks),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), L, H, s, main_len,
      cross_bias != 0.f ? 1 : 0, cross_bias, q_scale);
  return static_cast<int>(cudaGetLastError());
}
