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
//     Here one block owns (batch*head, 128 query rows) and streams 64-key K/V tiles
//     through double-buffered shared memory with cp.async, so the logits never leave
//     registers and the next tile's copy overlaps this tile's math.
//   * Eight warps, 16 query rows each; both products run on mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate) fed by ldmatrix from XOR-swizzled tiles (no bank conflicts).
//     P stays in registers: the S accumulator layout is the A-operand layout of P.V.
//   * q, k and v are read in their (B, L, H, D) layout through strides, which saves
//     the (B*H, L, D) transpose copy the TPU path gets for free from XLA.
//   * The ragged tail is masked in the kernel: rows past L are zero-filled on load
//     and never stored; no host-side padding.
//   * Softmax runs in the base-2 domain (exp2 of logits pre-scaled by log2(e)).
// wgmma, TMA and warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 128;
constexpr int kBlockM = 128;  // query rows per block
constexpr int kBlockN = 64;   // keys per streamed tile
constexpr int kWarps = kBlockM / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = kHeadDim / 8;  // 16-byte chunks per row
constexpr int kTileElems = kBlockN * kHeadDim;
constexpr int kSmemBytes = (kBlockM * kHeadDim + 4 * kTileElems) * 2;  // Q + 2 x (K, V)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh;
};

// Element offset of 16-byte chunk `chunk` of row `row` in a swizzled [rows][128] tile.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kHeadDim + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 bytes without reading the source
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + ROWS) of one head into a swizzled tile; rows >= L read as 0.
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base, long long row_stride,
                                          int row0, int L, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c / kChunks, chunk = c % kChunks;
    const bool valid = row0 + row < L;
    const bf16* src = valid ? base + (long long)(row0 + row) * row_stride + chunk * 8 : base;
    cp_async_16(tile + swz(row, chunk), src, valid);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                 int L, int H, Strides s, int main_len, int has_cross, float cross_bias_log2,
                 float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBlockM * kHeadDim;  // [2][kBlockN][kHeadDim]
  bf16* sV = sK + 2 * kTileElems;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBlockM;
  const bf16* qp = q + b * s.qb + h * s.qh;
  const bf16* kp = k + b * s.kb + h * s.kh;
  const bf16* vp = v + b * s.vb + h * s.vh;

  load_tile<kBlockM>(sQ, qp, s.ql, q0, L, tid);
  load_tile<kBlockN>(sK, kp, s.kl, 0, L, tid);
  load_tile<kBlockN>(sV, vp, s.vl, 0, L, tid);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;  // this thread's two query rows
  const int n_tiles = (L + kBlockN - 1) / kBlockN;
  uint32_t qf[kHeadDim / 16][4];
  float o[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // running max, log2 domain
  float l_r[2] = {0.f, 0.f};          // this thread's share of the running sum

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<kBlockN>(sK + (buf ^ 1) * kTileElems, kp, s.kl, (j + 1) * kBlockN, L, tid);
      load_tile<kBlockN>(sV + (buf ^ 1) * kTileElems, vp, s.vl, (j + 1) * kBlockN, L, tid);
    }
    cp_async_commit();  // an empty group on the last tile keeps the wait count uniform
    cp_async_wait_prev();
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk)
        ldmatrix_x4(qf[kk], sQ + swz(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    const bf16* tK = sK + buf * kTileElems;
    float sc[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, tK + swz(np * 16 + ((lane >> 4) << 3) + (lane & 7),
                                 kk * 2 + ((lane >> 3) & 1)));
        mma_bf16(sc[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale, cross-segment bias, ragged-tail mask (same order as the TPU kernel)
    const int k0 = j * kBlockN;
    const bool masked = has_cross || k0 + kBlockN > L;
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (masked) {
          const int kpos = k0 + n * 8 + t4 * 2 + (e & 1);
          const int qpos = e < 2 ? row_a : row_b;
          if (has_cross && ((qpos >= main_len) != (kpos >= main_len))) x += cross_bias_log2;
          if (kpos >= L) x = kNegInf;
        }
        sc[n][e] = x;
      }
    }

    // online softmax: new running max per row (reduced over the 4 threads of a row)
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[n][0], sc[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float corr[2] = {exp2f(m_r[0] - mx[0]), exp2f(m_r[1] - mx[1])};
    m_r[0] = mx[0];
    m_r[1] = mx[1];

    // p in fp32 for the row sums, rounded to bf16 as the A operand of P.V
    uint32_t pf[kBlockN / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
      const float p0 = exp2f(sc[n][0] - mx[0]), p1 = exp2f(sc[n][1] - mx[0]);
      const float p2 = exp2f(sc[n][2] - mx[1]), p3 = exp2f(sc[n][3] - mx[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_r[0] = l_r[0] * corr[0] + rs[0];
    l_r[1] = l_r[1] * corr[1] + rs[1];
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V
    const bf16* tV = sV + buf * kTileElems;
#pragma unroll
    for (int ks = 0; ks < kBlockN / 16; ++ks) {
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, tV + swz(ks * 16 + (((lane >> 3) & 1) << 3) + (lane & 7),
                                       dp * 2 + (lane >> 4)));
        mma_bf16(o[2 * dp], pf[ks], bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pf[ks], bv[2], bv[3]);
      }
    }
    __syncthreads();  // the next iteration refills the buffer read here
  }

  // epilogue: full row sums, normalise, store out (B, L, H, D) and lse (B*H, L)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const int rows[2] = {row_a, row_b};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    const float l_safe = fmaxf(l_r[r], 1e-20f);
    const float inv = 1.f / l_safe;
    bf16* orow = out + (((long long)b * L + rows[r]) * H + h) * kHeadDim;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t4 * 2) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
    if (t4 == 0) lse[(long long)bh * L + rows[r]] = m_r[r] * kLn2 + logf(l_safe);
  }
}

}  // namespace

// q, k, v: (B, L, H, 128) bf16 with unit stride on the last dim and 16-byte aligned rows.
// out: contiguous (B, L, H, 128) bf16. lse: contiguous (B*H, L) fp32. Launches on
// `stream` and returns cudaGetLastError(); it does not synchronise.
extern "C" int flash_fwd_bf16_d128(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int B, int L, int H, long long q_sb, long long q_sl,
                                   long long q_sh, long long k_sb, long long k_sl, long long k_sh,
                                   long long v_sb, long long v_sl, long long v_sh, int main_len,
                                   float cross_bias, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides s{q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  const dim3 grid((L + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), L, H, s, main_len,
      cross_bias != 0.f ? 1 : 0, cross_bias * kLog2e, kLog2e / sqrtf(static_cast<float>(kHeadDim)));
  return static_cast<int>(cudaGetLastError());
}
