// The Hopper (sm_90a) forward flash-attention pipeline: TMA, mbarriers, wgmma and warp
// specialisation. K1 and K7a, the ring-chunk forward (flash_fwd.cu), K8b (flash_fwd_int8.cu) and
// K9b (flash_fwd_nr.cu) run on it. The backward pipeline of K6a/K6b and K7c, flash_bwd_sm90.cuh,
// builds on its primitives (mbarriers, TMA, descriptors, wgmma, setmaxnreg, encode_rows).
//
// One block owns (batch*head, kBlockM = 128 query rows) and has three warpgroups:
//   * warpgroup 0, the producer, with its registers cut to kProducerRegs by setmaxnreg. One of
//     its threads keeps TMA loads in flight: the Q tile once, then 128-key K and V tiles
//     through a ring of kStages stages. Each stage has a "full" mbarrier for K and one for V
//     (the TMA bytes have landed) and an "empty" one for each (all 8 consumer warps are done
//     with it), so the copy of K and V for later tiles runs under this tile's math;
//   * warpgroups 1 and 2, the consumers, each own 64 query rows and raise their registers to
//     kConsumerRegs. Per K tile: S = Q K^T by wgmma with Q and K read from shared memory
//     through descriptors (m64n128k16 bf16 -> fp32, or m64n128k32 s8 -> s32 for K8b); the score
//     step's scale, bias and mask; the online softmax in fp32 with ex2.approx; P rounded to
//     bf16 stays in registers as the A operand of O += P V (the S accumulator layout is P's A
//     layout), V read MN-major from shared memory (the transpose bit of the bf16 form). Within
//     a warpgroup, tile j's Q K^T and tile j - 1's P V are issued together and tile j's softmax
//     runs while that P V is on the tensor cores; O is rescaled and tile j's P packed only once
//     it is done. No register an in-flight wgmma reads is written meanwhile: ptxas would
//     otherwise serialize every wgmma (its C7513 notice), which a build of this loop with a
//     separate P buffer did.
// Every 128 x 128 bf16 tile is held as two boxes of [128 rows][64 columns] with 128-byte rows
// under CU_TENSOR_MAP_SWIZZLE_128B: the layout the descriptors' 128B swizzle reads. An int8
// tile of 128 rows is one [128][128 bytes] box in the same swizzle. Rows past L arrive as
// zeros from TMA; the score step masks keys >= L and the epilogue skips rows >= L.
// The roles split once, in one if/else at the top of the pipeline, and never reconverge, so
// ptxas honours setmaxnreg.
//
// The seams, passed in as functors:
//   load_k(dst, bar, k0)        the K-tile source, run by the producer thread: issues the loads
//                               of the K tile whose first key is k0 into stage memory dst (a
//                               kTileBytes stage: a bf16 tile by load_rows, or K8b's int8 tile
//                               and its 128 fp32 key scales) and their expect_tx on bar;
//   prepare_q(sq, wg, t)        the Q step, run by each consumer warpgroup once the raw Q tile
//                               has landed in sq (thread t of consumer warpgroup wg, on its own
//                               64 rows; the pipeline fences and syncs the warpgroup after it).
//                               K1 has none, K9b norms and rotates the rows in place, K8b
//                               quantizes them in place to the int8 tile that box 0 then holds;
//   issue_scores(q, k, sc)      the score step, in two parts: issues the product of the
//   finish_scores(k0, wg, k, sc)  warpgroup's Q rows at q and the K tile at stage address k as
//                               one wgmma group (into sc, or into an accumulator of its own);
//                               once the pipeline has waited for that group, fences the
//                               accumulator and turns it into the base-2 logits of the tile
//                               whose first key is k0, biased and masked, in sc. The stage is
//                               released only after the finish, which may read it (K8b's key
//                               scales);
//   store(wg, t, st)            the epilogue: store_rows, with the lse rows for K1 and K7a.
// Q and V are always bf16 tiles loaded by load_q / load_v.

#pragma once

#include <cuda.h>

#include "flash_common.cuh"

namespace {
namespace sm90 {

constexpr int kBlockM = 128;   // query rows per block
constexpr int kBlockN = 128;   // keys per K/V tile
constexpr int kRowsWG = 64;    // query rows per consumer warpgroup
constexpr int kStages = 2;     // depth of the K/V ring
constexpr int kThreads = 384;  // the producer warpgroup and two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 65536
constexpr int kBoxCols = 64;                            // bf16 columns in one 128-byte row
constexpr uint32_t kBoxBytes = 128 * kBoxCols * 2;      // one [128][64] bf16 box, 16 KB
constexpr uint32_t kTileBytes = 2 * kBoxBytes;          // one 128 x 128 bf16 tile
constexpr int kBars = 1 + 4 * kStages;                  // full Q; full/empty K and V per stage
constexpr int kSmemBytes = (1 + 2 * kStages) * kTileBytes + kBars * 8 + 1024;  // + alignment
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr uint32_t kInt8TileBytes = 128 * kHeadDim;  // one [128][128] int8 box, 16 KB
static_assert(kBlockM == kBlockN, "the forward's Q, K and V tiles share one box shape");

// A consumer thread's share of its warpgroup's 64 x 128 logits in the wgmma accumulator
// layout: [n][e] is row 16 * warp + lane / 4 (+ 8 for e >= 2), key 8 n + 2 (lane % 4) + e % 2.
using ScoreTile = float[kBlockN / 8][4];

// Per-thread softmax state of the thread's two rows, as the accumulator layout places them.
struct RowState {
  float o[kHeadDim / 8][4];  // unnormalised output
  float m[2];                // running max, log2 domain
  float l[2];                // this thread's share of the running sum
};

// ---- mbarriers, TMA, proxies ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Issues the TMA loads of rows [row0, row0 + ROWS) of head h of batch b of a map made by
// encode_rows with ROWS-row boxes, as two 64-column boxes at dst and dst + ROWS * 128,
// completing on bar (whose expect_tx the caller has issued).
template <int ROWS>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int row0, int b) {
  tma_load_4d(dst, map, bar, 0, h, row0, b);
  tma_load_4d(dst + ROWS * 128, map, bar, kBoxCols, h, row0, b);
}

// Rows [row0, row0 + 128) of head h of batch b, with their bytes expected on bar.
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int h, int row0, int b) {
  mbar_expect_tx(bar, kTileBytes);
  tma_rows<kBlockM>(dst, map, bar, h, row0, b);
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// A consumer thread's first query row: block row q0, then its warpgroup's 64, its warp's 16 and
// its lane's quad (the second row is 8 below).
__device__ __forceinline__ int first_row(int q0, int wg, int t) {
  return q0 + wg * kRowsWG + (t >> 5) * 16 + ((t & 31) >> 2);
}

// Generic-proxy writes to shared memory become visible to the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---- wgmma ------------------------------------------------------------------------------

// A shared-memory matrix descriptor for the 128B swizzle: start address, leading and stride
// byte offsets (16-byte units), layout type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed wgmma groups are pending (groups complete
// in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of a wgmma operand held in registers (an
// accumulator, or P) across the asynchronous wgmma that uses it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e]) :: "memory");
  }
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e]) :: "memory");
  }
}

__device__ __forceinline__ void fence_acc(int (&d)[16][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e]) :: "memory");
  }
}

// The 64 accumulator operands: c is the constraint ("+f", "+r" or "=r").
#define SM90_ACC4(c, d, i) c(d[i][0]), c(d[i][1]), c(d[i][2]), c(d[i][3])
#define SM90_ACC64C(c, d)                                                                       \
  SM90_ACC4(c, d, 0), SM90_ACC4(c, d, 1), SM90_ACC4(c, d, 2), SM90_ACC4(c, d, 3),               \
      SM90_ACC4(c, d, 4), SM90_ACC4(c, d, 5), SM90_ACC4(c, d, 6), SM90_ACC4(c, d, 7),           \
      SM90_ACC4(c, d, 8), SM90_ACC4(c, d, 9), SM90_ACC4(c, d, 10), SM90_ACC4(c, d, 11),         \
      SM90_ACC4(c, d, 12), SM90_ACC4(c, d, 13), SM90_ACC4(c, d, 14), SM90_ACC4(c, d, 15)
#define SM90_ACC64(d) SM90_ACC64C("+f", d)
#define SM90_D64                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A B, 64 x 128 x 16, A and B K-major in shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, 64 x 128 x 16, A (bf16 pairs) in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[16][4], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SM90_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (+)= A B, 64 x 128 x 32, int8 A and B K-major in shared memory (int8 wgmma takes no
// transpose), int32 sums. The first k-step overwrites d and declares it an output only, so the
// previous tile's sums need not stay live until the next product is issued.
__device__ __forceinline__ void wgmma_ss_s8_first(int (&d)[16][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " SM90_D64 ", %64, %65, p;\n}\n"
      : SM90_ACC64C("=r", d)
      : "l"(a), "l"(b), "r"(0));
}

__device__ __forceinline__ void wgmma_ss_s8(int (&d)[16][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " SM90_D64 ", %64, %65, p;\n}\n"
      : SM90_ACC64C("+r", d)
      : "l"(a), "l"(b), "r"(1));
}

#undef SM90_ACC4
#undef SM90_ACC64C
#undef SM90_ACC64
#undef SM90_D64

// Issues S = Q K^T for a warpgroup's 64 rows as one wgmma group (wgmma_wait, then fence_acc,
// before sc is read). q: the warpgroup's first row in box 0 of the Q tile; k: box 0 of a K
// tile. Both K-major: a 16-column step moves 32 bytes inside a 128-byte row, and steps 4..7
// read the second box; 8-row groups are 1024 bytes apart.
__device__ __forceinline__ void qk_wgmma(ScoreTile& sc, uint32_t q, uint32_t k) {
  fence_acc(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
    wgmma_ss(sc, desc_sw128(q + off, 16, 1024), desc_sw128(k + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// The int8 form: S = Q8 K8^T in int32 as one wgmma group (fence_acc before acc is read). q: the
// warpgroup's first row of the [128][128 B] int8 Q tile; k: an int8 K tile. A 32-byte k-step
// moves 32 bytes inside the 128-byte row, so four steps cover the head dim.
__device__ __forceinline__ void qk_wgmma_s8(int (&acc)[16][4], uint32_t q, uint32_t k) {
  wgmma_fence();
  wgmma_ss_s8_first(acc, desc_sw128(q, 16, 1024), desc_sw128(k, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < kHeadDim / 32; ++kk)
    wgmma_ss_s8(acc, desc_sw128(q + kk * 32, 16, 1024), desc_sw128(k + kk * 32, 16, 1024));
  wgmma_commit();
}

// Issues O += P V over one 128-key V tile at v as one wgmma group. V is MN-major (head dim
// contiguous): the two 64-column boxes are kBoxBytes apart (leading offset), 8-key groups 1024
// bytes (stride offset), and a 16-key step moves 2048 bytes.
__device__ __forceinline__ void pv_wgmma(RowState& st, const uint32_t (&pf)[kBlockN / 16][4],
                                         uint32_t v) {
  fence_acc(st.o);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kBlockN / 16; ++ks)
    wgmma_rs_mn(st.o, pf[ks], desc_sw128(v + ks * 16 * 128, kBoxBytes, 1024));
  wgmma_commit();
}

// ---- the softmax ------------------------------------------------------------------------

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// s = s * scale, then, in the TPU kernels' order, `bias` (log2 units) where the row and the
// column lie on opposite sides of the cond boundary (has_cross), over an accumulator tile of 8 N
// columns: rows row (e < 2) and row + 8, columns c0 + 8 n + 2 t4 + e % 2. Rows are queries and
// columns keys, or the other way round (K6b, K7c). The boundary is local: row_main among the
// rows, col_main among the columns; both are main_len for a whole sequence (K1, K6, K9b), and a
// ring chunk's (K7a, K7c) differ, since each side is main_len less its chunk's ring-global start
// (either may be negative or past L). Only a tile that straddles col_main needs the side of each
// column; elsewhere a row's bias is one value.
template <int N>
__device__ __forceinline__ void scale_bias(float (&sc)[N][4], float scale, int c0, int row,
                                           int row_main, int col_main, int has_cross, float bias,
                                           int t4) {
  if (has_cross && c0 < col_main && c0 + 8 * N > col_main) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cpos = c0 + n * 8 + t4 * 2 + (e & 1);
        const int rpos = e < 2 ? row : row + 8;
        const bool cross = (rpos >= row_main) != (cpos >= col_main);
        sc[n][e] = sc[n][e] * scale + (cross ? bias : 0.f);
      }
    }
  } else {
    const bool c_cond = c0 >= col_main;
    const float b0 = has_cross && ((row >= row_main) != c_cond) ? bias : 0.f;
    const float b1 = has_cross && ((row + 8 >= row_main) != c_cond) ? bias : 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      sc[n][0] = sc[n][0] * scale + b0;
      sc[n][1] = sc[n][1] * scale + b0;
      sc[n][2] = sc[n][2] * scale + b1;
      sc[n][3] = sc[n][3] * scale + b1;
    }
  }
}

// The forward's score step: scale_bias over the tile of keys [k0, k0 + 128) for the thread's
// query rows row and row + 8 (boundaries q_main among queries, k_main among keys), then keys >= L
// masked.
__device__ __forceinline__ void scale_bias_mask(ScoreTile& sc, float scale, int k0, int row,
                                                int L, int q_main, int k_main, int has_cross,
                                                float bias, int lane) {
  const int t4 = lane & 3;
  scale_bias(sc, scale, k0, row, q_main, k_main, has_cross, bias, t4);
  if (k0 + kBlockN > L) {
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + n * 8 + t4 * 2 + (e & 1) >= L) sc[n][e] = kNegInf;
      }
    }
  }
}

// The online-softmax update with one tile of base-2 logits, in place: new running max (over
// the 4 threads of a row), l rescaled, sc overwritten by p = exp2(s - max) in fp32 (the row
// sums take it so). corr is the factor O must be rescaled by (rescale_o) before it takes this
// tile's P V; pack_p then rounds p to bf16 into the A fragments of P V.
__device__ __forceinline__ void softmax_tile(RowState& st, ScoreTile& sc, float (&corr)[2]) {
  float mx[2] = {st.m[0], st.m[1]};
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
  corr[0] = exp2_approx(st.m[0] - mx[0]);
  corr[1] = exp2_approx(st.m[1] - mx[1]);
  st.m[0] = mx[0];
  st.m[1] = mx[1];
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = exp2_approx(sc[n][e] - mx[e >> 1]);
    rs[0] += sc[n][0] + sc[n][1];
    rs[1] += sc[n][2] + sc[n][3];
  }
  st.l[0] = st.l[0] * corr[0] + rs[0];
  st.l[1] = st.l[1] * corr[1] + rs[1];
}

// P (the fp32 p of softmax_tile) rounded to bf16 pairs: the A fragment of key step ks holds
// keys 16 ks .. 16 ks + 15, as the accumulator layout left them.
__device__ __forceinline__ void pack_p(const ScoreTile& sc, uint32_t (&pf)[kBlockN / 16][4]) {
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
    pf[n >> 1][(n & 1) * 2] = pack_bf16(sc[n][0], sc[n][1]);
    pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(sc[n][2], sc[n][3]);
  }
}

__device__ __forceinline__ void rescale_o(RowState& st, const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
    st.o[n][0] *= corr[0];
    st.o[n][1] *= corr[0];
    st.o[n][2] *= corr[1];
    st.o[n][3] *= corr[1];
  }
}

// Two neighbouring output values: a bf16 pair, or (K7a) the pair rounded to bf16 and stored as
// fp32, the upcast the ring's fp32 merge takes.
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(round_bf16(a), round_bf16(b));
}

// The epilogue: full row sums, then out = o / max(l, 1e-20) into the contiguous
// (B, L, H, 128) out (bf16, or bf16-rounded fp32) for the thread's rows below L. With lse (the
// (b, h) row of a (B*H, L) array, K1's form) the quad's t4 == 0 lane also writes
// lse = m ln2 + log(max(l, 1e-20)), the rows K6a/K6b read back.
template <class T>
__device__ __forceinline__ void store_rows(RowState& st, T* __restrict__ out, int b, int h, int L,
                                           int H, int row, int lane,
                                           float* __restrict__ lse = nullptr) {
  const int t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
  }
  const int rows[2] = {row, row + 8};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    const float l_safe = fmaxf(st.l[r], 1e-20f);
    const float inv = 1.f / l_safe;
    T* orow = out + ((static_cast<long long>(b) * L + rows[r]) * H + h) * kHeadDim;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n)
      store_pair(orow + n * 8 + t4 * 2, st.o[n][2 * r] * inv, st.o[n][2 * r + 1] * inv);
    if (lse != nullptr && t4 == 0) lse[rows[r]] = st.m[r] * kLn2 + logf(l_safe);
  }
}

// ---- the pipeline -----------------------------------------------------------------------

// Runs the block: barrier set-up, then the producer and consumer roles. load_q(dst, bar) and
// load_v(dst, bar, k0) issue the bf16 Q and V tiles (load_rows); store(wg, t, st) is the
// consumer epilogue. See the top of this file for the seams.
template <class LoadQ, class LoadK, class LoadV, class PrepareQ, class IssueScores,
          class FinishScores, class Store>
__device__ __forceinline__ void flash_ws(unsigned char* smem_raw, int n_tiles, LoadQ&& load_q,
                                         LoadK&& load_k, LoadV&& load_v, PrepareQ&& prepare_q,
                                         IssueScores&& issue_scores, FinishScores&& finish_scores,
                                         Store&& store) {
  // TMA's 128B swizzle and the descriptors assume 1024-byte aligned tiles
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t q_tile = raw + pad;
  const uint32_t k_tiles = q_tile + kTileBytes, v_tiles = k_tiles + kStages * kTileBytes;
  const uint32_t bars = v_tiles + kStages * kTileBytes;
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto empty_k = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(empty_k(s), kConsumerWarps);
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      load_q(q_tile, full_q);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t parity = ((j / kStages) & 1) ^ 1;  // the first round finds them empty
        mbar_wait(empty_k(s), parity);
        load_k(k_tiles + s * kTileBytes, full_k(s), j * kBlockN);
        mbar_wait(empty_v(s), parity);
        load_v(v_tiles + s * kTileBytes, full_v(s), j * kBlockN);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1, t = threadIdx.x & 127, lane = t & 31;
    const uint32_t q_rows = q_tile + c * kRowsWG * 128;  // the warpgroup's rows of box 0
    auto release = [&](uint32_t bar) {  // this warp is done with a stage
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    mbar_wait(full_q, 0);
    prepare_q(reinterpret_cast<bf16*>(smem_raw + pad), c, t);
    fence_proxy_async();
    named_sync(1 + c, 128);

    RowState st;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) st.o[n][0] = st.o[n][1] = st.o[n][2] = st.o[n][3] = 0.f;
    st.m[0] = st.m[1] = kNegInf;
    st.l[0] = st.l[1] = 0.f;
    ScoreTile sc;
    uint32_t pf[kBlockN / 16][4];
    float corr[2];
    // tile 0: its scores alone (O is still 0, nothing to rescale)
    mbar_wait(full_k(0), 0);
    issue_scores(q_rows, k_tiles, sc);
    wgmma_wait<0>();
    finish_scores(0, c, k_tiles, sc);
    release(empty_k(0));
    softmax_tile(st, sc, corr);
    pack_p(sc, pf);
    // tile j: its scores run on the tensor cores beside tile j - 1's P V; then its softmax runs
    // while P V finishes, and O is rescaled and P packed once P V is done
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % kStages, sp = (j - 1) % kStages;
      mbar_wait(full_k(s), (j / kStages) & 1);
      issue_scores(q_rows, k_tiles + s * kTileBytes, sc);
      mbar_wait(full_v(sp), ((j - 1) / kStages) & 1);
      pv_wgmma(st, pf, v_tiles + sp * kTileBytes);
      wgmma_wait<1>();
      finish_scores(j * kBlockN, c, k_tiles + s * kTileBytes, sc);
      release(empty_k(s));
      softmax_tile(st, sc, corr);
      wgmma_wait<0>();
      fence_acc(st.o);
      fence_frags(pf);  // P stays in its registers until its P V is done
      release(empty_v(sp));
      rescale_o(st, corr);
      pack_p(sc, pf);
    }
    const int sl = (n_tiles - 1) % kStages;
    mbar_wait(full_v(sl), ((n_tiles - 1) / kStages) & 1);
    pv_wgmma(st, pf, v_tiles + sl * kTileBytes);
    wgmma_wait<0>();
    fence_acc(st.o);
    release(empty_v(sl));
    store(c, t, st);
  }
}

// ---- host side --------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime's entry-point query (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a (B, L, H, 128) bf16 tensor with element strides sb, sl, sh and a unit last
// stride: dims {128, H, L, B}, boxes of 64 columns x 1 head x box_rows rows x 1 batch, 128-byte
// swizzle, zeros outside. TMA needs a 16-byte aligned base and strides of 16-byte multiples.
inline bool encode_rows(CUtensorMap* map, const void* base, int B, int L, int H, long long sb,
                        long long sl, long long sh, int box_rows = kBlockM) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHeadDim), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D map over a contiguous (n_heads, L, 128) int8 tensor (K8a's workspace): boxes of 128
// rows of 128 bytes of one head, 128-byte swizzle, zeros past L. The driver has no signed 8-bit
// type; the bytes are copied as they are.
inline bool encode_int8_rows(CUtensorMap* map, const void* base, int n_heads, int L) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kHeadDim), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(n_heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kHeadDim),
                                 static_cast<cuuint64_t>(L) * kHeadDim};
  const cuuint32_t box[3] = {kHeadDim, kBlockN, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map over n_rows rows of L fp32 values, ld apart (K8a's key scales, one row a head; ld
// a multiple of 4, so every row starts on 16 bytes as TMA needs): boxes of kBlockN values of
// one row, no swizzle, zeros past L.
inline bool encode_float_rows(CUtensorMap* map, const void* base, int n_rows, int L,
                              long long ld) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {kBlockN, 1};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace
