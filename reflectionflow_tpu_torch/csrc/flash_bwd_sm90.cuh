// The Hopper (sm_90a) flash-attention backward pipeline: K6a (dQ) and K6b (dK, dV) of
// flash_bwd.cu run on it. It reuses the forward header's primitives (mbarriers, TMA, wgmma
// descriptors and products, setmaxnreg, the tensor-map encoders).
//
// One block owns (batch*head, 128 resident rows) and has three warpgroups, as the forward:
//   * warpgroup 0, the producer, cut to kBwdProducerRegs by setmaxnreg. Its thread 0 brings the
//     two resident 128-row tiles once (K6a: Q and dO; K6b: K and V) and then the two streamed
//     64-row tiles of each step (K6a: K and V of 64 keys; K6b: Q and dO of 64 query rows) through
//     a ring of kBwdStages stages, each with a "full" mbarrier (the TMA bytes have landed) and an
//     "empty" one (all 8 consumer warps are done with it). For K6b its warp 1 also copies the
//     step's 64 lse (times log2 e) and delta values into the stage with plain loads, since a row
//     of the (B*H, L) fp32 arrays starts on 16 bytes only when L % 4 == 0 and a TMA box must;
//     each of its 32 lanes arrives on the full barrier after its stores;
//   * warpgroups 1 and 2, the consumers, raised to kBwdConsumerRegs, each own 64 resident rows.
//     Per streamed tile they run the two score products as one wgmma group of m64n64k16 steps,
//     with both operands K-major in shared memory (as the forward's Q K^T), turn them into p and
//     ds in registers in fp32, round p and ds to bf16 in the accumulator layout (which is the A
//     operand layout) and accumulate the gradient products as m64n128k16 wgmma with A in
//     registers and the streamed tile read MN-major as B (as the forward's P V). Each tile's
//     products are waited for before its stage is released, so the overlap is mostly across the
//     two consumer warpgroups and with the producer's copies; within a warpgroup K6a computes p
//     while dP is on the tensor cores, and K6b computes ds while dV += p^T dO is. (Leaving K6a's
//     dQ product in flight under the next tile's score products measured no faster on an H100;
//     K6b's split of dV and dK into two groups measured 1-4% faster: PERF.md.)
// Every tile is held as two boxes of [rows][64 columns] with 128-byte rows under the 128B
// swizzle: boxes of 128 rows (kBoxBytes) for the resident tiles, of 64 rows (kHalfBoxBytes)
// for the streamed ones. Rows past L arrive as zeros from TMA.

#pragma once

#include "flash_fwd_sm90.cuh"

namespace {
namespace sm90 {

constexpr int kTileRows = 64;                          // rows of a streamed tile
constexpr uint32_t kHalfBoxBytes = kTileRows * 128;    // one [64][64] bf16 box, 8 KB
constexpr uint32_t kHalfTileBytes = 2 * kHalfBoxBytes;  // one 64 x 128 bf16 tile
constexpr int kBwdStages = 3;
constexpr int kBwdProducerRegs = 24, kBwdConsumerRegs = 240;  // 128 * 24 + 256 * 240 <= 65536
constexpr uint32_t kStageBytes = 2 * kHalfTileBytes;          // two streamed tiles
constexpr uint32_t kRowValBytes = 2 * kTileRows * 4;          // K6b: a step's lse and delta
constexpr int kBwdBars = 1 + 2 * kBwdStages;                  // resident; full/empty per stage
constexpr int kBwdSmemBytes =
    2 * kTileBytes + kBwdStages * (kStageBytes + kRowValBytes) + kBwdBars * 8 + 1024;

// A consumer thread's share of a 64 x 64 fp32 product in the wgmma accumulator layout: [n][e]
// is row 16 * warp + lane / 4 (+ 8 for e >= 2), column 8 n + 2 (lane % 4) + e % 2.
using PairTile = float[kTileRows / 8][4];
// The bf16 A fragments of a 64 x 64 PairTile: k-step ks holds columns 16 ks .. 16 ks + 15.
using PairFrags = uint32_t[kTileRows / 16][4];
// A 64 x 128 gradient accumulator (dQ, dK or dV rows of a consumer warpgroup).
using GradTile = float[kHeadDim / 8][4];

#define SM90_PAIR4(d, i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

// d (+)= A B, 64 x 64 x 16, A and B K-major in shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(PairTile& d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;"
      "\n}\n"
      : SM90_PAIR4(d, 0), SM90_PAIR4(d, 1), SM90_PAIR4(d, 2), SM90_PAIR4(d, 3), SM90_PAIR4(d, 4),
        SM90_PAIR4(d, 5), SM90_PAIR4(d, 6), SM90_PAIR4(d, 7)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef SM90_PAIR4

// d = A B^T over the head dim for 64 x 64 pairs (no commit): a is the consumer warpgroup's first
// row in box 0 of a resident 128-row tile, b box 0 of a streamed 64-row tile. Both K-major: a
// 16-column step moves 32 bytes inside a 128-byte row, steps 4..7 read the second box, 8-row
// groups are 1024 bytes apart.
__device__ __forceinline__ void pair_wgmma(PairTile& d, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    wgmma_ss_n64(d, desc_sw128(a + (kk >> 2) * kBoxBytes + col, 16, 1024),
                 desc_sw128(b + (kk >> 2) * kHalfBoxBytes + col, 16, 1024), kk > 0);
  }
}

// d += A B over the 64 rows of a streamed tile b (no commit): A the bf16 fragments of a
// PairTile, B the tile read MN-major (head dim contiguous): the two 64-column boxes are
// kHalfBoxBytes apart (leading offset), 8-row groups 1024 bytes (stride offset), and a 16-row
// step moves 2048 bytes.
__device__ __forceinline__ void grad_wgmma(GradTile& d, const PairFrags& a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < kTileRows / 16; ++ks)
    wgmma_rs_mn(d, a[ks], desc_sw128(b + ks * 16 * 128, kHalfBoxBytes, 1024));
}

// The gradient epilogue: rows row and row + 8 below L of a (B, L, H, 128) contiguous bf16 out,
// each value times `mul`.
__device__ __forceinline__ void store_grad(const GradTile& g, bf16* __restrict__ out, int b, int h,
                                           int L, int H, int row, int t4, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= L) continue;
    bf16* orow = out + ((static_cast<long long>(b) * L + rr) * H + h) * kHeadDim;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t4 * 2) =
          pack_bf16(g[n][2 * r] * mul, g[n][2 * r + 1] * mul);
    }
  }
}

// Shared-memory addresses of the pipeline (1024-byte aligned tiles).
struct BwdSmem {
  uint32_t res;     // two resident 128-row tiles, kTileBytes apart
  uint32_t stages;  // kBwdStages stages of two streamed tiles, kHalfTileBytes apart
  uint32_t vals;    // K6b: per stage, 64 lse * log2 e then 64 delta values
  uint32_t bars;
  __device__ uint32_t stage(int s) const { return stages + s * kStageBytes; }
  __device__ uint32_t stage_vals(int s) const { return vals + s * kRowValBytes; }
  __device__ uint32_t full_res() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8u * (1 + s); }
  __device__ uint32_t empty(int s) const { return bars + 8u * (1 + kBwdStages + s); }
};

// Runs the block: barrier set-up, then the roles, split once and never reconverging (so ptxas
// honours setmaxnreg). Producer thread 0: load_resident(dst, bar) for the two resident tiles,
// then load_stage(dst, bar, row0) for each of the n_tiles streamed steps. With load_vals, lanes
// of producer warp 1 run load_vals(vals, row0, lane) with the generic address of the stage's
// lse/delta slots and arrive on its full barrier. consume(sm, wg, t) is consumer thread t of
// consumer warpgroup wg.
template <bool kVals, class LoadResident, class LoadStage, class LoadVals, class Consume>
__device__ __forceinline__ void bwd_ws(unsigned char* smem_raw, int n_tiles,
                                       LoadResident&& load_resident, LoadStage&& load_stage,
                                       LoadVals&& load_vals, Consume&& consume) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  BwdSmem sm;
  sm.res = raw + pad;
  sm.stages = sm.res + 2 * kTileBytes;
  sm.vals = sm.stages + kBwdStages * kStageBytes;
  sm.bars = sm.vals + kBwdStages * kRowValBytes;

  if (threadIdx.x == 0) {
    mbar_init(sm.full_res(), 1);
#pragma unroll
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(sm.full(s), kVals ? 1 + 32 : 1);
      mbar_init(sm.empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    setmaxnreg_dec<kBwdProducerRegs>();
    if (threadIdx.x == 0) {
      load_resident(sm.res, sm.full_res());
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kBwdStages;
        mbar_wait(sm.empty(s), ((j / kBwdStages) & 1) ^ 1);  // the first round finds them empty
        load_stage(sm.stage(s), sm.full(s), j * kTileRows);
      }
    } else if (kVals && threadIdx.x >= 32 && threadIdx.x < 64) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kBwdStages;
        mbar_wait(sm.empty(s), ((j / kBwdStages) & 1) ^ 1);
        load_vals(reinterpret_cast<float*>(smem_raw + pad + (sm.stage_vals(s) - sm.res)),
                  j * kTileRows, threadIdx.x & 31);
        mbar_arrive(sm.full(s));
      }
    }
  } else {
    setmaxnreg_inc<kBwdConsumerRegs>();
    mbar_wait(sm.full_res(), 0);
    consume(sm, wg - 1, threadIdx.x & 127);
  }
}

// A consumer warp is done with stage s.
__device__ __forceinline__ void release_stage(const BwdSmem& sm, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(sm.empty(s));
}

// K6a: dQ of the block's 128 query rows [q0, q0 + 128) of head h of batch b. Resident: Q and dO;
// streamed: K and V tiles of 64 keys. Per tile, for the warpgroup's 64 rows:
//   S = Q K^T, dP = dO V^T (one wgmma group); p = exp2(S scale + bias - lse) with keys >= L
//   masked, ds = p (dP - delta), rounded to bf16; dQ += ds K.
// lse (times log2 e) and delta of the thread's two rows are read once into registers.
template <class LoadQO, class LoadKV>
__device__ __forceinline__ void dq_ws(unsigned char* smem_raw, LoadQO&& load_qo, LoadKV&& load_kv,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta, bf16* __restrict__ dq,
                                      int q0, int b, int h, int L, int H, int main_len,
                                      int has_cross, float bias, float scale_log2, float scale) {
  bwd_ws<false>(
      smem_raw, (L + kTileRows - 1) / kTileRows, load_qo, load_kv, [](float*, int, int) {},
      [&](const BwdSmem& sm, int c, int t) {
        const int lane = t & 31, t4 = lane & 3;
        const int row = first_row(q0, c, t);
        float lse_r[2], dlt_r[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool ok = row + 8 * r < L;
          const long long i = static_cast<long long>(b * H + h) * L + row + 8 * r;
          lse_r[r] = ok ? lse[i] * kLog2e : 0.f;
          dlt_r[r] = ok ? delta[i] : 0.f;
        }
        const uint32_t q_rows = sm.res + c * kRowsWG * 128, o_rows = q_rows + kTileBytes;
        GradTile acc;
#pragma unroll
        for (int n = 0; n < kHeadDim / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        PairTile s, dp;
        PairFrags dsf;
        const int n_tiles = (L + kTileRows - 1) / kTileRows;
        for (int j = 0; j < n_tiles; ++j) {
          const int st = j % kBwdStages, k0 = j * kTileRows;
          const uint32_t kt = sm.stage(st), vt = kt + kHalfTileBytes;
          mbar_wait(sm.full(st), (j / kBwdStages) & 1);
          fence_acc(s);
          fence_acc(dp);
          wgmma_fence();
          pair_wgmma(s, q_rows, kt);
          wgmma_commit();
          pair_wgmma(dp, o_rows, vt);
          wgmma_commit();
          wgmma_wait<1>();
          fence_acc(s);
          scale_bias(s, scale_log2, k0, row, main_len, has_cross, bias, t4);
          const bool tail = k0 + kTileRows > L;
#pragma unroll
          for (int n = 0; n < kTileRows / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = tail && k0 + n * 8 + t4 * 2 + (e & 1) >= L ? kNegInf : s[n][e];
              s[n][e] = exp2f(x - lse_r[e >> 1]);
            }
          }
          wgmma_wait<0>();
          fence_acc(dp);
#pragma unroll
          for (int n = 0; n < kTileRows / 8; ++n) {
            dsf[n >> 1][(n & 1) * 2] =
                pack_bf16(s[n][0] * (dp[n][0] - dlt_r[0]), s[n][1] * (dp[n][1] - dlt_r[0]));
            dsf[n >> 1][(n & 1) * 2 + 1] =
                pack_bf16(s[n][2] * (dp[n][2] - dlt_r[1]), s[n][3] * (dp[n][3] - dlt_r[1]));
          }
          fence_acc(acc);
          wgmma_fence();
          grad_wgmma(acc, dsf, kt);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(acc);
          fence_frags(dsf);
          release_stage(sm, st, lane);
        }
        store_grad(acc, dq, b, h, L, H, row, t4, scale);
      });
}

// K6b: dK and dV of the block's 128 keys [k0, k0 + 128) of head h of batch b. Resident: K and
// V; streamed: Q and dO tiles of 64 query rows with their lse and delta values. Per tile, for
// the warpgroup's 64 keys:
//   S^T = K Q^T, dP^T = V dO^T (one wgmma group); p^T = exp2(S^T scale + bias - lse), 0 for
//   query rows >= L, rounded to bf16 and dV += p^T dO issued; ds^T = p^T (dP^T - delta),
//   rounded to bf16, while that runs; then dK += ds^T Q.
template <class LoadKV, class LoadQO, class LoadVals>
__device__ __forceinline__ void dkv_ws(unsigned char* smem_raw, LoadKV&& load_kv,
                                       LoadQO&& load_qo, LoadVals&& load_vals,
                                       bf16* __restrict__ dk, bf16* __restrict__ dv, int k0, int b,
                                       int h, int L, int H, int main_len, int has_cross,
                                       float bias, float scale_log2, float scale) {
  bwd_ws<true>(
      smem_raw, (L + kTileRows - 1) / kTileRows, load_kv, load_qo, load_vals,
      [&](const BwdSmem& sm, int c, int t) {
        const int lane = t & 31, t4 = lane & 3;
        const int row = first_row(k0, c, t);
        const uint32_t k_rows = sm.res + c * kRowsWG * 128, v_rows = k_rows + kTileBytes;
        GradTile dka, dva;
#pragma unroll
        for (int n = 0; n < kHeadDim / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
        }
        PairTile s, dp;
        PairFrags pf, dsf;
        const int n_tiles = (L + kTileRows - 1) / kTileRows;
        for (int j = 0; j < n_tiles; ++j) {
          const int st = j % kBwdStages, q0 = j * kTileRows;
          const uint32_t qt = sm.stage(st), ot = qt + kHalfTileBytes, vals = sm.stage_vals(st);
          mbar_wait(sm.full(st), (j / kBwdStages) & 1);
          fence_acc(s);
          fence_acc(dp);
          wgmma_fence();
          pair_wgmma(s, k_rows, qt);
          pair_wgmma(dp, v_rows, ot);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(s);
          fence_acc(dp);
          scale_bias(s, scale_log2, q0, row, main_len, has_cross, bias, t4);
#pragma unroll
          for (int n = 0; n < kTileRows / 8; ++n) {  // p^T in place (fp32), and rounded into pf
            const int col = n * 8 + t4 * 2;
            const float2 l2 = lds_f2(vals + col * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[n][e] = q0 + col + (e & 1) < L ? exp2f(s[n][e] - (e & 1 ? l2.y : l2.x)) : 0.f;
            pf[n >> 1][(n & 1) * 2] = pack_bf16(s[n][0], s[n][1]);
            pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
          }
          fence_acc(dva);
          wgmma_fence();
          grad_wgmma(dva, pf, ot);
          wgmma_commit();
#pragma unroll
          for (int n = 0; n < kTileRows / 8; ++n) {  // ds^T while dV += p^T dO runs
            const float2 d2 = lds_f2(vals + (kTileRows + n * 8 + t4 * 2) * 4);
            dsf[n >> 1][(n & 1) * 2] =
                pack_bf16(s[n][0] * (dp[n][0] - d2.x), s[n][1] * (dp[n][1] - d2.y));
            dsf[n >> 1][(n & 1) * 2 + 1] =
                pack_bf16(s[n][2] * (dp[n][2] - d2.x), s[n][3] * (dp[n][3] - d2.y));
          }
          fence_acc(dka);
          wgmma_fence();
          grad_wgmma(dka, dsf, qt);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(dva);
          fence_acc(dka);
          fence_frags(pf);
          fence_frags(dsf);
          release_stage(sm, st, lane);
        }
        store_grad(dka, dk, b, h, L, H, row, t4, scale);
        store_grad(dva, dv, b, h, L, H, row, t4, 1.f);
      });
}

}  // namespace sm90
}  // namespace
