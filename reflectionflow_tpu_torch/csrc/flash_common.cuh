// Device helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_fwd_int8.cu, flash_fwd_nr.cu): the head dim, bf16 packing and 4-value loads and stores;
// and, for K7b's mma.sync body in flash_bwd.cu, head dim 128 rows in XOR-swizzled shared-memory
// tiles, cp.async copies, ldmatrix fragment loads and the bf16 mma.sync.
// Everything is inline PTX or a correctly rounded intrinsic, so it computes the same with or
// without --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 128;
constexpr int kChunks = kHeadDim / 8;  // 16-byte chunks per bf16 row

// Element offset of 16-byte chunk `chunk` of row `row` in a swizzled [rows][128] bf16 tile
// (the chunk index XOR the row's low 3 bits: ldmatrix reads 8 rows without bank conflicts).
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four consecutive bf16 values (8-byte aligned) as floats, and back.
__device__ __forceinline__ void load4(const bf16* p, float (&f)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

__device__ __forceinline__ void store4(bf16* p, const float (&f)[4]) {
  uint2 raw;
  raw.x = pack_bf16(f[0], f[1]);
  raw.y = pack_bf16(f[2], f[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Copy rows [row0, row0 + ROWS) of one head into a swizzled tile with THREADS threads; rows
// >= L read as 0.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base, long long row_stride,
                                          int row0, int L, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int row = c / kChunks, chunk = c % kChunks;
    const bool valid = row0 + row < L;
    const bf16* src = valid ? base + (long long)(row0 + row) * row_stride + chunk * 8 : base;
    cp_async_16(tile + swz(row, chunk), src, valid);
  }
}

}  // namespace
