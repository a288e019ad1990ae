// Device helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_fwd_int8.cu, flash_fwd_nr.cu) and their Hopper pipelines: the head dim, the shared-memory
// address of a pointer, bf16 packing and rounding, and 4-value loads and stores. Everything is a
// correctly rounded intrinsic, so it computes the same with or without --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

}  // namespace
