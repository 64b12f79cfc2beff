// Device helpers shared by the attention kernels (attention.cu,
// attention_mass.cu, attention_bwd.cu): the TPU kernels' masking and the bf16
// mma.sync with its fragment loads.
#pragma once
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

// code: 1 valid, 0 masked, -1 past the end of the keys
__device__ __forceinline__ float masked_score(float s, float code) {
  return code > 0.f ? s : (code == 0.f ? kNeg : -INFINITY);
}

__device__ __forceinline__ float key_code(const float* mask_row, int key, int nk) {
  if (key >= nk) return -1.f;
  return (mask_row == nullptr || mask_row[key] > 0.f) ? 1.f : 0.f;
}

// D += A B, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

// two bf16 from consecutive rows of a row-major tile, packed low = first
__device__ __forceinline__ uint32_t ld_pair_rows(const __nv_bfloat16* p, int ld) {
  uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  uint32_t hi = *reinterpret_cast<const uint16_t*>(p + ld);
  return lo | (hi << 16);
}

}  // namespace
