// Device helpers shared by the attention kernels (attention.cu,
// attention_mass.cu, attention_bwd.cu): the TPU kernels' masking, the bf16
// mma.sync with its fragment loads (ldmatrix among them), and cp.async.
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

// mask_row: the batch's bool key mask, one byte a key (null: all valid)
__device__ __forceinline__ float key_code(const uint8_t* mask_row, int key, int nk) {
  if (key >= nk) return -1.f;
  return (mask_row == nullptr || mask_row[key] != 0) ? 1.f : 0.f;
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

// x0, x1 as bf16 hi = bf16(x) and lo = bf16(x - hi), each pair packed low =
// x0: hi + lo keeps about 16 bits of each fp32 value (x - hi is exact)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// --------------------------------------------- asynchronous copies, ldmatrix
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; zeros when !fill
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(fill ? 16 : 0));
}

// 4 bytes global -> shared; zeros when !fill
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(fill ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices from shared memory; lanes 8i .. 8i+7 give the row
// addresses of matrix i, and each lane gets (row lane/4, columns 2(lane%4),
// +1) of each matrix: the mma fragment layout
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, transposed: each lane gets (rows 2(lane%4), +1, column lane/4)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

}  // namespace
