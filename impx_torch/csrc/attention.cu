// Masked multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel impx/ops/pallas/attention.py:mha_fused (:203,
// kernel _attn_kernel :49). The TPU kernel keeps all of K and V of one
// (batch, head) on chip; at N = 2048, dh = 64 that is 512 KB in bf16, more
// than an SM's 227 KB of shared memory, so this kernel tiles over keys with an
// online softmax (running max and sum in fp32, P.V accumulated in fp32,
// divided by the row sum at the end).
//
// The same kernels, given an lse buffer, replace the TPU kernel
// impx/ops/pallas/attention.py:mha_fused_lse (:245, kernel _attn_kernel_lse
// :221) too: the online softmax ends with each row's max m and sum l, and the
// kernel writes lse = m + log(l) in fp32, the residual of the training
// backward csrc/attention_bwd.cu (impx_mha_bwd_lse). A fully masked row
// writes lse = -1e30 exactly, as the TPU kernel (-1e30 + log Nk == -1e30).
//
// Bound on the H100: the two products, 4 * Nq * Nk * dh flops per
// (batch, head), against the bf16 tensor-core rate (0.032 ms at [8, 4, 2048,
// 64]); the exponentials, one a score, take about as long on the
// special-function units, and the bytes of q, k, v, o a third of that. At
// fp32 the products are three TF32 passes (3xTF32, csrc/attention_tf32.cuh)
// at 495 TFLOP/s: 0.185 ms at [8, 4, 2048, 64], against 0.456 ms for one
// fp32 pass on the FMA pipes.
//
// Layout: q [BH, Nq, dh], k/v [BH, Nk, dh] contiguous, out like q; the key
// mask [B, Nk] one byte a key (bool, nonzero valid), read as the caller gave
// it, or none.
//
// bf16 (attn_fwd_wgmma, dh 16, 32, 64), one block per (128 queries,
// batch*head), 288 threads:
//   * a producer warp keeps TMA loads in flight: Q once, then K and V in
//     64-key tiles through a ring of kStages stages, each stage with a "full"
//     mbarrier (transaction bytes) and an "empty" one (the 8 consumer warps);
//     the tensor maps are 3-D [BH, N, dh], so a ragged last tile arrives
//     zero-filled, and the swizzle (32, 64 or 128 B, a row's bytes) is the
//     one wgmma reads;
//   * two consumer warpgroups own 64 query rows each. S = Q K^T is a wgmma
//     with Q and the K tile (K-major) from shared memory; O += P V a wgmma
//     with P from registers (the S accumulator rounded to bf16 is the
//     register A fragment, so P never touches shared memory) and the V tile
//     MN-major (transposed). A warpgroup runs its two products in turn; the
//     four warpgroups of the two blocks an SM holds (at most 96 registers a
//     thread) overlap one's exponentials with the others' products. Issuing
//     tile j's QK^T beside tile j-1's P.V inside a warpgroup (wait_group 1)
//     keeps S, P and O live at once: at two blocks an SM that spills, at one
//     block an SM half the warps hide the latencies, and both ran slower;
//   * the softmax runs in base 2: p = 2^(s c - m c) with c = log2(e) /
//     sqrt(dh) folded into one FFMA a score; the running max m is kept in the
//     scores' own units, so lse = m / sqrt(dh) + log(l) as the reference;
//   * the key mask becomes a bit vector in shared memory once a block, and a
//     tile whose keys are all valid skips the selects. When no key of the
//     batch is valid (the reference gives every key -1e30, so a uniform
//     average of V), every key in range counts as valid with c = 0, and lse
//     is written as -1e30.
// fp32 (attn_fwd_tf32x3, csrc/attention_tf32.cuh): the same softmax and mask
// bits, both products as wgmma in 3xTF32, one block per (128 queries,
// batch*head), two warpgroups of 64 rows, K and V tiles through cp.async
// stages and split into TF32 hi and lo once a block.
// Semantics of the TPU kernel: scale by 1/sqrt(dh) before masking; masked
// keys score the finite -1e30 (a fully masked row averages V uniformly, never
// NaN); keys past Nk (the ragged last tile) get weight 0; P is exp(s - running
// max) rounded to the input dtype before P.V (no rounding at fp32), the
// division by l after it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tf32.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

// --------------------------------------------------------- bf16, wgmma + TMA
constexpr int kTileQ = 128;          // query rows a block: two consumer warpgroups of 64
constexpr int kTileK = 64;           // keys a tile
constexpr int kStages = 4;           // K/V tiles in flight
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + the producer warp

// Dynamic shared memory, from a 1024-byte aligned base: Q, the K stages, the
// V stages, the key mask as bits (two 32-bit words a key tile), mbarriers
template <int DH>
struct FwdSmem {
  static constexpr int kRow = 2 * DH;  // bytes of a row: the swizzle span
  static constexpr int kQ = kTileQ * kRow;
  static constexpr int kKV = kTileK * kRow;
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kWords = kV + kStages * kKV;
  static constexpr int kBars = 1 + 2 * kStages;
  static int bytes(int ntiles) { return 1024 + kWords + 8 * ntiles + 8 * kBars; }
};

// the tile's p (in s) rounded to bf16 as the register A fragments of P.V,
// one per 16-key step: n-blocks 2k and 2k + 1 of the accumulator
__device__ __forceinline__ void pack_p(const float (&s)[32], uint32_t (&p)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p[j >> 1][(j & 1) * 2 + 0] = pack_bf16(s[4 * j + 0], s[4 * j + 1]);  // row g
    p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);  // row g + 8
  }
}

template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint64_t dq, uint32_t k_tile) {
  constexpr uint64_t kSwizzle = DH == 64 ? 1 : (DH == 32 ? 2 : 3);
  const uint64_t dk = wgmma_desc(k_tile, 16 * DH, kSwizzle);  // 8 rows of 2 * DH bytes
#pragma unroll
  for (int k = 0; k < DH / 16; ++k) wgmma_ss_n64(s, dq + 2 * k, dk + 2 * k, k);  // +32 B a k-step
  wgmma_commit();
}

template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2], const uint32_t (&p)[4][4],
                                         uint32_t v_tile) {
  constexpr uint64_t kSwizzle = DH == 64 ? 1 : (DH == 32 ? 2 : 3);
  const uint64_t dv = wgmma_desc(v_tile, 16 * DH, kSwizzle);
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_rs(o, p[k], dv + 2 * DH * k);  // 16 rows of 2 * DH bytes a k-step
  wgmma_commit();
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int heads, int nq, int nk,
               float scale) {
  using L = FwdSmem<DH>;
  constexpr uint64_t kSwizzle = DH == 64 ? 1 : (DH == 32 ? 2 : 3);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int ntiles = (nk + kTileK - 1) / kTileK;
  uint32_t* words = reinterpret_cast<uint32_t*>(sm + L::kWords);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kWords + 8 * ntiles);
  uint64_t* full = q_full + 1;         // [kStages]: the tile's K and V have arrived
  uint64_t* empty = full + kStages;    // [kStages]: every consumer warp is done with them

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTileQ;
  const bool producer = tid == kConsumerWarps * 32;
  auto load_kv = [&](int j) {
    const int st = j % kStages;
    mbar_expect_tx(&full[st], 2 * L::kKV);
    tma_load_3d(sm + L::kK + st * L::kKV, &tk, &full[st], 0, j * kTileK, bh);
    tma_load_3d(sm + L::kV + st * L::kKV, &tv, &full[st], 0, j * kTileK, bh);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (producer) {  // the first copies fly while the block reads the mask
    mbar_expect_tx(q_full, L::kQ);
    tma_load_3d(sm, &tq, q_full, 0, q0, bh);
    for (int j = 0; j < kStages && j < ntiles; ++j) load_kv(j);
  }

  // the batch's key mask as bits, one warp a 32-key word
  const size_t mrow = static_cast<size_t>(bh / heads) * nk;
  int any = 0;
  for (int w = warp; w < 2 * ntiles; w += kConsumerWarps + 1) {
    const int key = w * 32 + lane;
    const bool ok = key < nk && (mask == nullptr || mask[mrow + key] != 0);
    const uint32_t bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) words[w] = bits;
    any |= bits != 0u;
  }
  // no valid key in the batch: every key in range weighs alike (the
  // reference's -1e30 on each), so all of them count, with scores scaled by 0
  const bool all_masked = !__syncthreads_or(any);
  if (all_masked) {
    for (int w = tid; w < 2 * ntiles; w += kThreads) {
      const int n = min(max(nk - 32 * w, 0), 32);
      words[w] = n == 32 ? 0xffffffffu : (1u << n) - 1u;
    }
    __syncthreads();
  }

  if (warp == kConsumerWarps) {  // producer: the rest of the ring
    if (producer) {
      for (int j = kStages; j < ntiles; ++j) {
        mbar_wait(&empty[j % kStages], ((j / kStages) - 1) & 1);
        load_kv(j);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const float c = all_masked ? 0.f : scale * kLog2e;
  const uint64_t dq = wgmma_desc(smem_addr(sm + wg * 64 * L::kRow), 16 * DH, kSwizzle);
  const uint32_t k_base = smem_addr(sm + L::kK), v_base = smem_addr(sm + L::kV);
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, mu[2] = {0.f, 0.f}, l[2] = {0.f, 0.f}, alpha[2];
  float s[32];
  uint32_t p[4][4];

  // Each tile: S = Q K^T, the softmax, O += P V. The two products of one
  // warpgroup run in turn; the four warpgroups an SM holds (two blocks)
  // overlap one's exponentials with another's products. fence_regs before a
  // wgmma.fence keeps the definitions of the wgmma's register operands (o's
  // rescaling, P) ahead of it, and after the issue keeps their next uses
  // behind the wait: a definition inside the pipeline makes ptxas serialise
  // the wgmmas (warning C7513).
  mbar_wait(q_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kStages;
    mbar_wait(&full[st], (j / kStages) & 1);
    fence_regs(s);
    wgmma_fence();
    issue_qk<DH>(s, dq, k_base + st * L::kKV);
    fence_regs(s);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(s, words[2 * j], words[2 * j + 1], t, c, m, mu, l, alpha);
    pack_p(s, p);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_pv<DH>(o, p, v_base + st * L::kKV);
    fence_regs(o);
    fence_regs(p);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + g;
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r0 + 8 * r < nq)
        lse[(size_t)bh * nq + r0 + 8 * r] = all_masked ? kNeg : m[r] * scale + logf(l[r]);
  }
  __nv_bfloat16* ob = out + (size_t)bh * nq * DH;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r0 + 8 * r < nq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)(r0 + 8 * r) * DH + 8 * n + 2 * t) =
            pack_bf16(o[4 * n + 2 * r] / l[r], o[4 * n + 2 * r + 1] / l[r]);
}

int smem_bytes(int dh, int nk) {
  const int ntiles = (nk + kTileK - 1) / kTileK;
  switch (dh) {
    case 16: return FwdSmem<16>::bytes(ntiles);
    case 32: return FwdSmem<32>::bytes(ntiles);
    case 64: return FwdSmem<64>::bytes(ntiles);
    default: return -1;
  }
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* mask, void* out,
                        float* lse, int bh, int heads, int nq, int nk, float scale,
                        cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode<DH>(&tq, q, bh, nq, kTileQ) || !encode<DH>(&tk, k, bh, nk, kTileK) ||
      !encode<DH>(&tv, v, bh, nk, kTileK))
    return cudaErrorInvalidValue;
  const int smem = smem_bytes(DH, nk);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static uint64_t raised = 0;  // devices whose dynamic shared memory limit is raised
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((raised >> device) & 1u)) {
    err = cudaFuncSetAttribute(attn_fwd_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    raised |= uint64_t{1} << device;
  }
  const dim3 grid((nq + kTileQ - 1) / kTileQ, bh);
  attn_fwd_wgmma<DH><<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<const uint8_t*>(mask),
                                                       static_cast<__nv_bfloat16*>(out), lse, heads,
                                                       nq, nk, scale);
  return cudaGetLastError();
}

// mask: one byte a key, or null
template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   float* lse, int bh, int heads, int nq, int nk, int is_bf16,
                   cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)DH));
  if (is_bf16) return launch_bf16<DH>(q, k, v, mask, out, lse, bh, heads, nq, nk, scale, stream);
  return launch_tf32x3<DH, true>(static_cast<const float*>(q), static_cast<const float*>(k),
                                 static_cast<const float*>(v), static_cast<const uint8_t*>(mask), nullptr,
                                 static_cast<float*>(out), lse, bh, heads, nq, nk, stream);
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* mask, void* out,
                     float* lse, int bh, int heads, int nq, int nk, int dh, int is_bf16,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq < 1 || nk < 1 || bh < 1 || bh > 65535) return cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch<16>(q, k, v, mask, out, lse, bh, heads, nq, nk, is_bf16, st);
    case 32: return launch<32>(q, k, v, mask, out, lse, bh, heads, nq, nk, is_bf16, st);
    case 64: return launch<64>(q, k, v, mask, out, lse, bh, heads, nq, nk, is_bf16, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int impx_mha_fwd(const void* q, const void* k, const void* v, const void* mask,
                            void* out, int bh, int heads, int nq, int nk, int dh, int is_bf16,
                            void* stream) {
  return (int)dispatch(q, k, v, mask, out, nullptr, bh, heads, nq, nk, dh, is_bf16, stream);
}

// Kernel 4: the forward that also writes each row's log-sum-exp, lse [BH, Nq]
// fp32 (impx/ops/pallas/attention.py:mha_fused_lse :245, _attn_kernel_lse :221)
extern "C" int impx_mha_fwd_lse(const void* q, const void* k, const void* v, const void* mask,
                                void* out, void* lse, int bh, int heads, int nq, int nk, int dh,
                                int is_bf16, void* stream) {
  return (int)dispatch(q, k, v, mask, out, static_cast<float*>(lse), bh, heads, nq, nk, dh,
                       is_bf16, stream);
}

// dynamic shared memory of one block at head dim dh and nk keys, bf16 or fp32
// (-1 for an unsupported dh)
extern "C" int impx_mha_fwd_smem_bytes(int dh, int nk, int is_bf16) {
  if (is_bf16) return smem_bytes(dh, nk);
  switch (dh) {
    case 16: return F32Smem<16, true>::bytes(nk);
    case 32: return F32Smem<32, true>::bytes(nk);
    case 64: return F32Smem<64, true>::bytes(nk);
    default: return -1;
  }
}
