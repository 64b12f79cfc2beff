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
// backward csrc/attention_bwd.cu (impx_mha_bwd_lse). For a fully masked row
// m = -1e30 and l = Nk, and the log term is absorbed: lse == -1e30 exactly,
// as in the TPU kernel.
//
// Bound on the H100: the two products, 4 * Nq * Nk * dh flops per
// (batch, head), against the bf16 tensor-core rate; the exponentials take
// about as long and the bytes of q, k, v, o a third of that. Scores and
// probabilities live in registers only.
//
// Layout: q [BH, Nq, dh], k/v [BH, Nk, dh] contiguous, mask [B, Nk] fp32
// (1 valid / 0 masked, or null for all valid), out like q. One block per
// (64 queries, batch*head); 64-key tiles of K and V in shared memory.
//   bf16: 4 warps, each owns 16 query rows; QK^T and P.V by mma.sync
//         m16n8k16 (bf16 in, fp32 accumulate). The S accumulator fragment is
//         the A fragment of P.V, so P never leaves registers.
//   fp32: 256 threads, 4 per query row, plain FMA in full fp32.
// Semantics of the TPU kernel: scale by 1/sqrt(dh) before masking; masked
// keys score the finite -1e30 (a fully masked row averages V uniformly, never
// NaN); keys past Nk (the ragged last tile) get weight 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

// ----------------------------------------------------------------- bf16, mma
template <int DH>
__global__ void __launch_bounds__(128)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int heads, int nq, int nk,
              float scale) {
  constexpr int LD = DH + 8;        // bf16 row stride: 16-byte rows, conflict-free fragments
  constexpr int KSTEPS = DH / 16;   // k-steps of QK^T
  constexpr int NT = DH / 8;        // n-tiles of P.V
  constexpr int CH = DH / 8;        // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * LD];
  __shared__ float code[kBlockK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const float* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const __nv_bfloat16* qb = q + (size_t)bh * nq * DH;
  const __nv_bfloat16* kb = k + (size_t)bh * nk * DH;
  const __nv_bfloat16* vb = v + (size_t)bh * nk * DH;
  const int r0 = blockIdx.x * kBlockQ + warp * 16 + g, r1 = r0 + 8;

  // this warp's 16 query rows as A fragments, held for the whole key loop
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const int c = s * 16 + 2 * t;
    qa[s][0] = r0 < nq ? ld_u32(qb + (size_t)r0 * DH + c) : 0u;
    qa[s][1] = r1 < nq ? ld_u32(qb + (size_t)r1 * DH + c) : 0u;
    qa[s][2] = r0 < nq ? ld_u32(qb + (size_t)r0 * DH + c + 8) : 0u;
    qa[s][3] = r1 < nq ? ld_u32(qb + (size_t)r1 * DH + c + 8) : 0u;
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows r0, r1
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

  for (int k0 = 0; k0 < nk; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBlockK * CH; idx += 128) {
      const int key = idx / CH, ch = idx % CH;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + key < nk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + key) * DH + ch * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + key) * DH + ch * 8);
      }
      *reinterpret_cast<uint4*>(ks + key * LD + ch * 8) = kv;
      *reinterpret_cast<uint4*>(vs + key * LD + ch * 8) = vv;
    }
    if (tid < kBlockK) code[tid] = key_code(mask_row, k0 + tid, nk);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys; s[j] covers keys j*8 .. j*8+7
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st) {
        const __nv_bfloat16* kp = ks + (j * 8 + g) * LD + st * 16 + 2 * t;
        mma_bf16(s[j], qa[st], ld_u32(kp), ld_u32(kp + 8));
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float c0 = code[j * 8 + 2 * t], c1 = code[j * 8 + 2 * t + 1];
      s[j][0] = masked_score(s[j][0] * scale, c0);
      s[j][1] = masked_score(s[j][1] * scale, c1);
      s[j][2] = masked_score(s[j][2] * scale, c0);
      s[j][3] = masked_score(s[j][3] * scale, c1);
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds at least one key < nk, so the new max is finite
    const float mn0 = fmaxf(m_run[0], mx0), mn1 = fmaxf(m_run[1], mx1);
    const float a0 = expf(m_run[0] - mn0), a1 = expf(m_run[1] - mn1);
    m_run[0] = mn0;
    m_run[1] = mn1;

    uint32_t pa[4][4];  // P as A fragments of P.V, one per 16-key step
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e0 = expf(s[j][0] - mn0), e1 = expf(s[j][1] - mn0);
      const float e2 = expf(s[j][2] - mn1), e3 = expf(s[j][3] - mn1);
      sum0 += e0 + e1;
      sum1 += e2 + e3;
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(e0, e1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(e2, e3);
    }
    l_run[0] = l_run[0] * a0 + sum0;
    l_run[1] = l_run[1] * a1 + sum1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P V; B[key][d] read as two bf16 of consecutive key rows
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const __nv_bfloat16* vp = vs + (st * 16 + 2 * t) * LD + n * 8 + g;
        mma_bf16(o[n], pa[st], ld_pair_rows(vp, LD), ld_pair_rows(vp + 8 * LD, LD));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_run[0] += __shfl_xor_sync(0xffffffffu, l_run[0], off);
    l_run[1] += __shfl_xor_sync(0xffffffffu, l_run[1], off);
  }
  if (lse != nullptr && t == 0) {  // m + log(l): a fully masked row keeps -1e30 exactly
    if (r0 < nq) lse[(size_t)bh * nq + r0] = m_run[0] + logf(l_run[0]);
    if (r1 < nq) lse[(size_t)bh * nq + r1] = m_run[1] + logf(l_run[1]);
  }
  __nv_bfloat16* ob = out + (size_t)bh * nq * DH;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < nq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * DH + c) =
          pack_bf16(o[n][0] / l_run[0], o[n][1] / l_run[0]);
    if (r1 < nq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * DH + c) =
          pack_bf16(o[n][2] / l_run[1], o[n][3] / l_run[1]);
  }
}

// ------------------------------------------------------------------ fp32, FMA
template <int DH>
__global__ void __launch_bounds__(256)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ mask,
             float* __restrict__ out, float* __restrict__ lse, int heads, int nq, int nk,
             float scale) {
  constexpr int KLD = DH + 1;            // padded K row
  constexpr int PLD = kBlockK + 1;       // padded P row
  constexpr int PER = kBlockK / 4;       // keys per thread
  constexpr int DPER = DH / 4;           // output columns per thread
  __shared__ float kp[kBlockQ * PLD];    // the K tile, then the P tile
  __shared__ float vs[kBlockK * DH];
  __shared__ float code[kBlockK];
  static_assert(kBlockK * KLD <= kBlockQ * PLD, "K tile must fit the P buffer");

  const int tid = threadIdx.x, row = tid >> 2, sub = tid & 3;
  const int bh = blockIdx.y;
  const int r = blockIdx.x * kBlockQ + row;
  const float* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const float* kb = k + (size_t)bh * nk * DH;
  const float* vb = v + (size_t)bh * nk * DH;

  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = r < nq ? q[((size_t)bh * nq + r) * DH + d] : 0.f;
  float o[DPER];
#pragma unroll
  for (int i = 0; i < DPER; ++i) o[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kBlockK) {
    __syncthreads();
    for (int idx = tid; idx < kBlockK * DH; idx += 256) {
      const int key = idx / DH, d = idx % DH;
      const bool in = k0 + key < nk;
      kp[key * KLD + d] = in ? kb[(size_t)(k0 + key) * DH + d] : 0.f;
      vs[key * DH + d] = in ? vb[(size_t)(k0 + key) * DH + d] : 0.f;
    }
    if (tid < kBlockK) code[tid] = key_code(mask_row, k0 + tid, nk);
    __syncthreads();

    float s[PER];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int key = sub + 4 * i;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(qr[d], kp[key * KLD + d], acc);
      s[i] = masked_score(acc * scale, code[key]);
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m_run, mx);
    const float alpha = expf(m_run - mn);
    m_run = mn;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      s[i] = expf(s[i] - mn);
      sum += s[i];
    }
    l_run = l_run * alpha + sum;
#pragma unroll
    for (int i = 0; i < DPER; ++i) o[i] *= alpha;

    __syncthreads();  // K is consumed; the buffer takes P
#pragma unroll
    for (int i = 0; i < PER; ++i) kp[row * PLD + sub + 4 * i] = s[i];
    __syncthreads();
    for (int j = 0; j < kBlockK; ++j) {
      const float p = kp[row * PLD + j];
#pragma unroll
      for (int i = 0; i < DPER; ++i) o[i] = fmaf(p, vs[j * DH + sub + 4 * i], o[i]);
    }
  }
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  if (lse != nullptr && sub == 0 && r < nq) lse[(size_t)bh * nq + r] = m_run + logf(l_run);
  if (r < nq) {
#pragma unroll
    for (int i = 0; i < DPER; ++i) out[((size_t)bh * nq + r) * DH + sub + 4 * i] = o[i] / l_run;
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* mask, void* out,
                   float* lse, int bh, int heads, int nq, int nk, int is_bf16,
                   cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)DH));
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, bh);
  if (is_bf16) {
    attn_fwd_bf16<DH><<<grid, 128, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out), lse, heads,
        nq, nk, scale);
  } else {
    attn_fwd_f32<DH><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        mask, static_cast<float*>(out), lse, heads, nq, nk, scale);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* mask, void* out,
                     float* lse, int bh, int heads, int nq, int nk, int dh, int is_bf16,
                     void* stream) {
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq < 1 || nk < 1 || bh < 1 || bh > 65535) return cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch<16>(q, k, v, m, out, lse, bh, heads, nq, nk, is_bf16, st);
    case 32: return launch<32>(q, k, v, m, out, lse, bh, heads, nq, nk, is_bf16, st);
    case 64: return launch<64>(q, k, v, m, out, lse, bh, heads, nq, nk, is_bf16, st);
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
