// Per-key attention mass for Hopper (sm_90a): the EIMP pooling statistic.
//
// Replaces the TPU kernel impx/ops/pallas/attention.py:attention_key_mass
// (:422, pallas_call :440, kernel _mass_kernel :395). For every key, the
// softmax probability q.k / sqrt(dh) over keys, summed over heads and over the
// queries that query_mask keeps: [B, Nk] fp32. The TPU kernel holds all of K
// of one (batch, head) in VMEM, softmaxes a block of queries against every
// key at once and adds the block's column sums into one [Nk] accumulator
// carried across its sequential (head, query-block) grid. On the H100, K at
// N = 2048, dh = 64 is 256 KB in bf16, more than a block's 227 KB of shared
// memory, and blocks run in parallel and carry nothing between them.
//
// Bound on the H100: the QK^T product, 2 * Nq * Nk * dh flops per (batch,
// head), against the bf16 tensor-core rate, and about as long again for the
// exponentials on the special-function units; q and k are read once. This
// design is simple first: it computes QK^T and the exponentials twice.
//   pass 1: over 64-key tiles, each query row's running max and sum;
//   pass 2: the scores again, p = exp(s - max) / sum * query_mask, reduced
//           over the block's 64 queries into a per-key column sum (within the
//           mma fragment, across lanes by shuffles, across warps through
//           shared memory) and written as one partial row;
//   then a second launch sums each key's partial rows in a fixed order.
// No atomics: the same inputs give the same bits on every run, which pooling
// needs, since it compares each mass with a median.
//
// Layout: q [BH, Nq, dh], k [BH, Nk, dh] contiguous; key_mask [B, Nk] and
// query_mask [B, Nq] fp32 (1 / 0, or null for all ones); partial
// [B, H * ceil(Nq / 64), Nk] fp32 scratch (row h * ceil(Nq / 64) + tile),
// which the caller sizes from impx_attention_key_mass_block_q(); out [B, Nk]
// fp32. One block per (64 queries, batch*head).
//   bf16: 4 warps, each owns 16 query rows; QK^T by mma.sync m16n8k16 (bf16
//         in, fp32 accumulate), as csrc/attention.cu.
//   fp32: 256 threads, 4 per query row, plain FMA in full fp32.
// Semantics of the TPU kernel: scale by 1/sqrt(dh) before masking; masked
// keys score the finite -1e30 (a query with no valid key spreads 1/Nk over
// all Nk keys, masked ones included); keys past Nk (the ragged last tile) and
// query rows past Nq weigh 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float query_weight(const float* qmask_row, int row, int nq) {
  if (row >= nq) return 0.f;
  return qmask_row == nullptr ? 1.f : qmask_row[row];
}

// ----------------------------------------------------------------- bf16, mma
// one 64-key tile of K into shared memory (zeros past nk), and its key codes
template <int DH, int THREADS>
__device__ __forceinline__ void load_k_tile_bf16(__nv_bfloat16* ks, float* code,
                                                 const __nv_bfloat16* kb, const float* mask_row,
                                                 int k0, int nk, int tid) {
  constexpr int LD = DH + 8;  // 16-byte rows, conflict-free fragments
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < kBlockK * CH; idx += THREADS) {
    const int key = idx / CH, ch = idx % CH;
    uint4 kv = make_uint4(0, 0, 0, 0);
    if (k0 + key < nk) kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + key) * DH + ch * 8);
    *reinterpret_cast<uint4*>(ks + key * LD + ch * 8) = kv;
  }
  if (tid < kBlockK) code[tid] = key_code(mask_row, k0 + tid, nk);
}

// masked, scaled scores of this warp's 16 rows against the tile's 64 keys;
// s[j] covers keys j*8 .. j*8+7 (mma C fragment: rows g, g+8; cols 2t, 2t+1)
template <int DH>
__device__ __forceinline__ void tile_scores_bf16(float (&s)[8][4], const uint32_t (&qa)[DH / 16][4],
                                                 const __nv_bfloat16* ks, const float* code,
                                                 float scale, int g, int t) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int st = 0; st < DH / 16; ++st) {
      const __nv_bfloat16* kp = ks + (j * 8 + g) * LD + st * 16 + 2 * t;
      mma_bf16(s[j], qa[st], ld_u32(kp), ld_u32(kp + 8));
    }
    const float c0 = code[j * 8 + 2 * t], c1 = code[j * 8 + 2 * t + 1];
    s[j][0] = masked_score(s[j][0] * scale, c0);
    s[j][1] = masked_score(s[j][1] * scale, c1);
    s[j][2] = masked_score(s[j][2] * scale, c0);
    s[j][3] = masked_score(s[j][3] * scale, c1);
  }
}

template <int DH>
__global__ void __launch_bounds__(128)
key_mass_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const float* __restrict__ key_mask, const float* __restrict__ query_mask,
              float* __restrict__ partial, int heads, int nq, int nk, float scale) {
  constexpr int LD = DH + 8;
  constexpr int KSTEPS = DH / 16;
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * LD];
  __shared__ float code[kBlockK];
  __shared__ float colsum[4][kBlockK];  // per warp

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads;
  const float* mask_row = key_mask == nullptr ? nullptr : key_mask + (size_t)b * nk;
  const float* qmask_row = query_mask == nullptr ? nullptr : query_mask + (size_t)b * nq;
  const __nv_bfloat16* qb = q + (size_t)bh * nq * DH;
  const __nv_bfloat16* kb = k + (size_t)bh * nk * DH;
  const int r0 = blockIdx.x * kBlockQ + warp * 16 + g, r1 = r0 + 8;

  uint32_t qa[KSTEPS][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const int c = s * 16 + 2 * t;
    qa[s][0] = r0 < nq ? ld_u32(qb + (size_t)r0 * DH + c) : 0u;
    qa[s][1] = r1 < nq ? ld_u32(qb + (size_t)r1 * DH + c) : 0u;
    qa[s][2] = r0 < nq ? ld_u32(qb + (size_t)r0 * DH + c + 8) : 0u;
    qa[s][3] = r1 < nq ? ld_u32(qb + (size_t)r1 * DH + c + 8) : 0u;
  }

  // pass 1: row max and row sum (this thread's share of the sum)
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float s[8][4];
  for (int k0 = 0; k0 < nk; k0 += kBlockK) {
    __syncthreads();
    load_k_tile_bf16<DH, 128>(ks, code, kb, mask_row, k0, nk, tid);
    __syncthreads();
    tile_scores_bf16<DH>(s, qa, ks, code, scale, g, t);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
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
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum0 += expf(s[j][0] - mn0) + expf(s[j][1] - mn0);
      sum1 += expf(s[j][2] - mn1) + expf(s[j][3] - mn1);
    }
    l_run[0] = l_run[0] * expf(m_run[0] - mn0) + sum0;
    l_run[1] = l_run[1] * expf(m_run[1] - mn1) + sum1;
    m_run[0] = mn0;
    m_run[1] = mn1;
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_run[0] += __shfl_xor_sync(0xffffffffu, l_run[0], off);
    l_run[1] += __shfl_xor_sync(0xffffffffu, l_run[1], off);
  }
  // each row's weight over its sum: p * query_mask = exp(s - max) * c
  const float c0 = query_weight(qmask_row, r0, nq) / l_run[0];
  const float c1 = query_weight(qmask_row, r1, nq) / l_run[1];

  // pass 2: column sums of p over the block's 64 rows, one partial row
  float* prow = partial + (size_t)(bh * gridDim.x + blockIdx.x) * nk;
  for (int k0 = 0; k0 < nk; k0 += kBlockK) {
    __syncthreads();  // the previous tile and its column sums are consumed
    load_k_tile_bf16<DH, 128>(ks, code, kb, mask_row, k0, nk, tid);
    __syncthreads();
    tile_scores_bf16<DH>(s, qa, ks, code, scale, g, t);
    float cs[8][2];  // columns j*8 + 2t, j*8 + 2t + 1 over rows g, g + 8
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cs[j][0] = expf(s[j][0] - m_run[0]) * c0 + expf(s[j][2] - m_run[1]) * c1;
      cs[j][1] = expf(s[j][1] - m_run[0]) * c0 + expf(s[j][3] - m_run[1]) * c1;
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {  // over g: the warp's 16 rows
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cs[j][0] += __shfl_xor_sync(0xffffffffu, cs[j][0], off);
        cs[j][1] += __shfl_xor_sync(0xffffffffu, cs[j][1], off);
      }
    }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        colsum[warp][j * 8 + 2 * t] = cs[j][0];
        colsum[warp][j * 8 + 2 * t + 1] = cs[j][1];
      }
    }
    __syncthreads();
    if (tid < kBlockK && k0 + tid < nk)
      prow[k0 + tid] = ((colsum[0][tid] + colsum[1][tid]) + colsum[2][tid]) + colsum[3][tid];
  }
}

// ------------------------------------------------------------------ fp32, FMA
template <int DH>
__global__ void __launch_bounds__(256)
key_mass_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ key_mask, const float* __restrict__ query_mask,
             float* __restrict__ partial, int heads, int nq, int nk, float scale) {
  constexpr int KLD = DH + 1;       // padded K row
  constexpr int PLD = kBlockK + 1;  // padded P row
  constexpr int PER = kBlockK / 4;  // keys per thread
  __shared__ float ks[kBlockK * KLD];
  __shared__ float ps[kBlockQ * PLD];
  __shared__ float code[kBlockK];

  const int tid = threadIdx.x, row = tid >> 2, sub = tid & 3;
  const int bh = blockIdx.y, b = bh / heads;
  const int r = blockIdx.x * kBlockQ + row;
  const float* mask_row = key_mask == nullptr ? nullptr : key_mask + (size_t)b * nk;
  const float* qmask_row = query_mask == nullptr ? nullptr : query_mask + (size_t)b * nq;
  const float* kb = k + (size_t)bh * nk * DH;

  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = r < nq ? q[((size_t)bh * nq + r) * DH + d] : 0.f;

  // scores of this thread's keys sub, sub + 4, ... of the tile
  auto load_and_score = [&](float (&s)[PER], int k0) {
    __syncthreads();
    for (int idx = tid; idx < kBlockK * DH; idx += 256) {
      const int key = idx / DH, d = idx % DH;
      ks[key * KLD + d] = k0 + key < nk ? kb[(size_t)(k0 + key) * DH + d] : 0.f;
    }
    if (tid < kBlockK) code[tid] = key_code(mask_row, k0 + tid, nk);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int key = sub + 4 * i;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(qr[d], ks[key * KLD + d], acc);
      s[i] = masked_score(acc * scale, code[key]);
    }
  };

  float s[PER];
  float m_run = -INFINITY, l_run = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kBlockK) {  // pass 1
    load_and_score(s, k0);
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < PER; ++i) mx = fmaxf(mx, s[i]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) sum += expf(s[i] - mn);
    l_run = l_run * expf(m_run - mn) + sum;
    m_run = mn;
  }
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  const float c = query_weight(qmask_row, r, nq) / l_run;

  float* prow = partial + (size_t)(bh * gridDim.x + blockIdx.x) * nk;
  for (int k0 = 0; k0 < nk; k0 += kBlockK) {  // pass 2
    load_and_score(s, k0);  // its first barrier also retires the last tile's column sums
#pragma unroll
    for (int i = 0; i < PER; ++i) ps[row * PLD + sub + 4 * i] = expf(s[i] - m_run) * c;
    __syncthreads();
    if (tid < kBlockK && k0 + tid < nk) {
      float acc = 0.f;
      for (int i = 0; i < kBlockQ; ++i) acc += ps[i * PLD + tid];
      prow[k0 + tid] = acc;
    }
  }
}

// out[b, key] = the sum of partial[b, :, key], rows in order
__global__ void __launch_bounds__(kReduceThreads)
key_mass_reduce(const float* __restrict__ partial, float* __restrict__ out, int rows, int nk) {
  const int key = blockIdx.x * kReduceThreads + threadIdx.x;
  if (key >= nk) return;
  const float* p = partial + (size_t)blockIdx.y * rows * nk + key;
  float acc = 0.f;
  for (int r = 0; r < rows; ++r) acc += p[(size_t)r * nk];
  out[(size_t)blockIdx.y * nk + key] = acc;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const float* key_mask, const float* query_mask,
                   float* partial, float* out, int bh, int heads, int nq, int nk, int is_bf16,
                   cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)DH));
  const int tiles = (nq + kBlockQ - 1) / kBlockQ;
  const dim3 grid(tiles, bh);
  if (is_bf16) {
    key_mass_bf16<DH><<<grid, 128, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), key_mask,
        query_mask, partial, heads, nq, nk, scale);
  } else {
    key_mass_f32<DH><<<grid, 256, 0, stream>>>(static_cast<const float*>(q),
                                                static_cast<const float*>(k), key_mask,
                                                query_mask, partial, heads, nq, nk, scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rgrid((nk + kReduceThreads - 1) / kReduceThreads, bh / heads);
  key_mass_reduce<<<rgrid, kReduceThreads, 0, stream>>>(partial, out, heads * tiles, nk);
  return cudaGetLastError();
}

}  // namespace

// the query rows per block, which fix the partial buffer's row count
extern "C" int impx_attention_key_mass_block_q() { return kBlockQ; }

extern "C" int impx_attention_key_mass(const void* q, const void* k, const void* key_mask,
                                       const void* query_mask, void* partial, void* out, int bh,
                                       int heads, int nq, int nk, int dh, int is_bf16,
                                       void* stream) {
  const float* km = static_cast<const float*>(key_mask);
  const float* qm = static_cast<const float*>(query_mask);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq < 1 || nk < 1 || heads < 1 || bh < heads || bh % heads || bh > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return (int)launch<16>(q, k, km, qm, p, o, bh, heads, nq, nk, is_bf16, st);
    case 32: return (int)launch<32>(q, k, km, qm, p, o, bh, heads, nq, nk, is_bf16, st);
    case 64: return (int)launch<64>(q, k, km, qm, p, o, bh, heads, nq, nk, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
