// Masked multi-head attention backward for Hopper (sm_90a): the two training
// backward kernels of impx/ops/pallas/attention.py.
//
// Kernel 3, impx_mha_bwd, replaces _mha_bwd_call (:137, kernel
// _attn_bwd_kernel :96), the VJP of mha_fused. It takes no saved residual:
// p = exp(s - max) / sum is recomputed, dp = do v^T, delta = rowsum(dp * p),
// ds = p (dp - delta) scale, dq = ds k, dk = ds^T q, dv = p^T do. Every product
// but QK^T takes fp32 operands (bf16 do, v, k, q upcast); a fully masked row
// (every key at -1e30) gets p = 1/Nk.
//
// Kernel 5, impx_mha_bwd_lse, replaces mha_bwd_from_lse (:336, kernel
// _attn_bwd_lse_kernel :290), the VJP of mha_fused_lse from its saved o and
// row lse: p = exp(s - lse), delta = rowsum(do * o) (upcast), dp = do v^T,
// ds = p (dp - delta) scale rounded to the stream dtype; every product takes
// stream-dtype operands with fp32 accumulation, p rounded to the stream dtype
// before p^T do. A fully masked row has lse == -1e30 (csrc/attention.cu), so
// p = exp(-1e30 + 1e30) = 1 there, not 1/Nk: the reference's own behaviour,
// kept.
//
// The TPU kernels hold all of K and V of one (batch, head) in VMEM and carry
// dk and dv across a sequential grid over query blocks. An SM holds 227 KB and
// blocks run in parallel and carry nothing, so every output has one owner:
// one launch over (64-query tiles, batch*head) loops over the key tiles for
// dq, one over (64-key tiles, batch*head) loops over the query tiles for dk
// and dv, each accumulating in fp32 registers and rounding once at the end.
// No atomics: a second run on the same inputs gives the same bits. Tiles past
// Nq or Nk are zero-filled and weigh 0 (p = 0, ds = 0), so no 0 * NaN reaches
// a sum.
//
// Bound on the H100. Kernel 3: four fp32 products (dp, dv, dq, dk), 8 * Nq *
// Nk * dh flops per (batch, head), against the 67 TFLOP/s of fp32 FMA, plus
// one QK^T. This first design runs on the FMA path for both dtypes (the QK^T
// products of bf16 values are exact in fp32, so it is the same function as a
// bf16 product with fp32 accumulation) and recomputes QK^T in each of its
// four passes: the dq launch finds each row's max and sum (pass 1), delta
// (pass 2) and dq (pass 3), and writes max, sum and delta for the dk/dv
// launch (pass 4). Kernel 5: five products against the bf16 tensor cores;
// bf16 inputs take mma.sync m16n8k16 (bf16 in, fp32 accumulate), QK^T and dp
// computed once in each of the two launches; a small launch before them
// computes delta. fp32 inputs take the FMA path with p = exp(s - lse).
//
// Layout: q, o, do, dq [BH, Nq, dh]; k, v, dk, dv [BH, Nk, dh], contiguous;
// mask [B, Nk] fp32 (1 valid / 0 masked, or null); lse [BH, Nq] fp32;
// scratch fp32, [3, BH, Nq] for kernel 3 (max, sum, delta) and [BH, Nq] for
// kernel 5 (delta), sized by the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 64;     // query rows (dq launch) or key rows (dk/dv launch) per block
constexpr int kFmaThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ------------------------------------------------------- delta = rowsum(do * o)
// one warp per row
template <typename T>
__global__ void __launch_bounds__(256)
row_dot(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out, int rows,
        int dh) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32)
    acc += to_f(a[(size_t)row * dh + d]) * to_f(b[(size_t)row * dh + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = acc;
}

// ------------------------------------------------------------------ FMA path
// 256 threads, 4 per row of the block's 64 rows; thread `sub` of a row takes
// the tile's columns sub, sub + 4, ... and the output columns sub + 4 i.

// rows [row0, row0 + 64) of a [rows, DH] tensor as fp32, row stride ld, zeros
// past nrows
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int row0, int nrows) {
  for (int idx = threadIdx.x; idx < kBlock * DH; idx += kFmaThreads) {
    const int rr = idx / DH, d = idx % DH;
    dst[rr * ld + d] = row0 + rr < nrows ? to_f(src[(size_t)(row0 + rr) * DH + d]) : 0.f;
  }
}

template <typename T, int DH>
__device__ __forceinline__ void load_row(float (&dst)[DH], const T* src, bool live) {
#pragma unroll
  for (int d = 0; d < DH; ++d) dst[d] = live ? to_f(src[d]) : 0.f;
}

template <int DH>
__device__ __forceinline__ float dot_row(const float (&x)[DH], const float* y) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc = fmaf(x[d], y[d], acc);
  return acc;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// dq for one (64-query tile, batch*head). kLse: p = exp(s - lse), delta given
// (kernel 5 at fp32). Otherwise (kernel 3): passes 1 and 2 find each row's max
// m, sum l and delta = sum_j dp_j p_j, written to stat_a/stat_l/delta for the
// dk/dv launch, and p = exp(s - m) / l.
template <typename T, int DH, bool kLse>
__global__ void __launch_bounds__(kFmaThreads)
bwd_dq_fma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ mask, const T* __restrict__ dout,
           float* __restrict__ stat_a, float* __restrict__ stat_l, float* __restrict__ delta,
           T* __restrict__ dq, int heads, int nq, int nk, float scale) {
  constexpr int KLD = DH + 1;          // padded K / V row
  constexpr int PLD = kBlock + 1;      // padded dS row
  constexpr int PER = kBlock / 4;      // keys per thread and tile
  constexpr int DPER = DH / 4;         // output columns per thread
  __shared__ float ks[kBlock * KLD];
  __shared__ float vd[kBlock * PLD];   // the V tile, then the dS tile
  __shared__ float code[kBlock];
  static_assert(KLD <= PLD, "the V tile must fit the dS buffer");

  const int row = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const int bh = blockIdx.y;
  const int r = blockIdx.x * kBlock + row;
  const bool live = r < nq;
  const size_t rq = (size_t)bh * nq + r;
  const float* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const T* kb = k + (size_t)bh * nk * DH;
  const T* vb = v + (size_t)bh * nk * DH;

  float qr[DH], dr[DH];
  load_row<T, DH>(qr, q + rq * DH, live);
  load_row<T, DH>(dr, dout + rq * DH, live);

  // stat_r: lse (kLse) or the row max; inv_l: 1 (kLse) or the row sum
  float stat_r, l_r = 1.f, dlt;
  if (kLse) {
    stat_r = live ? stat_a[rq] : INFINITY;  // p = 0 on rows past nq
    dlt = live ? delta[rq] : 0.f;
  } else {
    float m_run = -INFINITY, l_run = 0.f;
    for (int k0 = 0; k0 < nk; k0 += kBlock) {  // pass 1: online max and sum
      __syncthreads();
      load_tile<T, DH>(ks, KLD, kb, k0, nk);
      if (threadIdx.x < kBlock) code[threadIdx.x] = key_code(mask_row, k0 + threadIdx.x, nk);
      __syncthreads();
      float s[PER];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int key = sub + 4 * i;
        s[i] = masked_score(dot_row<DH>(qr, ks + key * KLD) * scale, code[key]);
        mx = fmaxf(mx, s[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m_run, mx);  // finite: every tile has a key < nk
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) sum += expf(s[i] - mn);
      l_run = l_run * expf(m_run - mn) + sum;
      m_run = mn;
    }
    l_run = quad_sum(l_run);
    float acc = 0.f;
    for (int k0 = 0; k0 < nk; k0 += kBlock) {  // pass 2: delta = sum_j dp_j p_j
      __syncthreads();
      load_tile<T, DH>(ks, KLD, kb, k0, nk);
      load_tile<T, DH>(vd, KLD, vb, k0, nk);
      if (threadIdx.x < kBlock) code[threadIdx.x] = key_code(mask_row, k0 + threadIdx.x, nk);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int key = sub + 4 * i;
        const float s = masked_score(dot_row<DH>(qr, ks + key * KLD) * scale, code[key]);
        const float p = expf(s - m_run) / l_run;
        acc += dot_row<DH>(dr, vd + key * KLD) * p;
      }
    }
    stat_r = m_run;
    l_r = l_run;
    dlt = quad_sum(acc);
    if (live && sub == 0) {
      stat_a[rq] = m_run;
      stat_l[rq] = l_run;
      delta[rq] = dlt;
    }
  }

  float acc[DPER];
#pragma unroll
  for (int i = 0; i < DPER; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kBlock) {  // pass 3: dq = sum_j ds_j k_j
    __syncthreads();
    load_tile<T, DH>(ks, KLD, kb, k0, nk);
    load_tile<T, DH>(vd, KLD, vb, k0, nk);
    if (threadIdx.x < kBlock) code[threadIdx.x] = key_code(mask_row, k0 + threadIdx.x, nk);
    __syncthreads();
    float ds[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int key = sub + 4 * i;
      const float s = masked_score(dot_row<DH>(qr, ks + key * KLD) * scale, code[key]);
      const float p = kLse ? expf(s - stat_r) : expf(s - stat_r) / l_r;
      const float dp = dot_row<DH>(dr, vd + key * KLD);
      ds[i] = p * (dp - dlt) * scale;
    }
    __syncthreads();  // V is consumed; the buffer takes dS
#pragma unroll
    for (int i = 0; i < PER; ++i) vd[row * PLD + sub + 4 * i] = ds[i];
    __syncthreads();
    for (int j = 0; j < kBlock; ++j) {
      const float w = vd[row * PLD + j];
#pragma unroll
      for (int i = 0; i < DPER; ++i) acc[i] = fmaf(w, ks[j * KLD + sub + 4 * i], acc[i]);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < DPER; ++i) put(dq + rq * DH + sub + 4 * i, acc[i]);
  }
}

template <int DH>
constexpr size_t dkdv_fma_smem() {
  return sizeof(float) * (2 * kBlock * (DH + 1) + 2 * kBlock * (kBlock + 1) + 3 * kBlock);
}

// dk and dv for one (64-key tile, batch*head), looping over the query tiles,
// with the per-row statistics of the dq launch (or lse and delta, kLse).
template <typename T, int DH, bool kLse>
__global__ void __launch_bounds__(kFmaThreads)
bwd_dkdv_fma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ mask, const T* __restrict__ dout,
             const float* __restrict__ stat_a, const float* __restrict__ stat_l,
             const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int heads,
             int nq, int nk, float scale) {
  constexpr int KLD = DH + 1;
  constexpr int PLD = kBlock + 1;
  constexpr int PER = kBlock / 4;
  constexpr int DPER = DH / 4;
  extern __shared__ float smem[];
  float* qs = smem;                    // Q tile [query][KLD]
  float* os = qs + kBlock * KLD;       // dO tile [query][KLD]
  float* pt = os + kBlock * KLD;       // P^T [key][PLD]
  float* st = pt + kBlock * PLD;       // dS^T [key][PLD]
  float* sa = st + kBlock * PLD;       // per query: lse or max
  float* sl = sa + kBlock;             // per query: 1 or sum
  float* sd = sl + kBlock;             // per query: delta

  const int row = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const int bh = blockIdx.y;
  const int key = blockIdx.x * kBlock + row;
  const bool live = key < nk;
  const size_t rk = (size_t)bh * nk + key;
  const float* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const float c = key_code(mask_row, key, nk);  // -1 past nk: p = 0
  const T* qb = q + (size_t)bh * nq * DH;
  const T* ob = dout + (size_t)bh * nq * DH;

  float kr[DH], vr[DH];
  load_row<T, DH>(kr, k + rk * DH, live);
  load_row<T, DH>(vr, v + rk * DH, live);
  float dka[DPER], dva[DPER];
#pragma unroll
  for (int i = 0; i < DPER; ++i) dka[i] = dva[i] = 0.f;

  for (int q0 = 0; q0 < nq; q0 += kBlock) {
    __syncthreads();
    load_tile<T, DH>(qs, KLD, qb, q0, nq);
    load_tile<T, DH>(os, KLD, ob, q0, nq);
    if (threadIdx.x < kBlock) {
      const int qq = q0 + threadIdx.x;
      const bool ok = qq < nq;  // rows past nq: p = 0, delta = 0
      const size_t i = (size_t)bh * nq + qq;
      sa[threadIdx.x] = ok ? stat_a[i] : INFINITY;
      sl[threadIdx.x] = ok && !kLse ? stat_l[i] : 1.f;
      sd[threadIdx.x] = ok ? delta[i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int qq = sub + 4 * i;
      const float s = masked_score(dot_row<DH>(kr, qs + qq * KLD) * scale, c);
      const float p = kLse ? expf(s - sa[qq]) : expf(s - sa[qq]) / sl[qq];
      const float dp = dot_row<DH>(vr, os + qq * KLD);
      pt[row * PLD + qq] = p;
      st[row * PLD + qq] = p * (dp - sd[qq]) * scale;
    }
    __syncthreads();
    for (int j = 0; j < kBlock; ++j) {
      const float pj = pt[row * PLD + j], sj = st[row * PLD + j];
#pragma unroll
      for (int i = 0; i < DPER; ++i) {
        dva[i] = fmaf(pj, os[j * KLD + sub + 4 * i], dva[i]);
        dka[i] = fmaf(sj, qs[j * KLD + sub + 4 * i], dka[i]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < DPER; ++i) {
      put(dk + rk * DH + sub + 4 * i, dka[i]);
      put(dv + rk * DH + sub + 4 * i, dva[i]);
    }
  }
}

// ------------------------------------------------------- kernel 5, bf16, mma
// 4 warps; a warp owns 16 rows of the block's 64. Fragment layouts as in
// csrc/attention.cu: an accumulator tile of 16 rows x 64 columns is the A
// operand of the next product, so p and ds never leave registers.

// one 64-row tile of a [rows, DH] bf16 tensor into shared memory, zeros past nrows
template <int DH>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int row0, int nrows) {
  constexpr int LD = DH + 8, CH = DH / 8;
  for (int idx = threadIdx.x; idx < kBlock * CH; idx += 128) {
    const int rr = idx / CH, ch = idx % CH;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + rr < nrows) x = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + rr) * DH + ch * 8);
    *reinterpret_cast<uint4*>(dst + rr * LD + ch * 8) = x;
  }
}

// rows r0 = row, r1 = row + 8 of a [rows, DH] bf16 tensor as A fragments
template <int DH>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[DH / 16][4], const __nv_bfloat16* src,
                                             int r0, int nrows, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int s = 0; s < DH / 16; ++s) {
    const int c = s * 16 + 2 * t;
    a[s][0] = r0 < nrows ? ld_u32(src + (size_t)r0 * DH + c) : 0u;
    a[s][1] = r1 < nrows ? ld_u32(src + (size_t)r1 * DH + c) : 0u;
    a[s][2] = r0 < nrows ? ld_u32(src + (size_t)r0 * DH + c + 8) : 0u;
    a[s][3] = r1 < nrows ? ld_u32(src + (size_t)r1 * DH + c + 8) : 0u;
  }
}

// acc[j] (16 rows x 8 columns j*8..j*8+7) += A (16 rows x DH) times the
// transpose of the 64-row tile `tile` (its rows are the columns)
template <int DH>
__device__ __forceinline__ void mma_a_tileT(float (&acc)[8][4], const uint32_t (&a)[DH / 16][4],
                                            const __nv_bfloat16* tile, int g, int t) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < DH / 16; ++s) {
      const __nv_bfloat16* p = tile + (j * 8 + g) * LD + s * 16 + 2 * t;
      mma_bf16(acc[j], a[s], ld_u32(p), ld_u32(p + 8));
    }
  }
}

// acc (16 rows x DH) += A (16 rows x 64, the tile's rows as k) times the tile
template <int DH>
__device__ __forceinline__ void mma_a_tile(float (&acc)[DH / 8][4], const uint32_t (&a)[4][4],
                                           const __nv_bfloat16* tile, int g, int t) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const __nv_bfloat16* p = tile + (s * 16 + 2 * t) * LD + n * 8 + g;
      mma_bf16(acc[n], a[s], ld_pair_rows(p, LD), ld_pair_rows(p + 8 * LD, LD));
    }
  }
}

// 16 x DH accumulator rows r0, r1 out as bf16
template <int DH>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst, const float (&acc)[DH / 8][4],
                                                int r0, int nrows, int t) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < nrows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r0 * DH + c) = pack_bf16(acc[n][0], acc[n][1]);
    if (r0 + 8 < nrows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r0 + 8) * DH + c) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int DH>
__global__ void __launch_bounds__(128)
bwd_dq_lse_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int heads, int nq,
                int nk, float scale) {
  constexpr int LD = DH + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kBlock * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlock * LD];
  __shared__ float code[kBlock];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * kBlock + warp * 16 + g, r1 = r0 + 8;
  const float* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const __nv_bfloat16* kb = k + (size_t)bh * nk * DH;
  const __nv_bfloat16* vb = v + (size_t)bh * nk * DH;

  uint32_t qa[DH / 16][4], da[DH / 16][4];
  load_a_frags<DH>(qa, q + (size_t)bh * nq * DH, r0, nq, t);
  load_a_frags<DH>(da, dout + (size_t)bh * nq * DH, r0, nq, t);
  const size_t base = (size_t)bh * nq;
  const float lse0 = r0 < nq ? lse[base + r0] : INFINITY, lse1 = r1 < nq ? lse[base + r1] : INFINITY;
  const float dl0 = r0 < nq ? delta[base + r0] : 0.f, dl1 = r1 < nq ? delta[base + r1] : 0.f;

  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kBlock) {
    __syncthreads();
    load_tile_bf16<DH>(ks, kb, k0, nk);
    load_tile_bf16<DH>(vs, vb, k0, nk);
    if (threadIdx.x < kBlock) code[threadIdx.x] = key_code(mask_row, k0 + threadIdx.x, nk);
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_a_tileT<DH>(s, qa, ks, g, t);   // S = Q K^T
    mma_a_tileT<DH>(dp, da, vs, g, t);  // dP = dO V^T
    uint32_t dsa[4][4];                 // dS, bf16, as A fragments
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float c0 = code[j * 8 + 2 * t], c1 = code[j * 8 + 2 * t + 1];
      const float p0 = expf(masked_score(s[j][0] * scale, c0) - lse0);
      const float p1 = expf(masked_score(s[j][1] * scale, c1) - lse0);
      const float p2 = expf(masked_score(s[j][2] * scale, c0) - lse1);
      const float p3 = expf(masked_score(s[j][3] * scale, c1) - lse1);
      dsa[j / 2][(j % 2) * 2 + 0] =
          pack_bf16(p0 * (dp[j][0] - dl0) * scale, p1 * (dp[j][1] - dl0) * scale);
      dsa[j / 2][(j % 2) * 2 + 1] =
          pack_bf16(p2 * (dp[j][2] - dl1) * scale, p3 * (dp[j][3] - dl1) * scale);
    }
    mma_a_tile<DH>(acc, dsa, ks, g, t);  // dQ += dS K
  }
  store_rows_bf16<DH>(dq + (size_t)bh * nq * DH, acc, r0, nq, t);
}

template <int DH>
__global__ void __launch_bounds__(128)
bwd_dkdv_lse_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                  const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int heads, int nq, int nk, float scale) {
  constexpr int LD = DH + 8;
  __shared__ __align__(16) __nv_bfloat16 qs[kBlock * LD];
  __shared__ __align__(16) __nv_bfloat16 os[kBlock * LD];
  __shared__ float sl[kBlock], sd[kBlock];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * kBlock + warp * 16 + g, r1 = r0 + 8;  // this thread's key rows
  const float* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const float c0 = key_code(mask_row, r0, nk), c1 = key_code(mask_row, r1, nk);
  const __nv_bfloat16* qb = q + (size_t)bh * nq * DH;
  const __nv_bfloat16* ob = dout + (size_t)bh * nq * DH;

  uint32_t ka[DH / 16][4], va[DH / 16][4];
  load_a_frags<DH>(ka, k + (size_t)bh * nk * DH, r0, nk, t);
  load_a_frags<DH>(va, v + (size_t)bh * nk * DH, r0, nk, t);
  float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += kBlock) {
    __syncthreads();
    load_tile_bf16<DH>(qs, qb, q0, nq);
    load_tile_bf16<DH>(os, ob, q0, nq);
    if (threadIdx.x < kBlock) {
      const int qq = q0 + threadIdx.x;  // rows past nq: p = 0, delta = 0
      sl[threadIdx.x] = qq < nq ? lse[(size_t)bh * nq + qq] : INFINITY;
      sd[threadIdx.x] = qq < nq ? delta[(size_t)bh * nq + qq] : 0.f;
    }
    __syncthreads();
    float p[8][4];
    mma_a_tileT<DH>(p, ka, qs, g, t);  // S^T = K Q^T; rows keys, columns queries
    uint32_t pa[4][4];                 // P^T, bf16, as A fragments
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float l0 = sl[j * 8 + 2 * t], l1 = sl[j * 8 + 2 * t + 1];
      p[j][0] = expf(masked_score(p[j][0] * scale, c0) - l0);
      p[j][1] = expf(masked_score(p[j][1] * scale, c0) - l1);
      p[j][2] = expf(masked_score(p[j][2] * scale, c1) - l0);
      p[j][3] = expf(masked_score(p[j][3] * scale, c1) - l1);
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p[j][0], p[j][1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[j][2], p[j][3]);
    }
    mma_a_tile<DH>(dva, pa, os, g, t);  // dV += P^T dO
    float dp[8][4];
    mma_a_tileT<DH>(dp, va, os, g, t);  // dP^T = V dO^T
    uint32_t dsa[4][4];                 // dS^T, bf16, as A fragments
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d0 = sd[j * 8 + 2 * t], d1 = sd[j * 8 + 2 * t + 1];
      dsa[j / 2][(j % 2) * 2 + 0] =
          pack_bf16(p[j][0] * (dp[j][0] - d0) * scale, p[j][1] * (dp[j][1] - d1) * scale);
      dsa[j / 2][(j % 2) * 2 + 1] =
          pack_bf16(p[j][2] * (dp[j][2] - d0) * scale, p[j][3] * (dp[j][3] - d1) * scale);
    }
    mma_a_tile<DH>(dka, dsa, qs, g, t);  // dK += dS^T Q
  }
  store_rows_bf16<DH>(dk + (size_t)bh * nk * DH, dka, r0, nk, t);
  store_rows_bf16<DH>(dv + (size_t)bh * nk * DH, dva, r0, nk, t);
}

// ------------------------------------------------------------------ launches
struct Args {
  const void *q, *k, *v, *o, *dout;
  const float *mask, *lse;
  float* scratch;
  void *dq, *dk, *dv;
  int bh, heads, nq, nk;
  cudaStream_t stream;
};

template <typename T, int DH, bool kLse>
cudaError_t launch_fma(const Args& a, float* stat_a, float* stat_l, float* delta, float scale) {
  const dim3 gq((a.nq + kBlock - 1) / kBlock, a.bh), gk((a.nk + kBlock - 1) / kBlock, a.bh);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  bwd_dq_fma<T, DH, kLse><<<gq, kFmaThreads, 0, a.stream>>>(
      q, k, v, a.mask, dout, stat_a, stat_l, delta, static_cast<T*>(a.dq), a.heads, a.nq, a.nk,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = dkdv_fma_smem<DH>();
  err = cudaFuncSetAttribute(bwd_dkdv_fma<T, DH, kLse>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv_fma<T, DH, kLse><<<gk, kFmaThreads, smem, a.stream>>>(
      q, k, v, a.mask, dout, stat_a, stat_l, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.heads, a.nq, a.nk, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_recompute(const Args& a, int is_bf16) {
  const float scale = (float)(1.0 / sqrt((double)DH));
  const size_t rows = (size_t)a.bh * a.nq;
  float* m = a.scratch;
  float* l = m + rows;
  float* delta = l + rows;
  return is_bf16 ? launch_fma<__nv_bfloat16, DH, false>(a, m, l, delta, scale)
                 : launch_fma<float, DH, false>(a, m, l, delta, scale);
}

template <int DH>
cudaError_t launch_lse(const Args& a, int is_bf16) {
  const float scale = (float)(1.0 / sqrt((double)DH));
  const int rows = a.bh * a.nq;
  float* delta = a.scratch;
  const dim3 grid_rows((rows + 7) / 8);
  if (!is_bf16) {
    row_dot<float><<<grid_rows, 256, 0, a.stream>>>(static_cast<const float*>(a.dout),
                                                    static_cast<const float*>(a.o), delta, rows, DH);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_fma<float, DH, true>(a, const_cast<float*>(a.lse), nullptr, delta, scale);
  }
  typedef __nv_bfloat16 bf;
  row_dot<bf><<<grid_rows, 256, 0, a.stream>>>(static_cast<const bf*>(a.dout),
                                               static_cast<const bf*>(a.o), delta, rows, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gq((a.nq + kBlock - 1) / kBlock, a.bh), gk((a.nk + kBlock - 1) / kBlock, a.bh);
  bwd_dq_lse_bf16<DH><<<gq, 128, 0, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v), a.mask,
      static_cast<const bf*>(a.dout), a.lse, delta, static_cast<bf*>(a.dq), a.heads, a.nq, a.nk,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_lse_bf16<DH><<<gk, 128, 0, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v), a.mask,
      static_cast<const bf*>(a.dout), a.lse, delta, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv),
      a.heads, a.nq, a.nk, scale);
  return cudaGetLastError();
}

bool bad_sizes(const Args& a) {
  return a.nq < 1 || a.nk < 1 || a.bh < 1 || a.bh > 65535 || a.heads < 1;
}

}  // namespace

// Kernel 3. scratch: fp32 [3, BH, Nq].
extern "C" int impx_mha_bwd(const void* q, const void* k, const void* v, const void* mask,
                            const void* dout, void* scratch, void* dq, void* dk, void* dv, int bh,
                            int heads, int nq, int nk, int dh, int is_bf16, void* stream) {
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(mask), nullptr,
               static_cast<float*>(scratch), dq, dk, dv, bh, heads, nq, nk,
               static_cast<cudaStream_t>(stream)};
  if (bad_sizes(a)) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return (int)launch_recompute<16>(a, is_bf16);
    case 32: return (int)launch_recompute<32>(a, is_bf16);
    case 64: return (int)launch_recompute<64>(a, is_bf16);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel 5. lse: fp32 [BH, Nq] from impx_mha_fwd_lse; scratch: fp32 [BH, Nq].
extern "C" int impx_mha_bwd_lse(const void* q, const void* k, const void* v, const void* mask,
                                const void* lse, const void* o, const void* dout, void* scratch,
                                void* dq, void* dk, void* dv, int bh, int heads, int nq, int nk,
                                int dh, int is_bf16, void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const float*>(mask), static_cast<const float*>(lse),
               static_cast<float*>(scratch), dq, dk, dv, bh, heads, nq, nk,
               static_cast<cudaStream_t>(stream)};
  if (bad_sizes(a)) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return (int)launch_lse<16>(a, is_bf16);
    case 32: return (int)launch_lse<32>(a, is_bf16);
    case 64: return (int)launch_lse<64>(a, is_bf16);
    default: return (int)cudaErrorInvalidValue;
  }
}
