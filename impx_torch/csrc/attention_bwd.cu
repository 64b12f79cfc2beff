// Masked multi-head attention backward for Hopper (sm_90a): the two training
// backward kernels of impx/ops/pallas/attention.py.
//
// Kernel 3, impx_mha_bwd, replaces _mha_bwd_call (:137, kernel
// _attn_bwd_kernel :96), the VJP of mha_fused. It takes no saved residual:
// p = exp(s - max) / sum is recomputed, dp = do v^T, delta = rowsum(dp * p),
// ds = p (dp - delta) scale, dq = ds k, dk = ds^T q, dv = p^T do, where p and
// ds are fp32 values and bf16 do, v, k, q are upcast. A fully masked row
// (every key at -1e30) gets p = 1/Nk, so the kernel keeps each row's max m
// and sum l apart and never forms an lse: in fp32 -1e30 + log(Nk) == -1e30,
// and exp(s - lse) would give p = 1 there.
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
// a dq launch over (64-query tile, batch*head) loops over the key tiles, then
// a dk/dv launch over (64-key tile, batch*head) loops over the query tiles,
// each accumulating in fp32 registers and rounding once at the end. No
// atomics: a second run on the same inputs gives the same bits. Tiles past Nq
// or Nk are zero-filled and weigh 0 (p = 0, ds = 0), so no 0 * NaN reaches a
// sum.
//
// bf16 inputs (the training config's path), both kernels, 2 launches a call:
//   * Every product on the tensor cores: S = Q K^T, dP = dO V^T, dQ += dS K,
//     dV += P^T dO and dK += dS^T Q by mma.sync m16n8k16 (bf16 in, fp32
//     accumulate). A from registers: a warp's 16 rows of the block's own
//     tile (Q and dO, or K and V, loaded once by ldmatrix), or the S or dP
//     accumulator repacked as bf16 fragments, so p and ds never leave
//     registers. B from shared memory by ldmatrix (ldmatrix.trans for dQ, dV
//     and dK, whose k runs over the tile's rows).
//   * The streamed tiles (K, V and the key mask in the dq launch; Q, dO and
//     the per-query statistics in the dk/dv launch) go through a ring of two
//     shared-memory stages filled by cp.async (zeros past the end): tile i + 1
//     is in flight while tile i computes. The block's own rows come through
//     stage 1 before the ring starts.
//   * Kernel 3: the dq launch's first pass over the keys finds m, l and delta
//     at once: D = sum_j dp_j exp(s_j - m) is rescaled by exp(m_old - m_new)
//     exactly as l is, and delta = D / l; it writes m, 1/l and delta to the
//     [3, BH, Nq] scratch for the dk/dv launch. So QK^T and dP are computed 3
//     times (pass 1, pass 2, dk/dv), not 4 and 3 times as the FMA path does.
//     p = exp(s - m) times 1/l, the reciprocal taken once a row (the plain
//     version divides; the two differ by about an fp32 ulp). The fp32
//     factor of dq, dk and dv (ds or p) is split into hi = bf16(x) and lo =
//     bf16(x - hi), and each product issued on both into one fp32
//     accumulator: about 16 bits of each fp32 factor, 2^-17 relative a term
//     (tests/test_torch_bwd_design.py), where TF32 would keep 11. That is 12
//     bf16 product-units a call (2 + 4 + 6) against kernel 5's 7.
//   * Kernel 5: the dq launch's prologue computes delta = rowsum(do * o) for
//     its own rows and writes it to the [BH, Nq] scratch for the dk/dv
//     launch, so no launch of its own; p and ds are rounded to bf16.
//   * Each launch: 4 warps of 16 rows, 128 threads; shared memory 2 stages x
//     2 bf16 tiles of 64 x (dh + 8) and 3 x 64 fp32 a stage (37.5 KB at dh =
//     64). Registers, not shared memory, bound occupancy: 176-254 a thread
//     at dh = 64 without spills (chip_smoke.py prints ptxas's count
//     for each kernel), so two blocks an SM.
//
// Bound on the H100 at bf16: kernel 3's 8 products (QK^T, dP, and dq, dk,
// dv twice each), kernel 5's 5, against 989 TFLOP/s. What holds this design
// back is shared-memory traffic: each warp reloads a whole 64-row tile for
// its 16 rows, 32 KB a warp a tile in kernel 3's dk/dv launch against 192
// mma.sync, and at 128 bytes a clock an SM reads a block's 128 KB a tile in
// about the time its 768 mma.sync take (an estimate from these counts).
// wgmma, whose B operand the tensor cores read from shared memory themselves
// for a 64-row warpgroup tile, is the next step.
//
// fp32 inputs take the FMA path (256 threads, 4 a row, full fp32): kernel 3's
// dq launch finds each row's max and sum (pass 1), delta (pass 2) and dq
// (pass 3), then the dk/dv launch; kernel 5 takes a row_dot launch for delta,
// then the same two launches with p = exp(s - lse).
//
// Layout: q, o, do, dq [BH, Nq, dh]; k, v, dk, dv [BH, Nk, dh], contiguous;
// mask [B, Nk] fp32 (1 valid / 0 masked, or null); lse [BH, Nq] fp32;
// scratch fp32, [3, BH, Nq] for kernel 3 (max, then the sum at fp32 or its
// reciprocal at bf16, delta) and [BH, Nq] for kernel 5 (delta), sized by the
// caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 64;     // query rows (dq launch) or key rows (dk/dv launch) per block
constexpr int kFmaThreads = 256;

// ------------------------------------------------------- delta = rowsum(do * o)
// one warp per row
__global__ void __launch_bounds__(256)
row_dot(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out, int rows,
        int dh) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32)
    acc += a[(size_t)row * dh + d] * b[(size_t)row * dh + d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = acc;
}

// ------------------------------------------------------------------ FMA path
// 256 threads, 4 per row of the block's 64 rows; thread `sub` of a row takes
// the tile's columns sub, sub + 4, ... and the output columns sub + 4 i.

// rows [row0, row0 + 64) of a [rows, DH] tensor as fp32, row stride ld, zeros
// past nrows
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int row0,
                                          int nrows) {
  for (int idx = threadIdx.x; idx < kBlock * DH; idx += kFmaThreads) {
    const int rr = idx / DH, d = idx % DH;
    dst[rr * ld + d] = row0 + rr < nrows ? src[(size_t)(row0 + rr) * DH + d] : 0.f;
  }
}

template <int DH>
__device__ __forceinline__ void load_row(float (&dst)[DH], const float* src, bool live) {
#pragma unroll
  for (int d = 0; d < DH; ++d) dst[d] = live ? src[d] : 0.f;
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
template <int DH, bool kLse>
__global__ void __launch_bounds__(kFmaThreads)
bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ mask, const float* __restrict__ dout,
           float* __restrict__ stat_a, float* __restrict__ stat_l, float* __restrict__ delta,
           float* __restrict__ dq, int heads, int nq, int nk, float scale) {
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
  const float* kb = k + (size_t)bh * nk * DH;
  const float* vb = v + (size_t)bh * nk * DH;

  float qr[DH], dr[DH];
  load_row<DH>(qr, q + rq * DH, live);
  load_row<DH>(dr, dout + rq * DH, live);

  // stat_r: lse (kLse) or the row max; inv_l: 1 (kLse) or the row sum
  float stat_r, l_r = 1.f, dlt;
  if (kLse) {
    stat_r = live ? stat_a[rq] : INFINITY;  // p = 0 on rows past nq
    dlt = live ? delta[rq] : 0.f;
  } else {
    float m_run = -INFINITY, l_run = 0.f;
    for (int k0 = 0; k0 < nk; k0 += kBlock) {  // pass 1: online max and sum
      __syncthreads();
      load_tile<DH>(ks, KLD, kb, k0, nk);
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
      load_tile<DH>(ks, KLD, kb, k0, nk);
      load_tile<DH>(vd, KLD, vb, k0, nk);
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
    load_tile<DH>(ks, KLD, kb, k0, nk);
    load_tile<DH>(vd, KLD, vb, k0, nk);
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
    for (int i = 0; i < DPER; ++i) dq[rq * DH + sub + 4 * i] = acc[i];
  }
}

template <int DH>
constexpr size_t dkdv_fma_smem() {
  return sizeof(float) * (2 * kBlock * (DH + 1) + 2 * kBlock * (kBlock + 1) + 3 * kBlock);
}

// dk and dv for one (64-key tile, batch*head), looping over the query tiles,
// with the per-row statistics of the dq launch (or lse and delta, kLse).
template <int DH, bool kLse>
__global__ void __launch_bounds__(kFmaThreads)
bwd_dkdv_fma(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const float* __restrict__ mask, const float* __restrict__ dout,
             const float* __restrict__ stat_a, const float* __restrict__ stat_l,
             const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
             int heads, int nq, int nk, float scale) {
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
  const float* qb = q + (size_t)bh * nq * DH;
  const float* ob = dout + (size_t)bh * nq * DH;

  float kr[DH], vr[DH];
  load_row<DH>(kr, k + rk * DH, live);
  load_row<DH>(vr, v + rk * DH, live);
  float dka[DPER], dva[DPER];
#pragma unroll
  for (int i = 0; i < DPER; ++i) dka[i] = dva[i] = 0.f;

  for (int q0 = 0; q0 < nq; q0 += kBlock) {
    __syncthreads();
    load_tile<DH>(qs, KLD, qb, q0, nq);
    load_tile<DH>(os, KLD, ob, q0, nq);
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
      dk[rk * DH + sub + 4 * i] = dka[i];
      dv[rk * DH + sub + 4 * i] = dva[i];
    }
  }
}

// ------------------------------------------------- bf16, tensor cores
// 4 warps; a warp owns 16 rows of the block's 64 (queries in the dq launch,
// keys in the dk/dv launch). mma.sync m16n8k16 (bf16 in, fp32 accumulate)
// with every shared-memory operand loaded by ldmatrix (.trans for the
// operand whose rows are the product's k); an accumulator tile of 16 rows x
// 64 columns is the A operand of the next product, so p and ds never leave
// registers. The streamed tiles go through a ring of kStages shared-memory
// stages filled by cp.async: tile i + 1 is in flight while tile i computes.
constexpr int kThreads = 128;
constexpr int kStages = 2;
static_assert(kStages >= 2, "the prologue stages the block's own rows in stage 1");
typedef __nv_bfloat16 bf;

template <int DH>
__host__ __device__ constexpr int tile_elems() {  // bf16 rows padded to DH + 8
  return kBlock * (DH + 8);
}

// shared bytes of either launch: kStages x 2 tiles, then kStages x 3 x 64
// fp32 (the dq launch: the key mask a stage and delta; the dk/dv launch: the
// per-query statistics a stage)
template <int DH>
constexpr size_t mma_smem() {
  return sizeof(bf) * 2 * kStages * tile_elems<DH>() + sizeof(float) * kStages * 3 * kBlock;
}

// cp.async of rows [row0, row0 + 64) of a [rows, DH] bf16 tensor into a
// tile, zeros past nrows
template <int DH>
__device__ __forceinline__ void copy_tile(bf* dst, const bf* src, int row0, int nrows) {
  constexpr int LD = DH + 8, CH = DH / 8;  // 16-byte chunks a row
  static_assert(kBlock * CH % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < kBlock * CH / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads, rr = idx / CH, ch = idx % CH;
    const bool live = row0 + rr < nrows;
    cp_async_16(dst + rr * LD + ch * 8, live ? src + (size_t)(row0 + rr) * DH + ch * 8 : src, live);
  }
}

// A fragments of tile rows [r0, r0 + 16) x DH
template <int DH>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[DH / 16][4], const bf* tile, int r0,
                                       int lane) {
  constexpr int LD = DH + 8;
  const bf* p = tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int s = 0; s < DH / 16; ++s) ldsm_x4(a[s], p + s * 16);
}

// acc[j] (16 rows x columns 8j .. 8j+7) = A (16 rows x DH) times the
// transpose of the 64-row tile (its rows are the columns); B by ldmatrix
template <int DH>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[DH / 16][4],
                                        const bf* tile, int lane) {
  constexpr int LD = DH + 8;
  const bf* p = tile + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int j2 = 0; j2 < 4; ++j2) {
#pragma unroll
    for (int s = 0; s < DH / 16; ++s) {
      uint32_t b[4];
      ldsm_x4(b, p + j2 * 16 * LD + s * 16);
      mma_bf16(acc[2 * j2], a[s], b[0], b[1]);
      mma_bf16(acc[2 * j2 + 1], a[s], b[2], b[3]);
    }
  }
}

// acc (16 x DH) += sum over the NA fragments of A (16 rows x tile rows
// 16 kk .. 16 kk + 15) times those tile rows; B by ldmatrix.trans, loaded
// once for the NA products (NA = 2: the hi and lo parts of an fp32 factor)
template <int DH, int NA>
__device__ __forceinline__ void mma_ab_step(float (&acc)[DH / 8][4], const uint32_t (&a)[NA][4],
                                            const bf* tile, int kk, int lane) {
  constexpr int LD = DH + 8;
  const bf* p = tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int n2 = 0; n2 < DH / 16; ++n2) {
    uint32_t b[4];
    ldsm_x4_trans(b, p + n2 * 16);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      mma_bf16(acc[2 * n2], a[i], b[0], b[1]);
      mma_bf16(acc[2 * n2 + 1], a[i], b[2], b[3]);
    }
  }
}

// the k-step kk of a 16 x 64 fp32 tile x as A fragments: bf16-rounded
// (NA = 1), or hi and lo parts (NA = 2)
template <int NA>
__device__ __forceinline__ void pack_step(uint32_t (&a)[NA][4], const float (&x)[8][4], int kk) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* c = x[2 * kk + h];
    if (NA == 1) {
      a[0][2 * h] = pack_bf16(c[0], c[1]);
      a[0][2 * h + 1] = pack_bf16(c[2], c[3]);
    } else {
      split_bf16(c[0], c[1], a[0][2 * h], a[NA - 1][2 * h]);
      split_bf16(c[2], c[3], a[0][2 * h + 1], a[NA - 1][2 * h + 1]);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// the tile's key column `col` (0..63) from k0: 1 valid, 0 masked, -1 past nk;
// msk holds the tile's mask values (unread when there is no mask)
__device__ __forceinline__ float tile_code(const float* msk, bool has_mask, int k0, int col,
                                           int nk) {
  if (k0 + col >= nk) return -1.f;
  return (!has_mask || msk[col] > 0.f) ? 1.f : 0.f;
}

// delta = rowsum(do * o) in fp32 for rows [q0, q0 + 64): into sdl (0 past
// nq) and out; a row's 16-byte chunks on neighbouring lanes
template <int DH>
__device__ __forceinline__ void row_delta(const bf* dout, const bf* o, int q0, int nq, float* sdl,
                                          float* out) {
  constexpr int CH = DH / 8;
#pragma unroll
  for (int i = 0; i < kBlock * CH / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads, rr = idx / CH, ch = idx % CH, r = q0 + rr;
    float acc = 0.f;
    if (r < nq) {
      const uint4 x = *reinterpret_cast<const uint4*>(dout + (size_t)r * DH + ch * 8);
      const uint4 y = *reinterpret_cast<const uint4*>(o + (size_t)r * DH + ch * 8);
      const bf* xs = reinterpret_cast<const bf*>(&x);
      const bf* ys = reinterpret_cast<const bf*>(&y);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += __bfloat162float(xs[e]) * __bfloat162float(ys[e]);
    }
#pragma unroll
    for (int off = CH / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (ch == 0) {
      sdl[rr] = acc;
      if (r < nq) out[r] = acc;
    }
  }
}

// 16 x DH accumulator rows r0, r0 + 8 out as bf16
template <int DH>
__device__ __forceinline__ void store_rows_bf16(bf* dst, const float (&acc)[DH / 8][4], int r0,
                                                int nrows, int t) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < nrows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r0 * DH + c) = pack_bf16(acc[n][0], acc[n][1]);
    if (r0 + 8 < nrows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r0 + 8) * DH + c) =
          pack_bf16(acc[n][2], acc[n][3]);
  }
}

// dq for one (64-query tile, batch*head), looping over the key tiles (K and
// V through the ring). kLse (kernel 5): the prologue computes this block's
// delta = rowsum(do * o) and writes it to scratch [BH, Nq] for the dk/dv
// launch; one pass, p = exp(s - lse), ds rounded to bf16. Otherwise (kernel
// 3): pass 1 runs the online row max m, sum l = sum_j exp(s_j - m) and D =
// sum_j dp_j exp(s_j - m), both rescaled by exp(m_old - m_new) as m grows,
// so delta = D / l, and writes m, 1/l, delta to scratch [3, BH, Nq]; pass 2
// takes p = exp(s - m) * (1/l), ds = p (dp - delta) scale in fp32 and issues
// dQ += ds_hi K + ds_lo K. The ring runs across both passes.
template <int DH, bool kLse>
__device__ __forceinline__ void dq_body(bf* smem, const bf* __restrict__ q,
                                        const bf* __restrict__ k, const bf* __restrict__ v,
                                        const float* __restrict__ mask,
                                        const bf* __restrict__ dout, const bf* __restrict__ o,
                                        const float* __restrict__ lse, float* __restrict__ scratch,
                                        bf* __restrict__ dq, int heads, int nq, int nk,
                                        float scale) {
  constexpr int TILE = tile_elems<DH>();
  constexpr int NA = kLse ? 1 : 2;
  float* msk = reinterpret_cast<float*>(smem + 2 * kStages * TILE);  // [kStages][64]
  float* sdl = msk + kStages * kBlock;                                // [64]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBlock;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const size_t rows = (size_t)gridDim.y * nq, base = (size_t)bh * nq;
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const bf* kb = k + (size_t)bh * nk * DH;
  const bf* vb = v + (size_t)bh * nk * DH;
  const int ntiles = (nk + kBlock - 1) / kBlock;
  const int total = kLse ? ntiles : 2 * ntiles;

  auto issue = [&](int it) {  // key tile it % ntiles into stage it % kStages
    const int k0 = (it % ntiles) * kBlock, st = it % kStages;
    copy_tile<DH>(smem + 2 * st * TILE, kb, k0, nk);
    copy_tile<DH>(smem + (2 * st + 1) * TILE, vb, k0, nk);
    if (mrow != nullptr && tid < kBlock)
      cp_async_4(msk + st * kBlock + tid, k0 + tid < nk ? mrow + k0 + tid : mrow, k0 + tid < nk);
  };

  // prologue: this block's Q and dO rows into stage 1 (free until tile 1 is
  // issued), key tile 0 into stage 0
  copy_tile<DH>(smem + 2 * TILE, q + base * DH, q0, nq);
  copy_tile<DH>(smem + 3 * TILE, dout + base * DH, q0, nq);
  cp_async_commit();
  issue(0);
  cp_async_commit();
  if (kLse) row_delta<DH>(dout + base * DH, o + base * DH, q0, nq, sdl, scratch + base);
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[DH / 16][4], da[DH / 16][4];
  ldsm_a<DH>(qa, smem + 2 * TILE, warp * 16, lane);
  ldsm_a<DH>(da, smem + 3 * TILE, warp * 16, lane);
  // p = exp(s - st) * il: kLse (lse, 1) a row, p = 0 past nq; otherwise
  // (m, 1/l) from pass 1. dl: delta
  float st0 = INFINITY, st1 = INFINITY, il0 = 1.f, il1 = 1.f, dl0 = 0.f, dl1 = 0.f;
  if (kLse) {
    if (r0 < nq) st0 = lse[base + r0];
    if (r1 < nq) st1 = lse[base + r1];
    dl0 = sdl[warp * 16 + g];
    dl1 = sdl[warp * 16 + g + 8];
  } else {
    st0 = st1 = -INFINITY;
  }
  float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;  // kernel 3, pass 1: this thread's share
  __syncthreads();           // stage 1 is read before tile 1 goes there

  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int stg = it % kStages, k0 = (it % ntiles) * kBlock;
    const bf* ks = smem + 2 * stg * TILE;
    const float* mk = msk + stg * kBlock;
    float s[8][4], dp[8][4];
    mma_abt<DH>(s, qa, ks, lane);           // S = Q K^T
    mma_abt<DH>(dp, da, ks + TILE, lane);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float c0 = tile_code(mk, mrow != nullptr, k0, j * 8 + 2 * t, nk);
      const float c1 = tile_code(mk, mrow != nullptr, k0, j * 8 + 2 * t + 1, nk);
      s[j][0] = masked_score(s[j][0] * scale, c0);
      s[j][1] = masked_score(s[j][1] * scale, c1);
      s[j][2] = masked_score(s[j][2] * scale, c0);
      s[j][3] = masked_score(s[j][3] * scale, c1);
    }
    if (!kLse && it < ntiles) {  // kernel 3, pass 1: online m, l and D
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      // finite: every tile holds a key < nk
      const float mn0 = fmaxf(st0, quad_max(mx0)), mn1 = fmaxf(st1, quad_max(mx1));
      const float a0 = expf(st0 - mn0), a1 = expf(st1 - mn1);  // 0 on the first tile
      float e0 = 0.f, e1 = 0.f, f0 = 0.f, f1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x0 = expf(s[j][0] - mn0), x1 = expf(s[j][1] - mn0);
        const float x2 = expf(s[j][2] - mn1), x3 = expf(s[j][3] - mn1);
        e0 += x0 + x1;
        e1 += x2 + x3;
        f0 += dp[j][0] * x0 + dp[j][1] * x1;  // keys past nk: x = 0 and dp = 0
        f1 += dp[j][2] * x2 + dp[j][3] * x3;
      }
      l0 = l0 * a0 + e0;
      l1 = l1 * a1 + e1;
      d0 = d0 * a0 + f0;
      d1 = d1 * a1 + f1;
      st0 = mn0;
      st1 = mn1;
      if (it == ntiles - 1) {  // m, 1/l and delta = D / l for pass 2 and the dk/dv launch
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        dl0 = quad_sum(d0) / l0;
        dl1 = quad_sum(d1) / l1;
        il0 = 1.f / l0;
        il1 = 1.f / l1;
        if (t == 0 && r0 < nq) {
          scratch[base + r0] = st0;
          scratch[rows + base + r0] = il0;
          scratch[2 * rows + base + r0] = dl0;
        }
        if (t == 0 && r1 < nq) {
          scratch[base + r1] = st1;
          scratch[rows + base + r1] = il1;
          scratch[2 * rows + base + r1] = dl1;
        }
      }
    } else {  // ds = p (dp - delta) scale; dQ += dS K
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - (e < 2 ? st0 : st1)) * (e < 2 ? il0 : il1);
          s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[NA][4];
        pack_step<NA>(a, s, kk);
        mma_ab_step<DH, NA>(acc, a, ks, kk, lane);
      }
    }
    __syncthreads();  // the stage is consumed before the next issue refills it
  }
  store_rows_bf16<DH>(dq + base * DH, acc, r0, nq, t);
}

// dk and dv for one (64-key tile, batch*head), looping over the query tiles
// (Q, dO and the per-query statistics through the ring): S^T = K Q^T, p, dV
// += P^T dO, dP^T = V dO^T, ds, dK += dS^T Q. kLse (kernel 5): p = exp(s -
// lse), p and ds rounded to bf16. Otherwise (kernel 3): p = exp(s - m) *
// (1/l) and ds in fp32, each product issued on its hi and lo parts.
template <int DH, bool kLse>
__device__ __forceinline__ void dkdv_body(bf* smem, const bf* __restrict__ q,
                                          const bf* __restrict__ k, const bf* __restrict__ v,
                                          const float* __restrict__ mask,
                                          const bf* __restrict__ dout,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ scratch, bf* __restrict__ dk,
                                          bf* __restrict__ dv, int heads, int nq, int nk,
                                          float scale) {
  constexpr int TILE = tile_elems<DH>();
  constexpr int NA = kLse ? 1 : 2;
  constexpr int NSTAT = kLse ? 2 : 3;  // (lse, delta) or (m, l, delta) a query
  float* stats = reinterpret_cast<float*>(smem + 2 * kStages * TILE);  // [kStages][3][64]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, key0 = blockIdx.x * kBlock;
  const int r0 = key0 + warp * 16 + g, r1 = r0 + 8;  // this thread's key rows
  const size_t rows = (size_t)gridDim.y * nq, base = (size_t)bh * nq;
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const float c0 = key_code(mrow, r0, nk), c1 = key_code(mrow, r1, nk);
  const bf* qb = q + base * DH;
  const bf* ob = dout + base * DH;
  // the per-query statistics: lse, delta (kLse) or m, l, delta
  const float* st_a = kLse ? lse + base : scratch + base;
  const float* st_b = kLse ? scratch + base : scratch + rows + base;
  const float* st_c = scratch + 2 * rows + base;
  const int ntiles = (nq + kBlock - 1) / kBlock;

  auto issue = [&](int it) {  // query tile it into stage it % kStages
    const int qq0 = it * kBlock, st = it % kStages;
    copy_tile<DH>(smem + 2 * st * TILE, qb, qq0, nq);
    copy_tile<DH>(smem + (2 * st + 1) * TILE, ob, qq0, nq);
    for (int idx = tid; idx < NSTAT * kBlock; idx += kThreads) {
      const int i = idx / kBlock, rr = idx % kBlock;
      const float* from = i == 0 ? st_a : (i == 1 ? st_b : st_c);
      const bool live = qq0 + rr < nq;
      cp_async_4(stats + (st * 3 + i) * kBlock + rr, live ? from + qq0 + rr : from, live);
    }
  };

  // prologue: this block's K and V rows into stage 1, query tile 0 into stage 0
  copy_tile<DH>(smem + 2 * TILE, k + (size_t)bh * nk * DH, key0, nk);
  copy_tile<DH>(smem + 3 * TILE, v + (size_t)bh * nk * DH, key0, nk);
  cp_async_commit();
  issue(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t ka[DH / 16][4], va[DH / 16][4];
  ldsm_a<DH>(ka, smem + 2 * TILE, warp * 16, lane);
  ldsm_a<DH>(va, smem + 3 * TILE, warp * 16, lane);
  __syncthreads();

  float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int stg = it % kStages, qq0 = it * kBlock;
    const bf* qs = smem + 2 * stg * TILE;
    const bf* os = qs + TILE;
    const float* sa = stats + stg * 3 * kBlock;  // lse or m
    const float* sl = sa + kBlock;               // delta (kLse) or 1/l
    const float* sd = kLse ? sl : sl + kBlock;   // delta
    float p[8][4];
    mma_abt<DH>(p, ka, qs, lane);  // S^T = K Q^T: rows keys, columns queries
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const float s = masked_score(p[j][e] * scale, e < 2 ? c0 : c1);
        const float x = kLse ? expf(s - sa[col]) : expf(s - sa[col]) * sl[col];
        p[j][e] = qq0 + col < nq ? x : 0.f;  // queries past nq weigh 0
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dV += P^T dO
      uint32_t a[NA][4];
      pack_step<NA>(a, p, kk);
      mma_ab_step<DH, NA>(dva, a, os, kk, lane);
    }
    float dp[8][4];
    mma_abt<DH>(dp, va, os, lane);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = p[j][e] * (dp[j][e] - sd[j * 8 + 2 * t + (e & 1)]) * scale;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dK += dS^T Q
      uint32_t a[NA][4];
      pack_step<NA>(a, dp, kk);
      mma_ab_step<DH, NA>(dka, a, qs, kk, lane);
    }
    __syncthreads();
  }
  store_rows_bf16<DH>(dk + (size_t)bh * nk * DH, dka, r0, nk, t);
  store_rows_bf16<DH>(dv + (size_t)bh * nk * DH, dva, r0, nk, t);
}

// one kernel name per route, so that a profile tells kernels 3 and 5 apart
#define IMPX_DQ_ARGS                                                                          \
  const bf *q, const bf *k, const bf *v, const float *mask, const bf *dout, const bf *o,      \
      const float *lse, float *scratch, bf *dq, int heads, int nq, int nk, float scale
#define IMPX_DKDV_ARGS                                                                        \
  const bf *q, const bf *k, const bf *v, const float *mask, const bf *dout, const float *lse, \
      const float *scratch, bf *dk, bf *dv, int heads, int nq, int nk, float scale
template <int DH>
__global__ void __launch_bounds__(kThreads) bwd_dq_recompute_bf16(IMPX_DQ_ARGS) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  dq_body<DH, false>(reinterpret_cast<bf*>(bwd_smem), q, k, v, mask, dout, o, lse, scratch, dq,
                     heads, nq, nk, scale);
}
template <int DH>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_recompute_bf16(IMPX_DKDV_ARGS) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  dkdv_body<DH, false>(reinterpret_cast<bf*>(bwd_smem), q, k, v, mask, dout, lse, scratch, dk, dv,
                       heads, nq, nk, scale);
}
template <int DH>
__global__ void __launch_bounds__(kThreads) bwd_dq_lse_bf16(IMPX_DQ_ARGS) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  dq_body<DH, true>(reinterpret_cast<bf*>(bwd_smem), q, k, v, mask, dout, o, lse, scratch, dq,
                    heads, nq, nk, scale);
}
template <int DH>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_lse_bf16(IMPX_DKDV_ARGS) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  dkdv_body<DH, true>(reinterpret_cast<bf*>(bwd_smem), q, k, v, mask, dout, lse, scratch, dk, dv,
                      heads, nq, nk, scale);
}
#undef IMPX_DQ_ARGS
#undef IMPX_DKDV_ARGS

// ------------------------------------------------------------------ launches
struct Args {
  const void *q, *k, *v, *o, *dout;
  const float *mask, *lse;
  float* scratch;
  void *dq, *dk, *dv;
  int bh, heads, nq, nk;
  cudaStream_t stream;
};

template <int DH, bool kLse>
cudaError_t launch_fma(const Args& a, float* stat_a, float* stat_l, float* delta, float scale) {
  const dim3 gq((a.nq + kBlock - 1) / kBlock, a.bh), gk((a.nk + kBlock - 1) / kBlock, a.bh);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  bwd_dq_fma<DH, kLse><<<gq, kFmaThreads, 0, a.stream>>>(
      q, k, v, a.mask, dout, stat_a, stat_l, delta, static_cast<float*>(a.dq), a.heads, a.nq, a.nk,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = dkdv_fma_smem<DH>();
  err = cudaFuncSetAttribute(bwd_dkdv_fma<DH, kLse>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv_fma<DH, kLse><<<gk, kFmaThreads, smem, a.stream>>>(
      q, k, v, a.mask, dout, stat_a, stat_l, delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.heads, a.nq, a.nk, scale);
  return cudaGetLastError();
}

// bf16: the dq launch, then the dk/dv launch, on the tensor cores. kLse:
// kernel 5 (scratch [BH, Nq] takes delta); otherwise kernel 3 (scratch
// [3, BH, Nq] takes m, l, delta).
template <int DH, bool kLse>
cudaError_t launch_mma(const Args& a, float scale) {
  const dim3 gq((a.nq + kBlock - 1) / kBlock, a.bh), gk((a.nk + kBlock - 1) / kBlock, a.bh);
  constexpr size_t smem = mma_smem<DH>();
  static_assert(smem <= 48 * 1024, "above 48 KB, dynamic shared memory must be asked for");
  auto dq_kernel = kLse ? bwd_dq_lse_bf16<DH> : bwd_dq_recompute_bf16<DH>;
  auto dkdv_kernel = kLse ? bwd_dkdv_lse_bf16<DH> : bwd_dkdv_recompute_bf16<DH>;
  const bf* q = static_cast<const bf*>(a.q);
  const bf* k = static_cast<const bf*>(a.k);
  const bf* v = static_cast<const bf*>(a.v);
  const bf* dout = static_cast<const bf*>(a.dout);
  dq_kernel<<<gq, kThreads, smem, a.stream>>>(q, k, v, a.mask, dout, static_cast<const bf*>(a.o),
                                              a.lse, a.scratch, static_cast<bf*>(a.dq), a.heads,
                                              a.nq, a.nk, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<gk, kThreads, smem, a.stream>>>(q, k, v, a.mask, dout, a.lse, a.scratch,
                                                static_cast<bf*>(a.dk), static_cast<bf*>(a.dv),
                                                a.heads, a.nq, a.nk, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_recompute(const Args& a, int is_bf16) {
  const float scale = (float)(1.0 / sqrt((double)DH));
  if (is_bf16) return launch_mma<DH, false>(a, scale);
  const size_t rows = (size_t)a.bh * a.nq;
  float* m = a.scratch;
  return launch_fma<DH, false>(a, m, m + rows, m + 2 * rows, scale);
}

template <int DH>
cudaError_t launch_lse(const Args& a, int is_bf16) {
  const float scale = (float)(1.0 / sqrt((double)DH));
  if (is_bf16) return launch_mma<DH, true>(a, scale);
  const int rows = a.bh * a.nq;
  float* delta = a.scratch;
  row_dot<<<(rows + 7) / 8, 256, 0, a.stream>>>(static_cast<const float*>(a.dout),
                                                static_cast<const float*>(a.o), delta, rows, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fma<DH, true>(a, const_cast<float*>(a.lse), nullptr, delta, scale);
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
