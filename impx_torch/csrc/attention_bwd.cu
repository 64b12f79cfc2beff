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
// each accumulating in fp32 registers and rounding once at the end. Two
// launches a call at either dtype. No atomics: a second run on the same
// inputs gives the same bits. Tiles past Nq or Nk are zero-filled and weigh 0
// (p = 0, ds = 0), so no 0 * NaN reaches a sum. Both dtypes read the bool key
// mask in place, one byte a key.
//
// bf16 inputs, both kernels:
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
//     times (pass 1, pass 2, dk/dv), not 4 and 3 times as the FMA design did.
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
// fp32 inputs, both kernels (bwd_*_tf32x3; the FMA design before it took 15.14 and
// 10.18 ms a call at [32, 4, 1024, 64], this one 2.10 and 1.59, PERF.md
// section 6):
//   * Every product on wgmma m64nNk8 .tf32 in 3xTF32, as the fp32 forward
//     (csrc/attention_tf32.cuh): each fp32 operand split into hi = tf32(x)
//     and lo = tf32(x - hi), lo.hi + hi.lo + hi.hi, the small terms first,
//     fp32 accumulators (about 2^-21 of each product left out; one TF32 pass
//     misses the fp32 limit, tests/test_torch_bwd_f32_design.py). Kernel 3
//     takes 9 products a call (the dq launch's passes S, dP, then S, dP, dQ;
//     the dk/dv launch's S^T, dP^T, dV, dK), kernel 5 takes 7.
//   * A block owns 128 rows, two warpgroups of 64: queries in the dq launch,
//     keys in the dk/dv launch. Its first operand (Q, or K) lies in registers
//     as hi and lo A fragments (dh registers a thread), its second (dO, or V)
//     in shared memory as hi and lo K-major blocks (A from shared memory), so
//     the registers hold the accumulators: at dh = 64, dQ (32), or dK and dV
//     (64), beside S and dP of a tile (32), a tile's product (32) and the A
//     fragments of P or dS (32).
//   * The other side streams in 32-row tiles (keys, or queries): cp.async
//     brings tile j + 2's rows into a raw tile while the block computes tile
//     j, and the block splits tile j + 1 from the raw tile into one of two
//     sets of split blocks while tile j's products run from the other. A
//     set holds the tile as it lies (the B of S = Q K^T, dP = dO V^T, S^T = K
//     Q^T and dP^T = V dO^T, N = 32) and transposed, for the products whose
//     k runs over the tile's rows (K^T for dQ += dS K; Q^T and dO^T for dK +=
//     dS^T Q and dV += P^T dO): TF32 wgmma reads K-major operands only.
//   * P and dS never leave registers: the accumulator of S (or S^T) is the A
//     fragment of the next product once its k index t stands for column 2t
//     and t + 4 for 2t + 1 (the forward's permutation), so the transposed
//     blocks store their 8 rows in the order 0 2 4 6 1 3 5 7.
//   * Each tile's dQ, dK or dV products (12 k-steps) run into an accumulator
//     that starts from zero and join the running sum after the wait in fp32
//     (add_tile_product), so the sum takes one fp32 rounding a tile instead
//     of the tensor cores' rounding of every k-step of the walk, whose error
//     grew with the keys (dq) and queries (dk, dv): 1.48e-05-1.55e-05
//     against float64 at [4, 4, 2048, 64] while the running sums were the
//     accumulators (PERF.md section 6). The dk/dv launch takes dV's
//     products, then dK's, through one such accumulator: a second beside dK,
//     dV and both A operands would not fit 255 registers.
//   * Kernel 3's dq launch takes the bf16 design's one pass for m, l and D
//     (base 2: mu = m c with c = log2(e) / sqrt(dh), p = 2^(s c - mu) / l),
//     then writes mu, 1/l and delta to the [3, BH, Nq] scratch; kernel 5's
//     computes delta = rowsum(do * o) in its prologue into the [BH, Nq]
//     scratch. A batch with no valid key takes every key in range as valid
//     and c = 0 (kernel 3: p = 1/Nk; kernel 5: p = 2^(-(lse + 1e30) log2 e),
//     1 at kernel 4's lse = -1e30).
//   * Shared memory a block at dh = 64: the own operand's hi and lo, 64 KB;
//     two sets of a tile's layouts (three in the dq launch, four in the dk/dv
//     launch), 2 x 48 or 2 x 64 KB; the dk/dv launch's per-query statistics
//     a set, 768 bytes; the raw tile, 2 x 32 rows of dh + 4 floats (17 KB);
//     the dq launch's key mask, a word a tile: 182,016 bytes plus Nk / 8, and
//     214,784. One block an SM.
//   * Where the time goes (impx_torch/tools/tf32_phases.py, H100 80GB HBM3,
//     700 W, kernel 3 / kernel 5 at [32, 4, 1024, 64]): 2.10 / 1.59 ms; one
//     TF32 pass 1.42 / 1.11; without the split 1.79 / 1.35; the dq launch
//     alone 1.26 / 0.69, the dk/dv launch alone 0.87 / 0.89. One warpgroup a
//     block of 64 rows, reading the tiles from device memory in its split,
//     took 2.72 / 2.09; two warpgroups and two sets 2.48 / 1.83. The two
//     warpgroups run in lockstep, so the tensor cores idle while both take
//     p and ds.
//
// Layout: q, o, do, dq [BH, Nq, dh]; k, v, dk, dv [BH, Nk, dh], contiguous,
// fp32 or bf16; mask [B, Nk] bool (or null); lse [BH, Nq] fp32; scratch fp32,
// [3, BH, Nq] for kernel 3 (bf16: the max, 1/sum, delta; fp32: the base-2
// max mu, 1/sum, delta) and [BH, Nq] for kernel 5 (delta), sized by the
// caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tf32.cuh"

namespace {

constexpr int kBlock = 64;     // query rows (dq launch) or key rows (dk/dv launch) per block

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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
// fp32 (the dq launch: the key mask a stage as 1 or 0, and delta; the dk/dv
// launch: the per-query statistics a stage)
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
                                        const uint8_t* __restrict__ mask,
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
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const bf* kb = k + (size_t)bh * nk * DH;
  const bf* vb = v + (size_t)bh * nk * DH;
  const int ntiles = (nk + kBlock - 1) / kBlock;
  const int total = kLse ? ntiles : 2 * ntiles;

  // key tile it % ntiles into stage it % kStages; its mask byte (thread tid
  // < 64: key k0 + tid) is loaded into `pending` here and stored into its
  // stage as a 1 or 0 by put_mask(it) one tile later, before the barrier
  // that precedes its use, so the load's latency hides behind a tile
  uint32_t pending = 0;
  auto issue = [&](int it) {
    const int k0 = (it % ntiles) * kBlock, st = it % kStages;
    copy_tile<DH>(smem + 2 * st * TILE, kb, k0, nk);
    copy_tile<DH>(smem + (2 * st + 1) * TILE, vb, k0, nk);
    if (mrow != nullptr && tid < kBlock) pending = k0 + tid < nk ? mrow[k0 + tid] : 0u;
  };
  auto put_mask = [&](int it) {
    if (mrow != nullptr && tid < kBlock) msk[(it % kStages) * kBlock + tid] = pending != 0u ? 1.f : 0.f;
  };

  // prologue: this block's Q and dO rows into stage 1 (free until tile 1 is
  // issued), key tile 0 into stage 0
  copy_tile<DH>(smem + 2 * TILE, q + base * DH, q0, nq);
  copy_tile<DH>(smem + 3 * TILE, dout + base * DH, q0, nq);
  cp_async_commit();
  issue(0);
  cp_async_commit();
  put_mask(0);
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
    if (it + 1 < total) put_mask(it + 1);
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
                                          const uint8_t* __restrict__ mask,
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
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
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

// ------------------------------------------------------------ fp32, 3xTF32
// Two warpgroups a block, 64 own rows each; the other side in 32-row tiles,
// split once a block into hi and lo k-step blocks of the no-swizzle K-major
// layout (csrc/attention_tf32.cuh: core matrices of 8 rows x 16 bytes,
// kInterK bytes apart along K, 8-row groups kInterRows apart), two sets of
// them: tile j's products run from one while the block splits tile j + 1
// into the other.
constexpr int kTfRows = 128;    // a block's own rows
constexpr int kTfTile = 32;     // rows of a streamed tile: one 32-bit word of the key mask
constexpr int kTfThreads = 256;

// Dynamic shared memory of either launch: the own operand's hi, then its lo
// ([128 x 8] k-step blocks, warpgroup w's rows at 2048 w bytes in each);
// two split sets, each kLayouts layouts of a tile, each layout's hi then lo
// (the dq launch: K and V as they lie, K^T; the dk/dv launch: Q and dO as
// they lie, Q^T, dO^T); the dk/dv launch's per-query statistics [2][3][32];
// the next tile's two tensors as they arrive by cp.async, rows of DH + 4
// floats (the split's reads on distinct banks); the dq launch's key mask, a
// word a tile
template <int DH, int kLayouts>
struct TfSmem {
  static constexpr int kOwnStep = kTfRows * 32;    // a [128 x 8] k-step block, bytes
  static constexpr int kOwn = DH / 8 * kOwnStep;   // the own operand's hi (or lo)
  static constexpr int kRowStep = kTfTile * 32;    // a [32 x 8] k-step block: the tile as it lies
  static constexpr int kColStep = DH * 32;         // a [DH x 8] k-step block: the tile transposed
  static constexpr int kPart = kTfTile * DH * 4;   // one layout's hi (or lo)
  static constexpr int kSet = 2 * kLayouts * kPart;
  static constexpr int kSets = 2 * kOwn;           // set s at kSets + s kSet; layout i's hi at 2 i kPart in it
  static constexpr int kStats = kSets + 2 * kSet;
  static constexpr int kRawLd = DH + 4;
  static constexpr int kRaw = kTfTile * kRawLd * 4;  // one tensor's rows of a tile
  static constexpr int kRawAt = kStats + 2 * 3 * kTfTile * 4;
  static constexpr int kWords = kRawAt + 2 * kRaw;
  static int bytes(int nk) { return kWords + 4 * ((nk + kTfTile - 1) / kTfTile); }
};

__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// The block's own rows [r0, r0 + 128) of a [n, DH] fp32 tensor (zeros past
// n) as hi and lo k-step blocks [128 x 8] (dims 8kk .. 8kk + 7 at kk
// kOwnStep), hi at dst, lo `lo` bytes after: the A operand of each
// warpgroup's 64 rows. A thread takes 16 bytes, 4 dims of a row; lanes 8i
// .. 8i + 7 take one 16-byte chunk of 8 rows, so a quarter-warp's stores
// fall on distinct banks and a warp reads 64 contiguous bytes of each of its
// 8 rows.
template <int DH>
__device__ __forceinline__ void split_own(uint8_t* dst, int lo, const float* __restrict__ src, int r0, int n) {
  constexpr int kItems = kTfRows * DH / 4;
  static_assert(DH % 16 == 0 && kItems % kTfThreads == 0, "whole warps of 8 rows x 4 chunks");
#pragma unroll
  for (int i = 0; i < kItems / kTfThreads; ++i) {
    const int c = threadIdx.x + i * kTfThreads, rest = c >> 5;
    const int row = (rest % (kTfRows / 8)) * 8 + (c & 7);
    const int chunk = (rest / (kTfRows / 8)) * 4 + ((c >> 3) & 3);
    const int r = r0 + row;
    const float4 x = r < n ? *reinterpret_cast<const float4*>(src + (size_t)r * DH + 4 * chunk)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    uint4 h, l;
    split4(x, h, l);
    const uint32_t off = (chunk >> 1) * (kTfRows * 32) + interleave_offset(row, chunk & 1);
    *reinterpret_cast<uint4*>(dst + off) = h;
    *reinterpret_cast<uint4*>(dst + lo + off) = l;
  }
}

// Rows [r0, r0 + 32) of two [n, DH] fp32 tensors into the raw tile (rows of
// kRawLd floats, zeros past n) by cp.async, 16 bytes a thread, neighbouring
// threads on neighbouring chunks of a row
template <class L, int DH>
__device__ __forceinline__ void load_raw(uint8_t* raw, const float* __restrict__ y1,
                                         const float* __restrict__ y2, int r0, int n) {
  constexpr int kChunks = DH / 4, kItems = 2 * kTfTile * kChunks;
  static_assert(kItems % kTfThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < kItems / kTfThreads; ++i) {
    const int c = threadIdx.x + i * kTfThreads, tensor = c / (kTfTile * kChunks);
    const int row = (c / kChunks) % kTfTile, chunk = c % kChunks;
    const bool in = r0 + row < n;
    const float* src = (tensor ? y2 : y1) + (size_t)(in ? r0 + row : 0) * DH + 4 * chunk;
    cp_async_16(raw + tensor * L::kRaw + (row * L::kRawLd + 4 * chunk) * 4, src, in);
  }
}

// The raw tile's 32 rows as they lie, as hi and lo k-step blocks [32 x 8]
// (dims 8kk .. 8kk + 7 at kk kRowStep), hi at dst, lo `lo` bytes after: the
// B operand of X Y^T. A thread takes 16 bytes; lanes take 32 rows of one
// chunk, so reads (rows kRawLd floats apart) and stores fall on distinct banks
template <class L, int DH>
__device__ __forceinline__ void split_raw_rows(uint8_t* dst, int lo, const uint8_t* raw) {
  constexpr int kItems = kTfTile * DH / 4;
  const float* rf = reinterpret_cast<const float*>(raw);
#pragma unroll
  for (int i = 0; i < (kItems + kTfThreads - 1) / kTfThreads; ++i) {
    const int c = threadIdx.x + i * kTfThreads;
    if (kItems % kTfThreads != 0 && c >= kItems) break;
    const int row = c % kTfTile, chunk = c / kTfTile;
    const float4 x = *reinterpret_cast<const float4*>(rf + row * L::kRawLd + 4 * chunk);
    uint4 h, l;
    split4(x, h, l);
    const uint32_t off = (chunk >> 1) * L::kRowStep + interleave_offset(row, chunk & 1);
    *reinterpret_cast<uint4*>(dst + off) = h;
    *reinterpret_cast<uint4*>(dst + lo + off) = l;
  }
}

// The raw tile's 32 rows transposed, as hi and lo k-step blocks [DH x 8
// rows]: the B operand of A Y with k over the rows. k-step jj holds rows
// 8jj .. 8jj + 7, its k index i < 4 row 8jj + 2i and i + 4 row 8jj + 2i + 1,
// the order in which an accumulator is the A operand. A thread takes one dim
// of 4 rows (one half of a k-step); lanes take consecutive dims.
template <class L, int DH>
__device__ __forceinline__ void split_cols(uint8_t* dst, int lo, const uint8_t* raw) {
  constexpr int kItems = kTfTile / 8 * 2 * DH;
  static_assert(kItems % 32 == 0, "whole warps");
  const float* rf = reinterpret_cast<const float*>(raw);
#pragma unroll
  for (int i = 0; i < (kItems + kTfThreads - 1) / kTfThreads; ++i) {
    const int c = threadIdx.x + i * kTfThreads;
    if (kItems % kTfThreads != 0 && c >= kItems) break;
    const int d = c % DH, half = (c / DH) & 1, jj = c / (2 * DH);
    const float* col = rf + (8 * jj + half) * L::kRawLd + d;  // rows 8jj + half + 2i
    float4 x;
    x.x = col[0];
    x.y = col[2 * L::kRawLd];
    x.z = col[4 * L::kRawLd];
    x.w = col[6 * L::kRawLd];
    uint4 h, l;
    split4(x, h, l);
    const uint32_t off = jj * L::kColStep + interleave_offset(d, half);
    *reinterpret_cast<uint4*>(dst + off) = h;
    *reinterpret_cast<uint4*>(dst + lo + off) = l;
  }
}

// hi and lo A fragments of rows r0 and r0 + 8 of a [n, DH] fp32 tensor (zeros
// past n): k-step kk holds dims 8kk + t and 8kk + t + 4
template <int DH>
__device__ __forceinline__ void load_a_rows(uint32_t (&hi)[DH / 8][4], uint32_t (&lo)[DH / 8][4],
                                            const float* __restrict__ src, int r0, int n, int t) {
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    const int d = 8 * kk + t;
    split_tf32(r0 < n ? src[(size_t)r0 * DH + d] : 0.f, hi[kk][0], lo[kk][0]);
    split_tf32(r0 + 8 < n ? src[(size_t)(r0 + 8) * DH + d] : 0.f, hi[kk][1], lo[kk][1]);
    split_tf32(r0 < n ? src[(size_t)r0 * DH + d + 4] : 0.f, hi[kk][2], lo[kk][2]);
    split_tf32(r0 + 8 < n ? src[(size_t)(r0 + 8) * DH + d + 4] : 0.f, hi[kk][3], lo[kk][3]);
  }
}

// the m64n32 accumulator x as hi and lo A fragments of 4 k-steps of 8
// columns: k index t is column 2t, t + 4 column 2t + 1
__device__ __forceinline__ void acc_to_a(const float (&x)[16], uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    split_tf32(x[4 * jj + 0], hi[jj][0], lo[jj][0]);  // row g, column 8jj + 2t
    split_tf32(x[4 * jj + 2], hi[jj][1], lo[jj][1]);  // row g + 8, column 8jj + 2t
    split_tf32(x[4 * jj + 1], hi[jj][2], lo[jj][2]);  // row g, column 8jj + 2t + 1
    split_tf32(x[4 * jj + 3], hi[jj][3], lo[jj][3]);  // row g + 8, column 8jj + 2t + 1
  }
}

// Issues S = X1 Y1^T (X1 from registers, Y1 as it lies at layout `y1`) and
// P2 = X2 Y2^T (X2 this warpgroup's rows of the own operand in shared memory
// at `x2`; Y2 at `y2`), each in three TF32 passes, m64n32, as one committed
// group; a layout's lo lies kPart after its hi. wait_tile_products waits.
template <class L, int DH>
__device__ __forceinline__ void issue_tile_products(float (&s)[16], float (&p2)[16], uint32_t (&x1h)[DH / 8][4],
                                                    uint32_t (&x1l)[DH / 8][4], uint32_t x2, uint32_t y1,
                                                    uint32_t y2) {
  fence_regs(s);
  fence_regs(p2);
  fence_regs(x1h);
  fence_regs(x1l);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    const uint64_t b_hi = wgmma_desc_interleave(y1 + kk * L::kRowStep);
    const uint64_t b_lo = wgmma_desc_interleave(y1 + L::kPart + kk * L::kRowStep);
    wgmma_tf32_rs_n32(s, x1l[kk], b_hi, kk);
    wgmma_tf32_rs_n32(s, x1h[kk], b_lo, 1);
    wgmma_tf32_rs_n32(s, x1h[kk], b_hi, 1);
  }
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    const uint64_t a_hi = wgmma_desc_interleave(x2 + kk * L::kOwnStep);
    const uint64_t a_lo = wgmma_desc_interleave(x2 + L::kOwn + kk * L::kOwnStep);
    const uint64_t b_hi = wgmma_desc_interleave(y2 + kk * L::kRowStep);
    const uint64_t b_lo = wgmma_desc_interleave(y2 + L::kPart + kk * L::kRowStep);
    wgmma_tf32_ss_n32(p2, a_lo, b_hi, kk);
    wgmma_tf32_ss_n32(p2, a_hi, b_lo, 1);
    wgmma_tf32_ss_n32(p2, a_hi, b_hi, 1);
  }
  wgmma_commit();
  fence_regs(s);
  fence_regs(p2);
  fence_regs(x1h);
  fence_regs(x1l);
}

__device__ __forceinline__ void wait_tile_products(float (&s)[16], float (&p2)[16]) {
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(p2);
}

// acc (64 x DH) += A Y over a tile's 32 rows: A as hi and lo fragments of 4
// k-steps, Y transposed at layout `yt` (hi, then lo kPart after); three TF32
// passes into `part`, an accumulator that starts from zero (scale_d = 0 on
// the first), waited for, then added to acc in fp32 registers. The running
// sum stays out of the tensor cores' accumulator, whose rounding of each
// k-step's sum lost accuracy in proportion to the walk's length while every
// tile ran on in it (PERF.md section 6).
template <class L, int DH>
__device__ __forceinline__ void add_tile_product(float (&acc)[DH / 2], uint32_t (&ah)[4][4],
                                                 uint32_t (&al)[4][4], uint32_t yt) {
  float part[DH / 2];
  fence_regs(part);
  fence_regs(ah);
  fence_regs(al);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const uint64_t b_hi = wgmma_desc_interleave(yt + jj * L::kColStep);
    const uint64_t b_lo = wgmma_desc_interleave(yt + L::kPart + jj * L::kColStep);
    wgmma_tf32_rs(part, al[jj], b_hi, jj);
    wgmma_tf32_rs(part, ah[jj], b_lo, 1);
    wgmma_tf32_rs(part, ah[jj], b_hi, 1);
  }
  wgmma_commit();
  fence_regs(part);
  fence_regs(ah);
  fence_regs(al);
  wgmma_wait<0>();
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] += part[i];
}

// rows r0 and r0 + 8 (< n) of a 64 x DH accumulator out to dst [n, DH] fp32
template <int DH>
__device__ __forceinline__ void store_acc(float* __restrict__ dst, const float (&acc)[DH / 2], int r0, int n,
                                          int t) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < n)
        *reinterpret_cast<float2*>(dst + (size_t)(r0 + 8 * h) * DH + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// whether any key of the batch is valid (kmask null: all are)
__device__ __forceinline__ bool any_valid_key(const uint8_t* kmask, int nk) {
  int any = kmask == nullptr;
  for (int key = threadIdx.x; !any && key < nk; key += kTfThreads) any = kmask[key] != 0;
  return __syncthreads_or(any);
}

// dq for one (128-query block, batch*head), looping over the 32-key tiles.
// Kernel 3 (!kLse): pass 1 finds each row's max, 1/l and delta and writes
// them to scratch [3, BH, Nq]; pass 2 takes p, ds and dQ += dS K. Kernel 5:
// the prologue takes delta = rowsum(do * o) (to scratch [BH, Nq]) and lse,
// then the one pass. The tiles of both passes go through the two split sets
// in turn.
template <int DH, bool kLse>
__device__ __forceinline__ void dq_tf32_body(uint8_t* smem, const float* __restrict__ q,
                                             const float* __restrict__ k, const float* __restrict__ v,
                                             const uint8_t* __restrict__ mask,
                                             const float* __restrict__ dout, const float* __restrict__ o,
                                             const float* __restrict__ lse, float* __restrict__ scratch,
                                             float* __restrict__ dq, int heads, int nq, int nk,
                                             float scale) {
  using L = TfSmem<DH, 3>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, q0 = blockIdx.x * kTfRows;
  const size_t rows = (size_t)gridDim.y * nq, base = (size_t)bh * nq;
  const int ntiles = (nk + kTfTile - 1) / kTfTile, total = kLse ? ntiles : 2 * ntiles;
  const float* kb = k + (size_t)bh * nk * DH;
  const float* vb = v + (size_t)bh * nk * DH;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + L::kWords);

  // the batch's key mask as bits, a word a tile; with no valid key, every key
  // in range counts, with scores scaled by 0 (c = 0)
  const uint8_t* kmask = mask == nullptr ? nullptr : mask + (size_t)b * nk;
  int any = 0;
  for (int w = warp; w < ntiles; w += kTfThreads / 32) {
    const int key = w * 32 + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, key < nk && (kmask == nullptr || kmask[key] != 0));
    if (lane == 0) words[w] = bits;
    any |= bits != 0u;
  }
  const bool all_masked = !__syncthreads_or(any);
  if (all_masked) {
    for (int w = tid; w < ntiles; w += kTfThreads) {
      const int n = min(nk - 32 * w, 32);
      words[w] = n == 32 ? 0xffffffffu : (1u << n) - 1u;
    }
  }
  const float c = all_masked ? 0.f : scale * kLog2e;

  // own rows r0, r0 + 8: Q's A fragments in registers, dO's blocks in shared memory
  const int r0 = q0 + 16 * warp + g;
  uint32_t qh[DH / 8][4], ql[DH / 8][4];
  load_a_rows<DH>(qh, ql, q + base * DH, r0, nq, t);
  split_own<DH>(smem, L::kOwn, dout + base * DH, q0, nq);
  const uint32_t own = smem_addr(smem) + (warp >> 2) * 2048, sets = smem_addr(smem + L::kSets);
  uint8_t* raw = smem + L::kRawAt;
  auto load_tile = [&](int it) {  // key tile it % ntiles's K and V rows into the raw tile
    load_raw<L, DH>(raw, kb, vb, (it % ntiles) * kTfTile, nk);
    cp_async_commit();
  };
  // key tile it % ntiles (in the raw tile) into set it % 2: K and V as they
  // lie, and K^T where dQ needs it
  auto split_tile = [&](int it) {
    uint8_t* set = smem + L::kSets + (it & 1) * L::kSet;
    split_raw_rows<L, DH>(set, L::kPart, raw);
    split_raw_rows<L, DH>(set + 2 * L::kPart, L::kPart, raw + L::kRaw);
    if (kLse || it >= ntiles) split_cols<L, DH>(set + 4 * L::kPart, L::kPart, raw);
    fence_proxy_async();
  };

  // p = 2^(s c - mu) il a valid key; delta dl (rows g and g + 8)
  float mu[2] = {0.f, 0.f}, il[2] = {1.f, 1.f}, dl[2] = {0.f, 0.f};
  if constexpr (kLse) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      float acc = 0.f;
      if (r < nq) {  // the four threads of a row take every fourth 16-byte chunk
        const float4* x = reinterpret_cast<const float4*>(dout + (base + r) * DH);
        const float4* y = reinterpret_cast<const float4*>(o + (base + r) * DH);
#pragma unroll
        for (int ch = t; ch < DH / 4; ch += 4) {
          const float4 a = x[ch], bb = y[ch];
          acc += a.x * bb.x + a.y * bb.y + a.z * bb.z + a.w * bb.w;
        }
      }
      dl[h] = quad_sum(acc);
      mu[h] = r < nq ? (all_masked ? lse[base + r] - kNeg : lse[base + r]) * kLog2e : INFINITY;
      if (t == 0 && r < nq) scratch[base + r] = dl[h];
    }
  }
  // kernel 3's pass 1: the online max m (raw; mu = m c), l and D = sum dp 2^(s c - mu)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float s[16], dp[16];
  // Each tile it: its products from set it % 2, in flight while the block
  // splits tile it + 1 (its rows landed in the raw tile) into the other set;
  // then tile it + 2's rows start for the raw tile
  load_tile(0);
  cp_async_wait<0>();
  __syncthreads();  // tile 0's rows, the own operand's blocks and the mask words in place
  split_tile(0);
  __syncthreads();  // set 0 in place; the raw tile free
  if (1 < total) load_tile(1);
  for (int it = 0; it < total; ++it) {
    const uint32_t set = sets + (it & 1) * L::kSet;
    issue_tile_products<L, DH>(s, dp, qh, ql, own, set, set + 2 * L::kPart);
    if (it + 1 < total) {
      cp_async_wait<0>();
      __syncthreads();  // tile it + 1's rows in place
      split_tile(it + 1);
    }
    wait_tile_products(s, dp);
    const uint32_t w = words[it % ntiles];
    if (!kLse && it < ntiles) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if ((w >> (8 * (i >> 2) + 2 * t + (i & 1))) & 1u) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        const float mu_new = m_new == -INFINITY ? 0.f : m_new * c;
        alpha[h] = m[h] == -INFINITY ? 0.f : ex2(mu[h] - mu_new);
        m[h] = m_new;
        mu[h] = mu_new;
      }
      float e_sum[2] = {0.f, 0.f}, d_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 16; ++i) {  // s[i]: row g + 8h (h = (i >> 1) & 1), key 8 (i >> 2) + 2t + (i & 1)
        const int h = (i >> 1) & 1;
        const float e = ((w >> (8 * (i >> 2) + 2 * t + (i & 1))) & 1u) ? ex2(fmaf(s[i], c, -mu[h])) : 0.f;
        e_sum[h] += e;
        d_sum[h] += e * dp[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] = l[h] * alpha[h] + e_sum[h];
        dd[h] = dd[h] * alpha[h] + d_sum[h];
      }
      if (it == ntiles - 1) {  // mu, 1/l and delta = D / l for pass 2 and the dk/dv launch
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const float lt = quad_sum(l[h]);
          il[h] = 1.f / lt;
          dl[h] = quad_sum(dd[h]) / lt;
          if (t == 0 && r < nq) {
            scratch[base + r] = mu[h];
            scratch[rows + base + r] = il[h];
            scratch[2 * rows + base + r] = dl[h];
          }
        }
      }
    } else {  // dQ += dS K, ds = p (dp - delta) scale
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int h = (i >> 1) & 1;
        const float p = ((w >> (8 * (i >> 2) + 2 * t + (i & 1))) & 1u) ? ex2(fmaf(s[i], c, -mu[h])) * il[h] : 0.f;
        s[i] = p * (dp[i] - dl[h]) * scale;
      }
      uint32_t ah[4][4], al[4][4];
      acc_to_a(s, ah, al);
      add_tile_product<L, DH>(acc, ah, al, set + 4 * L::kPart);
    }
    __syncthreads();  // set (it + 1) % 2 in place; set it % 2 and the raw tile free
    if (it + 2 < total) load_tile(it + 2);
  }
  store_acc<DH>(dq + base * DH, acc, r0, nq, t);
}

// dk and dv for one (128-key block, batch*head), looping over the 32-query
// tiles through the two split sets: S^T = K Q^T, dP^T = V dO^T, p and ds
// from the dq launch's per-query statistics (kernel 3: mu, 1/l, delta;
// kernel 5: lse, delta), dV += P^T dO, dK += dS^T Q.
template <int DH, bool kLse>
__device__ __forceinline__ void dkdv_tf32_body(uint8_t* smem, const float* __restrict__ q,
                                               const float* __restrict__ k, const float* __restrict__ v,
                                               const uint8_t* __restrict__ mask,
                                               const float* __restrict__ dout,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ scratch, float* __restrict__ dk,
                                               float* __restrict__ dv, int heads, int nq, int nk,
                                               float scale) {
  using L = TfSmem<DH, 4>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, key0 = blockIdx.x * kTfRows;
  const size_t rows = (size_t)gridDim.y * nq, base = (size_t)bh * nq;
  const int ntiles = (nq + kTfTile - 1) / kTfTile;
  const float* qb = q + base * DH;
  const float* ob = dout + base * DH;
  float* stats = reinterpret_cast<float*>(smem + L::kStats);  // [set][3][32]: mu, 1/l, delta a query

  const uint8_t* kmask = mask == nullptr ? nullptr : mask + (size_t)b * nk;
  const bool all_masked = !any_valid_key(kmask, nk);
  const float c = all_masked ? 0.f : scale * kLog2e;
  // own rows r0, r0 + 8: K's A fragments in registers, V's blocks in shared memory
  const int r0 = key0 + 16 * warp + g;
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    valid[h] = r < nk && (all_masked || kmask == nullptr || kmask[r] != 0);
  }
  uint32_t kh[DH / 8][4], kl[DH / 8][4];
  load_a_rows<DH>(kh, kl, k + (size_t)bh * nk * DH, r0, nk, t);
  split_own<DH>(smem, L::kOwn, v + (size_t)bh * nk * DH, key0, nk);
  const uint32_t own = smem_addr(smem) + (warp >> 2) * 2048, sets = smem_addr(smem + L::kSets);
  uint8_t* raw = smem + L::kRawAt;
  auto load_tile = [&](int it) {  // query tile it's Q and dO rows into the raw tile
    load_raw<L, DH>(raw, qb, ob, it * kTfTile, nq);
    cp_async_commit();
  };
  // query tile it (in the raw tile) into set it % 2: Q and dO as they lie,
  // Q^T, dO^T, and the queries' statistics (past nq weigh 0: p = 0, kernel 3
  // by 1/l = 0 and kernel 5 by mu = inf, and delta = 0)
  auto split_tile = [&](int it) {
    const int qq0 = it * kTfTile;
    uint8_t* set = smem + L::kSets + (it & 1) * L::kSet;
    split_raw_rows<L, DH>(set, L::kPart, raw);
    split_raw_rows<L, DH>(set + 2 * L::kPart, L::kPart, raw + L::kRaw);
    split_cols<L, DH>(set + 4 * L::kPart, L::kPart, raw);
    split_cols<L, DH>(set + 6 * L::kPart, L::kPart, raw + L::kRaw);
    if (tid < kTfTile) {
      float* st = stats + (it & 1) * 3 * kTfTile;
      const int qq = qq0 + tid;
      const bool in = qq < nq;
      if constexpr (kLse) {
        st[tid] = in ? (all_masked ? lse[base + qq] - kNeg : lse[base + qq]) * kLog2e : INFINITY;
        st[kTfTile + tid] = 1.f;
        st[2 * kTfTile + tid] = in ? scratch[base + qq] : 0.f;
      } else {
        st[tid] = in ? scratch[base + qq] : 0.f;
        st[kTfTile + tid] = in ? scratch[rows + base + qq] : 0.f;
        st[2 * kTfTile + tid] = in ? scratch[2 * rows + base + qq] : 0.f;
      }
    }
    fence_proxy_async();
  };

  float dka[DH / 2], dva[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.f;
  float s[16], dp[16];
  // the tiles go through the raw tile and the two sets as in dq_tf32_body
  load_tile(0);
  cp_async_wait<0>();
  __syncthreads();  // tile 0's rows and the own operand's blocks in place
  split_tile(0);
  __syncthreads();  // set 0 in place; the raw tile free
  if (1 < ntiles) load_tile(1);
  for (int it = 0; it < ntiles; ++it) {
    const uint32_t set = sets + (it & 1) * L::kSet;
    issue_tile_products<L, DH>(s, dp, kh, kl, own, set, set + 2 * L::kPart);
    if (it + 1 < ntiles) {
      cp_async_wait<0>();
      __syncthreads();  // tile it + 1's rows in place
      split_tile(it + 1);
    }
    wait_tile_products(s, dp);
    const float* st = stats + (it & 1) * 3 * kTfTile;
#pragma unroll
    for (int i = 0; i < 16; ++i) {  // s[i]: key row g + 8h (h = (i >> 1) & 1), query 8 (i >> 2) + 2t + (i & 1)
      const int h = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * t + (i & 1);
      const float p = valid[h] ? ex2(fmaf(s[i], c, -st[col])) * st[kTfTile + col] : 0.f;
      dp[i] = p * (dp[i] - st[2 * kTfTile + col]) * scale;
      s[i] = p;
    }
    // dV's products, then dK's, through one tile accumulator: a second one
    // beside dK, dV and both A operands would not fit the registers
    uint32_t ah[4][4], al[4][4];
    acc_to_a(s, ah, al);
    add_tile_product<L, DH>(dva, ah, al, set + 6 * L::kPart);  // dV += P^T dO
    acc_to_a(dp, ah, al);
    add_tile_product<L, DH>(dka, ah, al, set + 4 * L::kPart);  // dK += dS^T Q
    __syncthreads();  // set (it + 1) % 2 in place; set it % 2 and the raw tile free
    if (it + 2 < ntiles) load_tile(it + 2);
  }
  store_acc<DH>(dk + (size_t)bh * nk * DH, dka, r0, nk, t);
  store_acc<DH>(dv + (size_t)bh * nk * DH, dva, r0, nk, t);
}

// one kernel name per route, so that a profile tells kernels 3 and 5 apart
#define IMPX_DQ_ARGS                                                                          \
  const bf *q, const bf *k, const bf *v, const uint8_t *mask, const bf *dout, const bf *o,    \
      const float *lse, float *scratch, bf *dq, int heads, int nq, int nk, float scale
#define IMPX_DKDV_ARGS                                                                        \
  const bf *q, const bf *k, const bf *v, const uint8_t *mask, const bf *dout,                 \
      const float *lse, const float *scratch, bf *dk, bf *dv, int heads, int nq, int nk, float scale
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

#define IMPX_DQ_ARGS                                                                             \
  const float *q, const float *k, const float *v, const uint8_t *mask, const float *dout,        \
      const float *o, const float *lse, float *scratch, float *dq, int heads, int nq, int nk,    \
      float scale
#define IMPX_DKDV_ARGS                                                                           \
  const float *q, const float *k, const float *v, const uint8_t *mask, const float *dout,        \
      const float *lse, const float *scratch, float *dk, float *dv, int heads, int nq, int nk,   \
      float scale
template <int DH>
__global__ void __launch_bounds__(kTfThreads, 1) bwd_dq_recompute_tf32x3(IMPX_DQ_ARGS) {
  extern __shared__ __align__(16) uint8_t tf_smem[];
  dq_tf32_body<DH, false>(tf_smem, q, k, v, mask, dout, o, lse, scratch, dq, heads, nq, nk, scale);
}
template <int DH>
__global__ void __launch_bounds__(kTfThreads, 1) bwd_dkdv_recompute_tf32x3(IMPX_DKDV_ARGS) {
  extern __shared__ __align__(16) uint8_t tf_smem[];
  dkdv_tf32_body<DH, false>(tf_smem, q, k, v, mask, dout, lse, scratch, dk, dv, heads, nq, nk, scale);
}
template <int DH>
__global__ void __launch_bounds__(kTfThreads, 1) bwd_dq_lse_tf32x3(IMPX_DQ_ARGS) {
  extern __shared__ __align__(16) uint8_t tf_smem[];
  dq_tf32_body<DH, true>(tf_smem, q, k, v, mask, dout, o, lse, scratch, dq, heads, nq, nk, scale);
}
template <int DH>
__global__ void __launch_bounds__(kTfThreads, 1) bwd_dkdv_lse_tf32x3(IMPX_DKDV_ARGS) {
  extern __shared__ __align__(16) uint8_t tf_smem[];
  dkdv_tf32_body<DH, true>(tf_smem, q, k, v, mask, dout, lse, scratch, dk, dv, heads, nq, nk, scale);
}
#undef IMPX_DQ_ARGS
#undef IMPX_DKDV_ARGS

// ------------------------------------------------------------------ launches
struct Args {
  const void *q, *k, *v, *o, *dout;
  const uint8_t* mask;
  const float* lse;
  float* scratch;
  void *dq, *dk, *dv;
  int bh, heads, nq, nk;
  cudaStream_t stream;
};

// bf16: the dq launch, then the dk/dv launch, on the tensor cores. kLse:
// kernel 5 (scratch [BH, Nq] takes delta); otherwise kernel 3 (scratch
// [3, BH, Nq] takes m, 1/l, delta).
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

// fp32: the dq launch, then the dk/dv launch, in 3xTF32, each block 128 rows
// of its own and two warpgroups; their dynamic shared memory limits raised
// once a device
template <int DH, bool kLse>
cudaError_t launch_tf32(const Args& a, float scale) {
  const int smem_dq = TfSmem<DH, 3>::bytes(a.nk), smem_dkdv = TfSmem<DH, 4>::kWords;
  if (smem_dq > kMaxSmem) return cudaErrorInvalidValue;
  auto dq_kernel = kLse ? bwd_dq_lse_tf32x3<DH> : bwd_dq_recompute_tf32x3<DH>;
  auto dkdv_kernel = kLse ? bwd_dkdv_lse_tf32x3<DH> : bwd_dkdv_recompute_tf32x3<DH>;
  static uint64_t raised = 0;  // devices whose dynamic shared memory limits are raised
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((raised >> device) & 1u)) {
    err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    raised |= uint64_t{1} << device;
  }
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  dq_kernel<<<dim3((a.nq + kTfRows - 1) / kTfRows, a.bh), kTfThreads, smem_dq, a.stream>>>(
      q, k, v, a.mask, dout, static_cast<const float*>(a.o), a.lse, a.scratch, static_cast<float*>(a.dq),
      a.heads, a.nq, a.nk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3((a.nk + kTfRows - 1) / kTfRows, a.bh), kTfThreads, smem_dkdv, a.stream>>>(
      q, k, v, a.mask, dout, a.lse, a.scratch, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.heads,
      a.nq, a.nk, scale);
  return cudaGetLastError();
}

template <int DH, bool kLse>
cudaError_t launch(const Args& a, int is_bf16) {
  const float scale = (float)(1.0 / sqrt((double)DH));
  return is_bf16 ? launch_mma<DH, kLse>(a, scale) : launch_tf32<DH, kLse>(a, scale);
}

template <bool kLse>
cudaError_t launch_dh(const Args& a, int dh, int is_bf16) {
  if (a.nq < 1 || a.nk < 1 || a.bh < 1 || a.bh > 65535 || a.heads < 1) return cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch<16, kLse>(a, is_bf16);
    case 32: return launch<32, kLse>(a, is_bf16);
    case 64: return launch<64, kLse>(a, is_bf16);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Kernel 3. scratch: fp32 [3, BH, Nq].
extern "C" int impx_mha_bwd(const void* q, const void* k, const void* v, const void* mask,
                            const void* dout, void* scratch, void* dq, void* dk, void* dv, int bh,
                            int heads, int nq, int nk, int dh, int is_bf16, void* stream) {
  const Args a{q, k, v, nullptr, dout, static_cast<const uint8_t*>(mask), nullptr,
               static_cast<float*>(scratch), dq, dk, dv, bh, heads, nq, nk,
               static_cast<cudaStream_t>(stream)};
  return (int)launch_dh<false>(a, dh, is_bf16);
}

// Kernel 5. lse: fp32 [BH, Nq] from impx_mha_fwd_lse; scratch: fp32 [BH, Nq].
extern "C" int impx_mha_bwd_lse(const void* q, const void* k, const void* v, const void* mask,
                                const void* lse, const void* o, const void* dout, void* scratch,
                                void* dq, void* dk, void* dv, int bh, int heads, int nq, int nk,
                                int dh, int is_bf16, void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const uint8_t*>(mask), static_cast<const float*>(lse),
               static_cast<float*>(scratch), dq, dk, dv, bh, heads, nq, nk,
               static_cast<cudaStream_t>(stream)};
  return (int)launch_dh<true>(a, dh, is_bf16);
}
