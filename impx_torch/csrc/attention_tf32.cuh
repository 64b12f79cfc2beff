// The attention forward's base-2 online softmax (shared by the bf16 and fp32
// forwards, csrc/attention.cu, and the row lse of csrc/attention_mass.cu),
// the 3xTF32 product on Hopper's tensor cores, and the fp32 forward built on
// it: kernels 1 and 4 at fp32 (attention.cu) and, without P.V, kernel 6's
// standalone row lse (attention_mass.cu).
//
// 3xTF32. The tensor cores take fp32 operands as TF32 (10 mantissa bits), so
// each operand is split as a = hi + lo, hi = tf32(a) and lo = tf32(a - hi)
// (round to nearest, ties away from zero, as cvt.rna; a - hi is exact in fp32),
// and a product is taken as lo.hi + hi.lo + hi.hi, the two small terms first,
// accumulated in fp32. What lo.lo and lo's own rounding leave out is about
// 2^-21 of a product, the order of fp32 summation differences: the fp32
// tolerances of the plain version hold (one TF32 pass, about 5e-4 relative,
// would not). Three passes at the card's 495 TFLOP/s of TF32 are 165 TFLOP/s
// of fp32-exact products against the FMA pipes' 67.
//
// The fp32 forward (attn_fwd_tf32x3, dh 16, 32, 64): one block per (128
// queries, batch*head), two warpgroups of 64 query rows; S = Q K^T and O +=
// P V as wgmma m64nNk8 .tf32 with A from registers and B from shared memory:
//   * Q's A fragments, hi and lo, load once into registers (dh registers a
//     thread); 64-key K and V tiles stream raw through kF32Stages cp.async
//     stages (zero-filled past Nk);
//   * wgmma reads B from shared memory as it lies, so the split of K and V
//     is a pass once a block a tile (split_tile): every thread turns 16-byte
//     pieces of the raw tile into hi and lo k-step blocks in the no-swizzle
//     K-major layout, K as [64 keys x 8 dims] blocks and V transposed as
//     [dh dims x 8 keys], both written 512 contiguous bytes a warp;
//   * P stays in registers: the S accumulator (rows g, g + 8, keys 2t, 2t + 1
//     of each 8-key block) is P's A fragment once the k index t stands for
//     key 2t and t + 4 for key 2t + 1, a permutation that a sum allows; the
//     V^T blocks store their 8 keys in that order (0 2 4 6 1 3 5 7);
//   * the softmax is the bf16 forward's (softmax_tile below), with P kept in
//     fp32 and split into hi and lo for P.V;
//   * two sets of split blocks: tile j's QK^T runs from one while the block
//     splits tile j + 1 into the other, two barriers a tile (tile j + 1's raw
//     copy in place; the next set in place and the last one free); a
//     warpgroup runs its two products in turn;
//   * each tile's P V runs into an accumulator that starts from zero (scale_d
//     = 0 on its first k-step) and joins O after the wait in one fp32 FFMA,
//     O = O alpha + P V. With O itself as the accumulator, every k-step of
//     the walk (24 a tile, 768 at 2048 keys) rounded the running sum on the
//     tensor cores, and the error grew with the key count (1.47e-05 against
//     float64 at 2048 keys, over FWD_O_REL_L2 = 1e-5; PERF.md section 6).
// Where the time goes (impx_torch/tools/tf32_phases.py, H100 80GB HBM3,
// 700 W, [8, 4, 2048, 64]): both products on mma.sync m16n8k8, each warp
// splitting its own fragments, took 0.76 ms a call with cvt.rna and 0.64
// with the integer rounding below; on wgmma with one split set 0.50, with two
// 0.48, against 0.38 without the split pass.
// kPV = false leaves out P.V and the output: the row lse alone, for a caller
// that passes a query mask (a block whose queries all weigh 0 writes nothing).
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------ the online softmax
// One 64-key tile's softmax for this thread's two rows (g, g + 8): the tile's
// scores s (raw q.k; s[4j + 2h + e] = row g + 8h, key 8j + 2t + e: the m64n64
// wgmma accumulator's layout), the tile's mask words,
// the running max m (raw units), its scaled copy mu = m c (0 while m = -inf),
// the running sum l; writes p = 2^(s c - mu) over s (0 at invalid keys) and
// alpha, the factor for O and l.
template <bool kAllValid>
__device__ __forceinline__ void softmax_tile(float (&s)[32], uint32_t w_lo, uint32_t w_hi, int t,
                                             float c, float (&m)[2], float (&mu)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  uint32_t valid = 0xffffu;  // bit 2j + e: key 8j + 2t + e of the tile
  if (!kAllValid) {
    valid = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) valid |= (((j < 4 ? w_lo : w_hi) >> ((j & 3) * 8 + 2 * t)) & 3u) << (2 * j);
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if ((valid >> (2 * j + e)) & 1u) {
        mx[0] = fmaxf(mx[0], s[4 * j + e]);
        mx[1] = fmaxf(mx[1], s[4 * j + 2 + e]);
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)  // the 4 threads of a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    const float m_new = fmaxf(m[r], mx[r]);
    const float mu_new = m_new == -INFINITY ? 0.f : m_new * c;
    alpha[r] = m[r] == -INFINITY ? 0.f : ex2(mu[r] - mu_new);
    m[r] = m_new;
    mu[r] = mu_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // s[4j + 2h + e] = row g + 8h, key 8j + 2t + e
      const float e = ((valid >> (2 * j + (i & 1))) & 1u) ? ex2(fmaf(s[4 * j + i], c, -mu[i >> 1])) : 0.f;
      s[4 * j + i] = e;
      sum[i >> 1] += e;
    }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// a tile whose 64 keys are all valid, the common case, skips the selects
__device__ __forceinline__ void softmax(float (&s)[32], uint32_t w_lo, uint32_t w_hi, int t,
                                        float c, float (&m)[2], float (&mu)[2], float (&l)[2],
                                        float (&alpha)[2]) {
  if ((w_lo & w_hi) == 0xffffffffu) softmax_tile<true>(s, w_lo, w_hi, t, c, m, mu, l, alpha);
  else softmax_tile<false>(s, w_lo, w_hi, t, c, m, mu, l, alpha);
}

// ----------------------------------------------------------------- 3xTF32
// cvt.rna.tf32.f32 in integer arithmetic: half the unit of the 13 dropped
// bits added to the magnitude (the low 31 bits of the pattern), then those
// bits cleared: round to nearest, ties away from zero, the same bits for
// every finite x (an infinity stays one). The conversion unit issues a
// quarter as many results a clock as the integer pipes: with cvt.rna the
// mma.sync version of the forward took 0.76 ms, with these two instructions
// 0.64 (impx_torch/tools/tf32_phases.py).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as tf32 hi + lo
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// D (+)= A B, wgmma m64n64k8 tf32: A [64 x 8] from registers (each warp's 16
// rows as mma.sync m16n8k8's A fragment), B [8 x 64] K-major in shared memory
// (descriptor); scale_d = 0 overwrites D. The accumulator's layout is
// wgmma_ss_n64's: d[4j + 2h + e] = D[16w + g + 8h][8j + 2t + e].
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// the same at N = 32 (the backward's S, dP and their transposes)
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// the same with A [64 x 8] K-major in shared memory (descriptor)
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same at N = dh (16, 32 or 64): the P.V product and the backward's dQ,
// dK and dV products; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  wgmma_tf32_rs_n32(d, a, db, scale_d);
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  wgmma_tf32_rs_n64(d, a, db, scale_d);
}

// The no-swizzle ("interleaved") K-major layout of a wgmma operand: core
// matrices of 8 rows x 16 bytes (4 tf32), row after row; a 32-byte k-step is
// two core matrices side by side in K, kInterK bytes apart (the descriptor's
// leading byte offset), and 8-row groups kInterRows bytes apart (its stride
// byte offset): a [64 x 8] k-step block takes 2 KB.
constexpr uint32_t kInterK = 128;
constexpr uint32_t kInterRows = 256;

__device__ __forceinline__ uint64_t wgmma_desc_interleave(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kInterK >> 4) << 16) |
         (static_cast<uint64_t>(kInterRows >> 4) << 32);
}

// byte offset of row r's 16-byte chunk `half` (dims 4 half .. + 3) of a k-step block
__device__ __forceinline__ uint32_t interleave_offset(int r, int half) {
  return (r >> 3) * kInterRows + half * kInterK + (r & 7) * 16;
}

// shared-memory writes of the generic proxy made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------ the fp32 forward
constexpr int kF32TileQ = 128;  // query rows a block: 8 warps of 16
constexpr int kF32TileK = 64;   // keys a tile
constexpr int kF32Stages = 2;   // raw K/V tiles in flight
constexpr int kF32Warps = 8;
constexpr int kF32Threads = 32 * kF32Warps;

// Dynamic shared memory: the raw K (and V) stages; two sets of split blocks,
// each K's hi and lo as k-step blocks [64 keys x 8 dims] (interleaved,
// K-major: wgmma's B of QK^T) and V^T's hi and lo as k-step blocks [dh dims x
// 8 keys] (B of P.V, its 8 keys in the order 0 2 4 6 1 3 5 7: k index t <->
// key 2t, t + 4 <-> key 2t + 1, as the S accumulator holds P); then the key
// mask as bits (two words a key tile)
template <int DH, bool kPV>
struct F32Smem {
  static constexpr int kLd = DH + 4;  // floats a raw row: the split pass's 16-byte reads on distinct banks
  static constexpr int kRaw = kF32TileK * kLd * 4;
  static constexpr int kStage = (kPV ? 2 : 1) * kRaw;
  static constexpr int kKStep = kF32TileK * 32;
  static constexpr int kVStep = DH * 32;
  static constexpr int kBlocks = kF32Stages * kStage;  // split set s at kBlocks + s * kSet
  static constexpr int kKLo = DH / 8 * kKStep;         // offsets inside a set
  static constexpr int kVHi = 2 * kKLo;
  static constexpr int kVLo = kVHi + (kPV ? kF32TileK / 8 * kVStep : 0);
  static constexpr int kSet = kVLo + (kPV ? kF32TileK / 8 * kVStep : 0);
  static constexpr int kWords = kBlocks + 2 * kSet;
  static int bytes(int nk) { return kWords + 8 * ((nk + kF32TileK - 1) / kF32TileK); }
};

// lse (if not null) = m / sqrt(dh) + log(l) a row, -1e30 on a batch with no
// valid key; out = (P V) / l a row when kPV
template <int DH, bool kPV>
__global__ void __launch_bounds__(kF32Threads, 1)
attn_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const uint8_t* __restrict__ key_mask, const uint8_t* __restrict__ query_mask,
                float* __restrict__ out, float* __restrict__ lse, int heads, int nq, int nk,
                float scale) {
  using L = F32Smem<DH, kPV>;
  constexpr int kChunks = DH / 4;  // 16-byte chunks a row
  constexpr int kSteps = DH / 8;   // k-steps of QK^T
  extern __shared__ __align__(16) uint8_t smem_f32[];
  const int ntiles = (nk + kF32TileK - 1) / kF32TileK;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem_f32 + L::kWords);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, q0 = blockIdx.x * kF32TileQ;
  if constexpr (!kPV) {  // the row lse: no query of the block weighs anything
    const uint8_t* qmask = query_mask == nullptr ? nullptr : query_mask + (size_t)b * nq;
    if (!__syncthreads_or(tid < kF32TileQ && q0 + tid < nq && (qmask == nullptr || qmask[q0 + tid] != 0)))
      return;
  }
  const float* kb = k + (size_t)bh * nk * DH;
  const float* vb = kPV ? v + (size_t)bh * nk * DH : nullptr;
  auto load_tile = [&](int j) {  // rows past nk as zeros
    uint8_t* st = smem_f32 + (j % kF32Stages) * L::kStage;
    for (int c = tid; c < kF32TileK * kChunks; c += kF32Threads) {
      const int row = c / kChunks, col = (c % kChunks) * 4, key = j * kF32TileK + row;
      const bool in = key < nk;
      const size_t src = (size_t)(in ? key : 0) * DH + col;
      cp_async_16(st + (row * L::kLd + col) * 4, kb + src, in);
      if constexpr (kPV) cp_async_16(st + L::kRaw + (row * L::kLd + col) * 4, vb + src, in);
    }
  };
  // tile j's K (and V^T) as hi and lo k-step blocks in split set j % 2, once
  // a block. K: a warp takes 32 keys' 16 bytes of one k-step half; V: a warp
  // takes 32 dims of one 4-key half of a k-step (its keys 2i or 2i + 1)
  auto split_tile = [&](int j) {
    const float* rk = reinterpret_cast<const float*>(smem_f32 + (j % kF32Stages) * L::kStage);
    uint8_t* set = smem_f32 + L::kBlocks + (j & 1) * L::kSet;
    for (int c = tid; c < kF32TileK * kChunks; c += kF32Threads) {
      const int key = c % kF32TileK, half = (c / kF32TileK) & 1, kk = c / (2 * kF32TileK);
      const float4 x = *reinterpret_cast<const float4*>(rk + key * L::kLd + 8 * kk + 4 * half);
      uint4 hi, lo;
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      const uint32_t off = kk * L::kKStep + interleave_offset(key, half);
      *reinterpret_cast<uint4*>(set + off) = hi;
      *reinterpret_cast<uint4*>(set + L::kKLo + off) = lo;
    }
    if constexpr (kPV) {
      const float* rv = rk + L::kRaw / 4;
      for (int c = tid; c < kF32TileK / 8 * 2 * DH; c += kF32Threads) {
        const int d = c % DH, half = (c / DH) & 1, jj = c / (2 * DH);
        const float* col = rv + (8 * jj + half) * L::kLd + d;  // keys 8jj + half + 2i
        uint4 hi, lo;
        split_tf32(col[0], hi.x, lo.x);
        split_tf32(col[2 * L::kLd], hi.y, lo.y);
        split_tf32(col[4 * L::kLd], hi.z, lo.z);
        split_tf32(col[6 * L::kLd], hi.w, lo.w);
        const uint32_t off = jj * L::kVStep + interleave_offset(d, half);
        *reinterpret_cast<uint4*>(set + L::kVHi + off) = hi;
        *reinterpret_cast<uint4*>(set + L::kVLo + off) = lo;
      }
    }
    fence_proxy_async();
  };
  // the first tiles fly while the block reads the mask and Q
#pragma unroll
  for (int j = 0; j < kF32Stages; ++j) {
    if (j < ntiles) load_tile(j);
    cp_async_commit();
  }

  // the batch's key mask as bits, one warp a 32-key word
  const uint8_t* kmask = key_mask == nullptr ? nullptr : key_mask + (size_t)b * nk;
  int any = 0;
  for (int w = warp; w < 2 * ntiles; w += kF32Warps) {
    const int key = w * 32 + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, key < nk && (kmask == nullptr || kmask[key] != 0));
    if (lane == 0) words[w] = bits;
    any |= bits != 0u;
  }
  // no valid key in the batch: every key in range weighs alike (the
  // reference's -1e30 on each), so all of them count, with scores scaled by 0
  const bool all_masked = !__syncthreads_or(any);
  if (all_masked) {
    for (int w = tid; w < 2 * ntiles; w += kF32Threads) {
      const int n = min(max(nk - 32 * w, 0), 32);
      words[w] = n == 32 ? 0xffffffffu : (1u << n) - 1u;
    }
  }

  // Q's A fragments, hi and lo: rows r0, r0 + 8 (the warp's 16 of its
  // warpgroup's 64), dims 8kk + t and 8kk + t + 4
  const int r0 = q0 + 16 * warp + g;
  uint32_t qh[kSteps][4], ql[kSteps][4];
  {
    const float* qb = q + (size_t)bh * nq * DH;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int d = 8 * kk + t;
      split_tf32(r0 < nq ? qb[(size_t)r0 * DH + d] : 0.f, qh[kk][0], ql[kk][0]);
      split_tf32(r0 + 8 < nq ? qb[(size_t)(r0 + 8) * DH + d] : 0.f, qh[kk][1], ql[kk][1]);
      split_tf32(r0 < nq ? qb[(size_t)r0 * DH + d + 4] : 0.f, qh[kk][2], ql[kk][2]);
      split_tf32(r0 + 8 < nq ? qb[(size_t)(r0 + 8) * DH + d + 4] : 0.f, qh[kk][3], ql[kk][3]);
    }
  }
  const float c = all_masked ? 0.f : scale * kLog2e;
  const uint32_t sets = smem_addr(smem_f32 + L::kBlocks);
  float o[kPV ? DH / 2 : 1];
#pragma unroll
  for (int i = 0; i < (kPV ? DH / 2 : 1); ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, mu[2] = {0.f, 0.f}, l[2] = {0.f, 0.f}, alpha[2];
  float s[32];

  // Each tile j: S = Q K^T from split set j % 2, in flight while the block
  // splits tile j + 1 into the other set; the softmax; O = O alpha + P V. Tile j + 2
  // streams into the raw stage that tile j left. fence_regs before a
  // wgmma.fence keeps the definitions of the wgmma's register operands ahead
  // of it, and after the issue keeps their next uses behind the wait (see
  // csrc/attention.cu)
  cp_async_wait<kF32Stages - 1>();
  __syncthreads();  // tile 0 and the mask words in place
  split_tile(0);
  __syncthreads();  // set 0 in place; raw stage 0 free
  if (kF32Stages < ntiles) load_tile(kF32Stages);
  cp_async_commit();
  for (int j = 0; j < ntiles; ++j) {
    const uint32_t set = sets + (j & 1) * L::kSet;
    // S = Q K^T, a k-step at a time: Q_lo K_hi, Q_hi K_lo, Q_hi K_hi
    fence_regs(s);
    fence_regs(qh);
    fence_regs(ql);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint64_t d_hi = wgmma_desc_interleave(set + kk * L::kKStep);
      const uint64_t d_lo = wgmma_desc_interleave(set + L::kKLo + kk * L::kKStep);
      wgmma_tf32_rs_n64(s, ql[kk], d_hi, kk);
      wgmma_tf32_rs_n64(s, qh[kk], d_lo, 1);
      wgmma_tf32_rs_n64(s, qh[kk], d_hi, 1);
    }
    wgmma_commit();
    fence_regs(s);
    fence_regs(qh);
    fence_regs(ql);
    if (j + 1 < ntiles) {
      cp_async_wait<kF32Stages - 1>();
      __syncthreads();  // tile j + 1 in place
      split_tile(j + 1);
    }
    wgmma_wait<0>();
    fence_regs(s);
    softmax(s, words[2 * j], words[2 * j + 1], t, c, m, mu, l, alpha);

    if constexpr (kPV) {  // O = O alpha + P V, 8 keys a k-step: P's A fragment is S's n-block jj
      uint32_t ph[8][4], pl[8][4];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        split_tf32(s[4 * jj + 0], ph[jj][0], pl[jj][0]);  // row g, key 8jj + 2t (k index t)
        split_tf32(s[4 * jj + 2], ph[jj][1], pl[jj][1]);  // row g + 8, key 8jj + 2t
        split_tf32(s[4 * jj + 1], ph[jj][2], pl[jj][2]);  // row g, key 8jj + 2t + 1 (k index t + 4)
        split_tf32(s[4 * jj + 3], ph[jj][3], pl[jj][3]);  // row g + 8, key 8jj + 2t + 1
      }
      float pv[DH / 2];  // this tile's P V: the accumulator starts from 0 (scale_d = 0)
      fence_regs(pv);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const uint64_t d_hi = wgmma_desc_interleave(set + L::kVHi + jj * L::kVStep);
        const uint64_t d_lo = wgmma_desc_interleave(set + L::kVLo + jj * L::kVStep);
        wgmma_tf32_rs(pv, pl[jj], d_hi, jj);
        wgmma_tf32_rs(pv, ph[jj], d_lo, 1);
        wgmma_tf32_rs(pv, ph[jj], d_hi, 1);
      }
      wgmma_commit();
      fence_regs(pv);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_wait<0>();
      fence_regs(pv);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
    }
    __syncthreads();  // set (j + 1) % 2 in place; every warpgroup is done with set j % 2 and raw stage (j + 1) % 2
    if (j + 1 + kF32Stages < ntiles) load_tile(j + 1 + kF32Stages);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r0 + 8 * r < nq) lse[(size_t)bh * nq + r0 + 8 * r] = all_masked ? kNeg : m[r] * scale + logf(l[r]);
  }
  if constexpr (kPV) {  // o[4n + 2h + e] = O[row g + 8h][8n + 2t + e]
    float* ob = out + (size_t)bh * nq * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (r0 + 8 * r < nq)
          *reinterpret_cast<float2*>(ob + (size_t)(r0 + 8 * r) * DH + 8 * n + 2 * t) =
              make_float2(o[4 * n + 2 * r] / l[r], o[4 * n + 2 * r + 1] / l[r]);
  }
}

// attn_fwd_tf32x3<DH, kPV>'s dynamic shared memory limit raised, once a
// device, and the launch: one block per (128 queries, batch*head)
template <int DH, bool kPV>
cudaError_t launch_tf32x3(const float* q, const float* k, const float* v, const uint8_t* key_mask,
                          const uint8_t* query_mask, float* out, float* lse, int bh, int heads, int nq,
                          int nk, cudaStream_t stream) {
  const int smem = F32Smem<DH, kPV>::bytes(nk);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static uint64_t raised = 0;  // devices whose dynamic shared memory limit is raised
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((raised >> device) & 1u)) {
    err = cudaFuncSetAttribute(attn_fwd_tf32x3<DH, kPV>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    raised |= uint64_t{1} << device;
  }
  const float scale = (float)(1.0 / sqrt((double)DH));
  attn_fwd_tf32x3<DH, kPV><<<dim3((nq + kF32TileQ - 1) / kF32TileQ, bh), kF32Threads, smem, stream>>>(
      q, k, v, key_mask, query_mask, out, lse, heads, nq, nk, scale);
  return cudaGetLastError();
}

}  // namespace
