// Per-key attention mass for Hopper (sm_90a): the EIMP pooling statistic.
//
// Replaces the TPU kernel impx/ops/pallas/attention.py:attention_key_mass
// (:422, pallas_call :440, kernel _mass_kernel :395). For every key, the
// softmax probability q.k / sqrt(dh) over keys, summed over heads and over the
// queries that query_mask keeps: [B, Nk] fp32. The TPU kernel holds all of K
// of one (batch, head) in VMEM, softmaxes a block of queries against every
// key at once and adds the block's column sums into one [Nk] accumulator
// carried across its sequential (head, query-block) grid.
//
// A column sum over queries mixes rows whose softmax each has its own max and
// sum, so it needs every row's statistics before it starts. Here they come
// in: lse [B, H, Nq] fp32, each row's log-sum-exp, as the attention forward
// writes it (csrc/attention.cu, impx_mha_fwd_lse) for the same q, k and key
// mask, so the mass is one pass, p = exp(s / sqrt(dh) - lse). Without an lse
// from the caller, impx_attention_row_lse (this file) writes it first: QK^T and
// an online max and sum, kernel 1's arithmetic without P.V.
//
// Bound on the H100: one exponential a valid (query, key) pair on the
// special-function units (about 0.028 ms at [8, 4, 2048, 64] with 0-300
// padded keypoints), four times the QK^T's tensor-core time; q and k are read
// once.
//
// bf16 mass (key_mass_bf16, dh 16, 32, 64): the product is transposed, S^T =
// K Q^T, keys as wgmma's M and queries as its N. A thread's accumulator then
// holds two keys' scores against 16 of every 64 queries, so the sum over
// queries stays in its registers: carried across query tiles and heads,
// reduced over the four threads of a row once at the end, with no shuffle a
// tile. One CTA per (128 keys, split, batch), 544 threads: a producer warp
// streams 256-query tiles of Q (K-major, as they lie in memory) through a TMA
// ring, with each query's lse in base 2 (+inf for a query that weighs 0, so
// its p is 0; no select a score), loaded a tile ahead; four consumer
// warpgroups in two pairs that take alternate tiles, each warpgroup 64 keys
// whose K rows of a head are the wgmma's A in registers (loaded once a head).
// Each pair sums its tiles in its registers, and pair 1's sum is added to
// pair 0's at the end. p = 2^(s c - lse log2 e), c = log2(e) / sqrt(dh), one
// FFMA and one ex2 a score. One pair of warpgroups runs slower
// (impx_torch/tools/mass_phases.py).
// A tile with no kept query and a key block with no valid key are skipped;
// masked keys are written as 0 (the reference's exp(-1e30 - lse)). Heads and
// query tiles run in a fixed order, and with `splits` > 1 (the small key counts
// of compacted EIMP, where B * Nk / 128 CTAs leave SMs idle) each split takes a
// contiguous range of the (head, query tile) items into its own partial row,
// summed in split order by a second launch. No atomics: the same inputs give
// the same bits on every run, which pooling needs, since it compares each
// mass with a median.
//
// The batch with no valid key: the reference scores every key -1e30, so each
// kept query spreads 1/Nk over all Nk keys; the attention forward writes lse =
// -1e30 there, which would give exp(0) = 1 a key. The kernel detects the batch
// from the key mask and writes H * (kept queries) / Nk to every key instead.
//
// fp32 (key_mass_tf32x3, dh 16, 32, 64): the same pass on the fp32
// forward's skeleton (csrc/attention_tf32.cuh), S^T = K Q^T in 3xTF32 on
// wgmma m64n64k8 .tf32. One CTA per (128 keys, split, batch), two warpgroups
// of 64 keys whose K fragments, hi and lo, load once a head into registers as
// wgmma's A; 64-query Q tiles of the kept items stream raw through a cp.async
// ring of kF32Stages, each stage with its queries' lse in base 2 (+inf where
// a query weighs 0, fetched into registers an item ahead), and a pass once a
// CTA an item splits the tile into Q^T's hi and lo k-step blocks (wgmma's B),
// item n + 1's split running while item n's products are in flight.
// The accumulator's layout is the bf16 kernel's (two keys, 16 of every 64
// queries), so the sums over queries are the same column_sums, in the same
// order, and the same splits. The standalone route's row lse is the fp32
// forward without P.V (attn_fwd_tf32x3<DH, false>).
//
// Layout: q [BH, Nq, dh], k [BH, Nk, dh] contiguous; key_mask [B, Nk] and
// query_mask [B, Nq] one byte an entry (bool, nonzero kept) or null for all
// ones; lse [BH, Nq] fp32; partial [splits, B, Nk] fp32 when splits > 1; out
// [B, Nk] fp32. Semantics of the TPU kernel: scale by 1/sqrt(dh) before
// masking; masked keys score the finite -1e30; query rows past Nq weigh 0.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tf32.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + the producer warp
// bf16 mass: keys a CTA (a pair of warpgroups of 64 keys), pairs that take
// turns at the tiles, queries a ring stage, stages
constexpr int kMassKeys = 128;
constexpr int kMassPairs = 2;
constexpr int kMassConsumerWarps = 8 * kMassPairs;
constexpr int kMassThreads = 32 * (kMassConsumerWarps + 1);
constexpr int kMassQ = 256;  // the largest TMA box: fewer ring handshakes a query
constexpr int kMassStages = 4;
// bf16 row lse, kernel 1's shape: queries a block, keys a tile, stages
constexpr int kLseQ = 128;
constexpr int kLseK = 64;
constexpr int kLseStages = 4;
// fp32 mass: keys a CTA (two warpgroups of 64), queries a ring stage
constexpr int kF32MassKeys = 128;
constexpr int kF32MassQ = 64;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ bool kept(const uint8_t* mask_row, int i) {
  return mask_row == nullptr || mask_row[i] != 0;
}

// What a mass CTA knows of its batch before it starts: whether no key of the
// batch is valid, whether any of its own keys [key0, key0 + nkeys) is, and,
// for a batch with no valid key, how many queries it keeps. Every thread of
// the block calls it; its barriers also publish what the block wrote before.
struct BatchView {
  bool all_masked, block_any;
  int kept_queries;
};

__device__ BatchView batch_view(const uint8_t* kmask, const uint8_t* qmask, int key0, int nkeys,
                                int nq, int nk) {
  int any = kmask == nullptr, here = kmask == nullptr;
  if (kmask != nullptr) {
    for (int key = threadIdx.x; key < nk; key += blockDim.x)
      if (kmask[key]) {
        any = 1;
        here |= key >= key0 && key < key0 + nkeys;
      }
  }
  BatchView v;
  v.all_masked = !__syncthreads_or(any);
  v.block_any = __syncthreads_or(here) != 0;
  v.kept_queries = 0;
  if (v.all_masked) {
    for (int q0 = 0; q0 < nq; q0 += blockDim.x) {
      const int q = q0 + threadIdx.x;
      v.kept_queries += __syncthreads_count(q < nq && kept(qmask, q));
    }
  }
  return v;
}

// One key's result from a CTA: its sum, 0 at a masked key, or in a batch with
// no valid key the reference's 1/Nk for every kept query and head, all of it
// in split 0's row
__device__ __forceinline__ float key_result(float sum, const BatchView& v, const uint8_t* kmask,
                                            int key, int split, int heads, int nk) {
  if (v.all_masked) return split == 0 ? (float)heads * (float)v.kept_queries / (float)nk : 0.f;
  return kept(kmask, key) ? sum : 0.f;
}

// the first (head, query tile) item of `split`: splits take contiguous ranges
__device__ __forceinline__ int split_begin(int items, int split, int splits) {
  return (int)((long long)split * items / splits);
}

// ----------------------------------------------------------- bf16 mass, wgmma
// Dynamic shared memory, from a 1024-byte aligned base: the Q stages, each
// stage's lse in base 2, the key sums of pairs 1.., a flag a query tile, mbarriers
template <int DH>
struct MassSmem {
  static constexpr int kRow = 2 * DH;  // bytes of a row: the swizzle span
  static constexpr int kQBuf = kMassQ * kRow;
  static constexpr int kLse = kMassStages * kQBuf;
  static constexpr int kPair = kLse + kMassStages * kMassQ * 4;
  static constexpr int kFlags = kPair + (kMassPairs - 1) * kMassKeys * 4;
  static constexpr int kBars = 2 * kMassStages;
  static __host__ __device__ int bars(int ntq) { return kFlags + ((ntq + 7) & ~7); }
  static int bytes(int ntq) { return 1024 + bars(ntq) + 8 * kBars; }
};

// This thread's two keys (rows g, g + 8 of the warp's 16) summed over the 64
// queries of one m64n64 accumulator, 16 of them its own: s[4j + 2h + e] is key
// g + 8h against query 8j + 2t + e; lse2 the tile's lse in base 2
__device__ __forceinline__ void column_sums(const float (&s)[32], const float* lse2, int t, float c,
                                            float (&part)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
    part[0] += ex2(fmaf(s[4 * j + 0], c, -l.x));
    part[0] += ex2(fmaf(s[4 * j + 1], c, -l.y));
    part[1] += ex2(fmaf(s[4 * j + 2], c, -l.x));
    part[1] += ex2(fmaf(s[4 * j + 3], c, -l.y));
  }
}

template <int DH>
__global__ void __launch_bounds__(kMassThreads, 1)
key_mass_bf16(const __grid_constant__ CUtensorMap tq, const __nv_bfloat16* __restrict__ k,
              const uint8_t* __restrict__ key_mask, const uint8_t* __restrict__ query_mask,
              const float* __restrict__ lse, float* __restrict__ out, int heads, int nq, int nk,
              float c) {
  using L = MassSmem<DH>;
  constexpr uint64_t kSwizzle = DH == 64 ? 1 : (DH == 32 ? 2 : 3);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int ntq = (nq + kMassQ - 1) / kMassQ;
  float* lse_s = reinterpret_cast<float*>(sm + L::kLse);  // [kMassStages][kMassQ]
  uint8_t* flags = sm + L::kFlags;                         // [ntq]: the tile keeps a query
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::bars(ntq));  // [kMassStages]: Q tile, lse in place
  uint64_t* empty = full + kMassStages;  // [kMassStages]: the tile's pair is done with them

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int key0 = blockIdx.x * kMassKeys, split = blockIdx.y, splits = gridDim.y, b = blockIdx.z;
  const uint8_t* kmask = key_mask == nullptr ? nullptr : key_mask + (size_t)b * nk;
  const uint8_t* qmask = query_mask == nullptr ? nullptr : query_mask + (size_t)b * nq;
  float* orow = out + ((size_t)split * gridDim.z + b) * nk;

  if (tid == 0) {
    for (int st = 0; st < kMassStages; ++st) {
      mbar_init(&full[st], 1);   // lane 0 of the producer, after the warp's lse stores
      mbar_init(&empty[st], 8);   // the warps of the pair that takes the tile
    }
    fence_mbar_init();
  }
  for (int t = warp; t < ntq; t += kMassConsumerWarps + 1) {  // a warp a query tile
    int any = 0;
    for (int i = lane; i < kMassQ; i += 32) any |= t * kMassQ + i < nq && kept(qmask, t * kMassQ + i);
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) flags[t] = (uint8_t)any;
  }
  const BatchView view = batch_view(kmask, qmask, key0, kMassKeys, nq, nk);
  if (view.all_masked || !view.block_any) {  // every key's result is known
    if (tid < kMassKeys && key0 + tid < nk)
      orow[key0 + tid] = key_result(0.f, view, kmask, key0 + tid, split, heads, nk);
    return;
  }
  const int items = heads * ntq;
  const int i0 = split_begin(items, split, splits), i1 = split_begin(items, split + 1, splits);
  // the first kept item at or after i
  auto next_kept = [&](int i) {
    while (i < i1 && !flags[i % ntq]) ++i;
    return i;
  };

  if (warp == kMassConsumerWarps) {  // producer: each kept tile's Q and lse
    constexpr int kPer = kMassQ / 32;  // queries a lane of a tile
    // the next kept item's lse and weights, loaded while the ring is full:
    // their latency hides behind the wait for a free stage
    float lv[kPer];
    bool wv[kPer];
    auto fetch = [&](int i) {
      if (i >= i1) return;
      const size_t row = (size_t)(b * heads + i / ntq) * nq;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int q = (i % ntq) * kMassQ + lane + 32 * r;
        wv[r] = q < nq && kept(qmask, q);
        lv[r] = q < nq ? lse[row + q] : 0.f;
      }
    };
    int i = next_kept(i0);
    fetch(i);
    for (int n = 0; i < i1; ++n) {
      const int st = n % kMassStages;
      if (n >= kMassStages) mbar_wait(&empty[st], ((n / kMassStages) - 1) & 1);
      // each query's lse in base 2, +inf where it weighs 0: 2^(s c - inf) = 0
#pragma unroll
      for (int r = 0; r < kPer; ++r) lse_s[st * kMassQ + lane + 32 * r] = wv[r] ? lv[r] * kLog2e : INFINITY;
      __syncwarp();  // the lanes' stores before lane 0's arrival, which releases them
      if (lane == 0) {  // one arrival a tile, which also expects the tile's bytes
        mbar_expect_tx(&full[st], L::kQBuf);
        tma_load_3d(sm + st * L::kQBuf, &tq, &full[st], 0, (i % ntq) * kMassQ, b * heads + i / ntq);
      }
      i = next_kept(i + 1);
      fetch(i);
    }
    return;
  }

  // consumers: pair `pair` takes the kept items n = pair, pair + kMassPairs, ...; its
  // warpgroup wg owns keys key0 + 64 wg .. + 63, this thread keys r0 and r0 +
  // 8. A head's K rows of a warp are the wgmma's A from registers; an item's
  // S^T is one wgmma group for each 64 queries of the tile, in turn, each
  // summed when it is done, while the other pair's warps fill the waits.
  const int pair = warp >> 3, wg = (warp >> 2) & 1, g = lane >> 2, t4 = lane & 3;
  const int r0 = key0 + wg * 64 + (warp & 3) * 16 + g;
  float acc[2] = {0.f, 0.f};
  float s[32];
  uint32_t ka[DH / 16][4];
  auto load_k = [&](int h) {  // rows past nk as zeros
    const __nv_bfloat16* kb = k + (size_t)(b * heads + h) * nk * DH;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int col = 16 * kk + 2 * t4;
      ka[kk][0] = r0 < nk ? ld_u32(kb + (size_t)r0 * DH + col) : 0u;
      ka[kk][1] = r0 + 8 < nk ? ld_u32(kb + (size_t)(r0 + 8) * DH + col) : 0u;
      ka[kk][2] = r0 < nk ? ld_u32(kb + (size_t)r0 * DH + col + 8) : 0u;
      ka[kk][3] = r0 + 8 < nk ? ld_u32(kb + (size_t)(r0 + 8) * DH + col + 8) : 0u;
    }
  };
  auto issue = [&](int n, int group) {  // S^T of the tile's queries 64 group .. + 63
    const uint64_t dq = wgmma_desc(smem_addr(sm + (n % kMassStages) * L::kQBuf) + group * 64 * L::kRow,
                                   16 * DH, kSwizzle);
    fence_regs(s);
    fence_regs(ka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_rs_kmajor_n64(s, ka[kk], dq + 2 * kk, kk);  // +32 B a k-step
    wgmma_commit();
    fence_regs(s);
    fence_regs(ka);
  };
  int i = next_kept(i0);
  for (int p = 0; p < pair && i < i1; ++p) i = next_kept(i + 1);
  int head = -1;
  for (int n = pair; i < i1; n += kMassPairs) {
    const int st = n % kMassStages;
    if (i / ntq != head) {
      head = i / ntq;
      load_k(head);
    }
    mbar_wait(&full[st], (n / kMassStages) & 1);
    const float* lse2 = lse_s + st * kMassQ;
    float part[2] = {0.f, 0.f};
#pragma unroll 1
    for (int group = 0; group < kMassQ / 64; ++group) {
      issue(n, group);
      wgmma_wait<0>();
      fence_regs(s);
      column_sums(s, lse2 + 64 * group, t4, c, part);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // every group that read the tile is done
    acc[0] += part[0];
    acc[1] += part[1];
    for (int p = 0; p < kMassPairs && i < i1; ++p) i = next_kept(i + 1);  // the pair's next item
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the four threads of a key, in a fixed order
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
  }
  // pair 0's sum + pair 1's + ..., through shared memory (named barrier 1:
  // the consumer warps; the producer warp has returned)
  float* pair_sum = reinterpret_cast<float*>(sm + L::kPair);  // [kMassPairs - 1][kMassKeys]
  if (pair > 0 && t4 == 0) {
    pair_sum[(pair - 1) * kMassKeys + r0 - key0] = acc[0];
    pair_sum[(pair - 1) * kMassKeys + r0 + 8 - key0] = acc[1];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kMassConsumerWarps) : "memory");
  if (pair == 0 && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = r0 + 8 * r;
      float sum = acc[r];
      for (int p = 1; p < kMassPairs; ++p) sum += pair_sum[(p - 1) * kMassKeys + key - key0];
      if (key < nk) orow[key] = key_result(sum, view, kmask, key, split, heads, nk);
    }
  }
}

// ------------------------------------------------------- bf16 row lse, wgmma
template <int DH>
struct LseSmem {
  static constexpr int kRow = 2 * DH;
  static constexpr int kQ = kLseQ * kRow;
  static constexpr int kKT = kLseK * kRow;
  static constexpr int kK = kQ;
  static constexpr int kWords = kK + kLseStages * kKT;
  static constexpr int kBars = 1 + 2 * kLseStages;
  static int bytes(int ntiles) { return 1024 + kWords + 8 * ntiles + 8 * kBars; }
};

// lse [BH, Nq] of kernel 4 without its output: one block per (128 queries,
// batch*head), a producer warp streaming 64-key K tiles through a TMA ring,
// two consumer warpgroups of 64 rows; lse = -1e30 exactly on a batch with no
// valid key. A block whose queries all weigh 0 writes nothing: the mass reads
// no lse of such a query.
template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
key_mass_row_lse_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const uint8_t* __restrict__ key_mask, const uint8_t* __restrict__ query_mask,
                      float* __restrict__ lse, int heads, int nq, int nk, float scale) {
  using L = LseSmem<DH>;
  constexpr uint64_t kSwizzle = DH == 64 ? 1 : (DH == 32 ? 2 : 3);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int ntiles = (nk + kLseK - 1) / kLseK;
  uint32_t* words = reinterpret_cast<uint32_t*>(sm + L::kWords);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kWords + 8 * ntiles);
  uint64_t* full = q_full + 1;       // [kLseStages]: the K tile has arrived
  uint64_t* empty = full + kLseStages;  // [kLseStages]: every consumer warp is done with it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / heads, q0 = blockIdx.x * kLseQ;
  const uint8_t* qmask = query_mask == nullptr ? nullptr : query_mask + (size_t)b * nq;
  if (!__syncthreads_or(tid < kLseQ && q0 + tid < nq && kept(qmask, q0 + tid))) return;
  const bool producer = tid == kConsumerWarps * 32;
  auto load_k = [&](int j) {
    const int st = j % kLseStages;
    mbar_expect_tx(&full[st], L::kKT);
    tma_load_3d(sm + L::kK + st * L::kKT, &tk, &full[st], 0, j * kLseK, bh);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kLseStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (producer) {  // the first copies fly while the block reads the mask
    mbar_expect_tx(q_full, L::kQ);
    tma_load_3d(sm, &tq, q_full, 0, q0, bh);
    for (int j = 0; j < kLseStages && j < ntiles; ++j) load_k(j);
  }

  // the batch's key mask as bits, one warp a 32-key word
  const uint8_t* kmask = key_mask == nullptr ? nullptr : key_mask + (size_t)b * nk;
  int any = 0;
  for (int w = warp; w < 2 * ntiles; w += kConsumerWarps + 1) {
    const int key = w * 32 + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, key < nk && kept(kmask, key));
    if (lane == 0) words[w] = bits;
    any |= bits != 0u;
  }
  // no valid key in the batch: every key in range weighs alike, so all of
  // them count with scores scaled by 0, and lse is written as -1e30
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
      for (int j = kLseStages; j < ntiles; ++j) {
        mbar_wait(&empty[j % kLseStages], ((j / kLseStages) - 1) & 1);
        load_k(j);
      }
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const float c = all_masked ? 0.f : scale * kLog2e;
  const uint64_t dq = wgmma_desc(smem_addr(sm + wg * 64 * L::kRow), 16 * DH, kSwizzle);
  const uint32_t k_base = smem_addr(sm + L::kK);
  float m[2] = {-INFINITY, -INFINITY}, mu[2] = {0.f, 0.f}, l[2] = {0.f, 0.f}, alpha[2];
  float s[32];
  mbar_wait(q_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kLseStages;
    mbar_wait(&full[st], (j / kLseStages) & 1);
    const uint64_t dk = wgmma_desc(k_base + st * L::kKT, 16 * DH, kSwizzle);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < DH / 16; ++k) wgmma_ss_n64(s, dq + 2 * k, dk + 2 * k, k);
    wgmma_commit();
    fence_regs(s);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&empty[st]);  // the tile is read
    softmax(s, words[2 * j], words[2 * j + 1], t, c, m, mu, l, alpha);  // kernel 1's, P unused
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + g;
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r0 + 8 * r < nq)
        lse[(size_t)bh * nq + r0 + 8 * r] = all_masked ? kNeg : m[r] * scale + logf(l[r]);
  }
}

// ------------------------------------------------------------ fp32, 3xTF32
template <int DH>
struct F32MassSmem {
  static constexpr int kQLd = DH + 4;  // floats a raw Q row: the split pass's 16-byte reads on distinct banks
  static constexpr int kQ = kF32MassQ * kQLd * 4;
  static constexpr int kStage = kQ + kF32MassQ * 4;  // the raw tile, its lse in base 2
  static constexpr int kStep = kF32MassQ * 32;        // a [64 queries x 8 dims] k-step block, interleaved
  static constexpr int kBlocks = kF32Stages * kStage;  // split set s at kBlocks + s * kSet
  static constexpr int kLo = DH / 8 * kStep;           // offsets inside a set: Q^T's hi, lo, the lse
  static constexpr int kLse = 2 * kLo;
  static constexpr int kSet = kLse + kF32MassQ * 4;
  static constexpr int kFlags = kBlocks + 2 * kSet;
  static int bytes(int ntq) { return kFlags + ntq; }
};

// the mass from lse: one CTA per (128 keys, split, batch), two warpgroups of
// 64 keys; both take every kept item of the split, their keys against the
// item's 64 queries
template <int DH>
__global__ void __launch_bounds__(kF32Threads, 1)
key_mass_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                const uint8_t* __restrict__ key_mask, const uint8_t* __restrict__ query_mask,
                const float* __restrict__ lse, float* __restrict__ out, int heads, int nq, int nk,
                float c) {
  using L = F32MassSmem<DH>;
  constexpr int kChunks = DH / 4;  // 16-byte chunks a row
  constexpr int kSteps = DH / 8;
  extern __shared__ __align__(16) uint8_t smem_mass[];
  const int ntq = (nq + kF32MassQ - 1) / kF32MassQ;
  uint8_t* flags = smem_mass + L::kFlags;  // [ntq]: the tile keeps a query

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int key0 = blockIdx.x * kF32MassKeys, split = blockIdx.y, splits = gridDim.y, b = blockIdx.z;
  const uint8_t* kmask = key_mask == nullptr ? nullptr : key_mask + (size_t)b * nk;
  const uint8_t* qmask = query_mask == nullptr ? nullptr : query_mask + (size_t)b * nq;
  float* orow = out + ((size_t)split * gridDim.z + b) * nk;

  for (int tq = warp; tq < ntq; tq += kF32Warps) {  // a warp a query tile
    int any = 0;
    for (int i = lane; i < kF32MassQ; i += 32) any |= tq * kF32MassQ + i < nq && kept(qmask, tq * kF32MassQ + i);
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) flags[tq] = (uint8_t)any;
  }
  const BatchView view = batch_view(kmask, qmask, key0, kF32MassKeys, nq, nk);
  if (view.all_masked || !view.block_any) {  // every key's result is known
    if (tid < kF32MassKeys && key0 + tid < nk)
      orow[key0 + tid] = key_result(0.f, view, kmask, key0 + tid, split, heads, nk);
    return;
  }
  const int items = heads * ntq;
  const int i0 = split_begin(items, split, splits), i1 = split_begin(items, split + 1, splits);
  auto next_kept = [&](int i) {  // the first kept item at or after i
    while (i < i1 && !flags[i % ntq]) ++i;
    return i;
  };
  // an item's lse and weight for thread tid < 64, fetched an item before its
  // stage is written, so the loads' latency hides behind a tile's products
  float lv = 0.f;
  bool wv = false;
  auto fetch = [&](int i) {
    if (tid >= kF32MassQ || i >= i1) return;
    const int qq = (i % ntq) * kF32MassQ + tid;
    wv = qq < nq && kept(qmask, qq);
    lv = qq < nq ? lse[(size_t)(b * heads + i / ntq) * nq + qq] : 0.f;
  };
  // the kept items in order: `issue` the next to load, the n-th into raw stage n % kF32Stages
  int issue = next_kept(i0), issued = 0;
  fetch(issue);
  auto load_next = [&]() {  // rows past nq as zeros
    if (issue < i1) {
      uint8_t* st = smem_mass + (issued % kF32Stages) * L::kStage;
      const float* qb = q + (size_t)(b * heads + issue / ntq) * nq * DH;
      const int r0 = (issue % ntq) * kF32MassQ;
      for (int ch = tid; ch < kF32MassQ * kChunks; ch += kF32Threads) {
        const int row = ch / kChunks, col = (ch % kChunks) * 4;
        const bool in = r0 + row < nq;
        cp_async_16(st + (row * L::kQLd + col) * 4, qb + (size_t)(in ? r0 + row : 0) * DH + col, in);
      }
      // each query's lse in base 2, +inf where it weighs 0: 2^(s c - inf) = 0
      if (tid < kF32MassQ) reinterpret_cast<float*>(st + L::kQ)[tid] = wv ? lv * kLog2e : INFINITY;
      issue = next_kept(issue + 1);
      ++issued;
      fetch(issue);
    }
    cp_async_commit();
  };
  // the n-th item's landed tile as Q^T's hi and lo k-step blocks and its lse,
  // in split set n % 2, once a block: a warp takes 32 queries' 16 bytes of
  // one k-step half (reads of 8 rows 4 banks apart, writes of 512 bytes)
  auto split_item = [&](int n) {
    const uint8_t* st = smem_mass + (n % kF32Stages) * L::kStage;
    const float* raw = reinterpret_cast<const float*>(st);
    uint8_t* set = smem_mass + L::kBlocks + (n & 1) * L::kSet;
    for (int ch = tid; ch < kF32MassQ * kChunks; ch += kF32Threads) {
      const int qq = ch % kF32MassQ, half = (ch / kF32MassQ) & 1, kk = ch / (2 * kF32MassQ);
      const float4 x = *reinterpret_cast<const float4*>(raw + qq * L::kQLd + 8 * kk + 4 * half);
      uint4 hi, lo;
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      const uint32_t off = kk * L::kStep + interleave_offset(qq, half);
      *reinterpret_cast<uint4*>(set + off) = hi;
      *reinterpret_cast<uint4*>(set + L::kLo + off) = lo;
    }
    if (tid < kF32MassQ)
      reinterpret_cast<float*>(set + L::kLse)[tid] = reinterpret_cast<const float*>(st + L::kQ)[tid];
    fence_proxy_async();
  };

  // this thread's keys r0, r0 + 8 (warpgroup wg's 64, its warp's 16) as
  // wgmma's A fragment, hi and lo, a head's at a time
  const int wg = warp >> 2;
  const int r0 = key0 + 64 * wg + 16 * (warp & 3) + g;
  uint32_t kh[kSteps][4], kl[kSteps][4];
  auto load_k = [&](int h) {  // rows past nk as zeros
    const float* kb = k + (size_t)(b * heads + h) * nk * DH;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int d = 8 * kk + t4;
      split_tf32(r0 < nk ? kb[(size_t)r0 * DH + d] : 0.f, kh[kk][0], kl[kk][0]);
      split_tf32(r0 + 8 < nk ? kb[(size_t)(r0 + 8) * DH + d] : 0.f, kh[kk][1], kl[kk][1]);
      split_tf32(r0 < nk ? kb[(size_t)r0 * DH + d + 4] : 0.f, kh[kk][2], kl[kk][2]);
      split_tf32(r0 + 8 < nk ? kb[(size_t)(r0 + 8) * DH + d + 4] : 0.f, kh[kk][3], kl[kk][3]);
    }
  };
  const uint32_t sets = smem_addr(smem_mass + L::kBlocks);

  // Item n: S^T = K Q^T from split set n % 2, in flight while the block
  // splits item n + 1 into the other set; the sums. Item n + 3 streams into
  // the raw stage that item n + 1 left.
#pragma unroll
  for (int n = 0; n < kF32Stages; ++n) load_next();
  float acc[2] = {0.f, 0.f};
  float s[32];
  int head = -1;
  int i = next_kept(i0);
  if (i < i1) {
    cp_async_wait<kF32Stages - 1>();
    __syncthreads();  // item 0 in place
    split_item(0);
    __syncthreads();  // set 0 in place; raw stage 0 free
    load_next();
  }
  for (int n = 0; i < i1; ++n) {
    const int i_next = next_kept(i + 1);
    if (i / ntq != head) {
      head = i / ntq;
      load_k(head);
    }
    const uint32_t set = sets + (n & 1) * L::kSet;
    // S^T = K Q^T, a k-step at a time: K_lo Q_hi, K_hi Q_lo, K_hi Q_hi
    fence_regs(s);
    fence_regs(kh);
    fence_regs(kl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint64_t d_hi = wgmma_desc_interleave(set + kk * L::kStep);
      const uint64_t d_lo = wgmma_desc_interleave(set + L::kLo + kk * L::kStep);
      wgmma_tf32_rs_n64(s, kl[kk], d_hi, kk);
      wgmma_tf32_rs_n64(s, kh[kk], d_lo, 1);
      wgmma_tf32_rs_n64(s, kh[kk], d_hi, 1);
    }
    wgmma_commit();
    fence_regs(s);
    fence_regs(kh);
    fence_regs(kl);
    if (i_next < i1) {
      cp_async_wait<kF32Stages - 1>();
      __syncthreads();  // item n + 1 in place
      split_item(n + 1);
    }
    wgmma_wait<0>();
    fence_regs(s);
    float part[2] = {0.f, 0.f};
    column_sums(s, reinterpret_cast<const float*>(smem_mass + L::kBlocks + (n & 1) * L::kSet + L::kLse), t4,
                c, part);
    acc[0] += part[0];
    acc[1] += part[1];
    __syncthreads();  // set (n + 1) % 2 in place; every warpgroup is done with set n % 2 and raw stage (n + 1) % 2
    load_next();
    i = i_next;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the four threads of a key, in a fixed order
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
  }
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = r0 + 8 * r;
      if (key < nk) orow[key] = key_result(acc[r], view, kmask, key, split, heads, nk);
    }
  }
}

// out[i] = the sum of partial[:, i], splits in order
__global__ void __launch_bounds__(kReduceThreads)
key_mass_reduce(const float* __restrict__ partial, float* __restrict__ out, int splits, int n) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n) return;
  float acc = partial[i];
  for (int s = 1; s < splits; ++s) acc += partial[(size_t)s * n + i];
  out[i] = acc;
}

// -------------------------------------------------------------------- launch
// a kernel's dynamic shared memory limit raised to kMaxSmem, once a device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, uint64_t& raised) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device >= 64 || ((raised >> device) & 1u)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) raised |= uint64_t{1} << device;
  return err;
}

float inv_sqrt(int dh) { return (float)(1.0 / sqrt((double)dh)); }

template <int DH>
cudaError_t row_lse(const void* q, const void* k, const uint8_t* km, const uint8_t* qm, float* lse,
                    int bh, int heads, int nq, int nk, int is_bf16, cudaStream_t stream) {
  const float scale = inv_sqrt(DH);
  if (!is_bf16)
    return launch_tf32x3<DH, false>(static_cast<const float*>(q), static_cast<const float*>(k), nullptr, km,
                                    qm, nullptr, lse, bh, heads, nq, nk, stream);
  CUtensorMap tq, tk;
  if (!encode<DH>(&tq, q, bh, nq, kLseQ) || !encode<DH>(&tk, k, bh, nk, kLseK)) return cudaErrorInvalidValue;
  const int smem = LseSmem<DH>::bytes((nk + kLseK - 1) / kLseK);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static uint64_t raised = 0;
  const cudaError_t err = allow_smem(key_mass_row_lse_bf16<DH>, raised);
  if (err != cudaSuccess) return err;
  key_mass_row_lse_bf16<DH><<<dim3((nq + kLseQ - 1) / kLseQ, bh), kThreads, smem, stream>>>(
      tq, tk, km, qm, lse, heads, nq, nk, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t mass(const void* q, const void* k, const uint8_t* km, const uint8_t* qm, const float* lse,
                 float* partial, float* out, int bh, int heads, int nq, int nk, int is_bf16,
                 int splits, cudaStream_t stream) {
  const float scale = inv_sqrt(DH);
  const int b = bh / heads;
  float* dst = splits > 1 ? partial : out;
  if (is_bf16) {
    CUtensorMap tq;
    if (!encode<DH>(&tq, q, bh, nq, kMassQ)) return cudaErrorInvalidValue;
    const int smem = MassSmem<DH>::bytes((nq + kMassQ - 1) / kMassQ);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    static uint64_t raised = 0;
    const cudaError_t err = allow_smem(key_mass_bf16<DH>, raised);
    if (err != cudaSuccess) return err;
    key_mass_bf16<DH><<<dim3((nk + kMassKeys - 1) / kMassKeys, splits, b), kMassThreads, smem, stream>>>(
        tq, static_cast<const __nv_bfloat16*>(k), km, qm, lse, dst, heads, nq, nk, scale * kLog2e);
  } else {
    const int smem = F32MassSmem<DH>::bytes((nq + kF32MassQ - 1) / kF32MassQ);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    static uint64_t raised = 0;
    const cudaError_t err = allow_smem(key_mass_tf32x3<DH>, raised);
    if (err != cudaSuccess) return err;
    key_mass_tf32x3<DH><<<dim3((nk + kF32MassKeys - 1) / kF32MassKeys, splits, b), kF32Threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), km, qm, lse, dst, heads, nq, nk,
        scale * kLog2e);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int n = b * nk;
  key_mass_reduce<<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, stream>>>(
      partial, out, splits, n);
  return cudaGetLastError();
}

bool valid_sizes(int bh, int heads, int nq, int nk) {
  return nq >= 1 && nk >= 1 && heads >= 1 && bh >= heads && bh % heads == 0 && bh <= 65535;
}

}  // namespace

// Each row's log-sum-exp, lse [BH, Nq] fp32 (what impx_mha_fwd_lse writes,
// without the attention output), for a caller that has none
extern "C" int impx_attention_row_lse(const void* q, const void* k, const void* key_mask,
                                      const void* query_mask, void* lse, int bh, int heads,
                                      int nq, int nk, int dh, int is_bf16, void* stream) {
  const uint8_t* km = static_cast<const uint8_t*>(key_mask);
  const uint8_t* qm = static_cast<const uint8_t*>(query_mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid_sizes(bh, heads, nq, nk) || l == nullptr) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return (int)row_lse<16>(q, k, km, qm, l, bh, heads, nq, nk, is_bf16, st);
    case 32: return (int)row_lse<32>(q, k, km, qm, l, bh, heads, nq, nk, is_bf16, st);
    case 64: return (int)row_lse<64>(q, k, km, qm, l, bh, heads, nq, nk, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The mass [B, Nk] from lse [BH, Nq]: one launch, and a second that sums the
// splits' partial rows [splits, B, Nk] when splits > 1
extern "C" int impx_attention_key_mass(const void* q, const void* k, const void* key_mask,
                                       const void* query_mask, const void* lse, void* partial,
                                       void* out, int bh, int heads, int nq, int nk, int dh,
                                       int is_bf16, int splits, void* stream) {
  const uint8_t* km = static_cast<const uint8_t*>(key_mask);
  const uint8_t* qm = static_cast<const uint8_t*>(query_mask);
  const float* l = static_cast<const float*>(lse);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid_sizes(bh, heads, nq, nk) || l == nullptr || splits < 1 || splits > 65535 ||
      (splits > 1 && p == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return (int)mass<16>(q, k, km, qm, l, p, o, bh, heads, nq, nk, is_bf16, splits, st);
    case 32: return (int)mass<32>(q, k, km, qm, l, p, o, bh, heads, nq, nk, is_bf16, splits, st);
    case 64: return (int)mass<64>(q, k, km, qm, l, p, o, bh, heads, nq, nk, is_bf16, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one fp32 block at head dim dh: the mass kernel's
// at nq = n queries, or (row_lse) the standalone row lse's at nk = n keys (-1
// for an unsupported dh)
extern "C" int impx_attention_mass_f32_smem_bytes(int dh, int n, int row_lse) {
  const int ntq = (n + kF32MassQ - 1) / kF32MassQ;
  switch (dh) {
    case 16: return row_lse ? F32Smem<16, false>::bytes(n) : F32MassSmem<16>::bytes(ntq);
    case 32: return row_lse ? F32Smem<32, false>::bytes(n) : F32MassSmem<32>::bytes(ntq);
    case 64: return row_lse ? F32Smem<64, false>::bytes(n) : F32MassSmem<64>::bytes(ntq);
    default: return -1;
  }
}

// The default split: as many CTAs as the card has SMs, at least one
// (head, query tile) item a split
extern "C" int impx_attention_key_mass_splits(int b, int heads, int nq, int nk, int is_bf16, int sms) {
  const int keys = is_bf16 ? kMassKeys : kF32MassKeys, tile = is_bf16 ? kMassQ : kF32MassQ;
  const long long ctas = (long long)b * ((nk + keys - 1) / keys);
  const long long items = (long long)heads * ((nq + tile - 1) / tile);
  long long splits = ctas >= sms ? 1 : sms / ctas;
  if (splits > items) splits = items;
  return (int)(splits < 1 ? 1 : splits);
}
