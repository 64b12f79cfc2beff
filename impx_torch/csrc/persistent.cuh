// Persistent kernels on Hopper (sm_90a): the pieces that the two Sinkhorn
// heads (sinkhorn.cu, log_sinkhorn.cu) share.
//
// Both heads run as one cooperative launch whose CTAs all sit on the card at
// once. The B * (N+1) dustbin-padded rows of the plan (or Z) go to the CTAs
// in contiguous, fixed blocks; each CTA keeps the first `cap` rows of its
// block in shared memory, in the storage dtype, across every iteration, and
// the rest ("overflow") in a device-memory buffer that the iterations re-read
// from L2. Column sums cross CTAs through a workspace of per-CTA partials
// and a grid barrier; nothing is summed with atomics, so a call gives the same
// bits every time on one card.
//
// The schedule (`Sched`), as the host query and every CTA compute it:
//   * B <= CTAs the card holds: each pair gets per_pair = min(CTAs / B, N+1)
//     CTAs, and CTA g takes rows [k (N+1) / per_pair, (k+1) (N+1) / per_pair)
//     of pair g / per_pair (k = g % per_pair);
//   * B > CTAs: each CTA takes pairs_per_cta = ceil(B / CTAs) whole pairs.
// Either way a CTA owns a contiguous range of the flattened rows. Slot p *
// per_pair + k holds the column partials of CTA part k of pair p, and the
// same CTA reduces column slice k of pair p over that pair's slots, in slot
// order.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;          // a CTA: 16 warps, one CTA an SM
constexpr int kWarps = kThreads / 32;
constexpr int kScratch = 64;           // floats of reduction scratch

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The layout of a row in shared memory and in the overflow buffer (stride
// elements, half = stride / 2): lane or thread o reads octet o (columns 8o ..
// 8o+7) as 16-byte pieces that neighbouring lanes take from neighbouring
// addresses, so that no two lanes of a warp meet in a bank. A bf16 row is in
// column order (an octet is 16 bytes); an fp32 row is two planes of quads,
// columns 8o .. 8o+3 at 4o and 8o+4 .. 8o+7 at half + 4o.
__device__ __forceinline__ int at(const float*, int j, int half) {
  return (j >> 3) * 4 + (j & 3) + ((j >> 2) & 1) * half;
}
__device__ __forceinline__ int at(const __nv_bfloat16*, int j, int) { return j; }

template <typename P>
__device__ __forceinline__ float elem(const P* row, int j, int half) {
  return to_f(row[at(row, j, half)]);
}
__device__ __forceinline__ void put(float* row, int j, int half, float x) { row[at(row, j, half)] = x; }
__device__ __forceinline__ void put(__nv_bfloat16* row, int j, int half, float x) {
  row[j] = __float2bfloat16(x);
}

// octet o of a row, widened to fp32
__device__ __forceinline__ void load8(const float* row, int o, int half, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * o);
  const float4 b = *reinterpret_cast<const float4*>(row + half + 4 * o);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int o, int, float (&x)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(row + 8 * o);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(w[k] << 16);            // the low half is the lower column
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// columns j .. j+3 of a row (j a multiple of 4)
__device__ __forceinline__ void put4(float* row, int j, int half, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(row + (j >> 3) * 4 + ((j >> 2) & 1) * half) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void put4(__nv_bfloat16* row, int j, int, float a, float b, float c,
                                     float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&lo);
  w.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(row + j) = w;
}

// Four neighbouring columns j .. j+3 of a dist row and of a validity row
// (bit e of the result: column j + e < m is valid); 16-byte and 4-byte loads
// where the rows allow them.
__device__ __forceinline__ unsigned load_scores4(const float* drow, const uint8_t* v1, int j, int m,
                                                 float (&d)[4]) {
  const bool vec = j + 3 < m && ((reinterpret_cast<uintptr_t>(drow + j) & 15) == 0) &&
                   (v1 == nullptr || (reinterpret_cast<uintptr_t>(v1 + j) & 3) == 0);
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(drow + j);
    d[0] = q.x, d[1] = q.y, d[2] = q.z, d[3] = q.w;
    if (v1 == nullptr) return 0xfu;
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(v1 + j));
    return ((w & 0xffu) ? 1u : 0u) | ((w & 0xff00u) ? 2u : 0u) | ((w & 0xff0000u) ? 4u : 0u) |
           ((w & 0xff000000u) ? 8u : 0u);
  }
  unsigned bits = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    d[e] = j + e < m ? drow[j + e] : 0.f;
    if (j + e < m && (v1 == nullptr || __ldg(v1 + j + e))) bits |= 1u << e;
  }
  return bits;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// online log-sum-exp: (mx, s) holds sum_k exp(x_k - mx) with mx the running
// max; (-inf, 0) is empty. x > mx: s = s exp(mx - x) + 1, mx = x; else s +=
// exp(x - mx): one exponential of -|x - mx| and a select, no branch (x is
// finite).
__device__ __forceinline__ void lse_add(float& mx, float& s, float x) {
  const float d = x - mx;
  const float e = expf(-fabsf(d));
  s = d > 0.f ? fmaf(s, e, 1.f) : s + e;
  mx = fmaxf(mx, x);
}

__device__ __forceinline__ void lse_merge(float& mx, float& s, float omx, float os) {
  if (os == 0.f) return;  // an empty partial (and -inf - -inf)
  if (omx > mx) {
    s = s * expf(mx - omx) + os;
    mx = omx;
  } else {
    s += os * expf(omx - mx);
  }
}

__device__ __forceinline__ void warp_lse(float& mx, float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lse_merge(mx, s, __shfl_xor_sync(0xffffffffu, mx, off), __shfl_xor_sync(0xffffffffu, s, off));
}

// larger value wins; equal values keep the lower index (a total order, so
// any merge order gives the same result)
__device__ __forceinline__ void arg_merge(float& val, int& idx, float oval, int oidx) {
  if (oval > val || (oval == val && oidx < idx)) {
    val = oval;
    idx = oidx;
  }
}

__device__ __forceinline__ void warp_argmax(float& val, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    arg_merge(val, idx, __shfl_xor_sync(0xffffffffu, val, off),
              __shfl_xor_sync(0xffffffffu, idx, off));
}

// ------------------------------------------------------------------ schedule
struct Sched {
  int batch, rows, cols;  // B, N+1, M+1
  int grid;               // CTAs launched
  int per_pair;           // CTAs a pair (1 when a CTA takes whole pairs)
  int pairs_per_cta;      // 1 unless B exceeds the CTAs the card holds
  int slots;              // batch * per_pair column-partial slots
  int stride;             // row stride in elements: round_up(M+1, 8), 16-byte rows
  int rows_max;           // most rows a CTA owns
  int cap;                // rows a CTA keeps in shared memory
  int smem;               // dynamic shared memory bytes a CTA
  long long overflow;     // rows in device memory, all CTAs
};

__host__ __device__ inline void cta_range(const Sched& s, int g, long long& lo, long long& hi) {
  if (s.pairs_per_cta == 1) {
    const int p = g / s.per_pair, k = g % s.per_pair;
    lo = (long long)p * s.rows + (long long)k * s.rows / s.per_pair;
    hi = (long long)p * s.rows + (long long)(k + 1) * s.rows / s.per_pair;
  } else {
    const long long p0 = (long long)g * s.pairs_per_cta;
    const long long p1 = p0 + s.pairs_per_cta < s.batch ? p0 + s.pairs_per_cta : s.batch;
    lo = p0 * s.rows;
    hi = p1 * s.rows;
  }
}

// first overflow row of CTA g: the overflow rows of CTAs 0 .. g-1
__host__ __device__ inline long long overflow_offset(const Sched& s, int g) {
  long long off = 0, lo, hi;
  for (int h = 0; h < g; ++h) {
    cta_range(s, h, lo, hi);
    if (hi - lo > s.cap) off += hi - lo - s.cap;
  }
  return off;
}

// shared-memory layout after the rows: [v: stride floats] [u, rounded u, row
// valid (1/0), dustbin-column term: rows_max each] [valid counts n0, n1 of
// each pair of the CTA: 2 * pairs_per_cta] [scratch: kScratch] [the pair's
// valid columns, a bit each: ceil(stride / 32) words]
inline long long fixed_smem(int stride, int rows_max, int pairs_per_cta) {
  return 4ll * stride + 16ll * rows_max + 8ll * pairs_per_cta + 4 * kScratch +
         4ll * ((stride + 31) / 32);
}

// 0 on success; cudaErrorInvalidValue when v and the per-row vectors do not
// fit in shared memory (M + 1 beyond about 57,000 columns)
inline int make_sched(int batch, int n, int m, int elem_bytes, int max_ctas, int smem_max,
                      Sched* s) {
  s->batch = batch;
  s->rows = n + 1;
  s->cols = m + 1;
  s->stride = (m + 1 + 7) / 8 * 8;
  if (max_ctas < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (batch <= max_ctas) {
    s->per_pair = max_ctas / batch < s->rows ? max_ctas / batch : s->rows;
    s->pairs_per_cta = 1;
    s->grid = batch * s->per_pair;
    s->rows_max = (s->rows + s->per_pair - 1) / s->per_pair;
  } else {
    s->per_pair = 1;
    s->pairs_per_cta = (batch + max_ctas - 1) / max_ctas;
    s->grid = (batch + s->pairs_per_cta - 1) / s->pairs_per_cta;
    s->rows_max = s->pairs_per_cta * s->rows;
  }
  s->slots = batch * s->per_pair;
  const long long row_bytes = (long long)s->stride * elem_bytes;
  const long long fixed = fixed_smem(s->stride, s->rows_max, s->pairs_per_cta);
  if (fixed > smem_max) return (int)cudaErrorInvalidValue;
  const long long fit = (smem_max - fixed) / row_bytes;
  s->cap = (int)(fit < s->rows_max ? fit : s->rows_max);
  s->smem = (int)(s->cap * row_bytes + fixed);
  s->overflow = overflow_offset(*s, s->grid);
  return 0;
}

// The CTAs the card holds at once for `kernel` at the opt-in shared memory
// a block, and that shared memory (the attribute is set on `kernel` first).
// Kept per kernel and device after the first call.
inline cudaError_t card_limits(const void* kernel, int* max_ctas, int* smem_max) {
  struct Entry {
    const void* kernel;
    int dev, max_ctas, smem_max;
  };
  static Entry cache[32];
  static int cached = 0;
  int dev, sms, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  for (int i = 0; i < cached; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev) {
      *max_ctas = cache[i].max_ctas;
      *smem_max = cache[i].smem_max;
      return cudaSuccess;
    }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  *smem_max)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           *smem_max)) != cudaSuccess)
    return err;
  *max_ctas = sms * per_sm;
  if (cached < 32) cache[cached++] = Entry{kernel, dev, *max_ctas, *smem_max};
  return cudaSuccess;
}

// the schedule of `kernel` for a shape, written as 8 ints: grid, slots, rows
// on chip (all CTAs), overflow rows, row stride, dynamic smem a CTA, rows a
// CTA keeps in smem, CTAs a pair
inline int schedule_query(const void* kernel, int batch, int n, int m, int elem_bytes, int* out) {
  if (batch < 1 || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  int max_ctas, smem_max;
  cudaError_t err = card_limits(kernel, &max_ctas, &smem_max);
  if (err != cudaSuccess) return (int)err;
  Sched s;
  const int bad = make_sched(batch, n, m, elem_bytes, max_ctas, smem_max, &s);
  if (bad) return bad;
  const long long total = (long long)batch * s.rows;
  out[0] = s.grid;
  out[1] = s.slots;
  out[2] = (int)(total - s.overflow);
  out[3] = (int)s.overflow;
  out[4] = s.stride;
  out[5] = s.smem;
  out[6] = s.cap;
  out[7] = s.per_pair;
  return 0;
}

// ---------------------------------------------------------------- the barrier
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Grid barrier over a word that is 0 when the launch starts: barrier k waits
// until k * gridDim.x arrivals. Thread 0 of each CTA arrives with a release
// add after the CTA's barrier and waits with acquire loads, then releases the
// CTA. A wait of 2^34 clocks (about 9 s) means a CTA that never arrives: the
// launch traps instead of holding the card. Data written before the barrier
// by other CTAs is read after it with ld.global.cg (__ldcg), past the SM's
// L1.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    ++gen;
    const unsigned target = gen * gridDim.x;
    red_release(bar, 1u);
    long long start = clock64();
    while (ld_acquire(bar) < target) {
      if (clock64() - start > (1ll << 34)) __trap();
    }
  }
  __syncthreads();
}

// Leaves the barrier word and the exit word at 0 for the next launch on the
// stream: the last CTA out resets both, once every CTA has left its last wait.
__device__ __forceinline__ void grid_exit(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(bar + 1, 1u) == gridDim.x - 1) {
      bar[0] = 0;
      bar[1] = 0;
      __threadfence();
    }
  }
}

// ----------------------------------------------------------- a CTA's rows
// A CTA's rows (the flattened rows [lo, hi), the first `cap` in shared
// memory, the rest in the overflow buffer), its pairs p_first .. p_last, its
// part k of a pair, and its shared-memory vectors.
template <typename P>
struct Cta {
  P* smem;          // first `cap` rows
  P* spill;         // the rest
  long long lo, hi;
  int cap, stride, half, rows, k, p_first, p_last;
  float* vs;        // the pair's column vector v (a row of the layout above)
  float* us;        // u of each row, fp32
  float* urs;       // u rounded to the storage dtype
  float* rok;       // 1 at an interior row that is valid, else 0
  float* term;      // each row's term of the dustbin column's partial
  float* cnt;       // n0, n1 of each of the CTA's pairs
  float* scratch;
  unsigned* colbits;  // the current pair's valid columns (fill_colbits)

  // Row li lives in shared memory when li < cap: the hot loops branch on
  // that (warp-uniform) and index `smem` or `spill` themselves, so that the
  // compiler keeps shared-memory loads as such.
  __device__ __forceinline__ P* row(int li) const {
    return li < cap ? smem + (size_t)li * stride : spill + (size_t)(li - cap) * stride;
  }
  // the CTA's local rows of pair p: [l0, l1)
  __device__ __forceinline__ int l0(int p) const {
    const long long a = (long long)p * rows;
    return (int)((a > lo ? a : lo) - lo);
  }
  __device__ __forceinline__ int l1(int p) const {
    const long long b = (long long)(p + 1) * rows;
    return (int)((b < hi ? b : hi) - lo);
  }
};

// sum over a block, the same bits in every thread; scratch holds kWarps floats
__device__ __forceinline__ float block_sum(float x, float* scratch) {
  x = warp_sum(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kWarps; ++w) t += scratch[w];
  return t;
}

// count of nonzero bytes of a validity row (all `len` when it is absent)
__device__ __forceinline__ float count_valid(const uint8_t* valid, int len, float* scratch) {
  if (valid == nullptr) return (float)len;
  float c = 0.f;
  for (int j = threadIdx.x; j < len; j += kThreads) c += valid[j] ? 1.f : 0.f;
  return block_sum(c, scratch);
}

template <typename P>
__device__ __forceinline__ Cta<P> cta_setup(const Sched& s, P* spill, const uint8_t* valid0,
                            const uint8_t* valid1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cta<P> c;
  cta_range(s, blockIdx.x, c.lo, c.hi);
  c.cap = s.cap;
  c.stride = s.stride;
  c.half = s.stride / 2;
  c.rows = s.rows;
  c.k = s.pairs_per_cta == 1 ? blockIdx.x % s.per_pair : 0;
  c.p_first = (int)(c.lo / s.rows);
  c.p_last = (int)((c.hi - 1) / s.rows);
  c.smem = reinterpret_cast<P*>(smem_raw);
  c.spill = spill + (size_t)overflow_offset(s, blockIdx.x) * s.stride;
  c.vs = reinterpret_cast<float*>(smem_raw + (size_t)s.cap * s.stride * sizeof(P));
  c.us = c.vs + s.stride;
  c.urs = c.us + s.rows_max;
  c.rok = c.urs + s.rows_max;
  c.term = c.rok + s.rows_max;
  c.cnt = c.term + s.rows_max;
  c.scratch = c.cnt + 2 * s.pairs_per_cta;
  c.colbits = reinterpret_cast<unsigned*>(c.scratch + kScratch);
  const int n = s.rows - 1, m = s.cols - 1;
  for (int li = threadIdx.x; li < (int)(c.hi - c.lo); li += kThreads) {
    const long long gr = c.lo + li;
    const int p = (int)(gr / s.rows), i = (int)(gr % s.rows);
    c.rok[li] = (i < n && (valid0 == nullptr || valid0[(size_t)p * n + i])) ? 1.f : 0.f;
  }
  for (int p = c.p_first; p <= c.p_last; ++p) {
    const float n0 = count_valid(valid0 ? valid0 + (size_t)p * n : nullptr, n, c.scratch);
    const float n1 = count_valid(valid1 ? valid1 + (size_t)p * m : nullptr, m, c.scratch);
    if (threadIdx.x == 0) {
      c.cnt[2 * (p - c.p_first)] = n0;
      c.cnt[2 * (p - c.p_first) + 1] = n1;
    }
  }
  __syncthreads();
  return c;
}

// The valid columns j < m of a validity row (null: all) as bits in smem, one
// word for 32 columns (ceil(stride / 32) words); the caller synchronises
// after.
__device__ __forceinline__ void fill_colbits(unsigned* bits, const uint8_t* v1, int m, int stride) {
  for (int w = threadIdx.x; w < (stride + 31) / 32; w += kThreads) {
    unsigned word = 0;
    for (int b = 0; b < 32; ++b) {
      const int j = 32 * w + b;
      if (j < m && (v1 == nullptr || v1[j])) word |= 1u << b;
    }
    bits[w] = word;
  }
}

// bits e = 0..7 of octet o: columns 8o + e valid
__device__ __forceinline__ unsigned col_byte(const unsigned* bits, int o) {
  return (bits[o >> 2] >> (8 * (o & 3))) & 0xffu;
}

// The column slice [c0, c1) that slot `k` of a pair reduces, out of `cols`.
__device__ __forceinline__ void col_slice(int cols, int per_pair, int k, int& c0, int& c1) {
  c0 = (int)((long long)k * cols / per_pair);
  c1 = (int)((long long)(k + 1) * cols / per_pair);
}

// Threads a column (or column pair) in a column pass: a power of two up to 32
// with `ncols` columns still fitting the CTA (gs * ncols <= kThreads). The gs
// threads of a column split its terms (every gs-th, from their offset) and
// merge in a butterfly: a fixed order.
__device__ __forceinline__ int group_size(int ncols) {
  int gs = 1;
  while (gs < 32 && 2 * gs * ncols <= kThreads) gs *= 2;
  return gs;
}

// Phase timers of a probe build (nvcc -DIMPX_PHASE_TIMES): thread 0 of CTA 0
// adds the nanoseconds since its last mark to g_phase_ns[k]. Nothing
// otherwise.
#ifdef IMPX_PHASE_TIMES
__device__ unsigned long long g_phase_ns[8];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define IMPX_PHASE(k, mark)                               \
  if (blockIdx.x == 0 && threadIdx.x == 0) {              \
    const unsigned long long now_ = global_ns();          \
    g_phase_ns[k] += now_ - mark;                         \
    mark = now_;                                          \
  }
#define IMPX_PHASE_START(mark) unsigned long long mark = (blockIdx.x == 0 && threadIdx.x == 0) ? global_ns() : 0
#else
#define IMPX_PHASE(k, mark)
#define IMPX_PHASE_START(mark)
#endif

}  // namespace

#ifdef IMPX_PHASE_TIMES
// the phase timers' totals since the last read, which zeroes them
extern "C" int impx_phase_ns(unsigned long long* out) {
  static const unsigned long long zero[8] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_ns, sizeof(zero));
  return (int)(err != cudaSuccess ? err : cudaMemcpyToSymbol(g_phase_ns, zero, sizeof(zero)));
}
#endif
