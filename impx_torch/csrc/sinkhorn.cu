// Sinkhorn head with match statistics for Hopper (sm_90a): one persistent,
// cooperative kernel that keeps the plan on chip across the iterations.
//
// Replaces the TPU kernel impx/ops/pallas/sinkhorn.py:sinkhorn_fused_stats
// (:206, kernel _sinkhorn_kernel :62), which keeps the dustbin-padded plan of
// one pair in VMEM. At N = M = 2048 the plan is about 8.4 MB per pair in bf16
// (33.6 MB at B = 4), beyond one SM but close to the card's 132 x 227 KB of
// shared memory, so the plan is spread over every SM (persistent.cuh): each
// CTA builds its block of rows once and keeps the first `cap` of them in
// shared memory (at B = 4, N = M = 2048 in bf16, 54 of its 62-63 rows; the
// rest in an overflow buffer that stays in L2). One launch a call:
//   build     each row of the block: the masked row softmax of [dist_i, bin]
//             in the plan dtype, from one read of dist kept in registers (M
//             <= 2048; longer rows stream twice); the dustbin row is uniform
//             1/(n1+1) over the valid columns and the bin;
//   iterate   per iteration, over the CTA's rows:
//               row step: u_i = r_i / (sum_j P_ij * rnd(v_j) + EPS), one warp
//               a row, 16-byte loads of the row and of v from shared memory;
//               column partials: sum_i P_ij * rnd(u_i) over the CTA's rows,
//               eight columns a thread (the last, partial round of columns
//               split over up to 32 threads each, merged in a butterfly), the
//               dustbin column from each row's term by one warp, into the
//               CTA's workspace slot;
//             grid barrier; column reduce: each CTA sums a slice of its
//             pair's columns over the pair's slots in a fixed order and
//             writes v_j = c_j / (sum + EPS); grid barrier;
//   stats     row statistics (max0, idx0, rowmass) of the CTA's rows, and
//             per-slot column partials (best, arg, mass); grid barrier;
//             each CTA merges a column slice into idx1 and colmass.
// The loops over rows branch on whether a row is on chip and index shared
// memory or the overflow buffer directly, so that shared-memory loads stay
// shared-memory loads. No atomics touch the sums: a call gives the same
// bits every time. The marginals come from the validity masks in the kernel
// (r_i = valid0_i, r_N = n0 + 1, c likewise), so a wrapper call issues this
// launch and nothing else. rnd() rounds to the plan dtype, as the TPU kernel
// does before each product. The sums of the iterations are fp32 values
// accumulated in short fp32 blocks and then in fp64, rounded once: a sum a
// few fp32 ulps off can round u or v to the other side of a bf16 tie, and a
// row or column that one entry dominates then moves by 2^-8 of that entry's
// share, beyond the plain version's limits; near-exact sums land on the side
// of the exact value. The statistics use the unrounded u and v. Argmax keeps the first index on ties. Invalid cells: max0 fill
// -1, masses 0.
//
// Bound on the H100: reading dist once and the iterations' fp32 multiply-adds,
// about 20 us each at B = 4, N = M = 2048. What the design costs beyond
// that: two shared-memory sweeps of the plan and two grid barriers an
// iteration, and the overflow rows read from L2.
#include "persistent.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kEps = 1e-8f;
constexpr int kRowRegs = 64;  // dist values a lane holds while it builds a row (M <= 2048)

// x rounded to the plan dtype P
template <typename P>
__device__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename P>
struct Args {
  const float* dist;
  const float* bin;
  const uint8_t* valid0;  // [B, N] or null (all valid)
  const uint8_t* valid1;  // [B, M] or null
  P* spill;               // overflow rows
  float* u;
  float* v;
  float* max0;
  int* idx0;
  int* idx1;
  float* rowmass;
  float* colmass;
  float* work;            // [3, slots, M+1]
  unsigned* bar;          // two words, 0 at launch; left at 0
  int iterations;
  Sched s;
};

__device__ __forceinline__ bool ok_at(const uint8_t* valid, size_t at) {
  return valid == nullptr || valid[at] != 0;
}

// The masked row softmax of [dist_i, bin] into dst (the plan dtype, pads 0),
// one warp, four neighbouring columns a lane at a time (16-byte loads of dist
// where the row allows). Rows of M <= 32 * kRowRegs stay in registers
// between the max, the sum and the write (one read of dist, one exponential
// a cell); longer rows take an online max and sum over chunks and a second
// read.
template <typename P>
__device__ void build_row(P* dst, const float* drow, const uint8_t* v1, bool row_ok,
                          float bin_score, int m, int stride, int half, int lane) {
  constexpr int kQuads = kRowRegs / 4;
  auto scores4 = [&](int j, float (&x)[4]) {
    float d[4];
    const unsigned bits = load_scores4(drow, v1, j, m, d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = j + e < m ? ((row_ok && ((bits >> e) & 1u)) ? d[e] : kNeg) : -INFINITY;
  };
  if (m <= 32 * kRowRegs) {
    float x[kQuads][4];
    float mx = bin_score;
#pragma unroll
    for (int t = 0; t < kQuads; ++t) {
      const int j = 4 * (lane + 32 * t);
      if (j < m) {
        scores4(j, x[t]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[t][e] = -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) mx = fmaxf(mx, x[t][e]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kQuads; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[t][e] = expf(x[t][e] - mx);
        sum += x[t][e];
      }
    const float eb = expf(bin_score - mx);
    sum = warp_sum(sum) + eb;
#pragma unroll
    for (int t = 0; t < kQuads; ++t) {
      const int j = 4 * (lane + 32 * t);
      if (j + 3 < m)
        put4(dst, j, half, x[t][0] / sum, x[t][1] / sum, x[t][2] / sum, x[t][3] / sum);
      else
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < m) put(dst, j + e, half, x[t][e] / sum);
    }
    for (int j = m + lane; j < stride; j += 32) put(dst, j, half, j == m ? eb / sum : 0.f);
    return;
  }
  float mx = bin_score, sum = 1.f;  // the bin's term
  for (int c0 = 0; c0 < m; c0 += 128 * 4) {
    float x[4][4], cmx = -INFINITY, cs = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = c0 + 4 * (lane + 32 * t);
      if (j < m) {
        scores4(j, x[t]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[t][e] = -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) cmx = fmaxf(cmx, x[t][e]);
    }
    const float nmx = fmaxf(mx, warp_max(cmx));
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) cs += expf(x[t][e] - nmx);
    sum = sum * expf(mx - nmx) + warp_sum(cs);
    mx = nmx;
  }
  for (int j0 = 4 * lane; j0 < stride; j0 += 128) {
    float x[4];
    if (j0 < m) scores4(j0, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + e;
      put(dst, j, half, j < m ? expf(x[e] - mx) / sum : (j == m ? expf(bin_score - mx) / sum : 0.f));
    }
  }
}

// sum_j row_j * w_j over a row (pads 0), w a row of the same layout in
// shared memory, one warp: each eight products summed pairwise in fp32
// (bf16 products are exact), the eight-sums accumulated in fp64, the fp64
// butterfly rounded to fp32 once
template <typename P>
__device__ __forceinline__ float row_dot(const P* row, const P* w, int octs, int half, int lane) {
  double acc = 0.0;
#pragma unroll 8
  for (int o = lane; o < octs; o += 32) {
    float x[8], y[8];
    load8(row, o, half, x);
    load8(w, o, half, y);
    acc += (double)(((x[0] * y[0] + x[1] * y[1]) + (x[2] * y[2] + x[3] * y[3])) +
                    ((x[4] * y[4] + x[5] * y[5]) + (x[6] * y[6] + x[7] * y[7])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return (float)acc;
}

// sum += row[8o + e] * w over octet o, fp32
template <typename P>
__device__ __forceinline__ void axpy8(const P* row, int o, int half, float w, float (&sum)[8]) {
  float x[8];
  load8(row, o, half, x);
#pragma unroll
  for (int e = 0; e < 8; ++e) sum[e] = fmaf(x[e], w, sum[e]);
}

// acc[e] += sum_r P[li_r][8o + e] * urs[li_r] over the rows li = first,
// first + gs, ... < end of `rows` (shared memory or the overflow buffer,
// indexed from `base_li`): fp32 sums of four rows, accumulated in fp64
template <typename P>
__device__ __forceinline__ void col_accumulate(const P* rows, int base_li, int stride, int half,
                                              int o, int li, int end, int gs, const float* urs,
                                              double (&acc)[8]) {
  for (; li < end; li += 4 * gs) {
    float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lr = li + r * gs;
      if (lr < end) axpy8(rows + (size_t)(lr - base_li) * stride, o, half, urs[lr], sum);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += (double)sum[e];
  }
}

// Row statistics of an interior row over j < m, one warp: the largest
// filled value (first index on ties) and the valid mass.
template <typename P>
__device__ __forceinline__ void row_stats(const P* row, const float* v, const unsigned* colbits,
                                          bool row_ok, float ui, int m, int half, int lane,
                                          float& best, int& arg, float& mass) {
  best = -1.f, mass = 0.f, arg = 0;
#pragma unroll 4
  for (int o = lane; 8 * o < m; o += 32) {
    float x[8], y[8];
    load8(row, o, half, x);
    load8(v, o, half, y);
    const unsigned bits = row_ok ? col_byte(colbits, o) : 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool ok = (bits >> e) & 1u;
      const float val = x[e] * ui * y[e];
      const float filled = ok ? val : -1.f;
      if (filled > best) {
        best = filled;
        arg = 8 * o + e;
      }
      mass += ok ? val : 0.f;
    }
  }
  warp_argmax(best, arg);
  mass = warp_sum(mass);
}

// column statistics over one row: 8 columns
template <typename P>
__device__ __forceinline__ void col_stats8(const P* row, int o, int half, float ui, bool row_ok,
                                           unsigned bits, const float (&vj)[8], int i,
                                           float (&best)[8], int (&arg)[8], float (&mass)[8]) {
  float x[8];
  load8(row, o, half, x);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const bool ok = row_ok && ((bits >> e) & 1u);
    const float val = x[e] * ui * vj[e];
    const float filled = ok ? val : -1.f;
    if (filled > best[e]) {
      best[e] = filled;
      arg[e] = i;
    }
    mass[e] += ok ? val : 0.f;
  }
}

template <typename P>
__global__ void __launch_bounds__(kThreads, 1) sinkhorn_persistent(const __grid_constant__ Args<P> a) {
  const Sched& s = a.s;
  const int n = s.rows - 1, m = s.cols - 1, C = s.cols, R = s.rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Cta<P> c = cta_setup<P>(s, a.spill, a.valid0, a.valid1);
  const size_t plane = (size_t)s.slots * C;  // one [slots, M+1] plane of the workspace
  const int octs = s.stride / 8, octs_m = (m + 7) / 8;
  unsigned gen = 0;
  const float bin_score = *a.bin;
  IMPX_PHASE_START(mark);

  // ---- build: the masked row softmax of each row, once
  for (int li = warp; li < (int)(c.hi - c.lo); li += kWarps) {
    const long long gr = c.lo + li;
    const int p = (int)(gr / R), i = (int)(gr % R);
    P* dst = c.row(li);
    const uint8_t* v1 = a.valid1 ? a.valid1 + (size_t)p * m : nullptr;
    if (i == n) {
      const float inv = 1.0f / (c.cnt[2 * (p - c.p_first) + 1] + 1.f);  // 1 / (n1 + 1)
      for (int j = lane; j < s.stride; j += 32)
        put(dst, j, c.half, j < m ? (ok_at(v1, j) ? inv : 0.f) : (j == m ? inv : 0.f));
    } else {
      build_row(dst, a.dist + ((size_t)p * n + i) * m, v1, ok_at(a.valid0, (size_t)p * n + i),
                bin_score, m, s.stride, c.half, lane);
    }
  }
  __syncthreads();
  IMPX_PHASE(0, mark);

  // ---- iterations
  for (int it = 0; it < a.iterations; ++it) {
    const bool last = it == a.iterations - 1;
    // row step, pair by pair: u from rnd(v) of the previous iteration (v = 1
    // first), which is exact in P and kept as a row of P; each row's term of
    // the dustbin column's partial
    P* vp = reinterpret_cast<P*>(c.vs);
    for (int p = c.p_first; p <= c.p_last; ++p) {
      const float* vg = a.v + (size_t)p * C;
      for (int j = threadIdx.x; j < s.stride; j += kThreads)
        put(vp, j, c.half, j < C ? (it == 0 ? 1.f : rnd<P>(__ldcg(vg + j))) : 0.f);
      __syncthreads();
      const float* cnt = c.cnt + 2 * (p - c.p_first);
      for (int li = c.l0(p) + warp; li < c.l1(p); li += kWarps) {
        const bool on_chip = li < c.cap;
        const P* row = on_chip ? nullptr : c.spill + (size_t)(li - c.cap) * s.stride;
        const float acc = on_chip ? row_dot(c.smem + (size_t)li * s.stride, vp, octs, c.half, lane)
                                  : row_dot(row, vp, octs, c.half, lane);
        if (lane == 0) {
          const int i = (int)(c.lo + li - (long long)p * R);
          const float r = i < n ? c.rok[li] : cnt[0] + 1.f;
          const float ui = r / (acc + kEps);
          const float pm = on_chip ? elem(c.smem + (size_t)li * s.stride, m, c.half) : elem(row, m, c.half);
          c.us[li] = ui;
          c.urs[li] = rnd<P>(ui);
          c.term[li] = pm * rnd<P>(ui);
          if (last) a.u[(size_t)p * R + i] = ui;
        }
      }
      __syncthreads();
    }
    IMPX_PHASE(1, mark);
    // column partials of the CTA's rows, one slot a pair: 8 columns a thread
    // in rounds of kThreads, the last round's columns split over gs threads
    // each (rows q, q + gs, ...; a butterfly); the dustbin column from the
    // rows' terms, in row order by the last warp
    for (int p = c.p_first; p <= c.p_last; ++p) {
      float* part = a.work + (size_t)(p * s.per_pair + c.k) * C;
      const int l0 = c.l0(p), l1 = c.l1(p), lc = l1 < c.cap ? l1 : c.cap;
      for (int base = 0; base < octs_m;) {
        const int gs = group_size(octs_m - base), q = threadIdx.x % gs;
        const int o = base + threadIdx.x / gs;
        double acc[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
        if (o < octs_m) {
          // rows l0 + q, l0 + q + gs, ...: those in shared memory, then the
          // overflow rows, in the same sequence
          const int li0 = l0 + q;
          col_accumulate(c.smem, 0, s.stride, c.half, o, li0, lc, gs, c.urs, acc);
          const int first = li0 >= lc ? li0 : li0 + (lc - li0 + gs - 1) / gs * gs;
          col_accumulate(c.spill, c.cap, s.stride, c.half, o, first, l1, gs, c.urs, acc);
        }
        for (int off = gs / 2; off > 0; off >>= 1)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
        if (o < octs_m && q == 0)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (8 * o + e < m) part[8 * o + e] = (float)acc[e];
        base += kThreads / gs;
      }
      if (warp == kWarps - 1) {
        double t = 0.0;
        for (int li = l0 + lane; li < l1; li += 32) t += (double)c.term[li];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
        if (lane == 0) part[m] = (float)t;
      }
    }
    IMPX_PHASE(2, mark);
    grid_sync(a.bar, gen);
    IMPX_PHASE(3, mark);
    // column reduce: slice k of each pair over the pair's slots
    for (int p = c.p_first; p <= c.p_last; ++p) {
      int c0, c1;
      col_slice(C, s.per_pair, c.k, c0, c1);
      const int gs = group_size(c1 - c0), q = threadIdx.x % gs;
      const float* part = a.work + (size_t)p * s.per_pair * C;
      const float n1 = c.cnt[2 * (p - c.p_first) + 1];
      for (int base = c0; base < c1; base += kThreads / gs) {
        const int j = base + threadIdx.x / gs;
        double acc = 0.0;
        if (j < c1) {
#pragma unroll 4
          for (int sl = q; sl < s.per_pair; sl += gs) acc += (double)__ldcg(part + (size_t)sl * C + j);
        }
        for (int off = gs / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (j < c1 && q == 0) {
          const float cj = j < m ? (ok_at(a.valid1, (size_t)p * m + j) ? 1.f : 0.f) : n1 + 1.f;
          a.v[(size_t)p * C + j] = cj / ((float)acc + kEps);
        }
      }
    }
    IMPX_PHASE(4, mark);
    grid_sync(a.bar, gen);
    IMPX_PHASE(5, mark);
  }

  // ---- statistics of the final plan's interior, with the unrounded u and v
  for (int p = c.p_first; p <= c.p_last; ++p) {
    const float* vg = a.v + (size_t)p * C;
    __syncthreads();
    for (int j = threadIdx.x; j < s.stride; j += kThreads)
      put(c.vs, j, c.half, j < C ? __ldcg(vg + j) : 0.f);
    fill_colbits(c.colbits, a.valid1 ? a.valid1 + (size_t)p * m : nullptr, m, s.stride);
    __syncthreads();
    const int l0 = c.l0(p), l1 = c.l1(p);
    const int lrow_n = (int)((long long)p * R + n - c.lo);  // the dustbin row's local index
    const int l1i = l1 < lrow_n ? l1 : lrow_n;               // interior rows end
    const int lc = l1i < c.cap ? l1i : c.cap;
    // rows: one warp a row
    for (int li = l0 + warp; li < l1i; li += kWarps) {
      const int i = (int)(c.lo + li - (long long)p * R);
      const bool row_ok = c.rok[li] != 0.f;
      float best, mass;
      int arg;
      if (li < c.cap)
        row_stats(c.smem + (size_t)li * s.stride, c.vs, c.colbits, row_ok, c.us[li], m, c.half,
                  lane, best, arg, mass);
      else
        row_stats(c.spill + (size_t)(li - c.cap) * s.stride, c.vs, c.colbits, row_ok, c.us[li], m,
                  c.half, lane, best, arg, mass);
      if (lane == 0) {
        a.max0[(size_t)p * n + i] = best;
        a.idx0[(size_t)p * n + i] = arg;
        a.rowmass[(size_t)p * n + i] = mass;
      }
    }
    // column partials over the interior rows: 8 columns a thread, as the
    // sweeps' column pass
    const size_t slot = (size_t)(p * s.per_pair + c.k) * C;
    const int row0 = (int)(c.lo - (long long)p * R);  // pair-local row of local row 0
    for (int base = 0; base < octs_m;) {
      const int gs = group_size(octs_m - base), q = threadIdx.x % gs;
      const int o = base + threadIdx.x / gs;
      float best[8], mass[8], vj[8];
      int arg[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) best[e] = -1.f, mass[e] = 0.f, arg[e] = 0;
      if (o < octs_m) {
        load8(c.vs, o, c.half, vj);
        const unsigned bits = col_byte(c.colbits, o);
        int li = l0 + q;
        for (; li < lc; li += gs)
          col_stats8(c.smem + (size_t)li * s.stride, o, c.half, c.us[li], c.rok[li] != 0.f, bits,
                     vj, row0 + li, best, arg, mass);
        for (; li < l1i; li += gs)
          col_stats8(c.spill + (size_t)(li - c.cap) * s.stride, o, c.half, c.us[li],
                     c.rok[li] != 0.f, bits, vj, row0 + li, best, arg, mass);
      }
      for (int off = gs / 2; off > 0; off >>= 1)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          arg_merge(best[e], arg[e], __shfl_xor_sync(0xffffffffu, best[e], off),
                    __shfl_xor_sync(0xffffffffu, arg[e], off));
          mass[e] += __shfl_xor_sync(0xffffffffu, mass[e], off);
        }
      if (o < octs_m && q == 0)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (8 * o + e < m) {
            a.work[slot + 8 * o + e] = best[e];
            reinterpret_cast<int*>(a.work + plane)[slot + 8 * o + e] = arg[e];
            a.work[2 * plane + slot + 8 * o + e] = mass[e];
          }
      base += kThreads / gs;
    }
  }
  grid_sync(a.bar, gen);
  // column merge: slice k of each pair over the pair's slots
  for (int p = c.p_first; p <= c.p_last; ++p) {
    int c0, c1;
    col_slice(C, s.per_pair, c.k, c0, c1);
    c1 = c1 < m ? c1 : m;
    const int gs = group_size(c1 > c0 ? c1 - c0 : 1), q = threadIdx.x % gs;
    const size_t first = (size_t)p * s.per_pair * C;
    for (int base = c0; base < c1; base += kThreads / gs) {
      const int j = base + threadIdx.x / gs;
      float best = -1.f, mass = 0.f;
      int arg = 0;
      if (j < c1) {
        for (int sl = q; sl < s.per_pair; sl += gs) {
          const size_t at = first + (size_t)sl * C + j;
          arg_merge(best, arg, __ldcg(a.work + at),
                    __ldcg(reinterpret_cast<const int*>(a.work + plane) + at));
          mass += __ldcg(a.work + 2 * plane + at);
        }
      }
      for (int off = gs / 2; off > 0; off >>= 1) {
        arg_merge(best, arg, __shfl_xor_sync(0xffffffffu, best, off),
                  __shfl_xor_sync(0xffffffffu, arg, off));
        mass += __shfl_xor_sync(0xffffffffu, mass, off);
      }
      if (j < c1 && q == 0) {
        a.idx1[(size_t)p * m + j] = arg;
        a.colmass[(size_t)p * m + j] = mass;
      }
    }
  }
  IMPX_PHASE(6, mark);
  grid_exit(a.bar);
}

template <typename P>
cudaError_t run(Args<P> a, int batch, int n, int m, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(&sinkhorn_persistent<P>);
  int max_ctas, smem_max;
  cudaError_t err = card_limits(fn, &max_ctas, &smem_max);
  if (err != cudaSuccess) return err;
  const int bad = make_sched(batch, n, m, (int)sizeof(P), max_ctas, smem_max, &a.s);
  if (bad) return (cudaError_t)bad;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(fn, dim3(a.s.grid), dim3(kThreads), args, (size_t)a.s.smem,
                                     st);
}

}  // namespace

// The schedule for a shape: 8 ints (persistent.cuh:schedule_query); nonzero
// when the card cannot hold it.
extern "C" int impx_sinkhorn_schedule(int batch, int n, int m, int plan_bf16, int* out) {
  if (plan_bf16)
    return schedule_query(reinterpret_cast<const void*>(&sinkhorn_persistent<__nv_bfloat16>),
                          batch, n, m, 2, out);
  return schedule_query(reinterpret_cast<const void*>(&sinkhorn_persistent<float>), batch, n, m,
                        4, out);
}

extern "C" int impx_sinkhorn_stats(const void* dist, const void* bin, const void* valid0,
                                   const void* valid1, void* spill, void* u, void* v, void* max0,
                                   void* idx0, void* idx1, void* rowmass, void* colmass,
                                   void* work, void* bar, int batch, int n, int m,
                                   int iterations, int plan_bf16, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || iterations < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto& a) {
    a.dist = static_cast<const float*>(dist);
    a.bin = static_cast<const float*>(bin);
    a.valid0 = static_cast<const uint8_t*>(valid0);
    a.valid1 = static_cast<const uint8_t*>(valid1);
    a.u = static_cast<float*>(u);
    a.v = static_cast<float*>(v);
    a.max0 = static_cast<float*>(max0);
    a.idx0 = static_cast<int*>(idx0);
    a.idx1 = static_cast<int*>(idx1);
    a.rowmass = static_cast<float*>(rowmass);
    a.colmass = static_cast<float*>(colmass);
    a.work = static_cast<float*>(work);
    a.bar = static_cast<unsigned*>(bar);
    a.iterations = iterations;
  };
  if (plan_bf16) {
    Args<__nv_bfloat16> a;
    fill(a);
    a.spill = static_cast<__nv_bfloat16*>(spill);
    return (int)run(a, batch, n, m, st);
  }
  Args<float> a;
  fill(a);
  a.spill = static_cast<float*>(spill);
  return (int)run(a, batch, n, m, st);
}
