// Log-domain Sinkhorn head with match statistics for Hopper (sm_90a): one
// persistent, cooperative kernel that keeps Z on chip across the iterations.
//
// Replaces the TPU kernel impx/ops/pallas/log_sinkhorn.py:log_sinkhorn_fused_stats
// (:208, kernel _log_sinkhorn_kernel :59), which keeps the dustbin-padded,
// masked score matrix Z of one pair in VMEM and runs every iteration there.
// At N = M = 2048 one pair's Z is 8.4 MB in bf16 (33.6 MB at B = 4), so Z is
// spread over every SM (persistent.cuh): each CTA builds its block of rows of
// Z once and keeps the first `cap` of them in shared memory (the rest in an
// overflow buffer that stays in L2). One launch a call:
//   build     each row of Z in Z's dtype: the masked row [dist_i, bin] (-1e30
//             at invalid cells, the dustbin cell of an invalid row too); row
//             N is the bin score at valid columns and the corner, -1e30
//             elsewhere;
//   iterate   per iteration, over the CTA's rows:
//               row step: u_i = log_mu_i - logsumexp_j(Z_ij + v_j), one warp a
//               row, 16-byte loads of the row and of v from shared memory;
//               column partials: an online (max, sum) of Z_ij + u_i over the
//               CTA's rows in row order, eight columns a thread (the last,
//               partial round of columns split over up to 32 threads each,
//               merged in a butterfly), the dustbin column from each row's
//               Z_iM + u_i by one warp, into the CTA's workspace slot;
//             grid barrier; column reduce: each CTA merges a slice of its
//             pair's columns over the pair's slots in a fixed order, into a
//             log-sum-exp that starts from one term of exactly -1e30, and
//             writes v_j = log_nu_j - that; grid barrier;
//   stats     max0, idx0 of the CTA's rows of the log plan's interior Z + u +
//             v - norm, and per-slot column partials (best, arg); grid
//             barrier; each CTA merges a column slice into idx1.
// The log-marginals come from the validity masks in the kernel (norm =
// -log(n0 + n1), log_mu_i = norm at valid rows and -1e30 at invalid ones,
// log(n1) + norm at the dustbin; log_nu likewise), so a wrapper call issues
// this launch and nothing else. Sums, u and v are fp32; Z is read in its
// storage dtype and widened. The -1e30 start of each column's log-sum-exp is
// the contribution of a fully masked row, as the TPU layout's alignment rows
// give it: v is then 0 at invalid columns under both storage rules, and no
// valid column changes (exp(-1e30 - x) is 0). No atomics: a call gives the
// same bits every time. Argmax keeps the first index on ties; invalid cells
// are -1e30 in the statistics. The exponentials and logarithms are expf/logf,
// not the fast intrinsics (__expf drops accuracy near the large arguments of
// the rescales), so the kernel agrees with its plain version to the
// summation order.
//
// Bound on the H100: one exponential per cell in each of the 2 * iterations
// sweeps at the special-function units' rate (about 0.14 ms at 20 iterations
// and 0.72 ms at 100, B = 4, N = M = 2048); reading dist once is small
// beside that. The design adds two grid barriers an iteration and the
// overflow rows read from L2.
#include "persistent.cuh"

namespace {

constexpr float kNeg = -1e30f;

template <typename Z>
struct Args {
  const float* dist;
  const float* bin;
  const uint8_t* valid0;  // [B, N] or null (all valid)
  const uint8_t* valid1;  // [B, M] or null
  Z* spill;               // overflow rows
  float* u;
  float* v;
  float* max0;
  int* idx0;
  int* idx1;
  float* work;            // [3, slots, M+1]
  unsigned* bar;          // two words, 0 at launch; left at 0
  int iterations;
  Sched s;
};

__device__ __forceinline__ bool ok_at(const uint8_t* valid, size_t at) {
  return valid == nullptr || valid[at] != 0;
}

// log-sum-exp_j (row_j + w_j) over j < C, w in shared memory, one warp:
// eight octets a lane in registers, their max, then the sum of exponentials
// against it (as torch.logsumexp), merged across chunks of 2048 columns
template <typename Z>
__device__ __forceinline__ void row_lse(const Z* row, const float* w, int C, int half, int lane,
                                        float& mx, float& sum) {
  mx = -INFINITY, sum = 0.f;
  for (int o0 = 0; 8 * o0 < C; o0 += 32 * 8) {
    float x[8][8], cmx = -INFINITY;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int o = o0 + lane + 32 * k;
      if (8 * o < C) {
        float y[8];
        load8(row, o, half, x[k]);
        load8(w, o, half, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) x[k][e] = 8 * o + e < C ? x[k][e] + y[e] : -INFINITY;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[k][e] = -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) cmx = fmaxf(cmx, x[k][e]);
    }
    const float nmx = fmaxf(mx, warp_max(cmx));
    float cs = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) cs += expf(x[k][e] - nmx);
    sum = sum * expf(mx - nmx) + warp_sum(cs);
    mx = nmx;
  }
}

// (mx, s)[e] += row[8o + e] + ui online over octet o
template <typename Z>
__device__ __forceinline__ void lse_add8(const Z* row, int o, int half, float ui, float (&mx)[8],
                                         float (&s)[8]) {
  float x[8];
  load8(row, o, half, x);
#pragma unroll
  for (int e = 0; e < 8; ++e) lse_add(mx[e], s[e], x[e] + ui);
}

// Row statistics of an interior row of the log plan over j < m, one warp:
// the largest filled value (first index on ties)
template <typename Z>
__device__ __forceinline__ void row_stats(const Z* row, const float* v, const unsigned* colbits,
                                          bool row_ok, float ui, float nrm, int m, int half,
                                          int lane, float& best, int& arg) {
  best = kNeg, arg = 0;
#pragma unroll 4
  for (int o = lane; 8 * o < m; o += 32) {
    float x[8], y[8];
    load8(row, o, half, x);
    load8(v, o, half, y);
    const unsigned bits = row_ok ? col_byte(colbits, o) : 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float filled = ((bits >> e) & 1u) ? x[e] + ui + y[e] - nrm : kNeg;
      if (filled > best) {
        best = filled;
        arg = 8 * o + e;
      }
    }
  }
  warp_argmax(best, arg);
}

// column statistics over one row: 8 columns
template <typename Z>
__device__ __forceinline__ void col_stats8(const Z* row, int o, int half, float ui, bool row_ok,
                                           unsigned bits, const float (&vj)[8], float nrm, int i,
                                           float (&best)[8], int (&arg)[8]) {
  float x[8];
  load8(row, o, half, x);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float filled = (row_ok && ((bits >> e) & 1u)) ? x[e] + ui + vj[e] - nrm : kNeg;
    if (filled > best[e]) {
      best[e] = filled;
      arg[e] = i;
    }
  }
}

template <typename Z>
__global__ void __launch_bounds__(kThreads, 1)
log_sinkhorn_persistent(const __grid_constant__ Args<Z> a) {
  const Sched& s = a.s;
  const int n = s.rows - 1, m = s.cols - 1, C = s.cols, R = s.rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Cta<Z> c = cta_setup<Z>(s, a.spill, a.valid0, a.valid1);
  const size_t plane = (size_t)s.slots * C;  // one [slots, M+1] plane of the workspace
  const int octs_m = (m + 7) / 8;
  unsigned gen = 0;
  const float bin_score = *a.bin;
  IMPX_PHASE_START(mark);
  // norm = -log(n0 + n1) of the CTA's pair p
  auto norm_of = [&](int p) {
    const float* cnt = c.cnt + 2 * (p - c.p_first);
    return -logf(cnt[0] + cnt[1]);
  };

  // ---- build: the masked rows of Z, once (16 loads of dist in flight a lane)
  for (int li = warp; li < (int)(c.hi - c.lo); li += kWarps) {
    const long long gr = c.lo + li;
    const int p = (int)(gr / R), i = (int)(gr % R);
    Z* dst = c.row(li);
    const uint8_t* v1 = a.valid1 ? a.valid1 + (size_t)p * m : nullptr;
    const bool row_ok = i == n || ok_at(a.valid0, (size_t)p * n + i);
    const float* drow = a.dist + ((size_t)p * n + (i < n ? i : 0)) * m;
    for (int c0 = 0; c0 < s.stride; c0 += 128 * 4) {
      float x[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = c0 + 4 * (lane + 32 * t);
        float d[4];
        const unsigned bits = j < m ? load_scores4(drow, v1, j, m, d) : 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e < m)  // row N: the bin score at valid columns
            x[t][e] = (row_ok && ((bits >> e) & 1u)) ? (i < n ? d[e] : bin_score) : kNeg;
          else
            x[t][e] = j + e == m ? (row_ok ? bin_score : kNeg) : 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = c0 + 4 * (lane + 32 * t);
        if (j < s.stride) put4(dst, j, c.half, x[t][0], x[t][1], x[t][2], x[t][3]);
      }
    }
  }
  __syncthreads();
  IMPX_PHASE(0, mark);

  // ---- iterations
  for (int it = 0; it < a.iterations; ++it) {
    const bool last = it == a.iterations - 1;
    // row step, pair by pair: u from v of the previous iteration (v = 0
    // first); each row's dustbin-column term Z_iM + u_i
    for (int p = c.p_first; p <= c.p_last; ++p) {
      const float* vg = a.v + (size_t)p * C;
      for (int j = threadIdx.x; j < s.stride; j += kThreads)
        put(c.vs, j, c.half, (j < C && it > 0) ? __ldcg(vg + j) : 0.f);
      __syncthreads();
      const float* cnt = c.cnt + 2 * (p - c.p_first);
      const float nrm = norm_of(p);
      for (int li = c.l0(p) + warp; li < c.l1(p); li += kWarps) {
        const bool on_chip = li < c.cap;
        const Z* row = on_chip ? nullptr : c.spill + (size_t)(li - c.cap) * s.stride;
        float mx, sum;
        if (on_chip)
          row_lse(c.smem + (size_t)li * s.stride, c.vs, C, c.half, lane, mx, sum);
        else
          row_lse(row, c.vs, C, c.half, lane, mx, sum);
        if (lane == 0) {
          const int i = (int)(c.lo + li - (long long)p * R);
          const float log_mu = i < n ? (c.rok[li] != 0.f ? nrm : kNeg) : logf(cnt[1]) + nrm;
          const float ui = log_mu - (mx + logf(sum));
          c.us[li] = ui;
          c.term[li] =
              (on_chip ? elem(c.smem + (size_t)li * s.stride, m, c.half) : elem(row, m, c.half)) + ui;
          if (last) a.u[(size_t)p * R + i] = ui;
        }
      }
      __syncthreads();
    }
    IMPX_PHASE(1, mark);
    // column partials of the CTA's rows, one slot a pair: 8 columns a thread
    // in rounds of kThreads, the last round's columns split over gs threads
    // each (rows q, q + gs, ... online; a butterfly of merges); the dustbin
    // column from the rows' terms by the last warp
    for (int p = c.p_first; p <= c.p_last; ++p) {
      const size_t slot = (size_t)(p * s.per_pair + c.k) * C;
      const int l0 = c.l0(p), l1 = c.l1(p), lc = l1 < c.cap ? l1 : c.cap;
      for (int base = 0; base < octs_m;) {
        const int gs = group_size(octs_m - base), q = threadIdx.x % gs;
        const int o = base + threadIdx.x / gs;
        float mx[8], sm[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) mx[e] = -INFINITY, sm[e] = 0.f;
        if (o < octs_m) {
          int li = l0 + q;
#pragma unroll 2
          for (; li < lc; li += gs) lse_add8(c.smem + (size_t)li * s.stride, o, c.half, c.us[li], mx, sm);
          for (; li < l1; li += gs)
            lse_add8(c.spill + (size_t)(li - c.cap) * s.stride, o, c.half, c.us[li], mx, sm);
        }
        for (int off = gs / 2; off > 0; off >>= 1)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            lse_merge(mx[e], sm[e], __shfl_xor_sync(0xffffffffu, mx[e], off),
                      __shfl_xor_sync(0xffffffffu, sm[e], off));
        if (o < octs_m && q == 0)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (8 * o + e < m) {
              a.work[slot + 8 * o + e] = mx[e];
              a.work[plane + slot + 8 * o + e] = sm[e];
            }
        base += kThreads / gs;
      }
      if (warp == kWarps - 1) {
        float tm = -INFINITY, ts = 0.f;
        for (int li = l0 + lane; li < l1; li += 32) lse_add(tm, ts, c.term[li]);
        warp_lse(tm, ts);
        if (lane == 0) {
          a.work[slot + m] = tm;
          a.work[plane + slot + m] = ts;
        }
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
      const size_t first = (size_t)p * s.per_pair * C;
      const float* cnt = c.cnt + 2 * (p - c.p_first);
      const float nrm = norm_of(p);
      for (int base = c0; base < c1; base += kThreads / gs) {
        const int j = base + threadIdx.x / gs;
        float mx = -INFINITY, sum = 0.f;
        if (j < c1) {
#pragma unroll 4
          for (int sl = q; sl < s.per_pair; sl += gs) {
            const size_t at = first + (size_t)sl * C + j;
            lse_merge(mx, sum, __ldcg(a.work + at), __ldcg(a.work + plane + at));
          }
        }
        for (int off = gs / 2; off > 0; off >>= 1)
          lse_merge(mx, sum, __shfl_xor_sync(0xffffffffu, mx, off),
                    __shfl_xor_sync(0xffffffffu, sum, off));
        if (j < c1 && q == 0) {
          float cm = kNeg, cs = 1.f;  // the fully masked row's term
          lse_merge(cm, cs, mx, sum);
          const float log_nu =
              j < m ? (ok_at(a.valid1, (size_t)p * m + j) ? nrm : kNeg) : logf(cnt[0]) + nrm;
          a.v[(size_t)p * C + j] = log_nu - (cm + logf(cs));
        }
      }
    }
    IMPX_PHASE(4, mark);
    grid_sync(a.bar, gen);
    IMPX_PHASE(5, mark);
  }

  // ---- statistics of the log plan's interior Z + u + v - norm
  for (int p = c.p_first; p <= c.p_last; ++p) {
    const float* vg = a.v + (size_t)p * C;
    __syncthreads();
    for (int j = threadIdx.x; j < s.stride; j += kThreads)
      put(c.vs, j, c.half, j < C ? __ldcg(vg + j) : 0.f);
    fill_colbits(c.colbits, a.valid1 ? a.valid1 + (size_t)p * m : nullptr, m, s.stride);
    __syncthreads();
    const float nrm = norm_of(p);
    const int l0 = c.l0(p), l1 = c.l1(p);
    const int lrow_n = (int)((long long)p * R + n - c.lo);  // the dustbin row's local index
    const int l1i = l1 < lrow_n ? l1 : lrow_n;               // interior rows end
    const int lc = l1i < c.cap ? l1i : c.cap;
    // rows: one warp a row
    for (int li = l0 + warp; li < l1i; li += kWarps) {
      const int i = (int)(c.lo + li - (long long)p * R);
      const bool row_ok = c.rok[li] != 0.f;
      float best;
      int arg;
      if (li < c.cap)
        row_stats(c.smem + (size_t)li * s.stride, c.vs, c.colbits, row_ok, c.us[li], nrm, m, c.half, lane,
                  best, arg);
      else
        row_stats(c.spill + (size_t)(li - c.cap) * s.stride, c.vs, c.colbits, row_ok, c.us[li],
                  nrm, m, c.half, lane, best, arg);
      if (lane == 0) {
        a.max0[(size_t)p * n + i] = best;
        a.idx0[(size_t)p * n + i] = arg;
      }
    }
    // column partials over the interior rows: 8 columns a thread
    const size_t slot = (size_t)(p * s.per_pair + c.k) * C;
    const int row0 = (int)(c.lo - (long long)p * R);  // pair-local row of local row 0
    for (int base = 0; base < octs_m;) {
      const int gs = group_size(octs_m - base), q = threadIdx.x % gs;
      const int o = base + threadIdx.x / gs;
      float best[8], vj[8];
      int arg[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) best[e] = kNeg, arg[e] = 0;
      if (o < octs_m) {
        load8(c.vs, o, c.half, vj);
        const unsigned bits = col_byte(c.colbits, o);
        int li = l0 + q;
        for (; li < lc; li += gs)
          col_stats8(c.smem + (size_t)li * s.stride, o, c.half, c.us[li], c.rok[li] != 0.f, bits, vj,
                     nrm, row0 + li, best, arg);
        for (; li < l1i; li += gs)
          col_stats8(c.spill + (size_t)(li - c.cap) * s.stride, o, c.half, c.us[li], c.rok[li] != 0.f,
                     bits, vj, nrm, row0 + li, best, arg);
      }
      for (int off = gs / 2; off > 0; off >>= 1)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          arg_merge(best[e], arg[e], __shfl_xor_sync(0xffffffffu, best[e], off),
                    __shfl_xor_sync(0xffffffffu, arg[e], off));
      if (o < octs_m && q == 0)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (8 * o + e < m) {
            a.work[slot + 8 * o + e] = best[e];
            reinterpret_cast<int*>(a.work + plane)[slot + 8 * o + e] = arg[e];
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
      float best = kNeg;
      int arg = 0;
      if (j < c1) {
        for (int sl = q; sl < s.per_pair; sl += gs) {
          const size_t at = first + (size_t)sl * C + j;
          arg_merge(best, arg, __ldcg(a.work + at),
                    __ldcg(reinterpret_cast<const int*>(a.work + plane) + at));
        }
      }
      for (int off = gs / 2; off > 0; off >>= 1)
        arg_merge(best, arg, __shfl_xor_sync(0xffffffffu, best, off),
                  __shfl_xor_sync(0xffffffffu, arg, off));
      if (j < c1 && q == 0) a.idx1[(size_t)p * m + j] = arg;
    }
  }
  IMPX_PHASE(6, mark);
  grid_exit(a.bar);
}

template <typename Z>
cudaError_t run(Args<Z> a, int batch, int n, int m, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(&log_sinkhorn_persistent<Z>);
  int max_ctas, smem_max;
  cudaError_t err = card_limits(fn, &max_ctas, &smem_max);
  if (err != cudaSuccess) return err;
  const int bad = make_sched(batch, n, m, (int)sizeof(Z), max_ctas, smem_max, &a.s);
  if (bad) return (cudaError_t)bad;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(fn, dim3(a.s.grid), dim3(kThreads), args, (size_t)a.s.smem,
                                     st);
}

}  // namespace

// The schedule for a shape: 8 ints (persistent.cuh:schedule_query); nonzero
// when the card cannot hold it.
extern "C" int impx_log_sinkhorn_schedule(int batch, int n, int m, int z_bf16, int* out) {
  if (z_bf16)
    return schedule_query(reinterpret_cast<const void*>(&log_sinkhorn_persistent<__nv_bfloat16>),
                          batch, n, m, 2, out);
  return schedule_query(reinterpret_cast<const void*>(&log_sinkhorn_persistent<float>), batch, n,
                        m, 4, out);
}

extern "C" int impx_log_sinkhorn_stats(const void* dist, const void* bin, const void* valid0,
                                       const void* valid1, void* spill, void* u, void* v,
                                       void* max0, void* idx0, void* idx1, void* work, void* bar,
                                       int batch, int n, int m, int iterations, int z_bf16,
                                       void* stream) {
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
    a.work = static_cast<float*>(work);
    a.bar = static_cast<unsigned*>(bar);
    a.iterations = iterations;
  };
  if (z_bf16) {
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
