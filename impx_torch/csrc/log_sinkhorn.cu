// Log-domain Sinkhorn head with match statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel impx/ops/pallas/log_sinkhorn.py:log_sinkhorn_fused_stats
// (:208, kernel _log_sinkhorn_kernel :59), which keeps the dustbin-padded,
// masked score matrix Z of one pair in VMEM and runs every iteration there.
// At N = M = 2048 one pair's Z is 8.4 MB in bf16, far beyond one SM, so the
// head runs as launches over a Z in device memory (1 + 2 * iterations + 2
// launches, all on the caller's stream):
//   log_build_z    one block per row of Z: the masked row [dist_i, bin] in
//                  Z's dtype (-1e30 at invalid cells, the dustbin cell of an
//                  invalid row too); row N is the bin score at valid columns
//                  and the corner, -1e30 elsewhere;
//   log_update_u   one warp per row: u_i = log_mu_i - logsumexp_j(Z_ij + v_j);
//   log_update_v   32-column strips, 16 row phases, each an online max/sum in
//                  row order, merged in phase order (no atomics, the same
//                  bits on every run): v_j = log_nu_j - logsumexp_i(Z_ij + u_i);
//   log_row_stats  one warp per interior row: max0, idx0 of Z + u + v - norm;
//   log_col_stats  32-column strips: idx1.
// Sums, u and v are fp32; Z is read in its storage dtype and widened. Each
// column's log-sum-exp starts from one term of exactly -1e30 (with weight 1),
// the contribution of a fully masked row, as the TPU layout's alignment rows
// give it: v is then 0 at invalid columns under both storage rules, and no
// valid column changes (exp(-1e30 - x) is 0). Argmax keeps the first index
// on ties; invalid cells are -1e30 in the statistics. The exponentials and
// logarithms are expf/logf, not the fast intrinsics (__expf drops accuracy
// near the large arguments of the rescales), so the kernel agrees with its
// plain version to the summation order.
//
// Bound on the H100: one exponential per cell in each of the 2 * iterations
// sweeps at the special-function units' rate (about 0.16 ms at 20 iterations
// and 0.8 ms at 100, B = 4, N = M = 2048); reading dist once is small beside
// that. Z is re-read 2 * iterations times; at B = 4 it is 34 MB in bf16 and
// stays in the 50 MB L2 between launches. Keeping it on chip across the
// iterations is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;       // columns per block in the column passes
constexpr int kVPhases = 16;     // row phases of log_update_v (512 threads)
constexpr int kSPhases = 8;      // row phases of log_col_stats (256 threads)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// online log-sum-exp: (mx, s) holds sum_k exp(x_k - mx) with mx the running
// max; (-inf, 0) is empty
__device__ __forceinline__ void lse_add(float& mx, float& s, float x) {
  if (x > mx) {
    s = s * expf(mx - x) + 1.f;
    mx = x;
  } else {
    s += expf(x - mx);
  }
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

// larger value wins; equal values keep the lower index
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

// grid (N + 1, B): row i < N of Z, then the dustbin row
template <typename Z>
__global__ void __launch_bounds__(kThreads)
log_build_z(const float* __restrict__ dist, const float* __restrict__ bin,
            const float* __restrict__ f0, const float* __restrict__ f1, Z* __restrict__ z, int n,
            int m) {
  const int i = blockIdx.x, b = blockIdx.y;
  const float* f1b = f1 + (size_t)b * m;
  Z* zrow = z + ((size_t)b * (n + 1) + i) * (m + 1);
  const float bin_score = *bin;
  if (i == n) {
    for (int j = threadIdx.x; j <= m; j += kThreads)
      put(zrow + j, (j == m || f1b[j] > 0.f) ? bin_score : kNeg);
    return;
  }
  const bool row_ok = f0[(size_t)b * n + i] > 0.f;
  const float* drow = dist + ((size_t)b * n + i) * m;
  for (int j = threadIdx.x; j <= m; j += kThreads) {
    float x;
    if (j == m)
      x = row_ok ? bin_score : kNeg;
    else
      x = (row_ok && f1b[j] > 0.f) ? drow[j] : kNeg;
    put(zrow + j, x);
  }
}

// grid (ceil((N+1)/8), B), one warp per row; v == nullptr means v = 0
template <typename Z>
__global__ void __launch_bounds__(kThreads)
log_update_u(const Z* __restrict__ z, const float* __restrict__ log_mu,
             const float* __restrict__ v, float* __restrict__ u, int n, int m) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5), b = blockIdx.y;
  if (i > n) return;
  const Z* zrow = z + ((size_t)b * (n + 1) + i) * (m + 1);
  const float* vb = v == nullptr ? nullptr : v + (size_t)b * (m + 1);
  float mx = -INFINITY, s = 0.f;
#pragma unroll 4
  for (int j = lane; j <= m; j += 32) lse_add(mx, s, to_f(zrow[j]) + (vb ? vb[j] : 0.f));
  warp_lse(mx, s);
  const size_t at = (size_t)b * (n + 1) + i;
  if (lane == 0) u[at] = log_mu[at] - (mx + logf(s));
}

// grid (ceil((M+1)/32), B), block (32, 16): column j, row phases
template <typename Z>
__global__ void __launch_bounds__(kStrip * kVPhases)
log_update_v(const Z* __restrict__ z, const float* __restrict__ log_nu,
             const float* __restrict__ u, float* __restrict__ v, int n, int m) {
  __shared__ float pmx[kVPhases][kStrip + 1];
  __shared__ float ps[kVPhases][kStrip + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * kStrip + tx, b = blockIdx.y;
  const float* ub = u + (size_t)b * (n + 1);
  float mx = -INFINITY, s = 0.f;
  if (j <= m) {
    const Z* zb = z + (size_t)b * (n + 1) * (m + 1) + j;
#pragma unroll 4
    for (int i = ty; i <= n; i += kVPhases) lse_add(mx, s, to_f(zb[(size_t)i * (m + 1)]) + ub[i]);
  }
  pmx[ty][tx] = mx;
  ps[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j <= m) {
    float cm = kNeg, cs = 1.f;  // the fully masked row's term
    for (int p = 0; p < kVPhases; ++p) lse_merge(cm, cs, pmx[p][tx], ps[p][tx]);
    const size_t at = (size_t)b * (m + 1) + j;
    v[at] = log_nu[at] - (cm + logf(cs));
  }
}

// grid (ceil(N/8), B), one warp per interior row
template <typename Z>
__global__ void __launch_bounds__(kThreads)
log_row_stats(const Z* __restrict__ z, const float* __restrict__ f0, const float* __restrict__ f1,
              const float* __restrict__ u, const float* __restrict__ v,
              const float* __restrict__ norm, float* __restrict__ max0, int* __restrict__ idx0,
              int n, int m) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5), b = blockIdx.y;
  if (i >= n) return;
  const Z* zrow = z + ((size_t)b * (n + 1) + i) * (m + 1);
  const float* f1b = f1 + (size_t)b * m;
  const float* vb = v + (size_t)b * (m + 1);
  const bool row_ok = f0[(size_t)b * n + i] > 0.f;
  const float ui = u[(size_t)b * (n + 1) + i], nrm = norm[b];
  float best = kNeg;
  int arg = 0;
  for (int j = lane; j < m; j += 32) {
    const float filled = (row_ok && f1b[j] > 0.f) ? to_f(zrow[j]) + ui + vb[j] - nrm : kNeg;
    if (filled > best) {
      best = filled;
      arg = j;
    }
  }
  warp_argmax(best, arg);
  if (lane == 0) {
    max0[(size_t)b * n + i] = best;
    idx0[(size_t)b * n + i] = arg;
  }
}

// grid (ceil(M/32), B), block (32, 8): interior column j over rows i < N
template <typename Z>
__global__ void __launch_bounds__(kStrip * kSPhases)
log_col_stats(const Z* __restrict__ z, const float* __restrict__ f0, const float* __restrict__ f1,
              const float* __restrict__ u, const float* __restrict__ v,
              const float* __restrict__ norm, int* __restrict__ idx1, int n, int m) {
  __shared__ float pbest[kSPhases][kStrip + 1];
  __shared__ int parg[kSPhases][kStrip + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * kStrip + tx, b = blockIdx.y;
  float best = kNeg;
  int arg = 0;
  if (j < m) {
    const bool col_ok = f1[(size_t)b * m + j] > 0.f;
    const float vj = v[(size_t)b * (m + 1) + j], nrm = norm[b];
    const float* f0b = f0 + (size_t)b * n;
    const float* ub = u + (size_t)b * (n + 1);
    const Z* zb = z + (size_t)b * (n + 1) * (m + 1) + j;
    for (int i = ty; i < n; i += kSPhases) {
      const float filled =
          (col_ok && f0b[i] > 0.f) ? to_f(zb[(size_t)i * (m + 1)]) + ub[i] + vj - nrm : kNeg;
      if (filled > best) {
        best = filled;
        arg = i;
      }
    }
  }
  pbest[ty][tx] = best;
  parg[ty][tx] = arg;
  __syncthreads();
  if (ty == 0 && j < m) {
    for (int p = 1; p < kSPhases; ++p) arg_merge(best, arg, pbest[p][tx], parg[p][tx]);
    idx1[(size_t)b * m + j] = arg;
  }
}

template <typename Z>
cudaError_t run(const float* dist, const float* bin, const float* f0, const float* f1,
                const float* log_mu, const float* log_nu, const float* norm, Z* z, float* u,
                float* v, float* max0, int* idx0, int* idx1, int batch, int n, int m,
                int iterations, cudaStream_t st) {
  cudaError_t err;
  const dim3 rows_grid((n + 1 + kWarps - 1) / kWarps, batch);
  const dim3 cols_grid((m + 1 + kStrip - 1) / kStrip, batch);
  log_build_z<Z><<<dim3(n + 1, batch), kThreads, 0, st>>>(dist, bin, f0, f1, z, n, m);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int it = 0; it < iterations; ++it) {
    log_update_u<Z><<<rows_grid, kThreads, 0, st>>>(z, log_mu, it == 0 ? nullptr : v, u, n, m);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    log_update_v<Z><<<cols_grid, dim3(kStrip, kVPhases), 0, st>>>(z, log_nu, u, v, n, m);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  log_row_stats<Z><<<dim3((n + kWarps - 1) / kWarps, batch), kThreads, 0, st>>>(
      z, f0, f1, u, v, norm, max0, idx0, n, m);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  log_col_stats<Z><<<dim3((m + kStrip - 1) / kStrip, batch), dim3(kStrip, kSPhases), 0, st>>>(
      z, f0, f1, u, v, norm, idx1, n, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" int impx_log_sinkhorn_stats(const void* dist, const void* bin, const void* f0,
                                       const void* f1, const void* log_mu, const void* log_nu,
                                       const void* norm, void* z, void* u, void* v, void* max0,
                                       void* idx0, void* idx1, int batch, int n, int m,
                                       int iterations, int z_bf16, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || m < 1 || iterations < 1)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (z_bf16)
    return (int)run<__nv_bfloat16>(f(dist), f(bin), f(f0), f(f1), f(log_mu), f(log_nu), f(norm),
                                   static_cast<__nv_bfloat16*>(z), w(u), w(v), w(max0),
                                   static_cast<int*>(idx0), static_cast<int*>(idx1), batch, n, m,
                                   iterations, st);
  return (int)run<float>(f(dist), f(bin), f(f0), f(f1), f(log_mu), f(log_nu), f(norm),
                         static_cast<float*>(z), w(u), w(v), w(max0), static_cast<int*>(idx0),
                         static_cast<int*>(idx1), batch, n, m, iterations, st);
}
