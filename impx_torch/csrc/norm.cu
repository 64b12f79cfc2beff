// The MLP block's epilogue for Hopper (sm_90a): y = act(InstanceNorm_mask(p + b))
// over the tokens of [R, N, C], the product p of a dense block without its
// bias (impx_torch/ops/mlp.py:mlp_apply, every block but the last).
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses the bias add, the masked moments and the activation. In PyTorch's
// eager mode the same function is 19 device launches, ten of which read and
// write the whole tensor (0.29 ms at [8, 2000, 512] fp32 on an H100; this
// kernel 0.043 ms at 32 channels a cluster).
//
// Bound on the H100: bytes. p read once and y written once, 2 R N C
// itemsize at 3.35 TB/s: 19.6 us at [8, 2000, 512] fp32. The design reads p
// from device memory once: one thread-block cluster of `cluster` CTAs (the
// caller's, at most 8, set at launch) for each (image, slice of SC
// channels), CTA k holding rows [k rows_per, (k + 1) rows_per) of the slice
// in shared memory (cp.async, 16 bytes a copy). Each CTA sums its valid
// rows, the CTAs exchange their partial sums through distributed shared
// memory, and every CTA adds the partials in rank order, so all of them
// hold the same mean; the centred sum of squares about that mean follows
// the same way (two passes over shared memory, never E[x^2] - E[x]^2). Then
// each CTA normalises, activates and stores its rows from shared memory.
// Where a CTA's rows exceed kMaxTileBytes (above some 51,200 tokens at 512
// fp32 channels in slices of 8), the same kernel reads them from device
// memory in each of its three passes instead (the second and third mostly
// from L2). A thread always takes the same rows and channels and every sum
// runs in a fixed order, with no atomics: the same bits on every call.
//
// Numerics, as the plain path (norms.instance_norm after dense_apply): the
// bias is added first in the input dtype (bf16: the fp32 sum rounded to
// bf16); statistics in fp32 over the valid tokens, the count clamped at 1
// (a fully masked image has mean 0 and variance 0); eps 1e-3; padded rows
// normalised with the valid rows' statistics; under bf16 the normalised value
// is rounded to bf16 before the activation, and the activation's output
// again. Activations: relu, gelu (erf-exact), leaky relu with slope 0.1.
//
// Layout: p, out [R, N, C] contiguous in fp32 or bf16, C a multiple of SC;
// bias [C] in p's dtype; the mask [R, N] one byte a token (nonzero valid),
// or none.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;                // the portable cluster size
constexpr int kThreads = 256;
constexpr float kEps = 1e-3f;
constexpr int kMaxTileBytes = 200 * 1024;  // one CTA's rows of its slice in shared memory

// 16 bytes of T, as floats
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[N]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[N]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// PyTorch's CUDA formulas: relu, gelu (x / 2 (1 + erf(x / sqrt 2))), leaky relu
__device__ __forceinline__ float activate(float y, int act) {
  if (act == 0) return y < 0.f ? 0.f : y;
  if (act == 1) return y * 0.5f * (1.f + erff(y * 0.70710678118654752f));
  return y > 0.f ? y : y * 0.1f;
}

template <typename T, int SC>
__global__ void __launch_bounds__(kThreads)
    norm_act_cluster(const T* __restrict__ x, const T* __restrict__ bias,
                     const uint8_t* __restrict__ mask, T* __restrict__ out, int n, int c,
                     int rows_per, int cluster_size, bool tiled, int act) {
  using V = Vec<T>;
  constexpr int kVec = V::N;
  constexpr int kLanes = SC / kVec;         // threads across one row of the slice
  constexpr int kRowLanes = kThreads / kLanes;
  static_assert(kLanes >= 1 && kThreads % kLanes == 0, "slice narrower than 16 bytes");

  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // [rows_per, SC]
  __shared__ float part[kRowLanes][SC];      // each row lane's sums
  __shared__ float part_count[kRowLanes];
  __shared__ float ex_sum[SC + 1];           // the CTA's sums and valid count, read by the cluster
  __shared__ float ex_m2[SC];                // the CTA's centred sums of squares
  __shared__ float mean_s[SC], rstd_s[SC];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = blockIdx.x / cluster_size;  // (image, slice), slices fastest
  const int slice = group % (c / SC), image = group / (c / SC);
  const int row0 = rank * rows_per;
  const int nrows = max(0, min(rows_per, n - row0));
  const int tid = threadIdx.x, lane = tid % kLanes, rl = tid / kLanes;
  const int col = slice * SC + lane * kVec;
  const size_t base = (static_cast<size_t>(image) * n + row0) * c;
  const T* rows = x + base + slice * SC;  // this CTA's rows of the slice in device memory

  if (tiled) {
    for (int i = tid; i < nrows * kLanes; i += kThreads) {
      const int r = i / kLanes, l = i % kLanes;
      cp_async_16(tile + r * SC + l * kVec, rows + static_cast<size_t>(r) * c + l * kVec, true);
    }
    cp_async_commit();
  }
  float b[kVec];
  V::load(bias + col, b);
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + static_cast<size_t>(image) * n + row0;
  cp_async_wait<0>();
  __syncthreads();

  // the biased sum as the plain path rounds it
  auto biased = [&](int r, float (&s)[kVec]) {
    if (tiled)
      V::load(tile + r * SC + lane * kVec, s);
    else
      V::load(rows + static_cast<size_t>(r) * c + lane * kVec, s);
#pragma unroll
    for (int k = 0; k < kVec; ++k) s[k] = V::round(s[k] + b[k]);
  };
  // this CTA's sums over row lanes, in order, into ex[0, SC) (and the count into ex[SC])
  auto reduce_rows = [&](const float (&acc)[kVec], float count, float* ex) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) part[rl][lane * kVec + k] = acc[k];
    if (lane == 0) part_count[rl] = count;
    __syncthreads();
    if (tid < SC) {
      float s = 0.f;
      for (int i = 0; i < kRowLanes; ++i) s += part[i][tid];
      ex[tid] = s;
    } else if (tid == SC && ex == ex_sum) {
      float s = 0.f;
      for (int i = 0; i < kRowLanes; ++i) s += part_count[i];
      ex[SC] = s;
    }
  };

  // 1. the mean over the valid rows of the whole image
  float acc[kVec] = {};
  float count = 0.f;
  for (int r = rl; r < nrows; r += kRowLanes) {
    if (mrow != nullptr && mrow[r] == 0) continue;
    float s[kVec];
    biased(r, s);
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] += s[k];
    count += 1.f;
  }
  reduce_rows(acc, count, ex_sum);
  cluster.sync();
  if (tid < SC) {
    float s = 0.f, k = 0.f;
    for (int q = 0; q < cluster_size; ++q) {
      const float* remote = cluster.map_shared_rank(&ex_sum[0], q);
      s += remote[tid];
      k += remote[SC];
    }
    k = fmaxf(k, 1.f);
    mean_s[tid] = s / k;
    rstd_s[tid] = k;  // the count until the variance is known
  }
  __syncthreads();

  // 2. the centred sum of squares about that mean
  float mean[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    mean[k] = mean_s[lane * kVec + k];
    acc[k] = 0.f;
  }
  for (int r = rl; r < nrows; r += kRowLanes) {
    if (mrow != nullptr && mrow[r] == 0) continue;
    float s[kVec];
    biased(r, s);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float d = s[k] - mean[k];
      acc[k] += d * d;
    }
  }
  reduce_rows(acc, 0.f, ex_m2);
  cluster.sync();
  if (tid < SC) {
    float s = 0.f;
    for (int q = 0; q < cluster_size; ++q) s += cluster.map_shared_rank(&ex_m2[0], q)[tid];
    rstd_s[tid] = rsqrtf(s / rstd_s[tid] + kEps);
  }
  __syncthreads();

  // 3. normalise every row, valid or not, activate and store
  float rstd[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) rstd[k] = rstd_s[lane * kVec + k];
  for (int r = rl; r < nrows; r += kRowLanes) {
    float s[kVec];
    biased(r, s);
#pragma unroll
    for (int k = 0; k < kVec; ++k) s[k] = activate(V::round((s[k] - mean[k]) * rstd[k]), act);
    V::store(out + base + static_cast<size_t>(r) * c + col, s);
  }
  cluster.sync();  // no CTA leaves while another may still read its exchange buffers
}

template <typename T, int SC>
cudaError_t launch(const void* x, const void* bias, const void* mask, void* out, int r, int n, int c,
                   int cluster, int act, cudaStream_t stream) {
  const int rows_per = (n + cluster - 1) / cluster;
  const long long tile_bytes = static_cast<long long>(rows_per) * SC * sizeof(T);
  const bool tiled = tile_bytes <= kMaxTileBytes;
  const long long blocks = static_cast<long long>(cluster) * (c / SC) * r;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  static uint64_t raised = 0;  // devices whose dynamic shared memory limit is raised
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((raised >> device) & 1u)) {
    err = cudaFuncSetAttribute(norm_act_cluster<T, SC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxTileBytes);
    if (err != cudaSuccess) return err;
    raised |= uint64_t{1} << device;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = tiled ? static_cast<size_t>(tile_bytes) : 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, norm_act_cluster<T, SC>, static_cast<const T*>(x),
                            static_cast<const T*>(bias), static_cast<const uint8_t*>(mask),
                            static_cast<T*>(out), n, c, rows_per, cluster, tiled, act);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* bias, const void* mask, void* out, int r, int n, int c,
                     int slice, int cluster, int act, cudaStream_t stream) {
  switch (slice) {  // ops/kernels/norm.py:SLICES
    case 8: return launch<T, 8>(x, bias, mask, out, r, n, c, cluster, act, stream);
    case 16: return launch<T, 16>(x, bias, mask, out, r, n, c, cluster, act, stream);
    case 32: return launch<T, 32>(x, bias, mask, out, r, n, c, cluster, act, stream);
    case 64: return launch<T, 64>(x, bias, mask, out, r, n, c, cluster, act, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (the product), bias, mask (bool or null), out; r images of n tokens and
// c channels, each cluster of `cluster` CTAs (1 to 8) a slice of `slice`
// channels (8, 16, 32 or 64, dividing c); act 0 relu, 1 gelu, 2 leaky relu
extern "C" int impx_norm_act(const void* x, const void* bias, const void* mask, void* out, int r, int n,
                             int c, int slice, int cluster, int act, int is_bf16, void* stream) {
  if (r < 1 || n < 1 || slice < 1 || c % slice != 0 || cluster < 1 || cluster > kMaxCluster || act < 0 ||
      act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)dispatch<__nv_bfloat16>(x, bias, mask, out, r, n, c, slice, cluster, act, st);
  return (int)dispatch<float>(x, bias, mask, out, r, n, c, slice, cluster, act, st);
}
