// Fused residual add + RMSNorm for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (`fused_rmsnorm`,
// body `_rmsnorm_kernel`, launched by pl.pallas_call). It computes the
// same function as the plain version (src/repro_torch/kernels/ref.py
// `fused_rmsnorm_ref`):
//
//   x (N, d) f32|bf16; scale (d,) f32; residual optional (N, d) in x's
//   dtype  ->  r = x + residual rounded to x's dtype (r = x without a
//   residual), y = r * rsqrt(mean(r^2) + eps) * scale with the reduction
//   in fp32, y cast to x's dtype.
//
// Rounding: the normalized value is the ROUNDED sum r, as in the
// reference model's block (`x = x + a; apply_norm(x)`) and its oracle
// src/repro/kernels/ref.py `fused_rmsnorm_ref`. The Pallas body
// normalizes the unrounded fp32 sum instead, so at bf16 this kernel and
// the Pallas kernel differ by up to one bf16 ulp; at f32 they agree.
//
// Bound on this card: bytes. About four flops per element against two
// (x, y) or four (x, residual, r, y) element reads and writes, far below
// the H100's ~295 flop/byte ridge; the least time is those bytes plus
// the scale over 3.35 TB/s. At decode (N 8) the bytes take 0.04 us and
// the kernel costs what one launch and one memory round trip cost.
//
// Design. One block per row, one 16-byte vector of the row per thread
// (d * sizeof(T) / 16 threads rounded up to whole warps: 256 for d 2048
// bf16, 640 for d 5120 bf16), so N rows run as N blocks and every element
// is read once and written once. A row of more than 1024 vectors (f32
// above d 4096, up to d 8192) takes two vectors a thread, j and
// j + blockDim.x, so neighbouring threads still read neighbouring
// addresses. Each thread issues all its loads (x, the residual and the
// matching scale vectors) before any arithmetic: one dependent memory
// round trip per launch, none after the reduction. The sum of squares is a
// warp-shuffle reduction, then one exchange through shared memory between
// the row's warps. The wrapper computes the block size
// (kernels/rmsnorm.py `launch_shape`); this file only checks that it
// covers the row. Rows sharing a block (four rows, up to eight vectors a
// thread) lost to this mapping at every N from 64 to 8192 on an H100 80GB
// HBM3 at 700 W (PERF.md), so no other mapping is kept.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 8192;
constexpr int kMaxThreads = 1024;
constexpr int kMaxVecs = 2;      // 16-byte vectors of the row a thread

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int kVecs>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
               const float* __restrict__ scale, T* __restrict__ y, T* __restrict__ r_out,
               int d, float eps) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int kScaleVecs = kVec / 4;   // float4 scale vectors per vector
  __shared__ float part[kMaxThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * d;

  // every load first: x, residual, scale; vector j + v·blockDim.x of the
  // row is this thread's v-th (the last warp may overhang the row)
  uint4 xs[kVecs];
  uint4 rs[kVecs];
  float4 sc[kVecs][kScaleVecs];
  bool live[kVecs];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const int j = threadIdx.x + v * blockDim.x;
    live[v] = j < d / kVec;
    xs[v] = make_uint4(0, 0, 0, 0);
    rs[v] = make_uint4(0, 0, 0, 0);
    if (live[v]) {
      xs[v] = reinterpret_cast<const uint4*>(x + base)[j];
      if (res != nullptr) rs[v] = reinterpret_cast<const uint4*>(res + base)[j];
#pragma unroll
      for (int c = 0; c < kScaleVecs; ++c) {
        sc[v][c] = reinterpret_cast<const float4*>(scale)[j * kScaleVecs + c];
      }
    }
  }

  // r = x + residual rounded to T (written out), and the sum of squares of r
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const int j = threadIdx.x + v * blockDim.x;
    T* xe = reinterpret_cast<T*>(&xs[v]);
    if (live[v] && res != nullptr) {
      const T* re = reinterpret_cast<const T*>(&rs[v]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) xe[e] = from_float<T>(to_float(xe[e]) + to_float(re[e]));
      reinterpret_cast<uint4*>(r_out + base)[j] = xs[v];
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) ss = fmaf(to_float(xe[e]), to_float(xe[e]), ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (blockDim.x > 32) {  // the row spans several warps
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) ss += part[w];
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    if (live[v]) {
      const T* xe = reinterpret_cast<const T*>(&xs[v]);
      const float* se = reinterpret_cast<const float*>(&sc[v][0]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int e = 0; e < kVec; ++e) oe[e] = from_float<T>(to_float(xe[e]) * inv * se[e]);
      reinterpret_cast<uint4*>(y + base)[threadIdx.x + v * blockDim.x] = o;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* res, const float* scale, void* y, void* r_out,
                   int N, int d, float eps, int threads, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (d % kVec != 0 || threads % 32 != 0 || threads <= 0 || threads > kMaxThreads) {
    return cudaErrorInvalidValue;
  }
  // whole warps covering the row with one or two vectors a thread
  const int nvec = d / kVec;
  const int vecs = (nvec + threads - 1) / threads;
  if (vecs == 1) {
    rmsnorm_kernel<T, 1><<<N, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(res), scale, static_cast<T*>(y),
        static_cast<T*>(r_out), d, eps);
  } else if (vecs == kMaxVecs) {
    rmsnorm_kernel<T, kMaxVecs><<<N, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(res), scale, static_cast<T*>(y),
        static_cast<T*>(r_out), d, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape, type or block size the kernel does
// not take). `residual` and `r_out` are both null (plain RMSNorm) or both
// set. x, residual, scale, y and r_out must be 16-byte aligned and
// row-contiguous. `threads` is the block size the wrapper chose
// (kernels/rmsnorm.py `launch_shape`): whole warps, one or two 16-byte
// vectors of the row each.
extern "C" int fused_rmsnorm_fwd(const void* x, const void* residual, const void* scale,
                                 void* y, void* r_out, int N, int d, float eps, int dtype,
                                 int threads, void* stream) {
  if (N <= 0 || d <= 0 || d > kMaxD || (residual == nullptr) != (r_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32) {
    err = launch<float>(x, residual, sc, y, r_out, N, d, eps, threads, s);
  } else if (dtype == kBF16) {
    err = launch<__nv_bfloat16>(x, residual, sc, y, r_out, N, d, eps, threads, s);
  }
  return static_cast<int>(err);
}
