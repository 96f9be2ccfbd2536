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
// the scale over 3.35 TB/s.
//
// What this simple design does about that bound:
//  * one warp per row, four rows per 128-thread block; the last block
//    masks a ragged tail of rows, so any N is taken;
//  * each lane loads its share of the row in 16-byte vectors and keeps it
//    in registers (d <= 2048), so every element is read once and written
//    once, and the residual sum never goes back to memory before the norm;
//  * the sum of squares is a warp-shuffle reduction: no shared memory and
//    no barrier.
// At decode (N = live lanes, 8) only two blocks run: the kernel is bound
// by its launch there, not by the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kMaxD = 2048;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
               const float* __restrict__ scale, T* __restrict__ y, T* __restrict__ r_out,
               int N, int d, float eps) {
  constexpr int kVec = 16 / sizeof(T);            // elements per 16-byte load
  constexpr int kMaxVecs = kMaxD / kVec / 32;     // 16-byte loads per lane
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;  // ragged tail: the whole warp leaves together
  const int nvec = d / kVec;
  const size_t base = static_cast<size_t>(row) * d;
  const uint4* xv = reinterpret_cast<const uint4*>(x + base);
  const uint4* rv = res != nullptr ? reinterpret_cast<const uint4*>(res + base) : nullptr;

  float vals[kMaxVecs][kVec];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec) {
      const uint4 a = xv[j];
      const T* ae = reinterpret_cast<const T*>(&a);
      if (rv != nullptr) {
        const uint4 b = rv[j];
        const T* be = reinterpret_cast<const T*>(&b);
        uint4 o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const T s = from_float<T>(to_float(ae[e]) + to_float(be[e]));
          oe[e] = s;
          vals[i][e] = to_float(s);
        }
        reinterpret_cast<uint4*>(r_out + base)[j] = o;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) vals[i][e] = to_float(ae[e]);
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) ss = fmaf(vals[i][e], vals[i][e], ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  uint4* yv = reinterpret_cast<uint4*>(y + base);
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec) {
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        oe[e] = from_float<T>(vals[i][e] * inv * scale[j * kVec + e]);
      }
      yv[j] = o;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* res, const float* scale, void* y, void* r_out,
                   int N, int d, float eps, cudaStream_t stream) {
  if (d % (16 / static_cast<int>(sizeof(T))) != 0) return cudaErrorInvalidValue;
  const int blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), scale, static_cast<T*>(y),
      static_cast<T*>(r_out), N, d, eps);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape or type the kernel does not take).
// `residual` and `r_out` are both null (plain RMSNorm) or both set. x,
// residual, y and r_out must be 16-byte aligned and row-contiguous.
extern "C" int fused_rmsnorm_fwd(const void* x, const void* residual, const void* scale,
                                 void* y, void* r_out, int N, int d, float eps, int dtype,
                                 void* stream) {
  if (N <= 0 || d <= 0 || d > kMaxD || (residual == nullptr) != (r_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32) err = launch<float>(x, residual, sc, y, r_out, N, d, eps, s);
  else if (dtype == kBF16) err = launch<__nv_bfloat16>(x, residual, sc, y, r_out, N, d, eps, s);
  return static_cast<int>(err);
}
