// Flash-attention forward (prefill) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_flash_kernel`, launched by pl.pallas_call),
// which is the Pallas form of the reference's pure-JAX prefill attention
// `blocked_attn.flash_sdpa`. It computes the same function as the plain
// version (src/repro_torch/kernels/ref.py `flash_attention_ref`):
//
//   q (B, H, Tq, D), k/v (B, KVH, Tk, D), f32|bf16, any strides with a
//   unit stride along D  ->  out (B, H, Tq, D) in q's dtype, where head h
//   attends with its KV head h / (H / KVH); scores and P·V in fp32; masks
//   top-left aligned (query i, key j): causal keeps j <= i, window > 0
//   keeps j > i - window.
//
// The online softmax follows the Pallas body line for line: running max m
// and sum l per query row, m_safe = max(m_new, NEG_INF / 2) so a row with
// nothing unmasked yet never computes -inf - -inf, and the correction
// exp(m_old - m_safe) is 0 until the row has seen an unmasked key. A row
// with no unmasked key at all writes 0, as the Pallas kernel does.
//
// Bound on this card: at prefill lengths the operations (4·D flops per
// unmasked query-key pair) against q, k, v and out each moved once; which
// of the two is larger depends on T (chip_smoke.py computes both).
//
// What this simple design does:
//  * one 128-thread block per (64-row q tile, head, batch row); two threads
//    per query row, each holding the row's q in registers, scoring every
//    other key of the tile and owning half of the output row's D columns;
//  * K and V stream through shared memory in 64-key tiles, converted to
//    fp32 as they land (the load loop is unrolled, so each thread keeps
//    several loads in flight); the inner loops read them as float4 (row
//    stride D + 4 keeps rows 16-byte aligned and puts the pair's two reads
//    in different banks);
//  * the key loop of a block runs only over tiles that hold an unmasked key
//    for some row of its q tile: it ends at min(Tk, q_end) when causal and
//    starts at the window's first tile, which is how Hopper gets the
//    Pallas kernel's `pl.when` tile skip; the grid runs in any order;
//  * ragged Tq and Tk are masked inside the block (no padding copies).
// It uses scalar fp32 FMAs, not the tensor cores, and every FMA takes one
// operand from shared memory, so shared-memory issue bounds it (a 16-byte
// load still costs four passes of the load unit): register blocking, or
// wgmma on TMA-fed tiles with P·V kept in fp32, is the redesign that can
// approach the operation bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per shared-memory tile
constexpr int kThreads = 2 * kBQ;       // two threads per query row
constexpr int kKeysPerThread = kBK / 2;
constexpr float kNegInf = -1e30f;       // the Pallas kernel's NEG_INF

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Args {
  int H, KVH, Tq, Tk;
  long long qsb, qsh, qst;  // element strides of batch, head, token
  long long ksb, ksh, kst;
  long long vsb, vsh, vst;
  long long osb, osh, ost;
  int causal, window;
  float sm_scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, Args a) {
  constexpr int kHalfD = D / 2;
  constexpr int kStride = D + 4;
  __shared__ __align__(16) float k_s[kBK][kStride];
  __shared__ __align__(16) float v_s[kBK][kStride];

  const int q_start = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int tid = threadIdx.x;
  const int half = tid & 1;              // which keys and which D columns
  const int qi = q_start + (tid >> 1);   // this thread's query row
  const bool row_ok = qi < a.Tq;

  float qr[D];
  {
    const T* qp = q + b * a.qsb + h * a.qsh + static_cast<long long>(qi) * a.qst;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = row_ok ? to_float(qp[d]) : 0.f;
  }
  float acc[kHalfD];
#pragma unroll
  for (int d = 0; d < kHalfD; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  // tiles holding an unmasked key for some row of [q_start, q_start + kBQ)
  int k_hi = a.Tk;
  if (a.causal) k_hi = min(a.Tk, q_start + kBQ);
  int k_lo = 0;
  if (a.window > 0) k_lo = max(0, q_start - a.window + 1) / kBK * kBK;

  const T* kb = k + b * a.ksb + kvh * a.ksh;
  const T* vb = v + b * a.vsb + kvh * a.vsh;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    // unrolled, so each thread has several loads in flight at once
#pragma unroll 8
    for (int r = 0; r < kBK * D / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int t = i / D;
      const int d = i % D;
      const int kj = k0 + t;
      float kv = 0.f;
      float vv = 0.f;
      if (kj < a.Tk) {
        kv = to_float(kb[static_cast<long long>(kj) * a.kst + d]);
        vv = to_float(vb[static_cast<long long>(kj) * a.vst + d]);
      }
      k_s[t][d] = kv;
      v_s[t][d] = vv;
    }
    __syncthreads();

    // scores of this thread's keys k0 + 2j + half
    float s[kKeysPerThread];
    unsigned ok_bits = 0u;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int t = 2 * j + half;
      const int kj = k0 + t;
      const bool ok = row_ok && kj < a.Tk && (!a.causal || kj <= qi) &&
                      (a.window <= 0 || kj > qi - a.window);
      const float4* kr = reinterpret_cast<const float4*>(&k_s[t][0]);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kv = kr[d4];
        dot = fmaf(qr[4 * d4], kv.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
      }
      s[j] = ok ? dot * a.sm_scale : kNegInf;
      ok_bits |= (ok ? 1u : 0u) << j;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float m_safe = fmaxf(m_new, kNegInf / 2);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      s[j] = ((ok_bits >> j) & 1u) ? expf(s[j] - m_safe) : 0.f;
      sum += s[j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = m > kNegInf / 2 ? expf(fmaxf(m, kNegInf / 2) - m_safe) : 0.f;
    l = l * corr + sum;
#pragma unroll
    for (int d = 0; d < kHalfD; ++d) acc[d] *= corr;
    // P·V over all 64 keys: this thread's probabilities and its partner's
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const float p_mine = s[j];
      const float p_other = __shfl_xor_sync(0xffffffffu, s[j], 1);
      const float4* v_mine =
          reinterpret_cast<const float4*>(&v_s[2 * j + half][half * kHalfD]);
      const float4* v_other =
          reinterpret_cast<const float4*>(&v_s[2 * j + (half ^ 1)][half * kHalfD]);
#pragma unroll
      for (int d4 = 0; d4 < kHalfD / 4; ++d4) {
        const float4 vm = v_mine[d4];
        const float4 vo = v_other[d4];
        acc[4 * d4] = fmaf(p_other, vo.x, fmaf(p_mine, vm.x, acc[4 * d4]));
        acc[4 * d4 + 1] = fmaf(p_other, vo.y, fmaf(p_mine, vm.y, acc[4 * d4 + 1]));
        acc[4 * d4 + 2] = fmaf(p_other, vo.z, fmaf(p_mine, vm.z, acc[4 * d4 + 2]));
        acc[4 * d4 + 3] = fmaf(p_other, vo.w, fmaf(p_mine, vm.w, acc[4 * d4 + 3]));
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float lsafe = fmaxf(l, 1e-30f);
    T* op = out + b * a.osb + h * a.osh + static_cast<long long>(qi) * a.ost + half * kHalfD;
#pragma unroll
    for (int d = 0; d < kHalfD; ++d) store(&op[d], acc[d] / lsafe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* out, int B,
                     const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, a, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape or type the kernel does not take).
// `strides` holds 12 element strides: (batch, head, token) of q, k, v
// and out, in that order; the stride along D is 1 for all four.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int B, int H, int KVH, int Tq, int Tk, int D,
                                   const long long* strides, int causal, int window,
                                   float sm_scale, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || KVH <= 0 || H % KVH != 0 || Tq <= 0 ||
      Tk <= 0 || window < 0 || strides == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{H, KVH, Tq, Tk,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
               causal != 0 ? 1 : 0, window, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32) err = launch_d<float>(D, q, k, v, out, B, a, s);
  else if (dtype == kBF16) err = launch_d<__nv_bfloat16>(D, q, k, v, out, B, a, s);
  return static_cast<int>(err);
}
