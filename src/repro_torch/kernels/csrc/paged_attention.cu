// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (`paged_attention`, body `_paged_kernel`, launched by pl.pallas_call).
// It computes the same function as the plain version
// (src/repro_torch/kernels/ref.py `paged_attention_ref`):
//
//   q (B, H, D) f32|bf16; k/v pages (P, page, KVH, D) in q's dtype, or int8
//   with per-token-per-head f32 scales (P, page, KVH); block_table
//   (B, max_pages) int32, each entry clamped to [0, P-1]; lengths (B,)
//   int32 >= 1  ->  out (B, H, D) in q's dtype, where head h of slot b
//   attends with an fp32 softmax over the first lengths[b] tokens of its
//   KV head h / (H / KVH), read through the slot's block table.
//
// Entries of block_table past ceil(lengths[b] / page) are never read, so
// they may hold -1.
//
// Bound on this card: bytes. Each query token does 4·D flops per cached
// token and head, so the arithmetic intensity sits far below the H100's
// ~295 flop/byte ridge; the least time is the K/V (and scale) bytes the
// slots' live tokens occupy, sum_b len_b · KVH · D · 2 · itemsize, over
// 3.35 TB/s.
//
// What this simple design does about that bound:
//  * one thread block per (slot, KV head) walks only ceil(len/page) pages
//    of its own block-table row, chasing each page id by pointer, so no
//    byte past a slot's length is read;
//  * each K/V page is read from device memory once and kept in shared
//    memory in fp32 for all H/KVH query heads of the GQA group (int8 pages
//    are dequantized as they land), so the group shares one read;
//  * the softmax is online (running max and sum per head, fp32), so the
//    kernel makes a single pass over the cache and writes only (B, H, D).
// It does not yet pipeline loads (cp.async / TMA) or split long contexts
// across blocks; a batch smaller than the SM count leaves SMs idle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPage = 32;   // tokens per page held in shared memory
constexpr int kMaxGroup = 8;   // query heads per KV head

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // null unless the pages are int8
  const float* v_scale;
  const int* block_table;
  const int* lengths;
  void* out;
  int B, H, KVH, P, page, max_pages;
};

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pages,
                       const KVT* __restrict__ v_pages, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ block_table,
                       const int* __restrict__ lengths, QT* __restrict__ out, int H, int KVH,
                       int P, int page, int max_pages) {
  constexpr int kAcc = (kMaxGroup * D + kThreads - 1) / kThreads;
  __shared__ float q_s[kMaxGroup][D];
  __shared__ float k_s[kMaxPage][D + 1];  // +1: score reads walk rows, no bank conflicts
  __shared__ float v_s[kMaxPage][D];
  __shared__ float p_s[kMaxGroup][kMaxPage];
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];
  __shared__ float c_s[kMaxGroup];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = lengths[b];
  const size_t tok_stride = static_cast<size_t>(KVH) * D;  // elements between tokens
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G;

  // the group's query rows, pre-scaled by 1/sqrt(D)
  const float sm_scale = rsqrtf(static_cast<float>(D));
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i / D][i % D] = to_float(q[head0 * D + i]) * sm_scale;
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;

  // a length past the table's reach reads only what the table maps, as
  // the plain version's mask over max_pages * page positions does
  const int n_pages = min((len + page - 1) / page, max_pages);
  const int* bt = block_table + static_cast<size_t>(b) * max_pages;
  for (int j = 0; j < n_pages; ++j) {
    const int pid = min(max(bt[j], 0), P - 1);
    const size_t page_base = static_cast<size_t>(pid) * page;
    __syncthreads();  // the previous page's shared tiles are no longer read
    for (int i = tid; i < page * D; i += kThreads) {
      const int t = i / D;
      const int d = i % D;
      const size_t off = (page_base + t) * tok_stride + static_cast<size_t>(kvh) * D + d;
      float kv = to_float(k_pages[off]);
      float vv = to_float(v_pages[off]);
      if (k_scale != nullptr) {
        const size_t so = (page_base + t) * KVH + kvh;
        kv *= k_scale[so];
        vv *= v_scale[so];
      }
      k_s[t][d] = kv;
      v_s[t][d] = vv;
    }
    __syncthreads();
    // scores for every (head of the group, token of the page)
    const int t0 = j * page;
    for (int i = tid; i < G * page; i += kThreads) {
      const int g = i / page;
      const int t = i % page;
      float s = -INFINITY;
      if (t0 + t < len) {
        s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(q_s[g][d], k_s[t][d], s);
      }
      p_s[g][t] = s;
    }
    __syncthreads();
    // online softmax: one warp per head. Token t0 is always valid, so the
    // page maximum is finite and exp(m_old - m_new) is 0 on the first page.
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, p_s[g][t]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = (t0 + t < len) ? expf(p_s[g][t] - m_new) : 0.f;
        p_s[g][t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // rescale and accumulate p @ v; thread owns (head, dim) pairs tid + r*kThreads
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int i = tid + r * kThreads;
      if (i < G * D) {
        const int g = i / D;
        const int d = i % D;
        float a = acc[r] * c_s[g];
        for (int t = 0; t < page; ++t) a = fmaf(p_s[g][t], v_s[t][d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int i = tid + r * kThreads;
    if (i < G * D) {
      const float l = fmaxf(l_s[i / D], 1e-30f);
      store(&out[head0 * D + i], acc[r] / l);
    }
  }
}

template <typename QT, typename KVT, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.KVH, a.B);
  paged_attention_kernel<QT, KVT, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KVT*>(a.k), static_cast<const KVT*>(a.v),
      a.k_scale, a.v_scale, a.block_table, a.lengths, static_cast<QT*>(a.out), a.H, a.KVH, a.P,
      a.page, a.max_pages);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t launch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<QT, KVT, 16>(a, stream);
    case 64: return launch<QT, KVT, 64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape or type the kernel does not take).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                   const void* k_scale, const void* v_scale,
                                   const void* block_table, const void* lengths, void* out,
                                   int B, int H, int KVH, int D, int P, int page,
                                   int max_pages, int q_dtype, int kv_dtype, void* stream) {
  const bool quantized = kv_dtype == kI8;
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > kMaxGroup || page <= 0 ||
      page > kMaxPage || P <= 0 || max_pages <= 0 || quantized != (k_scale != nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<const int*>(block_table),
               static_cast<const int*>(lengths), out, B, H, KVH, P, page, max_pages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == kF32 && kv_dtype == kF32) err = launch_d<float, float>(D, a, s);
  else if (q_dtype == kBF16 && kv_dtype == kBF16) err = launch_d<__nv_bfloat16, __nv_bfloat16>(D, a, s);
  else if (q_dtype == kF32 && kv_dtype == kI8) err = launch_d<float, int8_t>(D, a, s);
  else if (q_dtype == kBF16 && kv_dtype == kI8) err = launch_d<__nv_bfloat16, int8_t>(D, a, s);
  return static_cast<int>(err);
}
