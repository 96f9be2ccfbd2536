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
// they may hold -1; a length past the table's reach (max_pages * page)
// reads only what the table maps. A slot of length 0 gets zeros, as the
// Pallas kernel gives.
//
// Bound on this card: bytes. Each cached token costs 4·G·D flops (G =
// H / KVH query heads share it) against 2·D·itemsize bytes, about 4
// flop/byte at G 4 in bf16, far below the H100's ~295 flop/byte ridge; the
// least time is the live K/V (and scale) bytes, sum_b len_b · KVH · D · 2 ·
// itemsize, over 3.35 TB/s. At decode sizes those bytes are few (5.6 MB at
// 8 slots of up to 1023 tokens), so what decides the time is how many
// bytes are in flight at once and on how many SMs.
//
// Design:
//  * Split over pages (flash-decoding). The grid is (n_splits, KVH, B);
//    block (s, kvh, b) attends over pages [s·pps, (s+1)·pps) of slot b's
//    table, where the wrapper picks pages_per_split (pps) from static
//    shapes only (kernels/paged_attention.py `split_plan`: about four blocks
//    an SM when every slot is full), never from `lengths`, which lives on
//    the card. A block whose split begins at or past its slot's length
//    exits at once. With one split the block writes the output; otherwise
//    it writes a partial (running max in the log2 domain, sum, unnormalised
//    fp32 accumulator) and `paged_attention_combine_kernel` merges the
//    ceil(len / split tokens) live splits, weighting an empty one by
//    exactly 0.
//  * Each of the block's four warps streams its own run of tiles (tile i
//    of the split goes to warp i % 4) through two shared-memory stages of
//    its own: 16-byte `cp.async` copies, neighbouring lanes on neighbouring
//    bytes of a token's row, bring tile i + 4 while tile i is scored.
//    Tiles hold 32 tokens (16 for 256-byte rows, 8 for 512-byte rows), each
//    row looked up through the block table on its own, so any page size
//    works and a ragged tile is zero-filled without a read. K and V stay in
//    their storage type in shared memory (rows padded to an odd count of
//    16-byte pieces, so a warp's row reads hit distinct banks) and are
//    widened in registers; int8 scales come with their tile.
//  * Scores: a lane (or 2-4 lanes sharing a row, combined by shuffles)
//    takes one token and all G query rows, read as broadcasts from the
//    shared copy of q pre-scaled by log2(e)/sqrt(D). Each warp keeps its
//    own fp32 online softmax (max by shuffles once a tile, sums per lane);
//    P·V has each lane own D/32 dimensions of every head's accumulator. The
//    loop has no block barrier: warps sync only themselves. The four warps
//    merge once per split, through one block barrier.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 16;   // query heads per KV head
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// N consecutive elements read by one load of N * sizeof(T) bytes
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T x[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_widen(const unsigned char* p, float (&out)[N]) {
  const Pack<T, N> v = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(v.x[i]);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous copies; with valid false they read nothing and zero-fill
// the destination (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Tile geometry of one instantiation (GM: query rows a block holds, G <= GM)
template <typename KVT, int D, int GM>
struct Geo {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KVT));
  static constexpr int kChunks = kRowBytes / 16;               // 16-byte pieces of a row
  static constexpr int kRow = kRowBytes + (kChunks % 2 == 0 ? 16 : 0);  // padded smem stride
  static constexpr int kTokens = kRowBytes <= 128 ? 32 : (kRowBytes <= 256 ? 16 : 8);
  static constexpr int kLanesPerToken = 32 / kTokens;          // in the scores
  static constexpr int kChunksPerLane = kChunks / kLanesPerToken;
  static constexpr int kElems = 16 / static_cast<int>(sizeof(KVT));  // per 16 bytes
  static constexpr int kDimsPerLane = D >= 32 ? D / 32 : 1;    // in P·V
  static constexpr int kLanesPerRow = D / kDimsPerLane;
  static constexpr int kTokenGroups = 32 / kLanesPerRow;       // tokens a warp takes at once
  static constexpr int kStage = 2 * kTokens * kRow + 2 * kTokens * 4;  // K, V, k/v scales
  static constexpr int kWarpBytes = 2 * kStage + kTokens * GM * 4;    // two stages, P
  static constexpr int kSmem = GM * D * 4 + kWarps * kWarpBytes;      // q, warps
  static_assert(kChunks >= 1 && kChunks % kLanesPerToken == 0, "row split");
  static_assert(kTokens * kChunks % 32 == 0, "copies per lane");
  static_assert(2 * kStage >= GM * (D + 2) * 4, "merge rows fit a warp's stages");
  static_assert(GM % 4 == 0, "P rows are read as float4");
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // null unless the pages are int8
  const float* v_scale;
  const int* block_table;
  const int* lengths;
  void* out;             // (B, H, D), written by the split kernel when n_splits == 1
  float* part_ml;        // (n_splits, B, H, 2): max (log2 domain), sum
  float* part_acc;       // (n_splits, B, H, D): unnormalised accumulator
  int B, H, KVH, G, P, page, max_pages, pages_per_split, n_splits;
};

// (kThreads, 1): ptxas takes the registers an instantiation needs; without
// the 1 it stopped the bf16 D 16 G 16 one at 128 and spilled
template <typename QT, typename KVT, int D, int GM>
__global__ void __launch_bounds__(kThreads, 1) paged_attention_split_kernel(const Params a) {
  using T = Geo<KVT, D, GM>;
  constexpr bool kQuant = sizeof(KVT) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = min(a.lengths[b], a.max_pages * a.page);
  const int split_tokens = a.pages_per_split * a.page;
  const int sb = split * split_tokens;
  if (split > 0 && sb >= len) return;  // empty: the combine reads splits below ceil(len / split_tokens)
  const int se = min(sb + split_tokens, len);
  const int n_tiles = se > sb ? (se - sb + T::kTokens - 1) / T::kTokens : 0;

  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* wbase = smem + GM * D * 4 + warp * T::kWarpBytes;
  float* p_s = reinterpret_cast<float*>(wbase + 2 * T::kStage);
  const KVT* kg = static_cast<const KVT*>(a.k);
  const KVT* vg = static_cast<const KVT*>(a.v);
  const int* bt = a.block_table + static_cast<size_t>(b) * a.max_pages;
  const int tok = lane % T::kTokens;   // the token a lane scores
  const int part = lane / T::kTokens;  // which part of its row
  const int grp = lane / T::kLanesPerRow;              // token group in P·V
  const int d0 = (lane % T::kLanesPerRow) * T::kDimsPerLane;

  // copy tile `tile` of the split into stage `st` of this warp
  auto load_tile = [&](int tile, int st) {
    unsigned char* k_s = wbase + st * T::kStage;
    unsigned char* v_s = k_s + T::kTokens * T::kRow;
    float* ks_s = reinterpret_cast<float*>(v_s + T::kTokens * T::kRow);
    const int pos0 = sb + tile * T::kTokens;
    const int pos = pos0 + tok;
    long long row = 0;  // (page id * page + offset) * KVH + kvh: the token's row of D
    if (pos < se) {
      const int pid = min(max(bt[pos / a.page], 0), a.P - 1);
      row = (static_cast<long long>(pid) * a.page + pos % a.page) * a.KVH + kvh;
    }
#pragma unroll
    for (int it = 0; it < T::kTokens * T::kChunks / 32; ++it) {
      const int i = it * 32 + lane;
      const int t = i / T::kChunks;
      const int c = i % T::kChunks;
      const long long r = __shfl_sync(kFull, row, t);
      const bool valid = pos0 + t < se;
      cp_async16(k_s + t * T::kRow + c * 16, kg + r * D + c * T::kElems, valid);
      cp_async16(v_s + t * T::kRow + c * 16, vg + r * D + c * T::kElems, valid);
    }
    if constexpr (kQuant) {
      if (lane < T::kTokens) {
        cp_async4(ks_s + tok, a.k_scale + row, pos < se);
        cp_async4(ks_s + T::kTokens + tok, a.v_scale + row, pos < se);
      }
    }
  };

  if (warp < n_tiles) load_tile(warp, 0);
  cp_async_commit();
  // the group's query rows, pre-scaled by log2(e) / sqrt(D), so scores are
  // in the log2 domain; rows G..GM-1 are zero and never written out
  const float qscale = kLog2e * rsqrtf(static_cast<float>(D));
  const QT* qg = static_cast<const QT*>(a.q) +
                 (static_cast<size_t>(b) * a.H + static_cast<size_t>(kvh) * a.G) * D;
  for (int i = threadIdx.x; i < GM * D; i += kThreads) {
    q_s[i] = i < a.G * D ? to_float(qg[i]) * qscale : 0.f;
  }
  __syncthreads();

  float m[GM], l[GM], acc[GM][T::kDimsPerLane];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < T::kDimsPerLane; ++j) acc[g][j] = 0.f;
  }

  int stage = 0;
  for (int tile = warp; tile < n_tiles; tile += kWarps, stage ^= 1) {
    if (tile + kWarps < n_tiles) load_tile(tile + kWarps, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const unsigned char* k_s = wbase + stage * T::kStage;
    const unsigned char* v_s = k_s + T::kTokens * T::kRow;
    const float* ks_s = reinterpret_cast<const float*>(v_s + T::kTokens * T::kRow);

    // scores of this lane's token for every query row
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    const unsigned char* krow = k_s + tok * T::kRow + part * T::kChunksPerLane * 16;
#pragma unroll
    for (int c = 0; c < T::kChunksPerLane; ++c) {
      float kf[T::kElems];
      load_widen<KVT, T::kElems>(krow + c * 16, kf);
      const float* qd = q_s + (part * T::kChunksPerLane + c) * T::kElems;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int e = 0; e < T::kElems; e += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qd + g * D + e);
          s[g] = fmaf(qq.x, kf[e], s[g]);
          s[g] = fmaf(qq.y, kf[e + 1], s[g]);
          s[g] = fmaf(qq.z, kf[e + 2], s[g]);
          s[g] = fmaf(qq.w, kf[e + 3], s[g]);
        }
      }
    }
#pragma unroll
    for (int o = T::kTokens; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GM; ++g) s[g] += __shfl_xor_sync(kFull, s[g], o);
    }
    const bool valid = sb + tile * T::kTokens + tok < se;
    const float k_sc = kQuant ? ks_s[tok] : 1.f;
    const float v_sc = kQuant ? ks_s[T::kTokens + tok] : 1.f;

    // online softmax of this warp; the tile's first token is always valid,
    // so the tile maximum is finite and exp2(m_old - m_new) is 0 on the
    // warp's first tile
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float sg = valid ? s[g] * k_sc : -INFINITY;
      float mx = sg;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float corr = exp2f(m[g] - m_new);
      const float p = exp2f(sg - m_new);   // 0 for a masked token
      l[g] = l[g] * corr + (part == 0 ? p : 0.f);
#pragma unroll
      for (int j = 0; j < T::kDimsPerLane; ++j) acc[g][j] *= corr;
      m[g] = m_new;
      s[g] = p * v_sc;
    }
    if (part == 0) {
#pragma unroll
      for (int g = 0; g < GM; g += 4) {
        *reinterpret_cast<float4*>(p_s + tok * GM + g) =
            make_float4(s[g], s[g + 1], s[g + 2], s[g + 3]);
      }
    }
    __syncwarp();

    // P·V: this lane's dimensions of every row, over its token group
#pragma unroll
    for (int tt = 0; tt < T::kTokens / T::kTokenGroups; ++tt) {
      const int t = tt * T::kTokenGroups + grp;
      float vf[T::kDimsPerLane];
      load_widen<KVT, T::kDimsPerLane>(v_s + t * T::kRow + d0 * sizeof(KVT), vf);
#pragma unroll
      for (int g = 0; g < GM; g += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(p_s + t * GM + g);
#pragma unroll
        for (int j = 0; j < T::kDimsPerLane; ++j) {
          acc[g][j] = fmaf(p4.x, vf[j], acc[g][j]);
          acc[g + 1][j] = fmaf(p4.y, vf[j], acc[g + 1][j]);
          acc[g + 2][j] = fmaf(p4.z, vf[j], acc[g + 2][j]);
          acc[g + 3][j] = fmaf(p4.w, vf[j], acc[g + 3][j]);
        }
      }
    }
    __syncwarp();  // stage and P are free for the next tile's copies and scores
  }
  cp_async_wait<0>();
  __syncwarp();

  // this warp's totals: sums over lanes, accumulators over token groups;
  // written over the warp's own stages, which no copy targets any more
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l[g] += __shfl_xor_sync(kFull, l[g], o);
#pragma unroll
    for (int o = T::kLanesPerRow; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < T::kDimsPerLane; ++j) acc[g][j] += __shfl_xor_sync(kFull, acc[g][j], o);
    }
  }
  float* mw = reinterpret_cast<float*>(wbase);  // m[GM], l[GM], acc[GM][D]
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      mw[g] = m[g];
      mw[GM + g] = l[g];
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int j = 0; j < T::kDimsPerLane; ++j) mw[2 * GM + g * D + d0 + j] = acc[g][j];
    }
  }
  __syncthreads();

  // merge the four warps; a warp that took no tile has m = -inf and weighs 0
  const size_t head0 = static_cast<size_t>(b) * a.H + static_cast<size_t>(kvh) * a.G;
  for (int i = threadIdx.x; i < a.G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mx = fmaxf(mx, reinterpret_cast<const float*>(smem + GM * D * 4 + w * T::kWarpBytes)[g]);
    }
    float sum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* r = reinterpret_cast<const float*>(smem + GM * D * 4 + w * T::kWarpBytes);
      const float wt = r[g] > -INFINITY ? exp2f(r[g] - mx) : 0.f;
      sum = fmaf(wt, r[GM + g], sum);
      out = fmaf(wt, r[2 * GM + g * D + d], out);
    }
    if (a.n_splits == 1) {
      store(static_cast<QT*>(a.out) + (head0 + g) * D + d, out / fmaxf(sum, 1e-30f));
    } else {
      const size_t o = static_cast<size_t>(split) * a.B * a.H + head0 + g;
      a.part_acc[o * D + d] = out;
      if (d == 0) {
        a.part_ml[2 * o] = mx;
        a.part_ml[2 * o + 1] = sum;
      }
    }
  }
}

// Merges the live splits of each (slot, head): the Pallas kernel's guard
// (a split with m = -inf adds exactly 0), then divides by max(l, 1e-30).
template <typename QT>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine_kernel(const float* __restrict__ part_ml,
                               const float* __restrict__ part_acc,
                               const int* __restrict__ lengths, QT* __restrict__ out, int B,
                               int H, int D, int n_splits, int split_tokens, int reach) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t bh_count = static_cast<size_t>(B) * H;
  if (i >= bh_count * D) return;
  const size_t bh = i / D;
  const int d = static_cast<int>(i % D);
  const int len = min(lengths[bh / H], reach);
  const int n_live = min(max((len + split_tokens - 1) / split_tokens, 0), n_splits);
  float mx = -INFINITY;
  for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, part_ml[2 * (s * bh_count + bh)]);
  float sum = 0.f, acc = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const size_t o = s * bh_count + bh;
    const float m = part_ml[2 * o];
    const float wt = m > -INFINITY ? exp2f(m - mx) : 0.f;
    sum = fmaf(wt, part_ml[2 * o + 1], sum);
    acc = fmaf(wt, part_acc[o * D + d], acc);
  }
  store(out + i, acc / fmaxf(sum, 1e-30f));
}

template <typename QT, typename KVT, int D, int GM>
cudaError_t launch(const Params& a, cudaStream_t stream) {
  constexpr int smem = Geo<KVT, D, GM>::kSmem;
  auto kernel = paged_attention_split_kernel<QT, KVT, D, GM>;
  // above 48 KB a block's shared memory must be asked for, once per device
  // and instantiation (a host call, not a stream operation, so it also runs
  // under graph capture; asking twice from two threads is harmless)
  static std::atomic<bool> asked[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!asked[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    asked[dev].store(true, std::memory_order_release);
  }
  kernel<<<dim3(a.n_splits, a.KVH, a.B), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return err;
  const size_t n = static_cast<size_t>(a.B) * a.H * D;
  paged_attention_combine_kernel<QT><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                                       kThreads, 0, stream>>>(
      a.part_ml, a.part_acc, a.lengths, static_cast<QT*>(a.out), a.B, a.H, D, a.n_splits,
      a.pages_per_split * a.page, a.max_pages * a.page);
  return cudaGetLastError();
}

template <typename QT, typename KVT, int D>
cudaError_t launch_g(const Params& a, cudaStream_t stream) {
  if (a.G <= 4) return launch<QT, KVT, D, 4>(a, stream);
  if (a.G <= 8) return launch<QT, KVT, D, 8>(a, stream);
  return launch<QT, KVT, D, 16>(a, stream);
}

template <typename QT, typename KVT>
cudaError_t launch_d(int D, const Params& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_g<QT, KVT, 16>(a, stream);
    case 64: return launch_g<QT, KVT, 64>(a, stream);
    case 128: return launch_g<QT, KVT, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream` (the split kernel,
// then the combine kernel when max_pages needs more than one split of
// pages_per_split pages), does not synchronise, allocates nothing: the
// partials (part_ml (n_splits, B, H, 2) and part_acc (n_splits, B, H, D),
// fp32) are the caller's scratch, unused with one split. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a shape, type or
// alignment the kernels do not take).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                   const void* k_scale, const void* v_scale,
                                   const void* block_table, const void* lengths, void* out,
                                   void* part_ml, void* part_acc, int B, int H, int KVH, int D,
                                   int P, int page, int max_pages, int pages_per_split,
                                   int q_dtype, int kv_dtype, void* stream) {
  const bool quantized = kv_dtype == kI8;
  if (B <= 0 || B > 65535 || KVH <= 0 || KVH > 65535 || H % KVH != 0 ||
      H / KVH > kMaxGroup || page <= 0 || P <= 0 || max_pages <= 0 || pages_per_split <= 0 ||
      pages_per_split > max_pages ||
      static_cast<long long>(max_pages) * page > 0x7fffffffLL ||
      quantized != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr) ||
      reinterpret_cast<uintptr_t>(k_pages) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pages) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_splits = (max_pages + pages_per_split - 1) / pages_per_split;
  if (n_splits > 1 && (part_ml == nullptr || part_acc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale), static_cast<const int*>(block_table),
                 static_cast<const int*>(lengths), out, static_cast<float*>(part_ml),
                 static_cast<float*>(part_acc), B, H, KVH, H / KVH, P, page, max_pages,
                 pages_per_split, n_splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == kF32 && kv_dtype == kF32) err = launch_d<float, float>(D, a, s);
  else if (q_dtype == kBF16 && kv_dtype == kBF16) err = launch_d<bf16, bf16>(D, a, s);
  else if (q_dtype == kF32 && kv_dtype == kI8) err = launch_d<float, int8_t>(D, a, s);
  else if (q_dtype == kBF16 && kv_dtype == kI8) err = launch_d<bf16, int8_t>(D, a, s);
  return static_cast<int>(err);
}
