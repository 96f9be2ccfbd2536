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
// Both kernels below keep the Pallas body's online softmax exactly: running
// max m and sum l per query row, m_safe = max(m_new, NEG_INF / 2) so a row
// with nothing unmasked yet never computes -inf - -inf, the correction
// exp(m_old - m_safe) is 0 until the row has seen an unmasked key, and a
// row with no unmasked key at all writes 0. Each block owns a 64-row q tile
// and loops over K/V tiles of 64 keys (32 at D 128, see `Tile`) itself
// (the TPU grid's sequential key axis); the loop runs only over tiles that hold an unmasked key for some
// row of the q tile: it ends at min(Tk, q_end) when causal and starts at
// the window's first tile, which is how Hopper gets the Pallas kernel's
// `pl.when` tile skip. Ragged Tq and Tk are masked inside the block.
//
// Bound on this card: at prefill lengths the operations (4·D flops per
// unmasked query-key pair) against q, k, v and out each moved once; which
// of the two is larger depends on T (chip_smoke.py computes both).
//
// bf16: tensor cores (FlashAttention-2 layout, `mma.sync` m16n8k16).
//  * One 128-thread block per (64-row q tile, head, batch row); each of the
//    four warps owns 16 query rows. Q's A-fragments are read once from
//    global memory as bf16 pairs and stay in registers. The q tiles run
//    last first: causal, they walk the most key tiles.
//  * K and V tiles of 64 keys (32 at D 128) stream into shared memory with
//    16-byte `cp.async` copies, double-buffered, so tile i + 1 lands while
//    tile i is used. They stay bf16; each row is padded by 16 bytes, so the eight
//    rows one `ldmatrix` phase reads fall in eight different bank groups
//    (an unpadded 128-byte row stride conflicts 8 ways). Rows past Tk are
//    zero-filled by the copy (src-size 0) and masked.
//  * S = Q·Kᵀ: bf16 in, fp32 accumulate; K's B-fragments from `ldmatrix`.
//    A bf16 x bf16 product is exact in fp32, so S is the reference's fp32
//    score up to the order of summation.
//  * Softmax on the fp32 accumulator fragments: row max and row sum across
//    the four threads of a quad; p = 2^(s·sm_scale·log2e - m) by one FFMA
//    and one `ex2.approx`. The mask is applied only in the tiles an edge of
//    the warp's mask cuts (diagonal, window edge, ragged tail), as -inf, so
//    a masked p is exactly 0.
//  * P·V keeps P in fp32, as the reference does: each probability is split
//    into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and two `mma.sync`
//    accumulate p_hi·V and p_lo·V into one fp32 accumulator. The split
//    carries about 16 bits of p's mantissa (p_hi's 8 and p_lo's 8), so its
//    error is near 2^-17 of each product, far below the output's one bf16
//    rounding (2^-8). One bf16 term alone would round p at 2^-8 and move
//    about 40 % of the outputs by an ulp (tests/test_torch_flash_numerics.py
//    holds both on the CPU). The score product's C-fragment layout is the
//    A-fragment layout of the next product, so P never leaves registers;
//    V's B-fragments come from `ldmatrix.trans`.
//  * At D 16 and 64 at most 128 registers a thread, so four blocks share an
//    SM and a prefill group's 512 blocks (B 8, H 32, T 128) run in one
//    wave. At D 128 a warp's 16 x 128 fp32 output accumulator alone takes
//    64 registers a thread and Q's fragments 32 more, so the bound is two
//    blocks an SM (255 registers); ptxas's report in chip_smoke.py's build
//    phase shows what each instantiation uses and whether it spills.
//  The unrolled tile body has no branch but the mask's: branches there cut
//  it into blocks the compiler schedules one by one, which cost more than
//  the masked work they skipped. The bf16 work is 1.5x the bound's (the
//  split doubles P·V). `wgmma` fed by TMA is the route to the card's full
//  tensor-core rate.
//
// f32: CUDA cores. Tensor cores would need a three-term TF32 split of q, k,
// v and p to stay exact in fp32, and this design already beats the PyTorch
// library call in f32 (PERF.md). Two threads per query row, each holding
// the row's q in registers, scoring every other key of the tile and owning
// half of the output row's D columns; K and V land in shared memory as
// fp32 (row stride D + 4, read as float4).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block

// `key_tile`: keys per shared-memory tile, 64, or 32 at D 128. A 64-key K/V
// ring at D 128 (69,632 bytes in bf16, 67,584 in f32) would pass the 48 KB
// a block may take statically; 32 keys keep it at 34,816 and 33,792 bytes, with no
// dynamic shared memory and so no attribute to set before the first launch
// (which may come inside a CUDA graph capture), and halve the S tile's
// registers beside the 64-register output accumulator. `min_blocks`: the
// bf16 kernel's blocks an SM, so 128 registers a thread, or 255 at D 128.
template <int D>
struct Tile {
  static constexpr int key_tile = D <= 64 ? 64 : 32;
  static constexpr int min_blocks = D <= 64 ? 4 : 2;
};
constexpr float kNegInf = -1e30f;       // the Pallas kernel's NEG_INF

enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  int H, KVH, Tq, Tk;
  long long qsb, qsh, qst;  // element strides of batch, head, token
  long long ksb, ksh, kst;
  long long vsb, vsh, vst;
  long long osb, osh, ost;
  int causal, window;
  float sm_scale;
};

// ----------------------------------------------------------------------
// f32: CUDA cores
// ----------------------------------------------------------------------

constexpr int kF32Threads = 2 * kBQ;    // two threads per query row

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, Args a) {
  constexpr int kBK = Tile<D>::key_tile;
  constexpr int kKeysPerThread = kBK / 2;
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
    const float* qp = q + b * a.qsb + h * a.qsh + static_cast<long long>(qi) * a.qst;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = row_ok ? qp[d] : 0.f;
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
  const float* kb = k + b * a.ksb + kvh * a.ksh;
  const float* vb = v + b * a.vsb + kvh * a.vsh;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    // unrolled, so each thread has several loads in flight at once
#pragma unroll 8
    for (int r = 0; r < kBK * D / kF32Threads; ++r) {
      const int i = tid + r * kF32Threads;
      const int t = i / D;
      const int d = i % D;
      const int kj = k0 + t;
      float kv = 0.f;
      float vv = 0.f;
      if (kj < a.Tk) {
        kv = kb[static_cast<long long>(kj) * a.kst + d];
        vv = vb[static_cast<long long>(kj) * a.vst + d];
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
    // P·V over the tile's keys: this thread's probabilities and its partner's
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
    float* op = out + b * a.osb + h * a.osh + static_cast<long long>(qi) * a.ost + half * kHalfD;
#pragma unroll
    for (int d = 0; d < kHalfD; ++d) op[d] = acc[d] / lsafe;
  }
}

// ----------------------------------------------------------------------
// bf16: tensor cores
// ----------------------------------------------------------------------

constexpr int kWarps = kBQ / 16;        // each warp owns 16 query rows
constexpr int kMmaThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with valid false it reads nothing and
// zero-fills the destination (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}

// c += a · b for one m16n8k16 tile: bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (ex2.approx: relative error near 2^-22,
// results below 2^-126 flushed to 0), far inside the split's 2^-17
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair (round to nearest), `lo` in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// p0, p1 as p_hi = bf16(p) and p_lo = bf16(p - p_hi), each a packed pair
__device__ __forceinline__ void split_bf16(float p0, float p1, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(p0, p1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, Tile<D>::min_blocks)
flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out, Args a) {
  constexpr int kBK = Tile<D>::key_tile;
  constexpr int kStride = D + 8;        // padded row, in elements: 16 bytes more
  constexpr int kChunks = D / 8;        // 16-byte pieces of a row
  constexpr int kCopies = kBK * kChunks / kMmaThreads;  // per thread per tile
  constexpr int kKD = D / 16;           // k-steps of Q·Kᵀ
  constexpr int kNK = kBK / 8;          // 8-key column blocks of S
  constexpr int kND = D / 8;            // 8-column blocks of the output
  static_assert(kCopies >= 1 && kBK * kChunks % kMmaThreads == 0 && D % 16 == 0,
                "tile shape");
  __shared__ __align__(16) bf16 k_s[2][kBK * kStride];
  __shared__ __align__(16) bf16 v_s[2][kBK * kStride];

  // the last q tiles first: causal, they have the most key tiles to walk
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;               // row within an 8-row half of a fragment
  const int t4 = lane & 3;               // thread within the quad
  const int row0 = q_start + 16 * warp;  // the warp's first query row

  const bf16* qb = q + b * a.qsb + h * a.qsh;
  const bf16* kb = k + b * a.ksb + kvh * a.ksh;
  const bf16* vb = v + b * a.vsb + kvh * a.vsh;

  // rows [r0, r0 + kBK) of one (T, D) slab into a padded shared tile
  auto load_tile = [&](bf16* dst, const bf16* src, long long st, int r0, int rows) {
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int c = tid + i * kMmaThreads;
      const int r = c / kChunks;
      const int ch = c % kChunks;
      const bool ok = r0 + r < rows;
      cp_async16(dst + r * kStride + ch * 8,
                 ok ? src + static_cast<long long>(r0 + r) * st + ch * 8 : src, ok);
    }
  };

  // tiles holding an unmasked key for some row of [q_start, q_start + kBQ)
  const int k_hi = a.causal ? min(a.Tk, q_start + kBQ) : a.Tk;
  const int k_lo = a.window > 0 ? max(0, q_start - a.window + 1) / kBK * kBK : 0;
  if (k_lo < k_hi) {
    load_tile(k_s[0], kb, a.kst, k_lo, a.Tk);
    load_tile(v_s[0], vb, a.vst, k_lo, a.Tk);
  }
  cp_async_commit();

  // Q's A-fragments straight from global memory (bf16 pairs, read once,
  // zero past Tq) while the first K/V tile lands: a0..a3 hold rows g,
  // g + 8, g, g + 8 at columns 2·t4 (+ 8 for a2, a3) of each k-step
  unsigned qf[kKD][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + g + 8 * (i & 1);
    const bf16* qp = qb + static_cast<long long>(row) * a.qst + 2 * t4 + 8 * (i >> 1);
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      qf[kk][i] = row < a.Tq ? *reinterpret_cast<const unsigned*>(qp + 16 * kk) : 0u;
    }
  }

  // row row0 + 8·r + g keeps keys key_lo[r] <= j <= key_hi[r]; a row past
  // Tq none
  int key_lo[2];
  int key_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r + g;
    key_hi[r] = qi >= a.Tq ? -1 : (a.causal ? min(qi, a.Tk - 1) : a.Tk - 1);
    key_lo[r] = a.window > 0 ? qi - a.window + 1 : 0;
  }
  // keys that every row of the warp keeps (rows past Tq are never written,
  // so they need no mask)
  const int full_hi = a.causal ? min(row0, a.Tk - 1) : a.Tk - 1;
  const int full_lo = a.window > 0 ? row0 + 16 - a.window : 0;

  float o[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};      // running max, log2 domain
  float l[2] = {0.f, 0.f};
  const float scale2 = a.sm_scale * kLog2e;  // scores to the log2 domain

  int buf = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK, buf ^= 1) {
    if (k0 + kBK < k_hi) {  // the next tile lands while this one is used
      load_tile(k_s[buf ^ 1], kb, a.kst, k0 + kBK, a.Tk);
      load_tile(v_s[buf ^ 1], vb, a.vst, k0 + kBK, a.Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = k_s[buf];
    const bf16* vs = v_s[buf];

    // S = Q·Kᵀ, two 8-key column blocks per ldmatrix
    float s[kNK][4];
#pragma unroll
    for (int j = 0; j < kNK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < kNK / 2; ++jp) {
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk) {
        unsigned kf[4];
        ldmatrix_x4(kf, &ks[(16 * jp + (lane & 7) + ((lane >> 4) << 3)) * kStride + 16 * kk +
                            ((lane >> 3) & 1) * 8]);
        mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // mask, only in the tiles an edge of the warp's mask cuts: a masked raw
    // score becomes -inf, so its probability below is ex2(-inf) = 0 exactly,
    // as the Pallas body's where(mask, p, 0), also in a row that has seen
    // no unmasked key (m_safe finite)
    if (k0 < full_lo || k0 + kBK - 1 > full_hi) {
#pragma unroll
      for (int j = 0; j < kNK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
          if (kj < key_lo[e >> 1] || kj > key_hi[e >> 1]) s[j][e] = -INFINITY;
        }
      }
    }
    // row max across the quad on the raw scores; then the running max in
    // the log2 domain (scores times sm_scale·log2e) and the correction
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
    float neg_m[2];
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] > kNegInf ? mx[r] * scale2 : kNegInf);
      const float m_safe = fmaxf(m_new, kNegInf / 2);
      corr[r] = m[r] > kNegInf / 2 ? fast_exp2(fmaxf(m[r], kNegInf / 2) - m_safe) : 0.f;
      neg_m[r] = -m_safe;
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // 16 keys at a time: P in fp32 (one FFMA and one ex2 per score), as
    // two bf16 terms in the A-fragment layout, then O += p_hi·V + p_lo·V
    // with two output column blocks per ldmatrix.trans
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned ahi[4];
      unsigned alo[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p0 = fast_exp2(fmaf(s[j][2 * r], scale2, neg_m[r]));
          const float p1 = fast_exp2(fmaf(s[j][2 * r + 1], scale2, neg_m[r]));
          sum[r] += p0 + p1;
          split_bf16(p0, p1, ahi[2 * jj + r], alo[2 * jj + r]);
        }
      }
#pragma unroll
      for (int np = 0; np < kND / 2; ++np) {
        unsigned vf[4];
        ldmatrix_x4_trans(vf, &vs[(16 * kk + (lane & 15)) * kStride + 16 * np + (lane >> 4) * 8]);
        mma_bf16(o[2 * np], ahi, vf[0], vf[1]);
        mma_bf16(o[2 * np], alo, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], ahi, vf[2], vf[3]);
        mma_bf16(o[2 * np + 1], alo, vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
    __syncthreads();  // this buffer is refilled by the next iteration's prefetch
  }

  bf16* ob = out + b * a.osb + h * a.osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r + g;
    if (qi < a.Tq) {
      const float lsafe = fmaxf(l[r], 1e-30f);
      bf16* op = ob + static_cast<long long>(qi) * a.ost + 2 * t4;
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        *reinterpret_cast<unsigned*>(op + 8 * n) =
            pack_bf16(o[n][2 * r] / lsafe, o[n][2 * r + 1] / lsafe);
      }
    }
  }
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* out, int B,
                   const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.H, B);
  if (dtype == kF32) {
    flash_attention_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), a);
  } else if (dtype == kBF16) {
    flash_attention_bf16_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape or type the kernel does not take).
// `strides` holds 12 element strides: (batch, head, token) of q, k, v
// and out, in that order; the stride along D is 1 for all four. For bf16
// the bases and the strides must be 16-byte aligned (the wrapper checks).
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
  switch (D) {
    case 16: return static_cast<int>(launch<16>(dtype, q, k, v, out, B, a, s));
    case 64: return static_cast<int>(launch<64>(dtype, q, k, v, out, B, a, s));
    case 128: return static_cast<int>(launch<128>(dtype, q, k, v, out, B, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
