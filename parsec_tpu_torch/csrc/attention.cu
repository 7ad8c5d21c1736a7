// Hand-written Hopper (sm_90a) tensor-core kernel for the flash-attention step.
//
// Replaces the Pallas TPU kernel flash_attention_block (B5) of
// parsec_tpu/ops/pallas_kernels.py: one online-softmax block update
//
//   logits = (q @ k^T) * scale
//   causal:  logits[r, c] = -inf  where  q_off + r < k_off + c
//   m'   = max(m, rowmax(logits))
//   p    = exp(logits - m'),  corr = exp(m - m')
//   l'   = l * corr + rowsum(p)
//   acc' = acc * corr + p @ v
//
// for q (Sq, D), k and v (Sk, D) in f32 or bf16, and an f32 carry acc
// (Sq, D), m and l (Sq, 1).
//
// What it computes, not how the TPU did it: the Pallas kernel keeps a whole
// (bq, Sk) logits tile in VMEM and reduces it at once.  Here one block of
// four warps owns 16 query rows (one mma row tile).  K and V stream through
// shared memory in chunks of 64 keys with cp.async, three stages deep
// (chunks c+1 and c+2 are in flight while chunk c is multiplied; f32 at
// D = 256 takes 32-key chunks and two stages to fit); within a chunk warp
// w takes keys [16w, 16w+16) (f32, D = 256: [8w, 8w+8)).  The incoming
// carry rides with chunk 0 into shared memory, so the combine at the end
// waits on no load.  Each warp keeps its own partial carry for its
// key slices -- a running max m_w that starts at the incoming m, a sum l_w
// and an accumulator acc_w (16 x D, f32 registers) that start at 0 -- and
// at the end the block combines them through shared memory in warp order
// 0, 1, 2, 3:
//
//   m'   = max_w m_w
//   l'   = l_in * exp(m_in - m') + sum_w l_w * exp(m_w - m')
//   acc' = acc_in * exp(m_in - m') + sum_w acc_w * exp(m_w - m')
//
// The order is fixed and there are no atomics, so two launches on the same
// inputs agree bit for bit.
//
// Both products run on the tensor cores with warp-level mma.sync, and
// every k step's passes go into fresh register tiles that are added to the
// f32 total once (the tensor core's own accumulation over many additions
// is what costs accuracy, PERF.md):
//   * bf16: q.k^T is one pass of m16n8k16 bf16 (products exact in f32, as
//     the reference's astype(float32) dot).  p is f32, so p.v splits p into
//     a bf16 hi and lo (round to nearest even, lo = p - hi) and runs two
//     passes, lo.v then hi.v; two adjacent n8 accumulator tiles of q.k^T are
//     the A fragment of one k16 step, so p never leaves registers.  K is the
//     "col" B operand as it lies (ldmatrix), V through ldmatrix.trans.
//   * f32: three TF32 passes of m16n8k8 for both products, hi = tf32(x)
//     rounded to nearest (ties away, cvt.rna's rounding) with the low 13
//     bits cleared and lo = tf32(x - hi) -- the recipe of csrc/matmul.cu.
//     The small terms hi.lo and lo.hi go into one tile, hi.hi into another
//     (two short mma chains instead of one of three).  Every element of k
//     and v is split by the one warp that reads it; q is split once.  The k
//     index of each m16n8k8 is permuted (slot t holds element 2t, slot t+4
//     element 2t+1; a sum does not depend on its order) so that q and k
//     fragments are 8-byte shared loads and p's accumulator fragment
//     (columns 2t, 2t+1) is its own A fragment, with no shuffles.
//
// Exact no-op cases.  A key masked out has the logit -inf before the max
// and contributes exp(-inf - m) = 0; m_w starts at the incoming m (finite:
// the carry init is -1e30), so no path computes (-inf) - (-inf).  A key
// slice in the future of all 16 rows is skipped by its warp, and a chunk in
// the future of the block's last row ends the loop.  A fully masked block
// therefore leaves every m_w at m_in: every factor is exp(0) = 1 and every
// partial 0, and the carry comes back bit-identical.  expf, not __expf,
// and no --use_fast_math: exp(0) must be exactly 1.
//
// What bounds it on an H100: at the path's block, 512 x 512 x 128, f32 is
// three TF32 passes of 4 * 512 * 512 * 128 operations (>= 0.81 us at 495
// TFLOP/s) and moves ~1.3 MB (0.4 us at 3.35 TB/s); bf16 moves ~0.9 MB and
// is byte-bound (0.28 us).  This design is the simple one: 32 blocks for
// 512 query rows put one warp on each scheduler of 32 SMs, so the time is
// the latency of each warp's own chain of loads, mma.sync and softmax, not
// a rate of the card.  A split over keys across blocks (more warps to hide
// that latency), TMA and wgmma are the next steps.
//
// Heads wider than 256 (D > D_ENGINE) take the wide kernel below, chosen
// by dispatch_d before launch: the mma.sync engine keeps a 16 x D f32
// accumulator per warp in registers and a K/V chunk per stage in shared
// memory, and neither fits at D = 512.
//
// Interface: a plain C entry point bound with ctypes; it launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// launch's cudaError_t (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 16;                 // query rows per block: one mma row tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int D_ENGINE = 256;        // widest head of the mma.sync engine
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a block may opt in to

template <typename T, int DMAX>
struct Traits {
  static constexpr bool F32 = std::is_same<T, float>::value;
  // shared-memory element: f32 values, or bf16 bits
  using Bits = std::conditional_t<F32, float, uint16_t>;
  // keys per chunk and per warp slice: 64 and 16; f32 at D = 256 takes 32
  // and 8, so that two stages fit
  static constexpr int BKC = F32 && DMAX == 256 ? 32 : 64;
  static constexpr int KW = BKC / WARPS;
  static constexpr int KSTEP = F32 ? 8 : 16;  // k depth of one mma
  // row pitches in elements, chosen so that every fragment load is free of
  // bank conflicts: 8-byte q/k loads (f32) and ldmatrix rows (bf16) want a
  // pitch of 8 words mod 32, the f32 v loads one of 4
  static constexpr int QP = DMAX + 8;
  static constexpr int KP = DMAX + 8;
  static constexpr int VP = F32 ? DMAX + 4 : DMAX + 8;
  static constexpr int CP = DMAX + 8;         // combine tile (f32)
  static constexpr int ESZ = sizeof(Bits);
  static constexpr int Q_BYTES = (F32 ? 2 : 1) * BQ * QP * ESZ;  // f32: hi and lo
  // the incoming carry of the block's rows, fetched with chunk 0: acc
  // [BQ][CP], then m and l [BQ]
  static constexpr int CARRY_BYTES = (BQ * CP + 2 * BQ) * 4;
  static constexpr int K_BYTES = BKC * KP * ESZ;
  static constexpr int STAGE_BYTES = K_BYTES + BKC * VP * ESZ;
  // chunks in flight: load c+1 and c+2 while c is multiplied; f32 at
  // D = 256 keeps two stages to fit
  static constexpr int STAGES = F32 && DMAX == 256 ? 2 : 3;
  static constexpr int SMEM = Q_BYTES + CARRY_BYTES + STAGES * STAGE_BYTES;
  // the combine reuses the stages: partial accumulators, m_w, l_w and the
  // WARPS + 1 factors of each row
  static constexpr int COMBINE_BYTES = (WARPS * BQ * CP + 2 * WARPS * BQ + (WARPS + 1) * BQ) * 4;
  static_assert(KW % 8 == 0 && (F32 || KW == 16), "a warp slice is whole n8 tiles (k16 in bf16)");
  static_assert(Q_BYTES % 16 == 0 && CARRY_BYTES % 16 == 0 && K_BYTES % 16 == 0 &&
                    STAGE_BYTES % 16 == 0,
                "every tile starts 16-byte aligned");
  static_assert(COMBINE_BYTES <= STAGES * STAGE_BYTES, "the combine tile fits in the stages");
  static_assert(SMEM <= SMEM_LIMIT, "the tiles fit the shared memory of one block");
};

// -- primitives -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with a source size: bytes past it (all of them for 0) are zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += A (16 x k) @ B (k x 8); A row-major in a[], B column-major in b0, b1
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// tf32 by round-to-nearest, ties away from zero, low 13 bits cleared: what
// cvt.rna.tf32.f32 gives, as two integer operations (half a TF32 ulp added
// to the magnitude bits, then truncated) instead of a conversion, which
// issues at a fraction of the integer rate.  hi is exact in TF32 and x - hi
// exact in f32.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi), x0 in the low half
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + ROWS) of a row-major (n, d) operand into shared memory
// at dst (row pitch PITCH elements), all DMAX columns: zeros past d and
// past row n, so that every product runs over DMAX columns with no bound
// known only at run time.  vec: 16-byte cp.async (the row pitch and the
// base are 16-byte multiples, so a unit lies wholly in or out of range);
// else predicated 4-byte cp.async (f32) or 2-byte copies (bf16).
template <typename Bits, int ROWS, int DMAX, int PITCH>
__device__ __forceinline__ void load_tile(Bits* dst, const Bits* __restrict__ src, int row0,
                                          int n, int d, bool vec, int tid) {
  if (vec) {
    constexpr int VEC = 16 / sizeof(Bits), UNITS = DMAX / VEC;
    static_assert(ROWS * UNITS % THREADS == 0, "a tile's units divide among the threads");
#pragma unroll
    for (int i = 0; i < ROWS * UNITS / THREADS; ++i) {
      const int u = tid + i * THREADS, r = u / UNITS, c = u % UNITS * VEC;
      const bool ok = row0 + r < n && c < d;
      const Bits* p = ok ? src + int64_t(row0 + r) * d + c : src;
      cp_async16(smem_u32(dst + r * PITCH + c), p, ok ? 16 : 0);
    }
    return;
  }
  static_assert(ROWS * DMAX % THREADS == 0, "a tile's elements divide among the threads");
#pragma unroll 4
  for (int i = 0; i < ROWS * DMAX / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / DMAX, c = e % DMAX;
    const bool ok = row0 + r < n && c < d;
    if constexpr (sizeof(Bits) == 4) {
      const Bits* p = ok ? src + int64_t(row0 + r) * d + c : src;
      cp_async4(smem_u32(dst + r * PITCH + c), p, ok ? 4 : 0);
    } else {
      dst[r * PITCH + c] = ok ? src[int64_t(row0 + r) * d + c] : Bits(0);
    }
  }
}

// -- the kernel -------------------------------------------------------------

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_block_kernel(int sq, int sk, int d, const void* __restrict__ qv,
                   const void* __restrict__ kv, const void* __restrict__ vv,
                   const float* __restrict__ acc_in, const float* __restrict__ m_in,
                   const float* __restrict__ l_in, float* __restrict__ acc_out,
                   float* __restrict__ m_out, float* __restrict__ l_out, long long q_off,
                   long long k_off, int causal, float scale, int vec_q, int vec_kv,
                   int vec_acc) {
  using Tr = Traits<T, DMAX>;
  using Bits = typename Tr::Bits;
  constexpr int BKC = Tr::BKC, KW = Tr::KW, KSTEP = Tr::KSTEP, STAGES = Tr::STAGES;
  constexpr int QP = Tr::QP, KP = Tr::KP, VP = Tr::VP, CP = Tr::CP;
  constexpr int NJ = KW / 8;    // n8 tiles of keys in a warp slice
  constexpr int NT = DMAX / 8;  // n8 tiles of the accumulator

  extern __shared__ __align__(16) uint8_t smem[];
  float* carry = reinterpret_cast<float*>(smem + Tr::Q_BYTES);  // acc_in, m_in, l_in
  uint8_t* stages = smem + Tr::Q_BYTES + Tr::CARRY_BYTES;
  auto k_stage = [&](int st) { return reinterpret_cast<Bits*>(stages + st * Tr::STAGE_BYTES); };
  auto v_stage = [&](int st) { return k_stage(st) + BKC * KP; };

  const Bits* q = static_cast<const Bits*>(qv);
  const Bits* k = static_cast<const Bits*>(kv);
  const Bits* v = static_cast<const Bits*>(vv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the fragment's row group and column pair
  const int row0 = blockIdx.x * BQ;

  // chunks to visit: a chunk starting after the block's last query position
  // is masked for every row, and so is every later chunk
  const long long q_last = q_off + (long long)min(row0 + BQ, sq) - 1;
  int nchunks = (sk + BKC - 1) / BKC;
  if (causal) {
    const long long lim = q_last - k_off;
    if (lim < 0) nchunks = 0;
    else if (lim / BKC + 1 < nchunks) nchunks = int(lim / BKC + 1);
  }

  // the first STAGES - 1 chunks in flight; with chunk 0, the incoming carry
  // (read only by the combine) and q in bf16
  load_tile<float, BQ, DMAX, CP>(carry, acc_in, row0, sq, d, vec_acc, tid);
  if (tid < 2 * BQ) {
    const int r = tid % BQ;
    const bool ok = row0 + r < sq;
    const float* src = tid < BQ ? m_in : l_in;
    cp_async4(smem_u32(carry + BQ * CP + tid), ok ? src + row0 + r : src, ok ? 4 : 0);
  }
  if constexpr (!Tr::F32)
    load_tile<Bits, BQ, DMAX, QP>(reinterpret_cast<Bits*>(smem), q, row0, sq, d, vec_q, tid);
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nchunks) {
      load_tile<Bits, BKC, DMAX, KP>(k_stage(p), k, p * BKC, sk, d, vec_kv, tid);
      load_tile<Bits, BKC, DMAX, VP>(v_stage(p), v, p * BKC, sk, d, vec_kv, tid);
    }
    cp_async_commit();
  }
  // f32 q, split once into TF32 hi and lo while those copies fly
  if constexpr (Tr::F32) {
    uint32_t* qh = reinterpret_cast<uint32_t*>(smem);
    uint32_t* ql = qh + BQ * QP;
#pragma unroll
    for (int i = tid; i < BQ * DMAX; i += THREADS) {
      const int r = i / DMAX, c = i % DMAX;
      const float x = row0 + r < sq && c < d ? q[int64_t(row0 + r) * d + c] : 0.f;
      split_tf32(x, qh[r * QP + c], ql[r * QP + c]);
    }
  }

  // this thread's rows of the warp's partial carry: g and g + 8
  float m_w[2], l_w[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) m_w[h] = row0 + g + 8 * h < sq ? m_in[row0 + g + 8 * h] : 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int c = 0, st = 0; c < nchunks; ++c, st = st + 1 == STAGES ? 0 : st + 1) {
    const int kc = c * BKC;
    cp_async_wait<STAGES - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();  // ... every thread's, and every warp is done with chunk c - 1
    if (c + STAGES - 1 < nchunks) {  // into chunk c - 1's stage
      const int nst = st == 0 ? STAGES - 1 : st - 1;
      const int kn = kc + (STAGES - 1) * BKC;
      load_tile<Bits, BKC, DMAX, KP>(k_stage(nst), k, kn, sk, d, vec_kv, tid);
      load_tile<Bits, BKC, DMAX, VP>(v_stage(nst), v, kn, sk, d, vec_kv, tid);
    }
    cp_async_commit();

    const int k0 = kc + KW * warp;  // the warp's first key
    if (k0 >= sk || (causal && q_last < k_off + k0)) continue;
    const Bits* kb = k_stage(st) + KW * warp * KP;
    const Bits* vb = v_stage(st) + KW * warp * VP;

    // s = q @ k^T for the slice: NJ n8 tiles, c-fragment (row g + 8h,
    // key 8j + 2t + e)
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    if constexpr (Tr::F32) {
      const uint32_t* qh = reinterpret_cast<const uint32_t*>(smem);
      const uint32_t* ql = qh + BQ * QP;
#pragma unroll
      for (int kk = 0; kk < DMAX; kk += KSTEP) {
        const int col = kk + 2 * t;  // slots t and t + 4 hold columns 2t and 2t + 1
        const uint2 h0 = *reinterpret_cast<const uint2*>(qh + g * QP + col);
        const uint2 h1 = *reinterpret_cast<const uint2*>(qh + (g + 8) * QP + col);
        const uint2 l0 = *reinterpret_cast<const uint2*>(ql + g * QP + col);
        const uint2 l1 = *reinterpret_cast<const uint2*>(ql + (g + 8) * QP + col);
        const uint32_t ah[4] = {h0.x, h1.x, h0.y, h1.y};
        const uint32_t al[4] = {l0.x, l1.x, l0.y, l1.y};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 x = *reinterpret_cast<const float2*>(kb + (8 * j + g) * KP + col);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(x.x, bh0, bl0);
          split_tf32(x.y, bh1, bl1);
          float dlo[4] = {0.f, 0.f, 0.f, 0.f}, dhi[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(dlo, ah, bl0, bl1);
          mma_tf32(dlo, al, bh0, bh1);
          mma_tf32(dhi, ah, bh0, bh1);
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] += dlo[i] + dhi[i];
        }
      }
    } else {
      const Bits* qs = reinterpret_cast<const Bits*>(smem);
      // ldmatrix row addresses: q rows 0-15 at columns 0 / 8; k keys 0-7
      // then 8-15, each at columns 0 and 8
      const uint32_t qa = smem_u32(qs + (lane & 15) * QP + (lane >> 4) * 8);
      const uint32_t ka = smem_u32(kb + ((lane & 7) + (lane >> 4) * 8) * KP + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int kk = 0; kk < DMAX; kk += KSTEP) {
        uint32_t a[4], b[4];
        ldsm_x4(a, qa + kk * 2);
        ldsm_x4(b, ka + kk * 2);
        float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d0, a, b[0], b[1]);
        mma_bf16(d1, a, b[2], b[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[0][i] += d0[i];
          s[1][i] += d1[i];
        }
      }
    }

    // scale and mask, then the slice's online-softmax step
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 8 * j + 2 * t + (i & 1);
        const long long qpos = q_off + row0 + g + 8 * (i >> 1);
        const bool keep = key < sk && (!causal || qpos >= k_off + key);
        s[j][i] = keep ? s[j][i] * scale : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    float corr[2], m_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_w[h], quad_max(mx[h]));
      corr[h] = expf(m_w[h] - m_new[h]);
      m_w[h] = m_new[h];
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = expf(s[j][i] - m_new[i >> 1]);
        psum[i >> 1] += s[j][i];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_w[h] = l_w[h] * corr[h] + psum[h];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc_w += p @ v
    if constexpr (Tr::F32) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        // slots t and t + 4 of this k8 step are keys 8j + 2t and 8j + 2t + 1:
        // the accumulator fragment as it is
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const Bits* vr = vb + (8 * j + 2 * t) * VP + g;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vr[8 * n], bh0, bl0);
          split_tf32(vr[VP + 8 * n], bh1, bl1);
          float dlo[4] = {0.f, 0.f, 0.f, 0.f}, dhi[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(dlo, ph, bl0, bl1);
          mma_tf32(dlo, pl, bh0, bh1);
          mma_tf32(dhi, ph, bh0, bh1);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] += dlo[i] + dhi[i];
        }
      }
    } else {
      // the k16 A fragment: tile 0 holds keys 2t, 2t + 1, tile 1 keys
      // 8 + 2t, 8 + 2t + 1
      uint32_t ph[4], pl[4];
      split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
      split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
      split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
      split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
      // ldmatrix.trans row addresses: keys 0-7 then 8-15, at columns 0 then 8
      const uint32_t va = smem_u32(vb + ((lane & 7) + ((lane >> 3) & 1) * 8) * VP + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, va + np * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float dd[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(dd, pl, b[2 * h], b[2 * h + 1]);
          mma_bf16(dd, ph, b[2 * h], b[2 * h + 1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[2 * np + h][i] += dd[i];
        }
      }
    }
  }

  // -- the combine, through shared memory in warp order --------------------
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages
  float* cacc = reinterpret_cast<float*>(stages);               // [WARPS][BQ][CP]
  float* cm = cacc + WARPS * BQ * CP;                             // [WARPS][BQ]
  float* cl = cm + WARPS * BQ;                                    // [WARPS][BQ]
  float* fac = cl + WARPS * BQ;                                   // [WARPS + 1][BQ]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lsum = quad_sum(l_w[h]);
    if (t == 0) {
      cm[warp * BQ + g + 8 * h] = m_w[h];
      cl[warp * BQ + g + 8 * h] = lsum;
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float* p = cacc + (warp * BQ + g) * CP + 8 * n + 2 * t;
    *reinterpret_cast<float2*>(p) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(p + 8 * CP) = make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  if (tid < BQ && row0 + tid < sq) {
    const int r = tid, gr = row0 + tid;
    const float mi = carry[BQ * CP + r];
    float mp = mi;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mp = fmaxf(mp, cm[w * BQ + r]);
    const float ei = expf(mi - mp);
    float lp = carry[BQ * CP + BQ + r] * ei;
    fac[r] = ei;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(cm[w * BQ + r] - mp);
      fac[(w + 1) * BQ + r] = e;
      lp += cl[w * BQ + r] * e;
    }
    m_out[gr] = mp;
    l_out[gr] = lp;
  }
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < BQ * DMAX; i += THREADS) {
    const int r = i / DMAX, col = i % DMAX;
    if (row0 + r >= sq || col >= d) continue;
    float a = carry[r * CP + col] * fac[r];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += cacc[(w * BQ + r) * CP + col] * fac[(w + 1) * BQ + r];
    acc_out[int64_t(row0 + r) * d + col] = a;
  }
}

template <typename T, int DMAX>
cudaError_t launch(int sq, int sk, int d, const void* q, const void* k, const void* v,
                   const float* acc, const float* m, const float* l, float* acc_o, float* m_o,
                   float* l_o, long long q_off, long long k_off, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int smem = Traits<T, DMAX>::SMEM;
  auto kern = flash_block_kernel<T, DMAX>;
  // dynamic shared memory above the 48 KB default: opted in once per
  // instantiation (a thread-safe static), for the device current at the
  // first launch -- the port drives one device
  static const cudaError_t opted =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opted != cudaSuccess) return opted;
  // 16-byte copies where the row pitch and the base are 16-byte multiples
  const bool pitch16 = size_t(d) * sizeof(T) % 16 == 0;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_q = pitch16 && aligned(q);
  const int vec_kv = pitch16 && aligned(k) && aligned(v);
  const int vec_acc = d % 4 == 0 && aligned(acc);
  kern<<<(sq + BQ - 1) / BQ, THREADS, smem, stream>>>(sq, sk, d, q, k, v, acc, m, l, acc_o, m_o,
                                                      l_o, q_off, k_off, causal, scale, vec_q,
                                                      vec_kv, vec_acc);
  return cudaGetLastError();
}

// -- the wide kernel (D > D_ENGINE) -----------------------------------------
//
// A simple FP32 design, for heads the mma.sync engine cannot hold.  The
// grid is (query blocks of WBQ rows) x (output column slabs of WCW): each
// block forms its rows' logits over the full D with FP32 FMA, looping over
// D in slabs of WDS columns staged (transposed) in shared memory, then
// applies the online softmax chunk by chunk and accumulates p.v for its
// own WCW columns only.  Every slab block of a row block runs the same
// logits arithmetic in the same order on the same data, so m and l agree
// bit for bit across the slabs; slab 0 writes them.  The logits are
// computed once per slab block (D / WCW times in all): at D = 512 that
// multiplies the q.k work by four, which is what keeps the design simple.
// Sums are blocked as a library GEMM's are: each D slab's logits and each
// chunk's p.v go into fresh registers that are then added to the totals,
// so no FMA chain is longer than 64 (one chain of 512 puts the logits
// ~3x further from float64).  Each thread issues all of its loads of a
// tile before it waits on any.  No atomics: two launches agree bit for
// bit.  The exact no-op cases hold as in the engine: -inf masking, m_run
// from m_in, expf, and the chunk loop ends at the first chunk in the
// future of the block's last row.  Rows past sq, keys past sk and columns
// past d are zero-filled in shared memory and never stored.  What bounds
// it: the FP32 rate of the CUDA cores (4 * Sq * Sk * D operations, times
// D / WCW for the logits).

constexpr int WBQ = 16;   // query rows per block
constexpr int WBKC = 64;  // keys per chunk
constexpr int WDS = 64;   // D slab of the logits loop
constexpr int WCW = 128;  // output columns per block
constexpr int WTX = 16, WTY = 8, WTHREADS = WTX * WTY;
constexpr int WRPT = WBQ / WTY;   // rows per thread: ty + WTY * r
constexpr int WCPT = WBKC / WTX;  // keys per thread: tx + WTX * j
constexpr int WDPT = WCW / WTX;   // output columns per thread: tx + WTX * c
// shared memory (f32): qt [WDS][WBQ + 1] and kt [WDS][WBKC + 1], transposed
// and padded so the transposing stores hit distinct banks; vs [WBKC][WCW];
// ps [WBQ][WBKC + 1]
constexpr int WQP = WBQ + 1, WKP = WBKC + 1, WPP = WBKC + 1;
constexpr int WIDE_SMEM = (WDS * WQP + WDS * WKP + WBKC * WCW + WBQ * WPP) * 4;
static_assert(WIDE_SMEM <= SMEM_LIMIT, "the wide kernel's tiles fit one block");
static_assert(WBQ * WDS % WTHREADS == 0 && WBKC * WDS % WTHREADS == 0 &&
                  WBKC * WCW % WTHREADS == 0,
              "every tile's elements divide among the threads");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// max / sum over the 16 lanes that share a query row (xor offsets below 16
// stay in a half warp)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = WTX / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = WTX / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(WTHREADS)
flash_wide_kernel(int sq, int sk, int d, const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ acc_in,
                  const float* __restrict__ m_in, const float* __restrict__ l_in,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, long long q_off, long long k_off, int causal,
                  float scale) {
  extern __shared__ __align__(16) float wsm[];
  float* qt = wsm;
  float* kt = qt + WDS * WQP;
  float* vs = kt + WDS * WKP;
  float* ps = vs + WBKC * WCW;

  const int tid = threadIdx.x, tx = tid % WTX, ty = tid / WTX;
  const int row0 = blockIdx.x * WBQ, c0 = blockIdx.y * WCW;

  // the carry of this thread's rows and columns; rows past sq compute on
  // zeros and are never stored
  float acc[WRPT][WDPT], m_run[WRPT], l_run[WRPT];
#pragma unroll
  for (int r = 0; r < WRPT; ++r) {
    const int gr = row0 + ty + WTY * r;
    const bool ok = gr < sq;
    m_run[r] = ok ? m_in[gr] : 0.f;
    l_run[r] = ok ? l_in[gr] : 0.f;
#pragma unroll
    for (int c = 0; c < WDPT; ++c) {
      const int col = c0 + tx + WTX * c;
      acc[r][c] = ok && col < d ? acc_in[int64_t(gr) * d + col] : 0.f;
    }
  }

  const long long q_last = q_off + (long long)min(row0 + WBQ, sq) - 1;
  for (int kc = 0; kc < sk; kc += WBKC) {
    if (causal && q_last < k_off + kc) break;
    const int nk = min(WBKC, sk - kc);
    __syncthreads();  // the previous chunk's readers of vs and ps are done
#pragma unroll
    for (int it = 0; it < WBKC * WCW / WTHREADS; ++it) {
      const int i = tid + it * WTHREADS, j = i / WCW, col = c0 + i % WCW;
      vs[i] = j < nk && col < d ? to_f32(v[int64_t(kc + j) * d + col]) : 0.f;
    }

    float s[WRPT][WCPT];
#pragma unroll
    for (int r = 0; r < WRPT; ++r)
#pragma unroll
      for (int j = 0; j < WCPT; ++j) s[r][j] = 0.f;
    for (int d0 = 0; d0 < d; d0 += WDS) {
      __syncthreads();  // the previous slab's readers of qt and kt are done
#pragma unroll
      for (int it = 0; it < WBQ * WDS / WTHREADS; ++it) {
        const int i = tid + it * WTHREADS, r = i / WDS, c = i % WDS;
        const int gr = row0 + r, col = d0 + c;
        qt[c * WQP + r] = gr < sq && col < d ? to_f32(q[int64_t(gr) * d + col]) : 0.f;
      }
#pragma unroll
      for (int it = 0; it < WBKC * WDS / WTHREADS; ++it) {
        const int i = tid + it * WTHREADS, j = i / WDS, c = i % WDS, col = d0 + c;
        kt[c * WKP + j] = j < nk && col < d ? to_f32(k[int64_t(kc + j) * d + col]) : 0.f;
      }
      __syncthreads();
      float sp[WRPT][WCPT];  // this slab's partial logits
#pragma unroll
      for (int r = 0; r < WRPT; ++r)
#pragma unroll
        for (int j = 0; j < WCPT; ++j) sp[r][j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < WDS; ++c) {
        float a[WRPT], b[WCPT];
#pragma unroll
        for (int r = 0; r < WRPT; ++r) a[r] = qt[c * WQP + ty + WTY * r];
#pragma unroll
        for (int j = 0; j < WCPT; ++j) b[j] = kt[c * WKP + tx + WTX * j];
#pragma unroll
        for (int r = 0; r < WRPT; ++r)
#pragma unroll
          for (int j = 0; j < WCPT; ++j) sp[r][j] = fmaf(a[r], b[j], sp[r][j]);
      }
#pragma unroll
      for (int r = 0; r < WRPT; ++r)
#pragma unroll
        for (int j = 0; j < WCPT; ++j) s[r][j] += sp[r][j];
    }

#pragma unroll
    for (int r = 0; r < WRPT; ++r) {
      const long long qpos = q_off + row0 + ty + WTY * r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < WCPT; ++j) {
        const int key = tx + WTX * j;
        const bool keep = key < nk && (!causal || qpos >= k_off + kc + key);
        s[r][j] = keep ? s[r][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[r][j]);
      }
      const float m_new = fmaxf(m_run[r], half_max(mx));
      const float corr = expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < WCPT; ++j) {
        const float p = expf(s[r][j] - m_new);
        sum += p;
        ps[(ty + WTY * r) * WPP + tx + WTX * j] = p;
      }
      l_run[r] = l_run[r] * corr + half_sum(sum);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < WDPT; ++c) acc[r][c] *= corr;
    }
    __syncthreads();  // ps and vs are complete

    float pv[WRPT][WDPT];  // this chunk's p.v
#pragma unroll
    for (int r = 0; r < WRPT; ++r)
#pragma unroll
      for (int c = 0; c < WDPT; ++c) pv[r][c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float p[WRPT];
#pragma unroll
      for (int r = 0; r < WRPT; ++r) p[r] = ps[(ty + WTY * r) * WPP + j];
#pragma unroll
      for (int c = 0; c < WDPT; ++c) {
        const float vv = vs[j * WCW + tx + WTX * c];
#pragma unroll
        for (int r = 0; r < WRPT; ++r) pv[r][c] = fmaf(p[r], vv, pv[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < WRPT; ++r)
#pragma unroll
      for (int c = 0; c < WDPT; ++c) acc[r][c] += pv[r][c];
  }

#pragma unroll
  for (int r = 0; r < WRPT; ++r) {
    const int gr = row0 + ty + WTY * r;
    if (gr >= sq) continue;
#pragma unroll
    for (int c = 0; c < WDPT; ++c) {
      const int col = c0 + tx + WTX * c;
      if (col < d) acc_out[int64_t(gr) * d + col] = acc[r][c];
    }
    if (blockIdx.y == 0 && tx == 0) {
      m_out[gr] = m_run[r];
      l_out[gr] = l_run[r];
    }
  }
}

template <typename T>
cudaError_t launch_wide(int sq, int sk, int d, const void* q, const void* k, const void* v,
                        const float* acc, const float* m, const float* l, float* acc_o,
                        float* m_o, float* l_o, long long q_off, long long k_off, int causal,
                        float scale, cudaStream_t stream) {
  auto kern = flash_wide_kernel<T>;
  static const cudaError_t opted =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, WIDE_SMEM);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((sq + WBQ - 1) / WBQ, (d + WCW - 1) / WCW);
  kern<<<grid, WTHREADS, WIDE_SMEM, stream>>>(sq, sk, d, static_cast<const T*>(q),
                                              static_cast<const T*>(k), static_cast<const T*>(v),
                                              acc, m, l, acc_o, m_o, l_o, q_off, k_off, causal,
                                              scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int sq, int sk, int d, const void* q, const void* k, const void* v,
                       const float* acc, const float* m, const float* l, float* acc_o,
                       float* m_o, float* l_o, long long q_off, long long k_off, int causal,
                       float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(sq, sk, d, q, k, v, acc, m, l, acc_o, m_o, l_o, q_off, k_off, causal,
                         scale, stream);
  if (d <= 128)
    return launch<T, 128>(sq, sk, d, q, k, v, acc, m, l, acc_o, m_o, l_o, q_off, k_off, causal,
                          scale, stream);
  if (d <= D_ENGINE)
    return launch<T, 256>(sq, sk, d, q, k, v, acc, m, l, acc_o, m_o, l_o, q_off, k_off, causal,
                          scale, stream);
  return launch_wide<T>(sq, sk, d, q, k, v, acc, m, l, acc_o, m_o, l_o, q_off, k_off, causal,
                        scale, stream);
}

}  // namespace

extern "C" int ptt_flash_attention_block(int bf16, int sq, int sk, int d, const void* q,
                                         const void* k, const void* v, const void* acc,
                                         const void* m, const void* l, void* acc_o, void* m_o,
                                         void* l_o, long long q_off, long long k_off, int causal,
                                         float scale, void* stream) {
  if (sq < 0 || sk < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (sq == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(acc);
  auto mi = static_cast<const float*>(m);
  auto li = static_cast<const float*>(l);
  auto ao = static_cast<float*>(acc_o);
  auto mo = static_cast<float*>(m_o);
  auto lo = static_cast<float*>(l_o);
  if (bf16)
    return (int)dispatch_d<__nv_bfloat16>(sq, sk, d, q, k, v, a, mi, li, ao, mo, lo, q_off,
                                          k_off, causal, scale, s);
  return (int)dispatch_d<float>(sq, sk, d, q, k, v, a, mi, li, ao, mo, lo, q_off, k_off, causal,
                                scale, s);
}
