// Hand-written Hopper (sm_90a) tensor-core kernels for the dpotrf tile products.
//
// Replaces two Pallas TPU kernels of parsec_tpu/ops/pallas_kernels.py:
//   * matmul_update (B1): O = C + alpha * A @ op(B)   -- syrk / gemm updates
//   * matmul        (B2): O = A @ op(B)               -- trsm as C @ inv(T)^T
// where op(B) = B^T when trans_b (B is n x k) and B otherwise (k x n).
//
// What it computes, not how the TPU did it: the Pallas kernels walk a
// sequential (m, n, k) grid on one TensorCore and carry the sum in the
// output block across k steps.  Here one block of one warpgroup computes
// a 64 x 64 output tile (at the 512^3 dpotrf tile it was faster than
// 128 x 64 and 64 x 128 in every mode, PERF.md) and loops over k inside
// itself: no split-K, no atomics, so every output element has one fixed
// summation order and two launches on the same inputs agree bit for bit.
//
// Engine (one for every mode).  The k loop walks slabs of 128 bytes of k
// per row -- one 128-byte swizzle row: 64 bf16 or 32 tf32 values.  The
// loader is register-staged and double-buffered: while wgmma multiplies
// slab s out of one shared-memory stage, every thread loads slab s+1 from
// global memory into registers (16-byte vectors where the row pitch and
// the base are 16-byte aligned, else predicated scalar loads; out of range
// reads 0, so every shape is accepted), then converts the values and
// stores them into the other stage, K-major with the 128-byte swizzle that
// the wgmma descriptors name.  Both operands are stored K-major, so
// trans_b=False is a transposing store and the descriptors never need a
// transpose flag (TF32 wgmma takes K-major operands only).  Each slab's
// wgmma products land in a fresh register tile that is then added to the
// f32 total with one rounding per slab, so the tensor core's own
// accumulation spans at most one slab.  The epilogue reads C once and
// writes O once from the accumulator fragment.
//
// Operand modes, all accumulated in f32 by wgmma.mma_async with both
// operands in shared memory:
//   * BF16: bf16 operands as they are, one m64n64k16 pass (B1 bf16 and
//     B2 bf16);
//   * SPLIT (split_f32): each f32 value splits in the loader into a bf16
//     hi = bf16(x) and lo = bf16(x - hi), round to nearest even (jnp's
//     astype), and three bf16 passes sum hi*lo + lo*hi + hi*hi: the
//     reference's own decomposition (pallas_kernels.py:120-129), small
//     terms first;
//   * TF32X3 (f32, B1 and B2): the same three passes in TF32 (m64n64k8)
//     with hi = tf32(x), lo = tf32(x - hi), each rounded by
//     cvt.rna.tf32.f32 and its low 13 bits cleared so that hi is exact in
//     TF32 and x - hi exact in f32 -- an f32-class product from narrower
//     tensor-core passes (single-pass TF32 fails the reference's 1e-5).
//
// What bounds it on an H100 at the dpotrf tile (512 x 512 x 512): the f32
// modes do 3 * 2 * 512^3 TF32 operations (>= 1.63 us at 495 TFLOP/s) and
// move ~4 MiB (>= 1.25 us at 3.35 TB/s); bf16 is byte-bound (0.94 us).
// This design is the simple one: a 512 x 512 output is 64 blocks on 132
// SMs and every slab waits for its loads, so latency, not the tensor
// cores, sets its time.  TMA and a warp-specialised persistent pipeline
// are the known next steps.
//
// Interface: plain C entry points bound with ctypes.  Every pointer and the
// stream are passed as void*; the vector widths come from the caller
// (ops/kernels.py:_mm_config), the shared-memory bytes from the mode.
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Mode : int { BF16 = 0, SPLIT = 1, TF32X3 = 2 };

constexpr int ROW_BYTES = 128;   // k extent of a slab: one 128-byte swizzle row
constexpr int STAGES = 2;        // slab buffers: load s+1 while s multiplies
constexpr int BM = 64;           // output tile rows: one warpgroup's m64
constexpr int BN = 64;           // output tile columns: wgmma's n64
constexpr int THREADS = 128;     // one warpgroup
constexpr int ALIGN = 1024;      // the swizzle pattern repeats every 8 rows
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may opt in to

template <int MODE>
struct ModeTraits {
  // global operand element (raw bits) and shared-memory operand bytes
  using Bits = std::conditional_t<MODE == BF16, uint16_t, uint32_t>;
  static constexpr int SBYTES = MODE == TF32X3 ? 4 : 2;
  static constexpr int NBUF = MODE == BF16 ? 1 : 2;    // (hi, lo) for the splits
  static constexpr int PASSES = MODE == BF16 ? 1 : 3;  // hi*lo, lo*hi, hi*hi
  static constexpr int BK = ROW_BYTES / SBYTES;        // k values per slab
  static constexpr int SMEM = STAGES * NBUF * (BM + BN) * ROW_BYTES + ALIGN;
  static_assert(SMEM <= SMEM_LIMIT, "the stages fit the shared memory of one block");
};

// byte offset of a K-major 128B-swizzled tile: the 16-byte chunk index
// (bits 4-6) is XORed with the row within its 8-row group (bits 7-9)
__device__ __forceinline__ uint32_t swz(uint32_t off) { return off ^ ((off >> 3) & 0x70u); }

__device__ __forceinline__ void st_shared(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t a, uint2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" :: "r"(a), "r"(v.x), "r"(v.y) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t a, uint16_t v) {
  asm volatile("st.shared.b16 [%0], %1;\n" :: "r"(a), "h"(v) : "memory");
}

// tf32 by round-to-nearest (ties away), low 13 bits cleared: exact in TF32
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float bf16_value(uint16_t b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}

// -- wgmma ------------------------------------------------------------------

// shared-memory matrix descriptor of a K-major, 128B-swizzled tile whose
// 8-row groups are 1024 bytes apart (LBO is unused for this layout)
__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr) {
  uint64_t d = (smem_addr & 0x3FFFFu) >> 4;
  d |= uint64_t(1) << 16;
  d |= uint64_t(ALIGN >> 4) << 32;
  d |= uint64_t(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy stores to shared memory become visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)
#define ACC32(i) ACC16(i), ACC16(i + 16)
#define REGS32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "

// d (+)= A(64 x 32 bytes of k) @ B(64 x 32 bytes of k)^T; scale_d = 0
// overwrites d
template <bool TF32>
struct Mma;

template <>
struct Mma<false> {
  __device__ static void run(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : ACC32(0)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <>
struct Mma<true> {
  __device__ static void run(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REGS32
        "%32, %33, p, 1, 1;\n}\n"
        : ACC32(0)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
// -- loader -----------------------------------------------------------------

// One operand's slab: ROWS rows (of m or n) x BK k values.  A unit is 16
// bytes of the global operand, VEC elements along its contiguous
// dimension.  KMAJOR: element (row, k) is at src[row * ld + k] (A, and B
// when trans_b); else at src[k * ld + row] (B when not trans_b), and the
// stores transpose it.
template <int MODE, int ROWS, bool KMAJOR>
struct Loader {
  using T = ModeTraits<MODE>;
  using Bits = typename T::Bits;
  static constexpr int VEC = 16 / sizeof(Bits);
  static constexpr int LINE = (KMAJOR ? T::BK : ROWS) / VEC;  // units per line
  static constexpr int PER_THREAD = ROWS * T::BK / VEC / THREADS;
  static_assert(ROWS * T::BK / VEC % THREADS == 0, "a slab's units divide among the threads");

  uint4 v[PER_THREAD];

  __device__ __forceinline__ static void unit(int i, int tid, int& row, int& kk) {
    const int u = tid + i * THREADS;
    if (KMAJOR) {
      row = u / LINE;
      kk = u % LINE * VEC;
    } else {
      kk = u / LINE;
      row = u % LINE * VEC;
    }
  }

  // rows [row0, row0 + ROWS) of `rows`, k values [k0, k0 + BK) of K; out of
  // range reads 0.  vec: 16-byte loads -- the pitch and the base are
  // 16-byte aligned, so a unit lies wholly in or out of range.
  __device__ __forceinline__ void load(const Bits* __restrict__ src, int ld, int row0, int rows,
                                       int k0, int K, int tid, bool vec) {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      int row, kk;
      unit(i, tid, row, kk);
      const int c = KMAJOR ? k0 + kk : row0 + row;  // contiguous coordinate
      const int s = KMAJOR ? row0 + row : k0 + kk;  // strided coordinate
      const int c_end = KMAJOR ? K : rows, s_end = KMAJOR ? rows : K;
      const Bits* p = src + int64_t(s) * ld + c;
      if (vec) {
        v[i] = (s < s_end && c < c_end) ? __ldg(reinterpret_cast<const uint4*>(p))
                                        : make_uint4(0u, 0u, 0u, 0u);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = 0u;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const uint32_t e = (s < s_end && c + j < c_end) ? uint32_t(__ldg(p + j)) : 0u;
          if constexpr (sizeof(Bits) == 2)
            w[j / 2] |= e << (16 * (j % 2));
          else
            w[j] = e;
        }
        v[i] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }

  // convert the staged slab and store it into one stage's hi (and lo)
  // buffers, K-major and swizzled
  __device__ __forceinline__ void store(uint32_t hi, uint32_t lo, int tid) const {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      int row, kk;
      unit(i, tid, row, kk);
      const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      if constexpr (MODE == BF16) {
        if (KMAJOR) {
          st_shared(hi + swz(row * ROW_BYTES + kk * 2), v[i]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            st_shared(hi + swz((row + j) * ROW_BYTES + kk * 2),
                      uint16_t(w[j / 2] >> (16 * (j % 2))));
        }
      } else if constexpr (MODE == SPLIT) {
        uint16_t h[4], l[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = __uint_as_float(w[j]);
          h[j] = bf16_bits(x);
          l[j] = bf16_bits(x - bf16_value(h[j]));
        }
        if (KMAJOR) {
          const uint32_t off = swz(row * ROW_BYTES + kk * 2);
          st_shared(hi + off, make_uint2(h[0] | uint32_t(h[1]) << 16, h[2] | uint32_t(h[3]) << 16));
          st_shared(lo + off, make_uint2(l[0] | uint32_t(l[1]) << 16, l[2] | uint32_t(l[3]) << 16));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t off = swz((row + j) * ROW_BYTES + kk * 2);
            st_shared(hi + off, h[j]);
            st_shared(lo + off, l[j]);
          }
        }
      } else {
        uint32_t h[4], l[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = __uint_as_float(w[j]);
          h[j] = tf32(x);
          l[j] = tf32(x - __uint_as_float(h[j]));
        }
        if (KMAJOR) {
          const uint32_t off = swz(row * ROW_BYTES + kk * 4);
          st_shared(hi + off, make_uint4(h[0], h[1], h[2], h[3]));
          st_shared(lo + off, make_uint4(l[0], l[1], l[2], l[3]));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t off = swz((row + j) * ROW_BYTES + kk * 4);
            st_shared(hi + off, h[j]);
            st_shared(lo + off, l[j]);
          }
        }
      }
    }
  }
};

// -- epilogue stores --------------------------------------------------------

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// -- the kernel -------------------------------------------------------------

template <int MODE, typename TO, bool TRANS_B, bool HAS_C>
__global__ void __launch_bounds__(THREADS, 1)
mm_kernel(int M, int N, int K, const void* __restrict__ Av, const void* __restrict__ Bv,
          const float* __restrict__ C, TO* __restrict__ O, float alpha, int vec_a, int vec_b,
          int vec_c) {
  using T = ModeTraits<MODE>;
  using Bits = typename T::Bits;
  constexpr int A_BYTES = BM * ROW_BYTES, B_BYTES = BN * ROW_BYTES;
  constexpr int STAGE_BYTES = T::NBUF * (A_BYTES + B_BYTES);
  constexpr int NACC = BN / 2;  // f32 accumulators per thread (m64n64)

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + (ALIGN - 1)) & ~uint32_t(ALIGN - 1);
  // stage st, buffer h (0 = hi or the bf16 copy, 1 = lo)
  auto a_buf = [&](int st, int h) { return base + st * STAGE_BYTES + h * A_BYTES; };
  auto b_buf = [&](int st, int h) {
    return base + st * STAGE_BYTES + T::NBUF * A_BYTES + h * B_BYTES;
  };

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const Bits* A = static_cast<const Bits*>(Av);
  const Bits* B = static_cast<const Bits*>(Bv);
  const int ldb = TRANS_B ? K : N;

  Loader<MODE, BM, true> la;
  Loader<MODE, BN, TRANS_B> lb;
  float acc[NACC], d[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = d[i] = 0.f;

  const int nslabs = (K + T::BK - 1) / T::BK;
  if (nslabs > 0) {
    la.load(A, K, row0, M, 0, K, tid, vec_a);
    lb.load(B, ldb, col0, N, 0, K, tid, vec_b);
    la.store(a_buf(0, 0), a_buf(0, T::NBUF - 1), tid);
    lb.store(b_buf(0, 0), b_buf(0, T::NBUF - 1), tid);
    fence_proxy_async();
    __syncthreads();
  }
  for (int s = 0; s < nslabs; ++s) {
    const int cur = s & 1, nxt = cur ^ 1;
    const bool more = s + 1 < nslabs;
    if (more) {  // next slab's global loads in flight during this slab's wgmma
      la.load(A, K, row0, M, (s + 1) * T::BK, K, tid, vec_a);
      lb.load(B, ldb, col0, N, (s + 1) * T::BK, K, tid, vec_b);
    }
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < T::PASSES; ++p) {
      // (A, B) buffers of pass p.  The split modes add the small cross
      // terms first, hi*lo and lo*hi, then hi*hi: the tensor core's own
      // additions into d round coarser than f32, so they should meet a
      // small d as often as possible
      const int ha = T::PASSES > 1 && p == 1, hb = T::PASSES > 1 && p == 0;
      const uint64_t da = make_desc(a_buf(cur, ha));
      const uint64_t db = make_desc(b_buf(cur, hb));
#pragma unroll
      for (int kk = 0; kk < ROW_BYTES / 32; ++kk)  // 32 bytes of k per wgmma
        Mma<MODE == TF32X3>::run(d, da + 2 * kk, db + 2 * kk, (p | kk) != 0);
    }
    wgmma_commit();
    if (more) {  // the other stage was released by the previous slab's wait
      la.store(a_buf(nxt, 0), a_buf(nxt, T::NBUF - 1), tid);
      lb.store(b_buf(nxt, 0), b_buf(nxt, T::NBUF - 1), tid);
    }
    wgmma_wait_all();
    fence_regs(d);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += d[i];  // one f32 rounding per slab
    if (more) {
      fence_proxy_async();
      __syncthreads();
    }
  }

  // accumulator fragment of m64n64: register 4j + 2h + e of thread
  // (warp, lane) holds row warp*16 + lane/4 + 8h, column 8j + 2(lane%4) + e
  const int warp = tid / 32, lane = tid % 32;
  const int rbase = row0 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = col0 + j * 8 + lane % 4 * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rbase + h * 8;
      if (r >= M || c >= N) continue;
      const int64_t off = int64_t(r) * N + c;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (vec_c) {  // N even and the bases aligned: c + 1 < N as well
        if constexpr (HAS_C) {
          const float2 cc = *reinterpret_cast<const float2*>(C + off);
          v0 = cc.x + alpha * v0;
          v1 = cc.y + alpha * v1;
        }
        store2(O + off, v0, v1);
      } else {
        if constexpr (HAS_C) v0 = C[off] + alpha * v0;
        store1(O + off, v0);
        if (c + 1 < N) {
          if constexpr (HAS_C) v1 = C[off + 1] + alpha * v1;
          store1(O + off + 1, v1);
        }
      }
    }
  }
}

template <int MODE, typename TO, bool TRANS_B, bool HAS_C>
cudaError_t launch(int M, int N, int K, const void* A, const void* B, const void* C, void* O,
                   float alpha, int vec_a, int vec_b, int vec_c, cudaStream_t stream) {
  constexpr int smem = ModeTraits<MODE>::SMEM;
  auto kern = mm_kernel<MODE, TO, TRANS_B, HAS_C>;
  // dynamic shared memory above the 48 KB default: opted in once per
  // instantiation (a thread-safe static), for the device current at the
  // first launch -- the port drives one device
  static const cudaError_t opted =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(M, N, K, A, B, static_cast<const float*>(C),
                                         static_cast<TO*>(O), alpha, vec_a, vec_b, vec_c);
  return cudaGetLastError();
}

template <int MODE, typename TO, bool HAS_C>
cudaError_t dispatch(int trans_b, int M, int N, int K, const void* A, const void* B,
                     const void* C, void* O, float alpha, int vec_a, int vec_b, int vec_c,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return trans_b ? launch<MODE, TO, true, HAS_C>(M, N, K, A, B, C, O, alpha, vec_a, vec_b,
                                                 vec_c, s)
                 : launch<MODE, TO, false, HAS_C>(M, N, K, A, B, C, O, alpha, vec_a, vec_b,
                                                  vec_c, s);
}

}  // namespace

extern "C" {

// B1: O(m,n) f32 = C(m,n) f32 + alpha * A @ op(B).
// in_bf16: A and B are bf16 (else f32); split_f32: f32 operands, 3-pass
// bf16 (else 3-pass TF32).  vec_a, vec_b: 16-byte operand loads; vec_c:
// paired C/O accesses.
int ptt_matmul_update(int in_bf16, int trans_b, int split_f32, int M, int N, int K,
                      const void* C, const void* A, const void* B, void* O, float alpha,
                      int vec_a, int vec_b, int vec_c, void* stream) {
  if (in_bf16)
    return dispatch<BF16, float, true>(trans_b, M, N, K, A, B, C, O, alpha, vec_a, vec_b,
                                       vec_c, stream);
  if (split_f32)
    return dispatch<SPLIT, float, true>(trans_b, M, N, K, A, B, C, O, alpha, vec_a, vec_b,
                                        vec_c, stream);
  return dispatch<TF32X3, float, true>(trans_b, M, N, K, A, B, C, O, alpha, vec_a, vec_b,
                                       vec_c, stream);
}

// B2: O(m,n) = A @ op(B), in A's dtype (f32 by three TF32 passes, or bf16
// rounded once from the f32 sum).  Vector flags as for ptt_matmul_update.
int ptt_matmul(int in_bf16, int trans_b, int M, int N, int K, const void* A, const void* B,
               void* O, int vec_a, int vec_b, int vec_c, void* stream) {
  if (in_bf16)
    return dispatch<BF16, __nv_bfloat16, false>(trans_b, M, N, K, A, B, nullptr, O, 1.f,
                                                vec_a, vec_b, vec_c, stream);
  return dispatch<TF32X3, float, false>(trans_b, M, N, K, A, B, nullptr, O, 1.f, vec_a,
                                        vec_b, vec_c, stream);
}

}  // extern "C"
