// Hand-written Hopper (sm_90a) kernels for the dpotrf trailing updates.
//
// Replaces two Pallas TPU kernels of parsec_tpu/ops/pallas_kernels.py:
//   * matmul_update (B1): O = C + alpha * A @ op(B)   -- syrk / gemm updates
//   * matmul        (B2): O = A @ op(B)               -- trsm as C @ inv(T)^T
// where op(B) = B^T when trans_b (B is n x k) and B otherwise (k x n).
//
// What it computes, not how the TPU did it: the Pallas kernels walk a
// sequential (m, n, k) grid on one TensorCore and carry the sum in the
// output block across k steps.  Here every 64 x 64 output tile is one
// block of 256 threads; the k dimension is a loop inside the block over
// 16-deep slabs of A and op(B) staged through shared memory, and each
// thread keeps a 4 x 4 register tile of f32 accumulators.  The epilogue
// reads C once and writes the output once, as the Pallas kernel's
// set-at-k==0-then-accumulate does.  Ragged edges are masked (loads of
// out-of-range elements read 0, stores are skipped), so every shape is
// accepted, including those the Pallas _block() cannot tile.
//
// Operand modes (template parameters):
//   * f32 operands, true FP32 FMA on the CUDA cores (never TF32: TF32 keeps
//     ~3 decimal digits and fails the reference's 1e-5 tolerance);
//   * bf16 operands, f32 accumulation: a product of two bf16 values is
//     exact in f32, so only the summation order differs from the TPU;
//   * split_f32: each f32 operand splits IN REGISTERS into a bf16 (hi, lo)
//     pair and the product sums hi*hi + hi*lo + lo*hi in f32, the
//     reference's 3-pass decomposition (pallas_kernels.py:120-129).
//
// What bounds it on an H100: at the dpotrf tile (512 x 512 x 512, f32) one
// call does 2*512^3 = 268 MFLOP and moves ~4 MiB.  With TF32 barred the
// FLOPs run on the FP32 CUDA cores (67 TFLOP/s on the SXM part, >= 4.0 us)
// while the bytes need >= 1.25 us at 3.35 TB/s: compute-bound.  This first
// kernel is the simple, correct one: register tiling takes each shared
// memory load over 4 FMAs, but there is no double buffering, no wgmma/TMA
// and a 512 x 512 output is only 64 blocks on 132 SMs.  Those are the
// known gaps for the fast redesign (ROADMAP B1/B2).
//
// Interface: plain C entry points bound with ctypes.  Every pointer and the
// stream are passed as void*; each launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // output rows per block
constexpr int BN = 64;    // output cols per block
constexpr int BK = 16;    // k-slab depth staged per iteration
constexpr int TM = 4;     // rows per thread
constexpr int TN = 4;     // cols per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// hi = bf16(x) (round to nearest even), lo = bf16(x - hi): jnp's astype
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = __bfloat162float(__float2bfloat16_rn(x - hi));
}

template <typename TI, typename TO, bool TRANS_B, bool SPLIT, bool HAS_C>
__global__ void __launch_bounds__(THREADS)
mm_kernel(int M, int N, int K, const TI* __restrict__ A, const TI* __restrict__ B,
          const float* __restrict__ C, TO* __restrict__ O, float alpha) {
  // k-major slabs: thread (ty, tx) reads As[kk][ty*TM + i] and
  // Bs[kk][tx*TN + j]; the +4 pad breaks the stride of the transposing
  // stores into As
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A slab: BM x BK, row-major in memory (m x k); consecutive threads
    // read consecutive k of one row
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? to_f32(A[(int64_t)gr * K + gc]) : 0.f;
    }
    if constexpr (TRANS_B) {
      // B is n x k: op(B)[k][n] = B[n][k]
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const int gn = col0 + r, gk = k0 + c;
        Bs[c][r] = (gn < N && gk < K) ? to_f32(B[(int64_t)gn * K + gk]) : 0.f;
      }
    } else {
      // B is k x n: consecutive threads read consecutive n of one row
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int r = e / BN, c = e % BN;
        const int gk = k0 + r, gn = col0 + c;
        Bs[r][c] = (gk < K && gn < N) ? to_f32(B[(int64_t)gk * N + gn]) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
      if constexpr (SPLIT) {
        float ah[TM], al[TM], bh[TN], bl[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) split(a[i], ah[i], al[i]);
#pragma unroll
        for (int j = 0; j < TN; ++j) split(b[j], bh[j], bl[j]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] += ah[i] * bh[j] + ah[i] * bl[j] + al[i] * bh[j];
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= N) continue;
      const int64_t off = (int64_t)r * N + c;
      if constexpr (HAS_C)
        store(&O[off], C[off] + alpha * acc[i][j]);
      else
        store(&O[off], acc[i][j]);
    }
  }
}

template <typename TI, typename TO, bool TRANS_B, bool SPLIT, bool HAS_C>
void launch(int M, int N, int K, const void* A, const void* B, const void* C,
            void* O, float alpha, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_kernel<TI, TO, TRANS_B, SPLIT, HAS_C><<<grid, THREADS, 0, stream>>>(
      M, N, K, static_cast<const TI*>(A), static_cast<const TI*>(B),
      static_cast<const float*>(C), static_cast<TO*>(O), alpha);
}

template <typename TI, typename TO, bool SPLIT, bool HAS_C>
void launch_t(int trans_b, int M, int N, int K, const void* A, const void* B,
              const void* C, void* O, float alpha, cudaStream_t stream) {
  if (trans_b)
    launch<TI, TO, true, SPLIT, HAS_C>(M, N, K, A, B, C, O, alpha, stream);
  else
    launch<TI, TO, false, SPLIT, HAS_C>(M, N, K, A, B, C, O, alpha, stream);
}

}  // namespace

extern "C" {

// B1: O(m,n) f32 = C(m,n) f32 + alpha * A @ op(B).
// in_bf16: A and B are bf16 (else f32); split_f32: f32 operands, 3-pass bf16.
int ptt_matmul_update(int in_bf16, int trans_b, int split_f32, int M, int N, int K,
                      const void* C, const void* A, const void* B, void* O,
                      float alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    launch_t<__nv_bfloat16, float, false, true>(trans_b, M, N, K, A, B, C, O, alpha, s);
  else if (split_f32)
    launch_t<float, float, true, true>(trans_b, M, N, K, A, B, C, O, alpha, s);
  else
    launch_t<float, float, false, true>(trans_b, M, N, K, A, B, C, O, alpha, s);
  return static_cast<int>(cudaGetLastError());
}

// B2: O(m,n) = A @ op(B), in A's dtype (f32, or bf16 rounded once from the
// f32 accumulator).
int ptt_matmul(int in_bf16, int trans_b, int M, int N, int K, const void* A,
               const void* B, void* O, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    launch_t<__nv_bfloat16, __nv_bfloat16, false, false>(trans_b, M, N, K, A, B, nullptr, O, 1.f, s);
  else
    launch_t<float, float, false, false>(trans_b, M, N, K, A, B, nullptr, O, 1.f, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
