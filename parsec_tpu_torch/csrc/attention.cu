// Hand-written Hopper (sm_90a) kernel for the flash-attention step.
//
// Replaces the Pallas TPU kernel flash_attention_block (B5) of
// parsec_tpu/ops/pallas_kernels.py: one online-softmax block update
//
//   logits = (q @ k^T) * scale            (true FP32, never TF32)
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
// 128 threads owns 32 query rows; K and V stream through shared memory in
// 64-key chunks, and the block keeps a running max, sum and accumulator in
// registers, starting from the incoming carry (the flash-attention
// recurrence applied chunk by chunk).  Chunking changes only the summation
// order of l and acc; m' is exact, since max is.  bf16 q/k/v are widened to
// f32 as they are loaded (the reference's astype(float32)).
//
// Exact no-op cases.  A key masked out contributes exp(-inf - m) = 0, and
// the running max starts at the incoming m (finite: the carry init is
// -1e30), so no path computes (-inf) - (-inf).  A chunk that is in the
// future of every row of the block is skipped, and so are all chunks after
// it: its update is exactly the identity (corr = exp(0) = 1, p = 0).  A
// fully masked block therefore leaves acc, m and l bit-identical.  expf,
// not __expf, and no --use_fast_math: exp(0) must be exactly 1.
//
// What bounds it on an H100: at the path's block, 512 x 512 x 128 f32, one
// call does 4 * 512 * 512 * 128 = 134 MFLOP on the FP32 CUDA cores
// (>= 2.0 us at 67 TFLOP/s) and moves ~1.3 MB (0.4 us at 3.35 TB/s):
// compute-bound.  This first kernel is the simple, correct one: FP32 FMA
// from shared memory with a 4 x 4 register tile for q.k and 4 x (D/16) for
// p.v, 16 blocks for 512 query rows, no tensor cores, no double buffering.
//
// Interface: a plain C entry point bound with ctypes; it launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// launch's cudaError_t (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;          // query rows per block
constexpr int BKC = 64;         // keys per shared-memory chunk
constexpr int TX = 16;          // threads along a row (one half-warp)
constexpr int TY = 8;           // thread rows
constexpr int THREADS = TX * TY;
constexpr int RPT = BQ / TY;    // query rows per thread: ty + TY * r
constexpr int CPT = BKC / TX;   // keys per thread in a chunk: tx + TX * j
constexpr int D_LIMIT = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// max / sum over the 16 lanes that share a query row (lanes 0-15 and 16-31
// of a warp hold two different rows; xor offsets below 16 stay in a half)
__device__ __forceinline__ float row_max(float x) {
  for (int o = TX / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = TX / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// shared memory (f32): qt [D][BQ+1] and kt [D][BKC+1] (transposed, padded
// so the transposing stores hit distinct banks), vs [BKC][D], ps [BQ][BKC+1]
__host__ __device__ constexpr size_t smem_floats(int d) {
  return (size_t)d * (BQ + 1) + (size_t)d * (BKC + 1) + (size_t)BKC * d
         + (size_t)BQ * (BKC + 1);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_block_kernel(int sq, int sk, int d,
                   const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v,
                   const float* __restrict__ acc_in, const float* __restrict__ m_in,
                   const float* __restrict__ l_in,
                   float* __restrict__ acc_out, float* __restrict__ m_out,
                   float* __restrict__ l_out,
                   long long q_off, long long k_off, int causal, float scale) {
  constexpr int DPT = DMAX / TX;  // accumulator columns per thread: tx + TX * c
  extern __shared__ float smem[];
  float* qt = smem;
  float* kt = qt + (size_t)d * (BQ + 1);
  float* vs = kt + (size_t)d * (BKC + 1);
  float* ps = vs + (size_t)BKC * d;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * BQ;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i % d;
    const int gr = row0 + r;
    qt[c * (BQ + 1) + r] = gr < sq ? to_f32(q[(size_t)gr * d + c]) : 0.f;
  }

  // the carry of this thread's rows; rows past sq compute on zeros and are
  // never stored
  float acc[RPT][DPT];
  float m_run[RPT], l_run[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int gr = row0 + ty + TY * r;
    const bool ok = gr < sq;
    m_run[r] = ok ? m_in[gr] : 0.f;
    l_run[r] = ok ? l_in[gr] : 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx + TX * c;
      acc[r][c] = (ok && col < d) ? acc_in[(size_t)gr * d + col] : 0.f;
    }
  }

  // the last query position of the block: a chunk starting after it is
  // masked for every row, and so is every later chunk
  const long long q_last = q_off + (long long)min(row0 + BQ, sq) - 1;

  for (int kc = 0; kc < sk; kc += BKC) {
    if (causal && q_last < k_off + kc) break;
    const int nk = min(BKC, sk - kc);
    __syncthreads();  // the previous chunk's readers of kt, vs, ps are done
    for (int i = tid; i < BKC * d; i += THREADS) {
      const int j = i / d, c = i % d;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const size_t g = (size_t)(kc + j) * d + c;
        kv = to_f32(k[g]);
        vv = to_f32(v[g]);
      }
      kt[c * (BKC + 1) + j] = kv;
      vs[j * d + c] = vv;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[r][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[RPT], b[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) a[r] = qt[c * (BQ + 1) + ty + TY * r];
#pragma unroll
      for (int j = 0; j < CPT; ++j) b[j] = kt[c * (BKC + 1) + tx + TX * j];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[r][j] = fmaf(a[r], b[j], s[r][j]);
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const long long qpos = q_off + row0 + ty + TY * r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = tx + TX * j;
        const bool keep = col < nk && (!causal || qpos >= k_off + kc + col);
        const float x = keep ? s[r][j] * scale : -INFINITY;
        s[r][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_run[r], row_max(mx));
      const float corr = expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[r][j] - m_new);
        sum += p;
        ps[(ty + TY * r) * (BKC + 1) + tx + TX * j] = p;
      }
      l_run[r] = l_run[r] * corr + row_sum(sum);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      float p[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) p[r] = ps[(ty + TY * r) * (BKC + 1) + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + TX * c;
        if (col < d) {
          const float vv = vs[j * d + col];
#pragma unroll
          for (int r = 0; r < RPT; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int gr = row0 + ty + TY * r;
    if (gr >= sq) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx + TX * c;
      if (col < d) acc_out[(size_t)gr * d + col] = acc[r][c];
    }
    if (tx == 0) {
      m_out[gr] = m_run[r];
      l_out[gr] = l_run[r];
    }
  }
}

template <typename T, int DMAX>
int launch(int sq, int sk, int d, const void* q, const void* k, const void* v,
           const float* acc, const float* m, const float* l, float* acc_o,
           float* m_o, float* l_o, long long q_off, long long k_off, int causal,
           float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(d) * sizeof(float);
  auto kernel = flash_block_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, bytes, stream>>>(
      sq, sk, d, (const T*)q, (const T*)k, (const T*)v, acc, m, l, acc_o, m_o,
      l_o, q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int sq, int sk, int d, const void* q, const void* k, const void* v,
               const float* acc, const float* m, const float* l, float* acc_o,
               float* m_o, float* l_o, long long q_off, long long k_off,
               int causal, float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(sq, sk, d, q, k, v, acc, m, l, acc_o, m_o, l_o, q_off,
                         k_off, causal, scale, stream);
  if (d <= 128)
    return launch<T, 128>(sq, sk, d, q, k, v, acc, m, l, acc_o, m_o, l_o, q_off,
                          k_off, causal, scale, stream);
  return launch<T, 256>(sq, sk, d, q, k, v, acc, m, l, acc_o, m_o, l_o, q_off,
                        k_off, causal, scale, stream);
}

}  // namespace

extern "C" int ptt_flash_attention_block(
    int bf16, int sq, int sk, int d, const void* q, const void* k, const void* v,
    const void* acc, const void* m, const void* l, void* acc_o, void* m_o,
    void* l_o, long long q_off, long long k_off, int causal, float scale,
    void* stream) {
  if (sq < 0 || sk < 0 || d <= 0 || d > D_LIMIT) return (int)cudaErrorInvalidValue;
  if (sq == 0) return 0;
  auto s = (cudaStream_t)stream;
  auto a = (const float*)acc;
  auto mi = (const float*)m;
  auto li = (const float*)l;
  if (bf16)
    return dispatch_d<__nv_bfloat16>(sq, sk, d, q, k, v, a, mi, li, (float*)acc_o,
                                     (float*)m_o, (float*)l_o, q_off, k_off,
                                     causal, scale, s);
  return dispatch_d<float>(sq, sk, d, q, k, v, a, mi, li, (float*)acc_o,
                           (float*)m_o, (float*)l_o, q_off, k_off, causal, scale,
                           s);
}
