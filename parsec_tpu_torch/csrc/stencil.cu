// Hand-written Hopper (sm_90a) kernels for the 2D 5-point Jacobi stencil.
//
// Replaces two Pallas TPU kernels of parsec_tpu/ops/pallas_kernels.py:
//   * stencil_5pt (B3): one step of an (h, w) tile,
//       out = 0.25 * (up + down + left + right)
//     where the neighbours past the tile's edges come from the (1, w) halo
//     rows `up`/`down` and the (h, 1) halo columns `left`/`right`;
//   * stencil_5pt_fused (B4): `iters` steps of a whole grid with zero
//     boundaries in one launch.
// The four neighbours are summed in the reference's order,
// ((up + down) + left) + right, then scaled: no contraction into an FMA is
// possible, so each step rounds as the reference's does.
//
// B3.  One thread per output element, blocks of 32 x 8.  The Pallas kernel
// assembles four shifted copies of the tile in VMEM; here each thread reads
// its four neighbours straight from `old` (neighbouring threads share them
// through L1) or, at the edges, from the halos.  The halo columns are strided
// views into the neighbour tiles (LEFT[:, -1:], RIGHT[:, :1]): the kernel
// takes their row strides, so no per-task copy gathers them.  What bounds it:
// one read of `old` and one write of the result, 8 bytes per f32 element
// (2.5 us for a 1024^2 f32 tile at 3.35 TB/s) against 5 flops per element:
// byte-bound.
//
// B4.  A cooperative launch (cudaLaunchCooperativeKernel) of as many blocks
// as can be resident at once; each step is a grid-stride pass and
// grid.sync() separates the steps.  The steps ping-pong between the output
// and a scratch buffer, arranged so that the last step writes the output;
// the input is only read.  Grids up to 2048^2 f32 keep both buffers in the
// 50 MB L2.  What bounds it: the function reads its input once and writes
// its output once, but does 5 flops per element per step, so at 100 steps
// the FP32 rate bounds it (operations); in practice each step is a pass
// over L2 plus a grid-wide barrier.
//
// Interface: plain C entry points bound with ctypes; each launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// launch's cudaError_t (0 = launched).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int FUSED_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(BX * BY)
stencil_kernel(int h, int w, const T* __restrict__ old, const T* __restrict__ up,
               const T* __restrict__ down, const T* __restrict__ left,
               long long left_stride, const T* __restrict__ right,
               long long right_stride, T* __restrict__ out) {
  const int c = blockIdx.x * BX + threadIdx.x;
  const int r = blockIdx.y * BY + threadIdx.y;
  if (r >= h || c >= w) return;
  const size_t i = (size_t)r * w + c;
  const T u = r > 0 ? old[i - w] : up[c];
  const T dn = r < h - 1 ? old[i + w] : down[c];
  const T lf = c > 0 ? old[i - 1] : left[(size_t)r * left_stride];
  const T rt = c < w - 1 ? old[i + 1] : right[(size_t)r * right_stride];
  out[i] = T(0.25) * (((u + dn) + lf) + rt);
}

// `src` and `dst` swap roles between steps and other blocks write what this
// block reads after grid.sync(): no __restrict__ and no read-only cache on
// them.
template <typename T>
__global__ void __launch_bounds__(FUSED_THREADS)
stencil_fused_kernel(int h, int w, int iters, const T* in, T* out, T* tmp) {
  cg::grid_group grid = cg::this_grid();
  const unsigned n = (unsigned)h * (unsigned)w;
  const unsigned stride = gridDim.x * blockDim.x;
  const T* src = in;
  for (int t = 0; t < iters; ++t) {
    // parity chosen so that step iters-1 lands in `out`
    T* dst = ((iters - 1 - t) % 2 == 0) ? out : tmp;
    for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
      const int r = (int)(i / (unsigned)w);
      const int c = (int)(i % (unsigned)w);
      const T u = r > 0 ? src[i - w] : T(0);
      const T dn = r < h - 1 ? src[i + w] : T(0);
      const T lf = c > 0 ? src[i - 1] : T(0);
      const T rt = c < w - 1 ? src[i + 1] : T(0);
      dst[i] = T(0.25) * (((u + dn) + lf) + rt);
    }
    grid.sync();
    src = dst;
  }
}

template <typename T>
int launch_step(int h, int w, const void* old, const void* up, const void* down,
                const void* left, long long ls, const void* right, long long rs,
                void* out, cudaStream_t stream) {
  const dim3 block(BX, BY);
  const dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY);
  stencil_kernel<T><<<grid, block, 0, stream>>>(
      h, w, (const T*)old, (const T*)up, (const T*)down, (const T*)left, ls,
      (const T*)right, rs, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused(int h, int w, int iters, const void* in, void* out, void* tmp,
                 cudaStream_t stream) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stencil_fused_kernel<T>, FUSED_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  // co-resident blocks only (a cooperative launch refuses more), and no
  // more than the grid has work for
  const long long need = ((long long)h * w + FUSED_THREADS - 1) / FUSED_THREADS;
  long long blocks = (long long)sms * per_sm;
  if (need < blocks) blocks = need;
  const T* in_t = (const T*)in;
  T* out_t = (T*)out;
  T* tmp_t = (T*)tmp;
  void* args[] = {&h, &w, &iters, &in_t, &out_t, &tmp_t};
  err = cudaLaunchCooperativeKernel((const void*)stencil_fused_kernel<T>,
                                    dim3((unsigned)blocks), dim3(FUSED_THREADS),
                                    args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_stencil_5pt(int f64, int h, int w, const void* old,
                               const void* up, const void* down, const void* left,
                               long long left_stride, const void* right,
                               long long right_stride, void* out, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (f64)
    return launch_step<double>(h, w, old, up, down, left, left_stride, right,
                               right_stride, out, s);
  return launch_step<float>(h, w, old, up, down, left, left_stride, right,
                            right_stride, out, s);
}

extern "C" int ptt_stencil_5pt_fused(int f64, int h, int w, int iters,
                                     const void* in, void* out, void* tmp,
                                     void* stream) {
  if (h <= 0 || w <= 0 || iters <= 0 || (long long)h * w >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (f64) return launch_fused<double>(h, w, iters, in, out, tmp, s);
  return launch_fused<float>(h, w, iters, in, out, tmp, s);
}
