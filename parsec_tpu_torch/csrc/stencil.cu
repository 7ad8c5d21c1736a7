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
// ((up + down) + left) + right, then scaled, in the grid's own dtype: f32,
// f64, f16 or bf16.  f16 and bf16 values are added in f32 and each partial
// sum is rounded to the storage type, which is the correctly rounded narrow
// add (f32 carries at least 2p + 2 bits of either type), as the reference
// and torch round them.  No contraction into an FMA is possible (the
// multiply comes last), so each step rounds as the reference's does and the
// two B4 modes agree with B3 and the plain versions bit for bit.
//
// B3.  Each thread owns one 16-byte column group (4 f32, 2 f64, 8 f16 or
// bf16 values) and walks down a strip of STEP_ROWS rows.  The loads of the
// whole strip -- the strip's rows and one halo row above and below -- are
// issued before any arithmetic, so each warp keeps (STEP_ROWS + 2) x 512 B
// in flight, and every element of `old` is read from memory once (plus the
// two halo rows).  Rows r - 1, r and r + 1 sit in registers; the left and
// right neighbours of a group's edge elements come from the adjacent lanes
// through shuffles, and only a warp's edge lanes load one extra element
// (at the tile edge from the halo column, read through its row stride: the
// halo columns are strided views into the neighbour tiles, LEFT[:, -1:],
// so no per-task copy gathers them).  Results leave as 16-byte streaming
// stores.  Where the row pitch or a base is not 16-byte aligned, the entry
// point launches the same kernel with one element per thread and scalar
// accesses.  What bounds it: one read of `old` and one write of the result,
// 8 bytes per f32 element (2.5 us for a 1024^2 f32 tile at 3.35 TB/s),
// against 5 operations per element: byte-bound.
//
// B4.  Two modes, chosen by the caller before launch (kernels._fused_mode):
//   * smem: one persistent block per SM holds a strip of `rows` grid rows
//     and two halo rows in shared memory for the whole run, as the Pallas
//     kernel keeps its grid in VMEM.  A step is B3's walk over shared
//     memory: each thread takes its column groups down the strip with rows
//     r - 1, r and r + 1 in registers and its left and right neighbours
//     from the adjacent lanes, and writes each new row back in place at
//     once, since no other thread reads its columns there: a warp's edge
//     lanes take their neighbours across the warp boundary from a small
//     copy of every warp's two edge columns, double-buffered by step
//     parity.  So a step costs one shared read and one shared write of the
//     strip and two barriers.  The block
//     publishes its top and bottom rows to an exchange buffer in global memory
//     (double-buffered by step parity) as 8-byte words that carry the step
//     in their upper half.  Each thread then polls only its own columns of
//     the two neighbours' rows until they carry this step's tag, and moves
//     them into the halo rows: the data is its own flag, so a step costs
//     one store and one load through L2 on the critical path, no fence and
//     no grid-wide barrier.  The launch is cooperative: guaranteed
//     co-residency is what makes the spin-wait safe.  The halos past the
//     physical edge stay zero.  The last step writes the output.  What
//     bounds it: the per-step dependency across SMs (an exchange through
//     L2 each step); the FP32 rate bounds the function (5 operations per
//     element per step).
//   * global: the grid does not fit the blocks' shared memory (f64 2048^2;
//     f32 wider than 2048 columns or taller than ~3000 rows).  As many blocks as are co-resident make a
//     grid-stride pass per step, with grid.sync() between steps; the steps
//     ping-pong between the output and a scratch buffer, arranged so that
//     the last step writes the output, and the input is only read.
//
// Interface: plain C entry points bound with ctypes; each launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// launch's cudaError_t (0 = launched).  dtype codes: 0 f32, 1 f64, 2 f16,
// 3 bf16.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int STEP_THREADS = 128;  // B3: one warp covers 512 contiguous bytes
constexpr int STEP_ROWS = 4;       // B3: rows of one thread's strip
constexpr int FUSED_THREADS = 256;        // B4 global mode
constexpr int FUSED_SMEM_THREADS = 512;   // B4 smem mode
constexpr unsigned FULL = 0xffffffffu;

// -- arithmetic in the storage type ----------------------------------------

template <typename T>
struct Arith {  // float, double: native
  __device__ static T add(T a, T b) { return a + b; }
  __device__ static T quarter(T a) { return T(0.25) * a; }
};
template <>
struct Arith<__half> {
  __device__ static __half add(__half a, __half b) {
    return __float2half_rn(__half2float(a) + __half2float(b));
  }
  __device__ static __half quarter(__half a) { return __float2half_rn(0.25f * __half2float(a)); }
};
template <>
struct Arith<__nv_bfloat16> {
  __device__ static __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  __device__ static __nv_bfloat16 quarter(__nv_bfloat16 a) {
    return __float2bfloat16_rn(0.25f * __bfloat162float(a));
  }
};

template <typename T>
__device__ __forceinline__ T five_point(T u, T dn, T lf, T rt) {
  using A = Arith<T>;
  return A::quarter(A::add(A::add(A::add(u, dn), lf), rt));
}

// -- bit-level helpers ------------------------------------------------------

// a value of T through its bits as an unsigned integer of the same size
template <int BYTES> struct BitsOf;
template <> struct BitsOf<2> { using type = unsigned short; };
template <> struct BitsOf<4> { using type = unsigned int; };
template <> struct BitsOf<8> { using type = unsigned long long; };

template <typename T>
__device__ __forceinline__ T shfl_up1(T x) {
  using B = typename BitsOf<sizeof(T)>::type;
  B b;
  memcpy(&b, &x, sizeof(T));
  if constexpr (sizeof(T) == 2)
    b = (B)__shfl_up_sync(FULL, (unsigned)b, 1);
  else
    b = __shfl_up_sync(FULL, b, 1);
  memcpy(&x, &b, sizeof(T));
  return x;
}
template <typename T>
__device__ __forceinline__ T shfl_down1(T x) {
  using B = typename BitsOf<sizeof(T)>::type;
  B b;
  memcpy(&b, &x, sizeof(T));
  if constexpr (sizeof(T) == 2)
    b = (B)__shfl_down_sync(FULL, (unsigned)b, 1);
  else
    b = __shfl_down_sync(FULL, b, 1);
  memcpy(&x, &b, sizeof(T));
  return x;
}

// VEC values at p: one 16-byte read-only load, or one scalar (VEC == 1)
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(T (&dst)[VEC], const T* __restrict__ p) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(dst, &raw, 16);
  } else {
    static_assert(VEC == 1, "a group is 16 bytes or one element");
    dst[0] = *p;
  }
}
// VEC values to p: one 16-byte streaming store, or one scalar store
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const T (&src)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    memcpy(&raw, src, 16);
    __stcs(reinterpret_cast<uint4*>(p), raw);
  } else {
    *p = src[0];
  }
}
// VEC values from / to shared memory: one 16-byte access, or one scalar
template <typename T, int VEC>
__device__ __forceinline__ void lds_vec(T (&dst)[VEC], const T* p) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    memcpy(dst, &raw, 16);
  } else {
    dst[0] = *p;
  }
}
template <typename T, int VEC>
__device__ __forceinline__ void sts_vec(T* p, const T (&src)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    memcpy(&raw, src, 16);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    *p = src[0];
  }
}

// B4's exchange words: 32 bits of a value and, above them, the step tag
// that says which step wrote it, so a reader polls the data itself -- no
// separate flag, no fence.  An aligned 8-byte access is single-copy atomic;
// relaxed accesses at gpu scope bypass the (incoherent) L1.
using Word = unsigned long long;
__host__ __device__ constexpr int words_of(int bytes) { return bytes == 8 ? 2 : 1; }

__device__ __forceinline__ Word ld_word(const Word* p) {
  Word v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_word(Word* p, Word v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// the value's bits as WORDS 32-bit pieces, each under `tag`
template <typename T>
__device__ __forceinline__ void put_tagged(Word* p, T x, unsigned tag) {
  using B = typename BitsOf<sizeof(T)>::type;
  B bits;
  memcpy(&bits, &x, sizeof(T));
#pragma unroll
  for (int i = 0; i < words_of(sizeof(T)); ++i)
    st_word(p + i, (Word)tag << 32 | (Word)(unsigned)((unsigned long long)bits >> (32 * i)));
}
template <typename T>
__device__ __forceinline__ T from_words(const Word (&v)[words_of(sizeof(T))]) {
  using B = typename BitsOf<sizeof(T)>::type;
  unsigned long long bits = 0;
#pragma unroll
  for (int i = 0; i < words_of(sizeof(T)); ++i) bits |= (v[i] & 0xffffffffull) << (32 * i);
  const B b = (B)bits;
  T x;
  memcpy(&x, &b, sizeof(T));
  return x;
}

// -- B3: one step of a tile -------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(STEP_THREADS)
stencil_step_kernel(int h, int w, const T* __restrict__ old, const T* __restrict__ up,
                    const T* __restrict__ down, const T* __restrict__ left, long long ls,
                    const T* __restrict__ right, long long rs, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x * STEP_THREADS + threadIdx.x) * VEC;
  const int r0 = blockIdx.y * STEP_ROWS;
  const bool active = c0 < w;  // whole groups: w is a multiple of VEC
  const int ce = c0 + VEC;     // the column right of the group
  // lanes whose right neighbour is not the next lane's first element
  const bool right_edge = lane == 31 || ce >= w;

  // every load of the strip first: rows r0 - 1 .. r0 + STEP_ROWS of the
  // group, then the warp edges' extra elements
  T x[STEP_ROWS + 2][VEC];
#pragma unroll
  for (int i = 0; i < STEP_ROWS + 2; ++i) {
    const int r = r0 - 1 + i;
    const T* src = r < 0 ? up + c0 : r < h ? old + (size_t)r * w + c0 : down + c0;
    if (active && r <= h) {
      load_vec<T, VEC>(x[i], src);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[i][e] = T{};
    }
  }
  T lf[STEP_ROWS], rt[STEP_ROWS];
#pragma unroll
  for (int i = 0; i < STEP_ROWS; ++i) {
    const int r = r0 + i;
    lf[i] = T{};
    rt[i] = T{};
    if (active && r < h) {
      if (lane == 0) lf[i] = c0 > 0 ? old[(size_t)r * w + c0 - 1] : left[(size_t)r * ls];
      if (right_edge) rt[i] = ce < w ? old[(size_t)r * w + ce] : right[(size_t)r * rs];
    }
  }

#pragma unroll
  for (int i = 0; i < STEP_ROWS; ++i) {
    // every lane takes part in the shuffles, active or not
    const T from_left = shfl_up1(x[i + 1][VEC - 1]);
    const T from_right = shfl_down1(x[i + 1][0]);
    const int r = r0 + i;
    if (!active || r >= h) continue;
    T o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const T l = e > 0 ? x[i + 1][e - 1] : lane == 0 ? lf[i] : from_left;
      const T rr = e < VEC - 1 ? x[i + 1][e + 1] : right_edge ? rt[i] : from_right;
      o[e] = five_point(x[i][e], x[i + 2][e], l, rr);
    }
    store_vec<T, VEC>(out + (size_t)r * w + c0, o);
  }
}

template <typename T>
int launch_step(int vec, int h, int w, const void* old, const void* up, const void* down,
                const void* left, long long ls, const void* right, long long rs, void* out,
                cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int groups = vec ? w / VEC : w;
  const dim3 grid((groups + STEP_THREADS - 1) / STEP_THREADS, (h + STEP_ROWS - 1) / STEP_ROWS);
  if (vec)
    stencil_step_kernel<T, VEC><<<grid, STEP_THREADS, 0, stream>>>(
        h, w, (const T*)old, (const T*)up, (const T*)down, (const T*)left, ls, (const T*)right,
        rs, (T*)out);
  else
    stencil_step_kernel<T, 1><<<grid, STEP_THREADS, 0, stream>>>(
        h, w, (const T*)old, (const T*)up, (const T*)down, (const T*)left, ls, (const T*)right,
        rs, (T*)out);
  return (int)cudaGetLastError();
}

// -- B4, smem mode ----------------------------------------------------------

// column slots per thread: FUSED_SMEM_THREADS * this many columns at most
// (one element a slot; a 16-byte group covers them in one slot)
template <typename T>
__host__ __device__ constexpr int fused_slots() {
  return sizeof(T) == 8 ? 2 : 4;
}

// `xbuf` holds [2 parities][blocks][top, bottom][w][WORDS] tagged words,
// zero at launch (no step writes tag 0).  Each block owns grid rows
// [b * rows, b * rows + n).  A thread takes VEC adjacent columns a slot:
// 16-byte groups where the row pitch allows, else one element.  Slot k of
// warp j covers span s = j + k * FUSED_SMEM_THREADS / 32, the 32 * VEC columns
// from s * 32 * VEC.  Shared memory: the strip and its halo rows, then
// `side`, [2 parities][spans][first, last column][rows]: each span's two
// edge columns of the previous step, which the neighbouring spans' edge
// lanes read instead of the values being overwritten in place.
template <typename T, int VEC>
__global__ void __launch_bounds__(FUSED_SMEM_THREADS)
stencil_fused_smem_kernel(int h, int w, int iters, int rows, const T* __restrict__ in,
                          T* __restrict__ out, Word* xbuf) {
  constexpr int KC = VEC == 1 ? fused_slots<T>() : 1;
  constexpr int WORDS = words_of(sizeof(T));
  extern __shared__ __align__(16) unsigned char fsm[];
  T* buf = reinterpret_cast<T*>(fsm);  // [n + 2][w]: row 0 and row n + 1 are halos
  T* side = buf + (size_t)(rows + 2) * w;
  const int b = blockIdx.x, nb = gridDim.x, tid = threadIdx.x, lane = tid & 31;
  const int spans = (w + 32 * VEC - 1) / (32 * VEC);
  const int r0 = b * rows;
  const int n = min(rows, h - r0);
  const size_t edge = (size_t)w * WORDS;  // one exchanged row
  // side[p][s][j][i]: parity p, span s, j 0 first / 1 last column, row i
  auto side_at = [&](int p, int s, int j) { return side + ((size_t)(p * spans + s) * 2 + j) * rows; };

  // the strip and its halo rows from the input; zeros past the grid's edge
#pragma unroll 8
  for (int i = tid; i < (n + 2) * w; i += FUSED_SMEM_THREADS) {
    const int gr = r0 - 1 + i / w;
    buf[i] = gr >= 0 && gr < h ? in[(size_t)gr * w + i % w] : T{};
  }
  __syncthreads();
  // the spans' edge columns of the input, for step 0
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int c0 = (tid + k * FUSED_SMEM_THREADS) * VEC, s = c0 / (32 * VEC);
    if (c0 >= w) continue;
    for (int i = 0; i < n; ++i) {
      if (lane == 0) side_at(0, s, 0)[i] = buf[(size_t)(i + 1) * w + c0];
      if (lane == 31) side_at(0, s, 1)[i] = buf[(size_t)(i + 1) * w + c0 + VEC - 1];
    }
  }
  __syncthreads();

  for (int t = 0; t < iters; ++t) {
    const bool last = t == iters - 1;
    const unsigned tag = (unsigned)t + 1;
    const int p = t & 1;
    Word* xs = xbuf + (size_t)p * nb * 2 * edge;  // this step's parity
    Word* mine = xs + (size_t)b * 2 * edge;       // this block's [top, bottom]
    // each thread walks its groups down the strip with rows i - 1, i and
    // i + 1 in registers (one 16-byte shared load a row, issued a row ahead)
    // and its left and right neighbours from the adjacent lanes; a span's
    // edge lanes read the neighbouring spans' edge columns from `side`.  The
    // strip's edge rows are computed first and leave for the exchange, so
    // the exchange's latency runs under the walk.  A group's new row goes
    // back in place at once (no one else reads it there), and the span's
    // edge columns to the other parity of `side`.
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c0 = (tid + k * FUSED_SMEM_THREADS) * VEC, s = c0 / (32 * VEC);
      if (s * 32 * VEC >= w) continue;  // the whole warp idle
      const bool active = c0 < w;
      const int ce = c0 + VEC;
      const T* lside = s > 0 ? side_at(p, s - 1, 1) : nullptr;  // lane 0's left neighbours
      const T* rside = s + 1 < spans ? side_at(p, s + 1, 0) : nullptr;  // lane 31's right ones
      // grid row i of the group from buf rows i, i + 1, i + 2
      auto new_row = [&](int i, T (&o)[VEC], const T (&up)[VEC], const T (&cur)[VEC],
                         const T (&dn)[VEC]) {
        T lf = shfl_up1(cur[VEC - 1]);  // every lane of the warp takes part
        T rt = shfl_down1(cur[0]);
        if (lane == 0) lf = lside ? lside[i] : T{};
        if (lane == 31 || ce >= w) rt = lane == 31 && rside ? rside[i] : T{};
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o[e] = five_point(up[e], dn[e], e > 0 ? cur[e - 1] : lf, e < VEC - 1 ? cur[e + 1] : rt);
      };
      auto load = [&](T (&x)[VEC], int r) {  // buf row r, zeros for idle lanes
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[e] = T{};
        if (active) lds_vec<T, VEC>(x, buf + (size_t)r * w + c0);
      };
      if (!last) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // top row, bottom row (the same when n == 1)
          const int i = j ? n - 1 : 0;
          T up[VEC], cur[VEC], dn[VEC], o[VEC];
          load(up, i);
          load(cur, i + 1);
          load(dn, i + 2);
          new_row(i, o, up, cur, dn);
          if (active) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              put_tagged(mine + (size_t)j * edge + (size_t)(c0 + e) * WORDS, o[e], tag);
          }
        }
      }
      T x0[VEC], x1[VEC], x2[VEC];
      load(x0, 0);
      load(x1, 1);
      load(x2, 2);
#pragma unroll 2
      for (int i = 0; i < n; ++i) {
        T x3[VEC];
        load(x3, i + 1 < n ? i + 3 : i + 2);  // the next row's below, before this row's store
        T o[VEC];
        new_row(i, o, x0, x1, x2);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          x0[e] = x1[e];
          x1[e] = x2[e];
          x2[e] = x3[e];
        }
        if (!active) continue;
        if (last) {
          store_vec<T, VEC>(out + (size_t)(r0 + i) * w + c0, o);
          continue;
        }
        sts_vec<T, VEC>(buf + (size_t)(i + 1) * w + c0, o);
        if (lane == 0) side_at(p ^ 1, s, 0)[i] = o[0];
        if (lane == 31) side_at(p ^ 1, s, 1)[i] = o[VEC - 1];
      }
    }
    if (last) break;
    __syncthreads();  // every read of the old halo rows and of `side[p]` is done

    // the neighbours' edge rows of this step into the halo rows: each
    // thread polls its own columns' words until they carry this step's tag
    // (all loads issued before any is waited on)
    const Word* above_rows = b > 0 ? xs + (size_t)(b - 1) * 2 * edge + edge : xs;  // its bottom row
    const Word* below_rows = b < nb - 1 ? xs + (size_t)(b + 1) * 2 * edge : xs;  // its top row
    Word got[2][KC][VEC][WORDS];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c0 = (tid + k * FUSED_SMEM_THREADS) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int j = 0; j < WORDS; ++j) {
          const size_t at = (size_t)(c0 + e) * WORDS + j;
          got[0][k][e][j] = b > 0 && c0 < w ? ld_word(above_rows + at) : 0;
          got[1][k][e][j] = b < nb - 1 && c0 < w ? ld_word(below_rows + at) : 0;
        }
    }
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c0 = (tid + k * FUSED_SMEM_THREADS) * VEC;
      if (c0 >= w) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
#pragma unroll
        for (int j = 0; j < WORDS; ++j) {
          const size_t at = (size_t)(c0 + e) * WORDS + j;
          if (b > 0)
            while ((unsigned)(got[0][k][e][j] >> 32) != tag) got[0][k][e][j] = ld_word(above_rows + at);
          if (b < nb - 1)
            while ((unsigned)(got[1][k][e][j] >> 32) != tag) got[1][k][e][j] = ld_word(below_rows + at);
        }
        if (b > 0) buf[c0 + e] = from_words<T>(got[0][k][e]);
        if (b < nb - 1) buf[(size_t)(n + 1) * w + c0 + e] = from_words<T>(got[1][k][e]);
      }
    }
    __syncthreads();  // the halo rows are in place
  }
}

// -- B4, global mode --------------------------------------------------------

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
      const T u = r > 0 ? src[i - w] : T{};
      const T dn = r < h - 1 ? src[i + w] : T{};
      const T lf = c > 0 ? src[i - 1] : T{};
      const T rt = c < w - 1 ? src[i + 1] : T{};
      dst[i] = five_point(u, dn, lf, rt);
    }
    grid.sync();
    src = dst;
  }
}

int cooperative_ok() {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  return coop ? 0 : (int)cudaErrorNotSupported;
}

template <typename T>
int launch_fused_global(int h, int w, int iters, const void* in, void* out, void* tmp,
                        cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stencil_fused_kernel<T>,
                                                        FUSED_THREADS, 0);
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
  err = cudaLaunchCooperativeKernel((const void*)stencil_fused_kernel<T>, dim3((unsigned)blocks),
                                    dim3(FUSED_THREADS), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_fused_smem_v(int h, int w, int iters, int rows, size_t smem, int optin,
                        const void* in, void* out, void* xbuf, cudaStream_t stream) {
  auto kern = stencil_fused_smem_kernel<T, VEC>;
  // opted in to the device's whole per-block allowance once per kernel (a
  // thread-safe static), for the device current at the first launch -- the
  // port drives one device
  static const cudaError_t opted =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (opted != cudaSuccess) return (int)opted;
  const T* in_t = (const T*)in;
  T* out_t = (T*)out;
  Word* x_t = (Word*)xbuf;
  void* args[] = {&h, &w, &iters, &rows, &in_t, &out_t, &x_t};
  const unsigned blocks = (unsigned)((h + rows - 1) / rows);
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                                dim3(FUSED_SMEM_THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused_smem(int vec, int h, int w, int iters, int rows, const void* in, void* out,
                      void* xbuf, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // the strip with its halo rows, then `side`
  const int spans = (w + 32 * (vec ? VEC : 1) - 1) / (32 * (vec ? VEC : 1));
  const size_t smem = ((size_t)(rows + 2) * w + (size_t)4 * spans * rows) * sizeof(T);
  if (w > FUSED_SMEM_THREADS * fused_slots<T>() || (vec && w % VEC))
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (vec) return launch_fused_smem_v<T, VEC>(h, w, iters, rows, smem, optin, in, out, xbuf, stream);
  return launch_fused_smem_v<T, 1>(h, w, iters, rows, smem, optin, in, out, xbuf, stream);
}

template <typename T>
int launch_fused(int mode, int vec, int h, int w, int iters, int rows, const void* in, void* out,
                 void* tmp, void* xbuf, cudaStream_t stream) {
  const int ok = cooperative_ok();
  if (ok != 0) return ok;
  if (mode == 1) return launch_fused_smem<T>(vec, h, w, iters, rows, in, out, xbuf, stream);
  return launch_fused_global<T>(h, w, iters, in, out, tmp, stream);
}

}  // namespace

extern "C" int ptt_stencil_device(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

extern "C" int ptt_stencil_5pt(int dtype, int vec, int h, int w, const void* old,
                               const void* up, const void* down, const void* left,
                               long long left_stride, const void* right,
                               long long right_stride, void* out, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_step<float>(vec, h, w, old, up, down, left, left_stride, right,
                                right_stride, out, s);
    case 1:
      return launch_step<double>(vec, h, w, old, up, down, left, left_stride, right,
                                 right_stride, out, s);
    case 2:
      return launch_step<__half>(vec, h, w, old, up, down, left, left_stride, right,
                                 right_stride, out, s);
    case 3:
      return launch_step<__nv_bfloat16>(vec, h, w, old, up, down, left, left_stride, right,
                                        right_stride, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// mode: 0 global, 1 smem (`rows` grid rows a block; `xbuf` the zeroed
// exchange words, [2][ceil(h / rows)][2][w][8 bytes: 2, else 1]; `vec`:
// 16-byte column groups, for a row pitch and an output base that are 16-byte
// multiples); `tmp` is the global mode's scratch grid
extern "C" int ptt_stencil_5pt_fused(int dtype, int mode, int vec, int h, int w, int iters,
                                     int rows, const void* in, void* out, void* tmp, void* xbuf,
                                     void* stream) {
  if (h <= 0 || w <= 0 || iters <= 0 || (long long)h * w >= (1LL << 31) ||
      (mode == 1 && rows <= 0))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_fused<float>(mode, vec, h, w, iters, rows, in, out, tmp, xbuf, s);
    case 1:
      return launch_fused<double>(mode, vec, h, w, iters, rows, in, out, tmp, xbuf, s);
    case 2:
      return launch_fused<__half>(mode, vec, h, w, iters, rows, in, out, tmp, xbuf, s);
    case 3:
      return launch_fused<__nv_bfloat16>(mode, vec, h, w, iters, rows, in, out, tmp, xbuf, s);
  }
  return (int)cudaErrorInvalidValue;
}
