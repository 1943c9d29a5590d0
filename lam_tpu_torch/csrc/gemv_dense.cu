// Dense row-major matvec for Hopper (sm_90a): the full-square engine
// (engine="pallas"), the only one for a matrix that is not symmetric, and
// the row shards of the 1-D sharded backend (lam_tpu_torch/parallel/pcg.py).
//
//   lam_gemv_f32        replaces lam_tpu/ops/gemv.py:gemv_f32 (:143; Pallas
//                       kernels _gemv_f32_kernel_dot and
//                       _gemv_f32_kernel_vpu, which compute the same
//                       function)
//   lam_gemv_df64       replaces lam_tpu/ops/gemv.py:gemv_df64 (:812;
//                       Pallas kernel _df64_kernel_body)
//   lam_gemv_f32_cols   replaces lam_tpu/ops/gemv.py:gemv_f32_cols (:216;
//                       Pallas kernel _gemv_f32_cols_kernel): the ring's
//                       partial matvec against one column block
//   lam_gemv_df64_cols  replaces lam_tpu/ops/gemv.py:gemv_df64_cols (:761;
//                       Pallas kernel _df64_cols_kernel)
//
// Contract: A is (m, lda) row-major, m a multiple of ROWS_PER_WARP and the
// width n it reads of each row a multiple of COLS_PER_STEP (the wrappers
// ask for multiples of 128, lam_tpu's rule); A, p and the lo planes are
// 16-byte aligned. A may be a row block of a larger matrix (m != n). The
// full-row kernels read all columns (n == lda). The column-block kernels
// read the nb columns [blk*nb, (blk+1)*nb) of each row in place (n == nb,
// lda the full width, A offset by blk*nb): the TPU kernel picked that
// stripe with a scalar-prefetched block index in its index map; here the
// block index is a host int, known when the ring step is issued, and the
// stripe is never copied.
//
// What bounds it: every element of A is read exactly once, 4 B (f32) or
// 8 B (df64: hi + lo planes), for 2 flops. At 0.5 (f32) or 0.25 (df64)
// flop per byte the card's compute roof is far away, so the only target
// is device-memory bandwidth: 125 us (f32) and 250 us (df64) for a
// 10240^2 square at 3.35 TB/s.
//
// How the design meets that: each warp owns ROWS_PER_WARP consecutive
// rows and walks them together across the columns, each lane taking 4
// columns per step as 16-byte streaming loads (__ldcs), so a warp's loads
// cover whole contiguous 512-byte segments of every row and one load of
// p (read through the read-only cache, __ldg) serves all of the warp's
// rows. Each lane keeps one running sum per row in registers; a warp
// butterfly adds the lanes. Every sum is taken in a FIXED order, with no
// atomics and no second pass, so results repeat bitwise from run to run
// (and with them CG iteration counts). The TPU kernels walked a
// sequential (rows, cols) grid of VMEM tiles with lane accumulators; here
// the column walk is the loop inside the warp. A column block is the same
// walk over a narrower width with the full row stride: each row's stripe
// is still contiguous, so the loads stay whole 512-byte segments.
//
// f32: exact f32 products with f32 accumulation (no TF32, no bf16).
// df64: on the TPU, which has no f64, the (hi, lo) float-float planes were
// multiplied with Dekker two_prod and summed with Knuth two_sum. The H100
// has native fp64 and the kernel is bound by bytes, so it forms hi + lo in
// double (exact: both come from splitting one f64 value), multiplies and
// accumulates in double, and returns the f32 split of the f64 sum, as the
// symmetric df64 kernel does (csrc/gemv_symm.cu).

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;  // 16
constexpr int VEC = 4;                                 // columns per load
constexpr int COLS_PER_STEP = 32 * VEC;                // 128

struct F32Mat {
  using acc_t = float;
  const float* __restrict__ a;
  __device__ __forceinline__ void load(size_t off, acc_t v[VEC]) const {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(a + off));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};

struct DF64Mat {
  using acc_t = double;
  const float* __restrict__ hi;
  const float* __restrict__ lo;
  __device__ __forceinline__ void load(size_t off, acc_t v[VEC]) const {
    const float4 h = __ldcs(reinterpret_cast<const float4*>(hi + off));
    const float4 l = __ldcs(reinterpret_cast<const float4*>(lo + off));
    v[0] = (double)h.x + (double)l.x;
    v[1] = (double)h.y + (double)l.y;
    v[2] = (double)h.z + (double)l.z;
    v[3] = (double)h.w + (double)l.w;
  }
};

struct F32Vec {
  const float* __restrict__ p;
  __device__ __forceinline__ void get(int c, float v[VEC]) const {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p + c));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};

struct DF64Vec {
  const float* __restrict__ hi;
  const float* __restrict__ lo;
  __device__ __forceinline__ void get(int c, double v[VEC]) const {
    const float4 h = __ldg(reinterpret_cast<const float4*>(hi + c));
    const float4 l = __ldg(reinterpret_cast<const float4*>(lo + c));
    v[0] = (double)h.x + (double)l.x;
    v[1] = (double)h.y + (double)l.y;
    v[2] = (double)h.z + (double)l.z;
    v[3] = (double)h.w + (double)l.w;
  }
};

struct F32Out {
  float* __restrict__ y;
  __device__ __forceinline__ void put(int i, float v) const { y[i] = v; }
};

struct DF64Out {
  float* __restrict__ y_hi;
  float* __restrict__ y_lo;
  __device__ __forceinline__ void put(int i, double v) const {
    const float h = (float)v;
    y_hi[i] = h;
    y_lo[i] = (float)(v - (double)h);
  }
};

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <class Mat, class Vec, class Out>
__global__ void __launch_bounds__(THREADS)
dense_rows(Mat A, Vec P, Out Y, int m, int n, int lda) {
  using acc_t = typename Mat::acc_t;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = (blockIdx.x * WARPS + warp) * ROWS_PER_WARP;
  if (r0 >= m) return;  // warp-uniform; no block-wide barrier follows

  acc_t acc[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) acc[r] = acc_t(0);

  const size_t row0 = (size_t)r0 * lda;
#pragma unroll 2
  for (int c = lane * VEC; c < n; c += COLS_PER_STEP) {
    acc_t pv[VEC];
    P.get(c, pv);
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      acc_t av[VEC];
      A.load(row0 + (size_t)r * lda + c, av);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r] += av[j] * pv[j];
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const acc_t v = warp_sum(acc[r]);
    if (lane == 0) Y.put(r0 + r, v);
  }
}

template <class Mat, class Vec, class Out>
int launch(Mat A, Vec P, Out Y, int m, int n, int lda, cudaStream_t stream) {
  if (m % ROWS_PER_WARP || n % COLS_PER_STEP || lda < n || lda % VEC)
    return (int)cudaErrorInvalidValue;
  const int blocks = (m + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  dense_rows<Mat, Vec, Out><<<blocks, THREADS, 0, stream>>>(A, P, Y, m, n, lda);
  return (int)cudaGetLastError();
}

// Element offset of column block blk of width nb in a row of n columns, or
// -1 for a block outside the row.
size_t column_block(int n, int nb, int blk) {
  if (nb <= 0 || n % nb || blk < 0 || blk >= n / nb) return (size_t)-1;
  return (size_t)blk * nb;
}

}  // namespace

// y (m,) = A (m, n) @ p (n,). Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a shape outside the contract above.
extern "C" int lam_gemv_f32(const float* a, const float* p, float* y, int m,
                            int n, void* stream) {
  return launch(F32Mat{a}, F32Vec{p}, F32Out{y}, m, n, n, (cudaStream_t)stream);
}

// (y_hi, y_lo) (m,) = (a_hi + a_lo) (m, n) @ (p_hi + p_lo) (n,), the f32
// split of the f64 result.
extern "C" int lam_gemv_df64(const float* a_hi, const float* a_lo,
                             const float* p_hi, const float* p_lo,
                             float* y_hi, float* y_lo, int m, int n,
                             void* stream) {
  return launch(DF64Mat{a_hi, a_lo}, DF64Vec{p_hi, p_lo},
                DF64Out{y_hi, y_lo}, m, n, n, (cudaStream_t)stream);
}

// y (m,) = A[:, blk*nb:(blk+1)*nb] @ p_blk (nb,) for a row-major (m, n) A.
extern "C" int lam_gemv_f32_cols(const float* a, const float* p_blk, float* y,
                                 int m, int n, int nb, int blk, void* stream) {
  const size_t c0 = column_block(n, nb, blk);
  if (c0 == (size_t)-1) return (int)cudaErrorInvalidValue;
  return launch(F32Mat{a + c0}, F32Vec{p_blk}, F32Out{y}, m, nb, n,
                (cudaStream_t)stream);
}

// (y_hi, y_lo) (m,) = (a_hi + a_lo)[:, blk*nb:(blk+1)*nb] @ (p_hi + p_lo)
// (nb,), the f32 split of the f64 result.
extern "C" int lam_gemv_df64_cols(const float* a_hi, const float* a_lo,
                                  const float* p_hi, const float* p_lo,
                                  float* y_hi, float* y_lo, int m, int n,
                                  int nb, int blk, void* stream) {
  const size_t c0 = column_block(n, nb, blk);
  if (c0 == (size_t)-1) return (int)cudaErrorInvalidValue;
  return launch(DF64Mat{a_hi + c0, a_lo + c0}, DF64Vec{p_hi, p_lo},
                DF64Out{y_hi, y_lo}, m, nb, n, (cudaStream_t)stream);
}
