// Dense row-major matvec for Hopper (sm_90a): the full-square engine
// (engine="pallas"), the only one for a matrix that is not symmetric, and
// the row shards of the 1-D sharded backend (lam_tpu_torch/parallel/pcg.py).
//
//   lam_gemv_f32        replaces lam_tpu/ops/gemv.py:gemv_f32 (:143; Pallas
//                       kernels _gemv_f32_kernel_dot and
//                       _gemv_f32_kernel_vpu, which compute the same
//                       function).                         Walk: dense_rows.
//   lam_gemv_df64       replaces lam_tpu/ops/gemv.py:gemv_df64 (:812;
//                       Pallas kernel _df64_kernel_body). Walk: dense_stream.
//   lam_gemv_f32_cols   replaces lam_tpu/ops/gemv.py:gemv_f32_cols (:216;
//                       Pallas kernel _gemv_f32_cols_kernel): the ring's
//                       partial matvec against one column block.
//                                                          Walk: dense_stream.
//   lam_gemv_df64_cols  replaces lam_tpu/ops/gemv.py:gemv_df64_cols (:761;
//                       Pallas kernel _df64_cols_kernel). Walk: dense_rows.
//
// Contract: A is (m, lda) row-major and the width n it reads of each row a
// multiple of COLS_PER_STEP (the wrappers ask for multiples of 128 on both
// sides, lam_tpu's rule; dense_rows also needs m a multiple of
// ROWS_PER_WARP); A, p and the lo planes are 16-byte aligned. A may be a
// row block of a larger matrix (m != n). The full-row kernels read all
// columns (n == lda). The column-block kernels read the nb columns
// [blk*nb, (blk+1)*nb) of each row in place (n == nb, lda the full width,
// A offset by blk*nb): the TPU kernel picked that stripe with a
// scalar-prefetched block index in its index map; here the block index is
// a host int, known when the ring step is issued, and the stripe is never
// copied.
//
// What bounds it: every element of A is read exactly once, 4 B (f32) or
// 8 B (df64: hi + lo planes), for 2 flops. At 0.5 (f32) or 0.25 (df64)
// flop per byte the card's compute roof is far away, so the only target
// is device-memory bandwidth: 125 us (f32) and 250 us (df64) for a
// 10240^2 square at 3.35 TB/s, 31.3 us for the ring's (5120, 5120) f32
// column block of a (5120, 10240) shard.
//
// Both walks give every row to one warp, which sums it in one FIXED order:
// each lane takes 4 columns per step of COLS_PER_STEP, in column order,
// into one running sum per row; a warp butterfly then adds the lanes. No
// atomics, no second pass: results repeat bitwise from run to run (and
// with them CG iteration counts), and the two walks give the same bits.
// The TPU kernels walked a sequential (rows, cols) grid of VMEM tiles with
// lane accumulators; here the column walk is the loop inside the warp.
//
// dense_rows (kernels 3 and 6): a fixed grid of ROWS_PER_BLOCK-row blocks.
// Each warp walks ROWS_PER_WARP rows together across the columns with
// 16-byte streaming loads (__ldcs), so a warp's loads cover whole 512-byte
// segments of every row and one load of p (__ldg) serves all its rows. The
// bytes in flight are what the registers and the unroll allow.
//
// dense_stream (kernels 4 and 5): a persistent grid of BLOCKS_PER_SM blocks
// on each SM (the SM count read once and cached), each owning a contiguous
// range of whole rows, balanced to within one row (m=5120 on 132 SMs, two
// blocks a SM: 19 or 20 rows a block, where 16-row blocks left 56 SMs with
// 3 blocks and 76 with 2). The block's last warp is the producer: one
// thread fills a ring of STAGES stages in shared memory with TMA 1-D bulk
// copies (cp.async.bulk ... mbarrier::complete_tx::bytes: UBLKCP in the
// SASS), one copy per row and plane of a stage of STAGE_ROWS rows x
// STAGE_COLS columns, read in place at stride lda (each row's stripe of a
// column block is contiguous), evict-first in L2; and one copy per plane of
// the same STAGE_COLS entries of p, evict-last, so the consumers read p
// from shared memory too (through __ldg it missed the small L1 that the
// ring leaves). Each stage has a full and an empty mbarrier. The WARPS
// consumer warps wait on a stage's full barrier, read their rows and p as
// 16-byte vectors (a warp reads 512 contiguous bytes of one row: no bank
// conflict), and arrive on its empty barrier. Every copy issued is waited
// on by the consumers, so none is in flight when the block exits. Bytes in
// flight a SM are STAGES x stage bytes x blocks, whatever the registers:
// the data sheet's 3.35 TB/s at ~1.5 us of latency needs ~38 KB a SM.
//
// Sizes, from a sweep on an H100 (PERF.md section 6): f32 column block
// STAGES=3, STAGE_ROWS=16, STAGE_COLS=512 (32 KB of A and 2 KB of p a
// stage, 102 KB a block), two blocks a SM of 4 consumer warps: 204 KB a
// SM; df64 STAGES=3, STAGE_ROWS=16, STAGE_COLS=512 (hi and lo: 64 KB of A
// and 4 KB of p a stage, 204 KB a block), one block a SM of 8 consumer
// warps. Smaller copies (1 KB and less) or fewer rows a stage were slower;
// a deeper ring was not faster: past ~100 KB a SM the bytes in flight are
// not what limits the walk.
//
// f32: exact f32 products with f32 accumulation (no TF32, no bf16).
// df64: on the TPU, which has no f64, the (hi, lo) float-float planes were
// multiplied with Dekker two_prod and summed with Knuth two_sum. The H100
// has native fp64 and the kernel is bound by bytes, so it forms hi + lo in
// double (exact: both come from splitting one f64 value), multiplies and
// accumulates in double, and returns the f32 split of the f64 sum, as the
// symmetric df64 kernel does (csrc/gemv_symm.cu).

#include <cstdint>

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

// ---- dense_stream: the persistent walk fed by TMA bulk copies -------------

constexpr int MAX_DEVICES = 64;  // of the per-device caches

template <int STAGES_, int STAGE_ROWS_, int STAGE_COLS_, int BLOCKS_PER_SM_,
          int WARPS_>
struct StreamCfg {
  static constexpr int STAGES = STAGES_;          // ring depth
  static constexpr int STAGE_ROWS = STAGE_ROWS_;  // rows a stage
  static constexpr int STAGE_COLS = STAGE_COLS_;  // columns of a row a stage
  static constexpr int BLOCKS_PER_SM = BLOCKS_PER_SM_;
  static constexpr int WARPS = WARPS_;            // consumer warps a block
  static constexpr int THREADS = (WARPS + 1) * 32;  // + the producer warp
  static_assert(STAGE_ROWS % WARPS == 0, "rows split over the warps");
  static_assert(STAGE_COLS % COLS_PER_STEP == 0, "whole lane steps");
};

// The f32 planes of a streamed operand (A, or p), and how the 16-byte vector
// i of one staged row (plane 0 at s, plane k at s + k * plane_floats)
// becomes four accumulator values.
struct F32Stream {
  using acc_t = float;
  static constexpr int PLANES = 1;
  const float* plane[PLANES];
  __device__ __forceinline__ static void get(const float* s, int, int i,
                                             acc_t v[VEC]) {
    const float4 x = reinterpret_cast<const float4*>(s)[i];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};

struct DF64Stream {
  using acc_t = double;
  static constexpr int PLANES = 2;  // hi, lo
  const float* plane[PLANES];
  __device__ __forceinline__ static void get(const float* s, int plane_floats,
                                             int i, acc_t v[VEC]) {
    const float4 h = reinterpret_cast<const float4*>(s)[i];
    const float4 l = reinterpret_cast<const float4*>(s + plane_floats)[i];
    v[0] = (double)h.x + (double)l.x;
    v[1] = (double)h.y + (double)l.y;
    v[2] = (double)h.z + (double)l.z;
    v[3] = (double)h.w + (double)l.w;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// L2 policies of the copies: A is read once (evict first), p by every
// block (evict last).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// TMA 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into this block's shared memory; completes
// its bytes on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)),
         "l"(policy)
      : "memory");
}

// A stage: the A planes, each STAGE_ROWS x STAGE_COLS floats (row r of
// plane k at k * R * C + r * C), then the p planes of the same columns,
// each STAGE_COLS floats.
template <class Cfg, class Mat>
__host__ __device__ constexpr int stage_floats() {
  return Mat::PLANES * (Cfg::STAGE_ROWS + 1) * Cfg::STAGE_COLS;
}

template <class Cfg, class Mat, class Out>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::BLOCKS_PER_SM)
dense_stream(Mat A, Mat P, Out Y, int m, int n, int lda) {
  using acc_t = typename Mat::acc_t;
  constexpr int S = Cfg::STAGES, R = Cfg::STAGE_ROWS, C = Cfg::STAGE_COLS;
  constexpr int W = Cfg::WARPS;
  constexpr int RW = R / W;  // rows of a stage a consumer warp sums
  constexpr int NP = Mat::PLANES;
  constexpr int PLANE_FLOATS = R * C;
  constexpr int STAGE_FLOATS = stage_floats<Cfg, Mat>();
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[S], empty[S];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this block's rows [r0, r1), balanced to within one row
  const int r0 = (int)((long long)blockIdx.x * m / gridDim.x);
  const int r1 = (int)((long long)(blockIdx.x + 1) * m / gridDim.x);
  const int chunks = (n + C - 1) / C;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == W) {  // the producer: one thread issues every copy
    if (lane == 0) {
      const uint64_t once = evict_first_policy();
      const uint64_t keep = evict_last_policy();
      int s = 0;
      uint32_t phase = 0;
      for (int g = r0; g < r1; g += R) {
        const int rows = min(R, r1 - g);
        for (int k = 0; k < chunks; ++k) {
          const int c0 = k * C;
          const uint32_t bytes = (uint32_t)min(C, n - c0) * sizeof(float);
          mbar_wait(&empty[s], phase ^ 1);  // the first pass finds it free
          mbar_expect_tx(&full[s], (rows + 1) * NP * bytes);
          float* st = ring + s * STAGE_FLOATS;
          for (int pl = 0; pl < NP; ++pl) {
            for (int r = 0; r < rows; ++r)
              bulk_copy(st + pl * PLANE_FLOATS + r * C,
                        A.plane[pl] + (size_t)(g + r) * lda + c0, bytes,
                        &full[s], once);
            bulk_copy(st + NP * PLANE_FLOATS + pl * C, P.plane[pl] + c0,
                      bytes, &full[s], keep);
          }
          if (++s == S) { s = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // the consumers: warp w sums the stage rows w, w + W, ...
  int s = 0;
  uint32_t phase = 0;
  for (int g = r0; g < r1; g += R) {
    const int rows = min(R, r1 - g);
    acc_t acc[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) acc[rr] = acc_t(0);
    for (int k = 0; k < chunks; ++k) {
      const int steps = min(C, n - k * C) / COLS_PER_STEP;
      mbar_wait(&full[s], phase);
      const float* st = ring + s * STAGE_FLOATS;
#pragma unroll
      for (int t = 0; t < C / COLS_PER_STEP; ++t) {
        if (t < steps) {
          const int i = t * 32 + lane;  // this lane's 16-byte vector
          acc_t pv[VEC];
          Mat::get(st + NP * PLANE_FLOATS, C, i, pv);
#pragma unroll
          for (int rr = 0; rr < RW; ++rr) {
            const int r = rr * W + warp;
            if (r < rows) {  // warp-uniform
              acc_t av[VEC];
              Mat::get(st + r * C, PLANE_FLOATS, i, av);
#pragma unroll
              for (int j = 0; j < VEC; ++j) acc[rr] += av[j] * pv[j];
            }
          }
        }
      }
      __syncwarp();  // every lane's reads of the stage before the release
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == S) { s = 0; phase ^= 1; }
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = rr * W + warp;
      if (r < rows) {
        const acc_t v = warp_sum(acc[rr]);
        if (lane == 0) Y.put(g + r, v);
      }
    }
  }
}

// The card's SM count, read once for each device.
int sm_count(int dev, int* sms) {
  static int cached[MAX_DEVICES];
  if (dev >= 0 && dev < MAX_DEVICES && cached[dev]) {
    *sms = cached[dev];
    return (int)cudaSuccess;
  }
  const cudaError_t e =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev >= 0 && dev < MAX_DEVICES) cached[dev] = *sms;
  return (int)e;
}

template <class Cfg, class Mat, class Out>
int launch_stream(Mat A, Mat P, Out Y, int m, int n, int lda,
                  cudaStream_t stream) {
  if (m <= 0 || n <= 0 || n % COLS_PER_STEP || lda < n || lda % VEC)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < Mat::PLANES; ++k)
    if (reinterpret_cast<uintptr_t>(A.plane[k]) % 16 ||
        reinterpret_cast<uintptr_t>(P.plane[k]) % 16)
      return (int)cudaErrorInvalidValue;
  constexpr size_t smem =
      (size_t)Cfg::STAGES * stage_floats<Cfg, Mat>() * sizeof(float);
  auto kernel = dense_stream<Cfg, Mat, Out>;
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int se = sm_count(dev, &sms);
  if (se != (int)cudaSuccess) return se;
  static bool sized[MAX_DEVICES];  // shared memory above 48 KB allowed
  if (dev < 0 || dev >= MAX_DEVICES || !sized[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 0 && dev < MAX_DEVICES) sized[dev] = true;
  }
  const int grid = sms * Cfg::BLOCKS_PER_SM;
  const int blocks = grid < m ? grid : m;
  kernel<<<blocks, Cfg::THREADS, smem, stream>>>(A, P, Y, m, n, lda);
  return (int)cudaGetLastError();
}

// The sizes of dense_stream for each entry point (header).
using F32ColsCfg = StreamCfg<3, 16, 512, 2, 4>;
using DF64Cfg = StreamCfg<3, 16, 512, 1, 8>;

// Element offset of column block blk of width nb in a row of n columns, or
// -1 for a block outside the row.
size_t column_block(int n, int nb, int blk) {
  if (nb <= 0 || n % nb || blk < 0 || blk >= n / nb) return (size_t)-1;
  return (size_t)blk * nb;
}

}  // namespace

// y (m,) = A (m, n) @ p (n,). Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a shape outside the contract above.
// Walk: dense_rows.
extern "C" int lam_gemv_f32(const float* a, const float* p, float* y, int m,
                            int n, void* stream) {
  return launch(F32Mat{a}, F32Vec{p}, F32Out{y}, m, n, n, (cudaStream_t)stream);
}

// (y_hi, y_lo) (m,) = (a_hi + a_lo) (m, n) @ (p_hi + p_lo) (n,), the f32
// split of the f64 result. Walk: dense_stream.
extern "C" int lam_gemv_df64(const float* a_hi, const float* a_lo,
                             const float* p_hi, const float* p_lo,
                             float* y_hi, float* y_lo, int m, int n,
                             void* stream) {
  return launch_stream<DF64Cfg>(DF64Stream{{a_hi, a_lo}},
                                DF64Stream{{p_hi, p_lo}}, DF64Out{y_hi, y_lo},
                                m, n, n, (cudaStream_t)stream);
}

// y (m,) = A[:, blk*nb:(blk+1)*nb] @ p_blk (nb,) for a row-major (m, n) A.
// Walk: dense_stream.
extern "C" int lam_gemv_f32_cols(const float* a, const float* p_blk, float* y,
                                 int m, int n, int nb, int blk, void* stream) {
  const size_t c0 = column_block(n, nb, blk);
  if (c0 == (size_t)-1) return (int)cudaErrorInvalidValue;
  return launch_stream<F32ColsCfg>(F32Stream{{a + c0}}, F32Stream{{p_blk}},
                                   F32Out{y}, m, nb, n, (cudaStream_t)stream);
}

// (y_hi, y_lo) (m,) = (a_hi + a_lo)[:, blk*nb:(blk+1)*nb] @ (p_hi + p_lo)
// (nb,), the f32 split of the f64 result. Walk: dense_rows.
extern "C" int lam_gemv_df64_cols(const float* a_hi, const float* a_lo,
                                  const float* p_hi, const float* p_lo,
                                  float* y_hi, float* y_lo, int m, int n,
                                  int nb, int blk, void* stream) {
  const size_t c0 = column_block(n, nb, blk);
  if (c0 == (size_t)-1) return (int)cudaErrorInvalidValue;
  return launch(DF64Mat{a_hi + c0, a_lo + c0}, DF64Vec{p_hi, p_lo},
                DF64Out{y_hi, y_lo}, m, nb, n, (cudaStream_t)stream);
}
