// Symmetric matvec over walk-order packed lower-triangle tiles, for Hopper
// (sm_90a), and the dual matvec over a dense rectangle of the same tiles.
// Eighteen kernels share one design:
//
//   lam_gemv_f32_symm   replaces lam_tpu/ops/gemv.py:gemv_f32_symm
//                       (packed=True; Pallas kernel _gemv_f32_symm_kernel)
//   lam_gemv_df64_symm  replaces lam_tpu/ops/gemv.py:gemv_df64_symm
//                       (packed=True; Pallas kernel _gemv_df64_symm_kernel)
//   lam_gemv_dfq_symm   replaces lam_tpu/ops/gemv.py:gemv_dfq_symm
//                       (:1172; Pallas kernel _gemv_dfq_symm_kernel)
//   lam_gemv_q16_symm   replaces lam_tpu/ops/gemv.py:gemv_q16_symm
//                       (_gemv_q16_symm_kernel and the blocked
//                       _gemv_q16_symm_multi_kernel)
//   lam_gemv_fq_symm    replaces lam_tpu/ops/gemv.py:gemv_fq_symm
//                       (_gemv_fq_symm_kernel)
//   lam_gemv_f32_symm_slab   replaces lam_tpu/ops/gemv.py:gemv_f32_symm_slab
//                            (:552; _gemv_f32_symm_slab_kernel)
//   lam_gemv_df64_symm_slab  replaces lam_tpu/ops/gemv.py:gemv_df64_symm_slab
//                            (:1267; _gemv_df64_symm_slab_kernel)
//   lam_gemv_q16_symm_slab   replaces lam_tpu/ops/gemv.py:gemv_q16_symm_slab
//                            (:2310; _gemv_q16_symm_slab_kernel)
//   lam_gemv_fq_symm_slab    replaces lam_tpu/ops/gemv.py:gemv_fq_symm_slab
//                            (:2405; _gemv_fq_symm_slab_kernel)
//   lam_gemv_dfq_symm_slab   replaces lam_tpu/ops/gemv.py:gemv_dfq_symm_slab
//                            (:1386; _gemv_dfq_symm_slab_kernel)
//   lam_gemv_f32_dual   replaces lam_tpu/ops/gemv.py:gemv_f32_dual
//                       (:1556; _gemv_f32_dual_kernel)
//   lam_gemv_df64_dual  replaces lam_tpu/ops/gemv.py:gemv_df64_dual
//                       (:1682; _gemv_df64_dual_kernel)
//   lam_gemv_dfq_dual   replaces lam_tpu/ops/gemv.py:gemv_dfq_dual
//                       (:1763; _gemv_dfq_dual_kernel)
//   lam_gemv_q16_dual   replaces lam_tpu/ops/gemv.py:gemv_q16_dual
//                       (:2544; _gemv_q16_dual_kernel, its 'vpu' form)
//   lam_gemv_fq_dual    replaces lam_tpu/ops/gemv.py:gemv_fq_dual
//                       (:2624; _gemv_fq_dual_kernel)
//
// and the bf16 product engine of the three q16 kernels (lam_tpu's
// LAM_Q16_IMPL "mxu" bodies, chosen by ops/gemv.py `_q16_impl`):
//
//   lam_gemv_q16_symm_bf16       _gemv_q16_symm_multi_kernel, impl="mxu"
//                                (:1955-1976, via _gemv_q16_symm_blocked)
//   lam_gemv_q16_symm_slab_bf16  _gemv_q16_symm_slab_kernel, impl="mxu"
//                                (:2266-2303)
//   lam_gemv_q16_dual_bf16       _gemv_q16_dual_kernel, impl="mxu"
//                                (:2502-2537)
//
// Storage contract (lam_tpu_torch/ops/layout.py pack_tri_host): the matrix
// is n x n with n = nblk * TB, and only its nblk(nblk+1)/2 lower-triangle
// TB x TB tiles are stored, stacked in row-major walk order into a
// (T*TB, TB) row-major buffer. Tile t sits at block (i, k) with
// t = i(i+1)/2 + k, k <= i. A tile contributes A_ik p_k to y_i (direct)
// and, when k < i, A_ik^T p_i to y_k (transpose); a diagonal tile only
// the direct term. The dfq lo plane (layout.py quantize_lo_tiles) holds
// int16 tiles against one power-of-two scale per tile, T tiles exactly.
// The fq planes (layout.py quantize_fq_tiles) are int16 tiles against one
// power-of-two scale per tile, stored padded to a multiple of 8 tiles; the
// grid covers the T real tiles only and never reads the pad tiles.
//
// The slab kernels walk one rank's share of the band-pair decomposition
// (lam_tpu_torch/parallel/pcg_symm.py) instead of the whole triangle: three
// int32 tables give tile t's global row tile it[t], column tile kt[t] and
// slab row tile lt[t]. The tile sits at rows t*TB of a (T*TB, TB) walk-order
// buffer (packed) or at (lt[t]*TB, kt[t]*TB) of the rank's row-major (ms, n)
// slab of full rows. Direct terms A p_kt go to yd (ms,) by lt, transpose
// terms A^T p_it (kt < it only) to yt (n,) by kt; the caller places yd at the
// rank's rows and sums the ranks' parts. The quantized slab kernels (q16,
// fq, dfq) take the packed buffer only: a rank's planes hold exactly its T
// walk tiles (no pad tiles) and each scale table has one entry per WALK
// POSITION t of that rank, not per triangle index; the diagonal of each
// it == kt tile is stored as zeros and its term is the operator's.
//
// The dual kernels compute (S p, S^T q) for a dense rectangle S (ms, n) in
// one pass over its tiles: the off-diagonal half-slabs of the symmetric 2-D
// grid (lam_tpu_torch/parallel/pcg2d_symm.py). S is stored as mb x cb tiles
// (mb = ms / TB, cb = n / TB) in row-major order, tile t = li * cb + k at
// rows t*TB of a (T*TB, TB) buffer with T >= mb * cb; the trailing pad
// tiles, which make the buffer as long as a diagonal rank's triangle, are
// never read, and neither are their scales. Every tile has both terms:
// S_lik p_k goes to yd (ms,) by li, S_lik^T q_li to yt (n,) by k. The scale
// tables of the quantized planes are indexed by t.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, no
// --use_fast_math; nvcc contracts a*b + c into FMAs (-fmad=true), which
// only removes roundings here: every int16 * power-of-two product below is
// exact in f64 with or without contraction, so no cascade term can be lost.
//
// What bounds it: a matvec does 2 (f32, q16) to 4 (df64, dfq, fq) flops
// per stored element and reads each stored element exactly once: 2 B
// (q16), 4 B (f32), 6 B (dfq: f32 hi + int16 lo; fq: three int16 planes)
// or 8 B (df64: hi + lo planes).
// At ~1 flop/byte it sits far below the card's compute roof, so the only
// target is device-memory bandwidth. q16 must also convert ~8 int16 values
// per SM per clock at its byte floor, about half the card's I2F rate.
//
// How the design meets that:
//  * A walk policy says where tile t lies and which block (i, k) it is: the
//    closed-form triangle index for the whole-triangle kernels, the tables
//    for the slab kernels, the row-major rectangle index for the dual
//    kernels; it also says whether the tile has a transpose term (k < i in
//    a triangle, always in a rectangle). Pass 1 is the same code for all
//    three, with one operand vector for the direct terms and one for the
//    transpose terms (the same vector in a symmetric walk).
//  * Pass 1 gives each (tile, 64-row strip) its own block, so T*8 blocks
//    keep all SMs streaming (one block per 1 MB tile would leave the last
//    wave mostly idle). Each warp walks 8 consecutive rows; each lane
//    holds 16 columns of a row, read as 16-byte streaming loads (__ldcs):
//    four float4 (f32 planes) or two 8 x int16 (fq planes), so a warp's
//    loads cover whole contiguous 512-byte segments; dfq pairs each float4
//    of the hi plane with one 8-byte load of 4 int16 of the lo plane
//    (256-byte segments). The direct row
//    sum is a warp butterfly; each lane keeps the transpose column sums
//    of its 16 columns in registers, reduced across the 8 warps in shared
//    memory. The pass writes per-tile direct partials part_d[T][TB] and
//    per-strip transpose partials part_t[T][8][TB].
//  * Pass 2 sums, for every output row, its direct partials and the
//    transpose partials of the tiles below it in a FIXED order. No float
//    atomics: an order that changed from run to run would change CG
//    iteration counts from run to run. For the slab kernels the tiles of
//    an output tile are not contiguous in the walk (the transpose terms of
//    column tile k come from every owned row tile below it), so pass 2
//    reads two CSR lists the wrapper builds on the host once per walk:
//    the tiles of each slab row tile (by lt) and the off-diagonal tiles of
//    each column tile (by kt), each in walk order. A TPU grid carried yd
//    and yt across its steps in VMEM; here the lists give the same sums in
//    an order fixed by the tables. The rectangle needs no lists: the tiles
//    of row tile li are li*cb .. li*cb + cb - 1 and those of column tile k
//    are k, k + cb, ...
//  The TPU kernels carried the transpose sums across their sequential
//  grid in VMEM scratch (acc_t / acct_*); Hopper's blocks run in no
//  order, hence the two passes.
//
// df64: on the TPU, which has no f64, the (hi, lo) float-float planes
// were multiplied with Dekker two_prod and summed with Knuth two_sum
// (~2^-48 relative). The H100 has native fp64, and this kernel is bound
// by bytes, so it forms hi + lo in double (exact: both halves come from
// splitting one f64 value, so the sum fits a double's 53-bit window),
// multiplies and accumulates in double, and returns the f32 split of the
// f64 sum. That is at least as accurate as the compensated chain and has
// no error-free-transform terms for FMA contraction to erase
// (lam_tpu/ops/gemv.py:644-665). The 'nolow'/'full' compensation budgets
// of the TPU kernel therefore have no counterpart here.
//
// q16: int16 -> f32 is exact, and the tile's power-of-two scale is folded
// into the operand values p (TB multiplies per block instead of one per
// element, exact), as the TPU kernel does; products are exact-f32 FMAs
// with f32 accumulation (no TF32, no bf16).
//
// dfq: the TPU dequantized the lo tile in f32 (exact: a power-of-two
// scale) and ran the df64 walk's compensated chain. Here hi + loq * sc is
// formed in double: the product is exact, so the element costs at most
// one f64 rounding, far below the storage's ~2^-39 tile-relative error.
// The rest is the df64 kernel's f64 walk.
//
// fq: the TPU rebuilt a float-float pair from the three planes with
// two_sum. Here q1*s1 + q2*s2 + q3*s3 is formed in double: every product
// is exact, the first sum is exact and the cascade spans ~48 bits, so it
// costs at most one f64 rounding, far below the 2^-48 storage bound. The
// rest is the df64 kernel's f64 walk.
//
// q16, bf16 engine: the TPU's "mxu" bodies run each tile's two products as
// single-pass DEFAULT-precision dots, which round both operands to bf16
// (the converted int16 value, and p * s) and sum the exact products in
// f32: ~2^-9 operator error against the quantization's 2^-16, bought for
// the MXU's rate at large n. Here the same function runs on the tensor
// cores: q16_bf16_pass1 stages its 64-row strip of the tile in shared
// memory as bf16 (__float2bfloat16_rn of each converted int16, 64 KB plus
// a pad that keeps the fragment loads free of bank conflicts), and
// bf16(p * s) of both operand slices (__fmul_rn, so no FMA can fuse the
// multiply into anything before the rounding). Warps 0-3 take the direct
// term S p_k, 16 strip rows each, as 32 mma.sync m16n8k16 bf16 products
// with f32 accumulators: the strip is the A operand (row-major fragments,
// 32-bit shared loads), p_k the B operand with one real column. Warps 4-7
// take the transpose term S^T p_i, 128 columns each: A^T is read from the
// strip as 16-bit pairs packed by hand, p_i (64 rows) is B. 7/8 of every
// product is padding, which costs nothing at ~1 flop per byte. The pass
// writes the exact kernel's part_d/part_t, so the three pass-2 kernels and
// their fixed order of sums are shared: no float atomics, bitwise repeats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int TB = 512;                       // tile width (layout contract)
constexpr int ROWS = 64;                      // rows of a tile per block
constexpr int STRIPS = TB / ROWS;             // blocks per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = ROWS / WARPS;   // 8
constexpr int COLS_PER_LANE = TB / 32;        // 16
constexpr int P2_COLS = 32;                   // outputs per pass-2 block
constexpr int P2_GROUPS = THREADS / P2_COLS;  // partial sums per output

// A plane type reads VEC elements of the current tile per 16-byte load
// (load) after set_tile(t), and says by what each tile folds into p
// (p_scale; 1 where the plane carries no scale).

struct F32Plane {
  using acc_t = float;
  static constexpr int VEC = 4;
  const float* __restrict__ a;
  __device__ __forceinline__ void set_tile(int) {}
  __device__ __forceinline__ acc_t p_scale() const { return 1.0f; }
  __device__ __forceinline__ void load(size_t off, acc_t v[VEC]) const {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(a + off));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};

struct DF64Plane {
  using acc_t = double;
  static constexpr int VEC = 4;
  const float* __restrict__ hi;
  const float* __restrict__ lo;
  __device__ __forceinline__ void set_tile(int) {}
  __device__ __forceinline__ acc_t p_scale() const { return 1.0; }
  __device__ __forceinline__ void load(size_t off, acc_t v[VEC]) const {
    const float4 h = __ldcs(reinterpret_cast<const float4*>(hi + off));
    const float4 l = __ldcs(reinterpret_cast<const float4*>(lo + off));
    v[0] = (double)h.x + (double)l.x;
    v[1] = (double)h.y + (double)l.y;
    v[2] = (double)h.z + (double)l.z;
    v[3] = (double)h.w + (double)l.w;
  }
};

// Eight int16 of one 16-byte load, sign-extended.
__device__ __forceinline__ void load_i16x8(const short* __restrict__ q,
                                           size_t off, int e[8]) {
  const int4 x = __ldcs(reinterpret_cast<const int4*>(q + off));
  const int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e[2 * j] = (int)(short)(w[j] & 0xffff);
    e[2 * j + 1] = w[j] >> 16;
  }
}

struct Q16Plane {
  using acc_t = float;
  static constexpr int VEC = 8;
  const short* __restrict__ q;
  const float* __restrict__ s;
  float sc;
  __device__ __forceinline__ void set_tile(int t) { sc = __ldg(s + t); }
  __device__ __forceinline__ acc_t p_scale() const { return sc; }
  __device__ __forceinline__ void load(size_t off, acc_t v[VEC]) const {
    int e[VEC];
    load_i16x8(q, off, e);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = (float)e[j];
  }
};

struct FQPlane {
  using acc_t = double;
  static constexpr int VEC = 8;
  const short* __restrict__ q1;
  const short* __restrict__ q2;
  const short* __restrict__ q3;
  const float* __restrict__ s1;
  const float* __restrict__ s2;
  const float* __restrict__ s3;
  double c1, c2, c3;
  __device__ __forceinline__ void set_tile(int t) {
    c1 = __ldg(s1 + t);
    c2 = __ldg(s2 + t);
    c3 = __ldg(s3 + t);
  }
  __device__ __forceinline__ acc_t p_scale() const { return 1.0; }
  __device__ __forceinline__ void load(size_t off, acc_t v[VEC]) const {
    int e1[VEC], e2[VEC], e3[VEC];
    load_i16x8(q1, off, e1);
    load_i16x8(q2, off, e2);
    load_i16x8(q3, off, e3);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      v[j] = ((double)e1[j] * c1 + (double)e2[j] * c2) + (double)e3[j] * c3;
  }
};

struct DFQPlane {
  using acc_t = double;
  static constexpr int VEC = 4;
  const float* __restrict__ hi;
  const short* __restrict__ loq;
  const float* __restrict__ sc;
  double c;
  __device__ __forceinline__ void set_tile(int t) { c = __ldg(sc + t); }
  __device__ __forceinline__ acc_t p_scale() const { return 1.0; }
  __device__ __forceinline__ void load(size_t off, acc_t v[VEC]) const {
    const float4 h = __ldcs(reinterpret_cast<const float4*>(hi + off));
    const int2 q = __ldcs(reinterpret_cast<const int2*>(loq + off));
    v[0] = (double)h.x + (double)(int)(short)(q.x & 0xffff) * c;
    v[1] = (double)h.y + (double)(q.x >> 16) * c;
    v[2] = (double)h.z + (double)(int)(short)(q.y & 0xffff) * c;
    v[3] = (double)h.w + (double)(q.y >> 16) * c;
  }
};

struct F32Vec {
  using acc_t = float;
  const float* __restrict__ p;
  __device__ __forceinline__ acc_t get(int i) const { return __ldg(p + i); }
};

struct DF64Vec {
  using acc_t = double;
  const float* __restrict__ hi;
  const float* __restrict__ lo;
  __device__ __forceinline__ acc_t get(int i) const {
    return (double)__ldg(hi + i) + (double)__ldg(lo + i);
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

// Row-tile index i of walk position t = i(i+1)/2 + k, 0 <= k <= i.
__device__ __forceinline__ int walk_row(int t) {
  int i = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  return i;
}

// Walk policies: tile(t) gives the block (i, k) of walk position t, the
// element offset of its first row and its row stride; transposed(i, k)
// says whether the tile also has a transpose term.
struct TriangleWalk {
  __device__ __forceinline__ bool transposed(int i, int k) const {
    return k < i;
  }
  __device__ __forceinline__ void tile(int t, int& i, int& k, size_t& base,
                                       int& ld) const {
    i = walk_row(t);
    k = t - i * (i + 1) / 2;
    base = (size_t)t * TB * TB;
    ld = TB;
  }
};

struct TableWalk {
  const int* __restrict__ it;
  const int* __restrict__ kt;
  const int* __restrict__ lt;
  int n;       // row stride of the (ms, n) slab
  int packed;  // 1: the (T*TB, TB) walk-order buffer; 0: the slab
  __device__ __forceinline__ bool transposed(int i, int k) const {
    return k < i;
  }
  __device__ __forceinline__ void tile(int t, int& i, int& k, size_t& base,
                                       int& ld) const {
    i = __ldg(it + t);
    k = __ldg(kt + t);
    if (packed) {
      base = (size_t)t * TB * TB;
      ld = TB;
    } else {
      base = (size_t)__ldg(lt + t) * TB * n + (size_t)k * TB;
      ld = n;
    }
  }
};

// The dense rectangle of cb column tiles in row-major tile order: a tile
// of the upper half is as good as any, so every tile has both terms.
struct RectWalk {
  int cb;
  __device__ __forceinline__ bool transposed(int, int) const { return true; }
  __device__ __forceinline__ void tile(int t, int& i, int& k, size_t& base,
                                       int& ld) const {
    i = t / cb;
    k = t - i * cb;
    base = (size_t)t * TB * TB;
    ld = TB;
  }
};

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Column of the tile that lane `lane` holds in slot q (0..15): groups of
// VEC columns, 32*VEC columns apart, so each group is one coalesced
// 512-byte segment across the warp.
template <int VEC>
__device__ __forceinline__ int lane_col(int lane, int q) {
  return (q / VEC) * (32 * VEC) + lane * VEC + (q % VEC);
}

// P is the operand of the direct terms (read at column tile k), Q that of
// the transpose terms (read at row tile i).
template <class Plane, class Vec, class Walk>
__global__ void __launch_bounds__(THREADS)
symm_pass1(Plane A, Vec P, Vec Q, Walk W,
           typename Plane::acc_t* __restrict__ part_d,
           typename Plane::acc_t* __restrict__ part_t) {
  using acc_t = typename Plane::acc_t;
  constexpr int VEC = Plane::VEC;
  __shared__ acc_t red[WARPS][TB];

  const int t = blockIdx.x / STRIPS;
  const int s = blockIdx.x % STRIPS;
  int i, k, ld;
  size_t tile0;
  W.tile(t, i, k, tile0, ld);
  const bool offdiag = W.transposed(i, k);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  A.set_tile(t);
  const acc_t sc = A.p_scale();

  acc_t pk[COLS_PER_LANE];
  acc_t tacc[COLS_PER_LANE];
#pragma unroll
  for (int q = 0; q < COLS_PER_LANE; ++q) {
    pk[q] = P.get(k * TB + lane_col<VEC>(lane, q)) * sc;
    tacc[q] = acc_t(0);
  }

  const int r0 = s * ROWS + warp * ROWS_PER_WARP;
#pragma unroll 2
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = r0 + rr;
    const size_t base = tile0 + (size_t)r * ld;
    acc_t a[COLS_PER_LANE];
#pragma unroll
    for (int g = 0; g < COLS_PER_LANE / VEC; ++g)
      A.load(base + g * 32 * VEC + lane * VEC, a + VEC * g);
    acc_t d = acc_t(0);
#pragma unroll
    for (int q = 0; q < COLS_PER_LANE; ++q) d += a[q] * pk[q];
    d = warp_sum(d);
    if (lane == 0) part_d[(size_t)t * TB + r] = d;
    if (offdiag) {
      const acc_t pi = Q.get(i * TB + r) * sc;
#pragma unroll
      for (int q = 0; q < COLS_PER_LANE; ++q) tacc[q] += a[q] * pi;
    }
  }

  if (offdiag) {  // uniform across the block
#pragma unroll
    for (int q = 0; q < COLS_PER_LANE; ++q)
      red[warp][lane_col<VEC>(lane, q)] = tacc[q];
    __syncthreads();
    acc_t* out = part_t + ((size_t)t * STRIPS + s) * TB;
    for (int c = threadIdx.x; c < TB; c += THREADS) {
      acc_t v = red[0][c];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v += red[w][c];
      out[c] = v;
    }
  }
}

// The q16 planes under the bf16 product engine: pass 1 is q16_bf16_pass1.
struct Q16Bf16Plane {
  using acc_t = float;
  const short* __restrict__ q;
  const float* __restrict__ s;
};

constexpr int BF_LD = TB + 8;  // bf16 row stride of the staged strip
constexpr int BF_SMEM =
    (ROWS * BF_LD + TB + ROWS) * (int)sizeof(__nv_bfloat16);
constexpr int BF_VECS = ROWS * TB / 8 / THREADS;  // 16-byte loads a thread

__device__ __forceinline__ unsigned bf16_pair(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) |
         ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

// Eight int16 of one 16-byte load as eight bf16 (round to nearest even).
__device__ __forceinline__ uint4 bf16x8_of_i16x8(const int4 x) {
  const int w[4] = {x.x, x.y, x.z, x.w};
  unsigned o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = bf16_pair(__float2bfloat16_rn((float)(int)(short)(w[j] & 0xffff)),
                     __float2bfloat16_rn((float)(w[j] >> 16)));
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ unsigned ld_bf16x2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d += a b over one m16n8k16 tile: bf16 operands, f32 accumulators. With
// g = lane / 4, c = lane % 4: a[0] holds A(g, 2c..2c+1), a[1] A(g+8, 2c..),
// a[2] A(g, 2c+8..), a[3] A(g+8, 2c+8..); b[0] B(2c..2c+1, g), b[1]
// B(2c+8.., g); d[0..1] D(g, 2c..2c+1), d[2..3] D(g+8, 2c..2c+1); the lower
// half of each register holds the element of the lower index.
__device__ __forceinline__ void mma_bf16(float d[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Pass 1 of the bf16 engine, same blocks and outputs as symm_pass1: block
// (t, s) writes part_d[t][s*ROWS .. +ROWS) and, for a tile with a transpose
// term, part_t[t][s][0 .. TB).
template <class Walk>
__global__ void __launch_bounds__(THREADS)
q16_bf16_pass1(Q16Bf16Plane A, F32Vec P, F32Vec Q, Walk W,
               float* __restrict__ part_d, float* __restrict__ part_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  // strip [ROWS][BF_LD], then pk [TB], then pi [ROWS]
  __nv_bfloat16* strip = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* pk = strip + ROWS * BF_LD;
  __nv_bfloat16* pi = pk + TB;

  const int t = blockIdx.x / STRIPS;
  const int s = blockIdx.x % STRIPS;
  int i, k, ld;
  size_t tile0;
  W.tile(t, i, k, tile0, ld);
  const bool offdiag = W.transposed(i, k);
  const float sc = __ldg(A.s + t);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the strip as bf16: coalesced 16-byte streaming loads, half a thread's
  // loads in flight at a time
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int4 raw[BF_VECS / 2];
#pragma unroll
    for (int u = 0; u < BF_VECS / 2; ++u) {
      const int v = threadIdx.x + (h * BF_VECS / 2 + u) * THREADS;
      raw[u] = __ldcs(reinterpret_cast<const int4*>(
          A.q + tile0 + (size_t)(s * ROWS + v / (TB / 8)) * ld +
          (v % (TB / 8)) * 8));
    }
#pragma unroll
    for (int u = 0; u < BF_VECS / 2; ++u) {
      const int v = threadIdx.x + (h * BF_VECS / 2 + u) * THREADS;
      *reinterpret_cast<uint4*>(strip + (v / (TB / 8)) * BF_LD +
                                (v % (TB / 8)) * 8) = bf16x8_of_i16x8(raw[u]);
    }
  }
  for (int c = threadIdx.x; c < TB; c += THREADS)
    pk[c] = __float2bfloat16_rn(__fmul_rn(P.get(k * TB + c), sc));
  if (threadIdx.x < ROWS)
    pi[threadIdx.x] = __float2bfloat16_rn(
        __fmul_rn(Q.get(i * TB + s * ROWS + threadIdx.x), sc));
  __syncthreads();

  const int g = lane / 4;
  const int c4 = lane % 4;
  if (warp < 4) {
    // direct: D(r, 0) = sum_c strip(16 warp + r, c) pk(c)
    const __nv_bfloat16* row = strip + (16 * warp + g) * BF_LD + 2 * c4;
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int kc = 0; kc < TB; kc += 16) {
      const unsigned a[4] = {ld_bf16x2(row + kc),
                             ld_bf16x2(row + 8 * BF_LD + kc),
                             ld_bf16x2(row + kc + 8),
                             ld_bf16x2(row + 8 * BF_LD + kc + 8)};
      const unsigned b[2] = {g == 0 ? ld_bf16x2(pk + kc + 2 * c4) : 0u,
                             g == 0 ? ld_bf16x2(pk + kc + 2 * c4 + 8) : 0u};
      mma_bf16(d, a, b);
    }
    if (c4 == 0) {
      float* out = part_d + (size_t)t * TB + s * ROWS + 16 * warp + g;
      out[0] = d[0];
      out[8] = d[2];
    }
  } else if (offdiag) {  // uniform across the warp
    // transpose: D(c, 0) = sum_r strip(r, c) pi(r), columns 128 (warp - 4) ..
    unsigned b[ROWS / 16][2];
#pragma unroll
    for (int kr = 0; kr < ROWS / 16; ++kr) {
      b[kr][0] = g == 0 ? ld_bf16x2(pi + 16 * kr + 2 * c4) : 0u;
      b[kr][1] = g == 0 ? ld_bf16x2(pi + 16 * kr + 2 * c4 + 8) : 0u;
    }
    float* out = part_t + ((size_t)t * STRIPS + s) * TB;
    for (int c0 = 128 * (warp - 4); c0 < 128 * (warp - 3); c0 += 16) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kr = 0; kr < ROWS / 16; ++kr) {
        // A^T(m, j) = strip(16 kr + j, c0 + m)
        const __nv_bfloat16* e = strip + (16 * kr + 2 * c4) * BF_LD + c0 + g;
        const unsigned a[4] = {bf16_pair(e[0], e[BF_LD]),
                               bf16_pair(e[8], e[BF_LD + 8]),
                               bf16_pair(e[8 * BF_LD], e[9 * BF_LD]),
                               bf16_pair(e[8 * BF_LD + 8], e[9 * BF_LD + 8])};
        mma_bf16(d, a, b[kr]);
      }
      if (c4 == 0) {
        out[c0 + g] = d[0];
        out[c0 + g + 8] = d[2];
      }
    }
  }
}

// Pass 1 of any walk: symm_pass1 with a tile reader, or q16_bf16_pass1.
template <class Plane, class Vec, class Walk>
int pass1(Plane A, Vec P, Vec Q, Walk W, int tiles,
          typename Plane::acc_t* part_d, typename Plane::acc_t* part_t,
          cudaStream_t stream) {
  if constexpr (std::is_same_v<Plane, Q16Bf16Plane>) {
    // the 64 KB strip needs the opt-in shared-memory size, set once for
    // each instantiation and device (devices past 63 set it every call)
    static std::atomic<unsigned long long> opted_in{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (!(opted_in.load(std::memory_order_acquire) & bit)) {
      e = cudaFuncSetAttribute(q16_bf16_pass1<Walk>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BF_SMEM);
      if (e != cudaSuccess) return (int)e;
      opted_in.fetch_or(bit, std::memory_order_release);
    }
    q16_bf16_pass1<Walk><<<tiles * STRIPS, THREADS, BF_SMEM, stream>>>(
        A, P, Q, W, part_d, part_t);
  } else {
    symm_pass1<Plane, Vec, Walk><<<tiles * STRIPS, THREADS, 0, stream>>>(
        A, P, Q, W, part_d, part_t);
  }
  return (int)cudaGetLastError();
}

// y[i*TB + r] = sum_{k<=i} part_d[t(i,k)][r] + sum_{j>i} sum_s part_t[t(j,i)][s][r]
// Block: P2_COLS consecutive outputs (one row-tile i, since P2_COLS divides
// TB) x P2_GROUPS strided partial sums, combined in a fixed order.
template <class acc_t, class Out>
__global__ void __launch_bounds__(THREADS)
symm_pass2(const acc_t* __restrict__ part_d, const acc_t* __restrict__ part_t,
           int nblk, Out out) {
  __shared__ acc_t red[P2_GROUPS][P2_COLS];
  const int col = threadIdx.x % P2_COLS;
  const int grp = threadIdx.x / P2_COLS;
  const int row = blockIdx.x * P2_COLS + col;
  const int i = row / TB;
  const int r = row % TB;
  const int n_direct = i + 1;
  const int n_terms = n_direct + (nblk - 1 - i) * STRIPS;
  const size_t tdiag0 = (size_t)i * (i + 1) / 2;

  acc_t v = acc_t(0);
  for (int m = grp; m < n_terms; m += P2_GROUPS) {
    if (m < n_direct) {
      v += part_d[(tdiag0 + m) * TB + r];
    } else {
      const int mt = m - n_direct;
      const int j = i + 1 + mt / STRIPS;
      const size_t tj = (size_t)j * (j + 1) / 2 + i;
      v += part_t[(tj * STRIPS + mt % STRIPS) * TB + r];
    }
  }
  red[grp][col] = v;
  __syncthreads();
  if (grp == 0) {
    acc_t y = red[0][col];
#pragma unroll
    for (int g = 1; g < P2_GROUPS; ++g) y += red[g][col];
    out.put(row, y);
  }
}

// The slab walk's pass 2: yd[l*TB + r] sums part_d[t][r] over the tiles t
// of slab row tile l (d_ids[d_ptr[l] .. d_ptr[l+1]]); yt[j*TB + c] sums
// part_t[t][s][c] over the off-diagonal tiles t of column tile j
// (t_ids[t_ptr[j] .. t_ptr[j+1]]) and their strips s. A block computes
// P2_COLS consecutive outputs of yd (the first ms / P2_COLS blocks) or of
// yt, each as P2_GROUPS strided partial sums combined in a fixed order.
template <class acc_t, class Out>
__global__ void __launch_bounds__(THREADS)
slab_pass2(const acc_t* __restrict__ part_d, const acc_t* __restrict__ part_t,
           const int* __restrict__ d_ptr, const int* __restrict__ d_ids,
           const int* __restrict__ t_ptr, const int* __restrict__ t_ids,
           int ms, Out yd, Out yt) {
  __shared__ acc_t red[P2_GROUPS][P2_COLS];
  const int col = threadIdx.x % P2_COLS;
  const int grp = threadIdx.x / P2_COLS;
  const int d_blocks = ms / P2_COLS;
  const bool direct = (int)blockIdx.x < d_blocks;  // uniform across the block
  const int row =
      (direct ? blockIdx.x : blockIdx.x - d_blocks) * P2_COLS + col;
  const int tile = row / TB;
  const int r = row % TB;

  acc_t v = acc_t(0);
  if (direct) {
    const int end = __ldg(d_ptr + tile + 1);
    for (int q = __ldg(d_ptr + tile) + grp; q < end; q += P2_GROUPS)
      v += part_d[(size_t)__ldg(d_ids + q) * TB + r];
  } else {
    const int b = __ldg(t_ptr + tile);
    const int n_terms = (__ldg(t_ptr + tile + 1) - b) * STRIPS;
    for (int q = grp; q < n_terms; q += P2_GROUPS) {
      const size_t tj = (size_t)__ldg(t_ids + b + q / STRIPS);
      v += part_t[(tj * STRIPS + q % STRIPS) * TB + r];
    }
  }
  red[grp][col] = v;
  __syncthreads();
  if (grp == 0) {
    acc_t y = red[0][col];
#pragma unroll
    for (int g = 1; g < P2_GROUPS; ++g) y += red[g][col];
    if (direct)
      yd.put(row, y);
    else
      yt.put(row, y);
  }
}

// The rectangle walk's pass 2: yd[li*TB + r] sums part_d[li*cb + k][r] over
// the cb tiles of row tile li; yt[k*TB + c] sums part_t[li*cb + k][s][c]
// over the mb tiles of column tile k and their strips. Blocks and partial
// sums as in slab_pass2.
template <class acc_t, class Out>
__global__ void __launch_bounds__(THREADS)
rect_pass2(const acc_t* __restrict__ part_d, const acc_t* __restrict__ part_t,
           int mb, int cb, Out yd, Out yt) {
  __shared__ acc_t red[P2_GROUPS][P2_COLS];
  const int col = threadIdx.x % P2_COLS;
  const int grp = threadIdx.x / P2_COLS;
  const int d_blocks = mb * TB / P2_COLS;
  const bool direct = (int)blockIdx.x < d_blocks;  // uniform across the block
  const int row =
      (direct ? blockIdx.x : blockIdx.x - d_blocks) * P2_COLS + col;
  const int tile = row / TB;
  const int r = row % TB;

  acc_t v = acc_t(0);
  if (direct) {
    for (int k = grp; k < cb; k += P2_GROUPS)
      v += part_d[((size_t)tile * cb + k) * TB + r];
  } else {
    for (int q = grp; q < mb * STRIPS; q += P2_GROUPS) {
      const size_t t = (size_t)(q / STRIPS) * cb + tile;
      v += part_t[(t * STRIPS + q % STRIPS) * TB + r];
    }
  }
  red[grp][col] = v;
  __syncthreads();
  if (grp == 0) {
    acc_t y = red[0][col];
#pragma unroll
    for (int g = 1; g < P2_GROUPS; ++g) y += red[g][col];
    if (direct)
      yd.put(row, y);
    else
      yt.put(row, y);
  }
}

template <class Plane, class Vec, class Out>
int launch(Plane A, Vec P, Out Y, typename Plane::acc_t* part_d,
           typename Plane::acc_t* part_t, int nblk, cudaStream_t stream) {
  const int T = nblk * (nblk + 1) / 2;
  const int e = pass1(A, P, P, TriangleWalk{}, T, part_d, part_t, stream);
  if (e != 0) return e;
  symm_pass2<typename Plane::acc_t, Out>
      <<<nblk * TB / P2_COLS, THREADS, 0, stream>>>(part_d, part_t, nblk, Y);
  return (int)cudaGetLastError();
}

// The CSR lists of the slab walk's pass 2 (see slab_pass2).
struct SlabLists {
  const int* d_ptr;
  const int* d_ids;
  const int* t_ptr;
  const int* t_ids;
};

template <class Plane, class Vec, class Out>
int launch_slab(Plane A, Vec P, TableWalk W, SlabLists L, Out YD, Out YT,
                typename Plane::acc_t* part_d, typename Plane::acc_t* part_t,
                int T, int ms, cudaStream_t stream) {
  if (T <= 0 || ms <= 0 || ms % TB || W.n <= 0 || W.n % TB)
    return (int)cudaErrorInvalidValue;
  const int e = pass1(A, P, P, W, T, part_d, part_t, stream);
  if (e != 0) return e;
  slab_pass2<typename Plane::acc_t, Out>
      <<<(ms + W.n) / P2_COLS, THREADS, 0, stream>>>(
          part_d, part_t, L.d_ptr, L.d_ids, L.t_ptr, L.t_ids, ms, YD, YT);
  return (int)cudaGetLastError();
}

template <class Plane, class Vec, class Out>
int launch_dual(Plane A, Vec P, Vec Q, Out YD, Out YT,
                typename Plane::acc_t* part_d, typename Plane::acc_t* part_t,
                int mb, int cb, cudaStream_t stream) {
  if (mb <= 0 || cb <= 0) return (int)cudaErrorInvalidValue;
  const int e = pass1(A, P, Q, RectWalk{cb}, mb * cb, part_d, part_t, stream);
  if (e != 0) return e;
  rect_pass2<typename Plane::acc_t, Out>
      <<<(mb + cb) * TB / P2_COLS, THREADS, 0, stream>>>(part_d, part_t, mb,
                                                         cb, YD, YT);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch sizes the caller allocates (elements): part_d T*TB, part_t
// T*STRIPS*TB, with T = nblk(nblk+1)/2 (never a padded plane's count);
// f32 for the f32 and q16 kernels, f64 for the df64, dfq and fq kernels. Every
// plane and vector pointer is 16-byte aligned. Returns cudaGetLastError()
// after the launches.
extern "C" int lam_symm_tile() { return TB; }
extern "C" int lam_symm_strips() { return STRIPS; }

extern "C" int lam_gemv_f32_symm(const float* a, const float* p, float* y,
                                 float* part_d, float* part_t, int nblk,
                                 void* stream) {
  return launch(F32Plane{a}, F32Vec{p}, F32Out{y}, part_d, part_t, nblk,
                (cudaStream_t)stream);
}

extern "C" int lam_gemv_df64_symm(const float* a_hi, const float* a_lo,
                                  const float* p_hi, const float* p_lo,
                                  float* y_hi, float* y_lo, double* part_d,
                                  double* part_t, int nblk, void* stream) {
  return launch(DF64Plane{a_hi, a_lo}, DF64Vec{p_hi, p_lo},
                DF64Out{y_hi, y_lo}, part_d, part_t, nblk,
                (cudaStream_t)stream);
}

extern "C" int lam_gemv_dfq_symm(const float* a_hi, const short* a_loq,
                                 const float* sc, const float* p_hi,
                                 const float* p_lo, float* y_hi, float* y_lo,
                                 double* part_d, double* part_t, int nblk,
                                 void* stream) {
  return launch(DFQPlane{a_hi, a_loq, sc, 0.0}, DF64Vec{p_hi, p_lo},
                DF64Out{y_hi, y_lo}, part_d, part_t, nblk,
                (cudaStream_t)stream);
}

extern "C" int lam_gemv_q16_symm(const short* q1, const float* s1,
                                 const float* p, float* y, float* part_d,
                                 float* part_t, int nblk, void* stream) {
  return launch(Q16Plane{q1, s1, 0.0f}, F32Vec{p}, F32Out{y}, part_d, part_t,
                nblk, (cudaStream_t)stream);
}

extern "C" int lam_gemv_fq_symm(const short* q1, const short* q2,
                                const short* q3, const float* s1,
                                const float* s2, const float* s3,
                                const float* p_hi, const float* p_lo,
                                float* y_hi, float* y_lo, double* part_d,
                                double* part_t, int nblk, void* stream) {
  return launch(FQPlane{q1, q2, q3, s1, s2, s3, 0.0, 0.0, 0.0},
                DF64Vec{p_hi, p_lo}, DF64Out{y_hi, y_lo}, part_d, part_t,
                nblk, (cudaStream_t)stream);
}

// Slab walk over T tiles of one rank's band pair: a is the (T*TB, TB)
// walk-order buffer (packed=1) or the rank's row-major (ms, n) slab
// (packed=0); it/kt/lt the (T,) walk tables; d_ptr (ms/TB + 1,) and d_ids
// (T,) the tiles of each slab row tile, t_ptr (n/TB + 1,) and t_ids the
// off-diagonal tiles of each column tile, both in walk order. Outputs yd
// (ms,) and yt (n,); scratch part_d T*TB and part_t T*STRIPS*TB elements.
extern "C" int lam_gemv_f32_symm_slab(
    const float* a, const float* p, const int* it, const int* kt,
    const int* lt, const int* d_ptr, const int* d_ids, const int* t_ptr,
    const int* t_ids, float* yd, float* yt, float* part_d, float* part_t,
    int T, int ms, int n, int packed, void* stream) {
  return launch_slab(F32Plane{a}, F32Vec{p}, TableWalk{it, kt, lt, n, packed},
                     SlabLists{d_ptr, d_ids, t_ptr, t_ids}, F32Out{yd},
                     F32Out{yt}, part_d, part_t, T, ms, (cudaStream_t)stream);
}

// The df64 twin: (a_hi + a_lo) formed and walked in f64; yd and yt returned
// as f32 (hi, lo) splits of the f64 sums.
extern "C" int lam_gemv_df64_symm_slab(
    const float* a_hi, const float* a_lo, const float* p_hi,
    const float* p_lo, const int* it, const int* kt, const int* lt,
    const int* d_ptr, const int* d_ids, const int* t_ptr, const int* t_ids,
    float* yd_hi, float* yd_lo, float* yt_hi, float* yt_lo, double* part_d,
    double* part_t, int T, int ms, int n, int packed, void* stream) {
  return launch_slab(DF64Plane{a_hi, a_lo}, DF64Vec{p_hi, p_lo},
                     TableWalk{it, kt, lt, n, packed},
                     SlabLists{d_ptr, d_ids, t_ptr, t_ids},
                     DF64Out{yd_hi, yd_lo}, DF64Out{yt_hi, yt_lo}, part_d,
                     part_t, T, ms, (cudaStream_t)stream);
}

// The quantized twins, packed storage only (T tiles exactly, one scale per
// walk position). q16: the int16 q1 plane against s1, f32 sums.
extern "C" int lam_gemv_q16_symm_slab(
    const short* q1, const float* s1, const float* p, const int* it,
    const int* kt, const int* lt, const int* d_ptr, const int* d_ids,
    const int* t_ptr, const int* t_ids, float* yd, float* yt, float* part_d,
    float* part_t, int T, int ms, int n, void* stream) {
  return launch_slab(Q16Plane{q1, s1, 0.0f}, F32Vec{p},
                     TableWalk{it, kt, lt, n, 1},
                     SlabLists{d_ptr, d_ids, t_ptr, t_ids}, F32Out{yd},
                     F32Out{yt}, part_d, part_t, T, ms, (cudaStream_t)stream);
}

// fq: q1*s1 + q2*s2 + q3*s3 formed and walked in f64.
extern "C" int lam_gemv_fq_symm_slab(
    const short* q1, const short* q2, const short* q3, const float* s1,
    const float* s2, const float* s3, const float* p_hi, const float* p_lo,
    const int* it, const int* kt, const int* lt, const int* d_ptr,
    const int* d_ids, const int* t_ptr, const int* t_ids, float* yd_hi,
    float* yd_lo, float* yt_hi, float* yt_lo, double* part_d, double* part_t,
    int T, int ms, int n, void* stream) {
  return launch_slab(FQPlane{q1, q2, q3, s1, s2, s3, 0.0, 0.0, 0.0},
                     DF64Vec{p_hi, p_lo}, TableWalk{it, kt, lt, n, 1},
                     SlabLists{d_ptr, d_ids, t_ptr, t_ids},
                     DF64Out{yd_hi, yd_lo}, DF64Out{yt_hi, yt_lo}, part_d,
                     part_t, T, ms, (cudaStream_t)stream);
}

// dfq: hi + loq * sc formed and walked in f64.
extern "C" int lam_gemv_dfq_symm_slab(
    const float* a_hi, const short* a_loq, const float* sc, const float* p_hi,
    const float* p_lo, const int* it, const int* kt, const int* lt,
    const int* d_ptr, const int* d_ids, const int* t_ptr, const int* t_ids,
    float* yd_hi, float* yd_lo, float* yt_hi, float* yt_lo, double* part_d,
    double* part_t, int T, int ms, int n, void* stream) {
  return launch_slab(DFQPlane{a_hi, a_loq, sc, 0.0}, DF64Vec{p_hi, p_lo},
                     TableWalk{it, kt, lt, n, 1},
                     SlabLists{d_ptr, d_ids, t_ptr, t_ids},
                     DF64Out{yd_hi, yd_lo}, DF64Out{yt_hi, yt_lo}, part_d,
                     part_t, T, ms, (cudaStream_t)stream);
}

// Dual matvec (yd, yt) = (S p, S^T q) over the mb x cb row-major tiles of a
// dense rectangle S (mb*TB, cb*TB) stored in a (T*TB, TB) buffer, T >= mb*cb
// (the pad tiles and their scales are not read): p (cb*TB,), q (mb*TB,), yd
// (mb*TB,), yt (cb*TB,); scratch part_d mb*cb*TB and part_t mb*cb*STRIPS*TB
// elements, f32 for the f32 and q16 kernels, f64 for the others.
extern "C" int lam_gemv_f32_dual(const float* a, const float* p,
                                 const float* q, float* yd, float* yt,
                                 float* part_d, float* part_t, int mb, int cb,
                                 void* stream) {
  return launch_dual(F32Plane{a}, F32Vec{p}, F32Vec{q}, F32Out{yd}, F32Out{yt},
                     part_d, part_t, mb, cb, (cudaStream_t)stream);
}

// The df64 twin: (a_hi + a_lo) formed and walked in f64; yd and yt returned
// as f32 (hi, lo) splits of the f64 sums.
extern "C" int lam_gemv_df64_dual(
    const float* a_hi, const float* a_lo, const float* p_hi, const float* p_lo,
    const float* q_hi, const float* q_lo, float* yd_hi, float* yd_lo,
    float* yt_hi, float* yt_lo, double* part_d, double* part_t, int mb, int cb,
    void* stream) {
  return launch_dual(DF64Plane{a_hi, a_lo}, DF64Vec{p_hi, p_lo},
                     DF64Vec{q_hi, q_lo}, DF64Out{yd_hi, yd_lo},
                     DF64Out{yt_hi, yt_lo}, part_d, part_t, mb, cb,
                     (cudaStream_t)stream);
}

// dfq: hi + loq * sc[t] formed and walked in f64.
extern "C" int lam_gemv_dfq_dual(
    const float* a_hi, const short* a_loq, const float* sc, const float* p_hi,
    const float* p_lo, const float* q_hi, const float* q_lo, float* yd_hi,
    float* yd_lo, float* yt_hi, float* yt_lo, double* part_d, double* part_t,
    int mb, int cb, void* stream) {
  return launch_dual(DFQPlane{a_hi, a_loq, sc, 0.0}, DF64Vec{p_hi, p_lo},
                     DF64Vec{q_hi, q_lo}, DF64Out{yd_hi, yd_lo},
                     DF64Out{yt_hi, yt_lo}, part_d, part_t, mb, cb,
                     (cudaStream_t)stream);
}

// q16: the int16 q1 plane against s1[t], the scale folded into p and q, f32
// sums.
extern "C" int lam_gemv_q16_dual(const short* q1, const float* s1,
                                 const float* p, const float* q, float* yd,
                                 float* yt, float* part_d, float* part_t,
                                 int mb, int cb, void* stream) {
  return launch_dual(Q16Plane{q1, s1, 0.0f}, F32Vec{p}, F32Vec{q}, F32Out{yd},
                     F32Out{yt}, part_d, part_t, mb, cb, (cudaStream_t)stream);
}

// fq: q1*s1[t] + q2*s2[t] + q3*s3[t] formed and walked in f64.
extern "C" int lam_gemv_fq_dual(
    const short* q1, const short* q2, const short* q3, const float* s1,
    const float* s2, const float* s3, const float* p_hi, const float* p_lo,
    const float* q_hi, const float* q_lo, float* yd_hi, float* yd_lo,
    float* yt_hi, float* yt_lo, double* part_d, double* part_t, int mb, int cb,
    void* stream) {
  return launch_dual(FQPlane{q1, q2, q3, s1, s2, s3, 0.0, 0.0, 0.0},
                     DF64Vec{p_hi, p_lo}, DF64Vec{q_hi, q_lo},
                     DF64Out{yd_hi, yd_lo}, DF64Out{yt_hi, yt_lo}, part_d,
                     part_t, mb, cb, (cudaStream_t)stream);
}

// The bf16 product engine of the three q16 kernels: the same arguments,
// scratch and outputs as lam_gemv_q16_symm, lam_gemv_q16_symm_slab and
// lam_gemv_q16_dual; each tile value and each scaled operand value rounded
// to bf16 (nearest even), tensor-core products, f32 sums.
extern "C" int lam_gemv_q16_symm_bf16(const short* q1, const float* s1,
                                      const float* p, float* y, float* part_d,
                                      float* part_t, int nblk, void* stream) {
  return launch(Q16Bf16Plane{q1, s1}, F32Vec{p}, F32Out{y}, part_d, part_t,
                nblk, (cudaStream_t)stream);
}

extern "C" int lam_gemv_q16_symm_slab_bf16(
    const short* q1, const float* s1, const float* p, const int* it,
    const int* kt, const int* lt, const int* d_ptr, const int* d_ids,
    const int* t_ptr, const int* t_ids, float* yd, float* yt, float* part_d,
    float* part_t, int T, int ms, int n, void* stream) {
  return launch_slab(Q16Bf16Plane{q1, s1}, F32Vec{p},
                     TableWalk{it, kt, lt, n, 1},
                     SlabLists{d_ptr, d_ids, t_ptr, t_ids}, F32Out{yd},
                     F32Out{yt}, part_d, part_t, T, ms, (cudaStream_t)stream);
}

extern "C" int lam_gemv_q16_dual_bf16(const short* q1, const float* s1,
                                      const float* p, const float* q,
                                      float* yd, float* yt, float* part_d,
                                      float* part_t, int mb, int cb,
                                      void* stream) {
  return launch_dual(Q16Bf16Plane{q1, s1}, F32Vec{p}, F32Vec{q}, F32Out{yd},
                     F32Out{yt}, part_d, part_t, mb, cb, (cudaStream_t)stream);
}
