// The walk shared by csrc/gemv_symm.cu (the solver's kernels) and
// csrc/q16_probe.cu (the q16 probe variants): tile readers, walk
// policies, both pass-1 kernels and the three pass-2 kernels, each
// instantiated where it is launched. The design is described at the top
// of gemv_symm.cu.

#pragma once

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
constexpr int P2_COLS = 32;                   // outputs per pass-2 block
constexpr int P2_GROUPS = THREADS / P2_COLS;  // partial sums per output
// The triangle walk of symm_pass1 and symm_pass2 also runs at other tile
// widths (the q16 probes' 1024): blocks per tile and columns per lane
// follow the width; every other walk and kernel is at TB.
template <int W>
constexpr int strips_of = W / ROWS;
template <int W>
constexpr int cols_per_lane_of = W / 32;      // 16 at TB

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

// The broadcast planes of generate mode (lam_tpu's _lo_plane_map and
// gemv_fq_symm's pinned block (0, 0)): an operand stored as ONE (TB, TB)
// tile that every walk position reads, the element at row r, column c of
// any tile reading the tile's (r, c). They go with the walks whose tile t
// starts at t*TB*TB (the packed triangle, the packed band-pair buffer and
// the rectangle; not the square or the slab read in place), so
// off & TILE_MASK is the element's offset within its tile. The tile is
// read with the read-only cache (__ldg), not streamed: 1 MB (f32) or
// 0.5 MB (int16) stays in L2, and the HBM stream is the hi or q1 plane
// alone. The sums are the full-plane planes' expressions, so a zero tile
// gives their bits over a zero plane. FULL_MASK keeps every offset: a
// plane of all the tiles.
constexpr size_t TILE_MASK = (size_t)TB * TB - 1;
constexpr size_t FULL_MASK = ~(size_t)0;

struct DF64TilePlane {
  using acc_t = double;
  static constexpr int VEC = 4;
  const float* __restrict__ hi;
  const float* __restrict__ lo;  // one (TB, TB) tile
  __device__ __forceinline__ void set_tile(int) {}
  __device__ __forceinline__ acc_t p_scale() const { return 1.0; }
  __device__ __forceinline__ void load(size_t off, acc_t v[VEC]) const {
    const float4 h = __ldcs(reinterpret_cast<const float4*>(hi + off));
    const float4 l =
        __ldg(reinterpret_cast<const float4*>(lo + (off & TILE_MASK)));
    v[0] = (double)h.x + (double)l.x;
    v[1] = (double)h.y + (double)l.y;
    v[2] = (double)h.z + (double)l.z;
    v[3] = (double)h.w + (double)l.w;
  }
};

// Eight int16 of one 16-byte vector, sign-extended.
__device__ __forceinline__ void i32x8_of_i16x8(const int4 x, int e[8]) {
  const int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e[2 * j] = (int)(short)(w[j] & 0xffff);
    e[2 * j + 1] = w[j] >> 16;
  }
}

// Eight int16 of one 16-byte load, sign-extended.
__device__ __forceinline__ void load_i16x8(const short* __restrict__ q,
                                           size_t off, int e[8]) {
  i32x8_of_i16x8(__ldcs(reinterpret_cast<const int4*>(q + off)), e);
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

// FQPlane with q2 and/or q3 as one broadcast (TB, TB) tile: m2, m3 are
// TILE_MASK for a tile and ~0 for a full plane (every offset kept). The
// scales stay per walk position.
struct FQTilePlane {
  using acc_t = double;
  static constexpr int VEC = 8;
  const short* __restrict__ q1;
  const short* __restrict__ q2;
  const short* __restrict__ q3;
  const float* __restrict__ s1;
  const float* __restrict__ s2;
  const float* __restrict__ s3;
  size_t m2, m3;
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
    i32x8_of_i16x8(__ldg(reinterpret_cast<const int4*>(q2 + (off & m2))), e2);
    i32x8_of_i16x8(__ldg(reinterpret_cast<const int4*>(q3 + (off & m3))), e3);
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
// says whether the tile also has a transpose term; `width` is the tile
// width of the walk.
template <int W = TB>
struct TriangleWalk {
  static constexpr int width = W;
  __device__ __forceinline__ bool transposed(int i, int k) const {
    return k < i;
  }
  __device__ __forceinline__ void tile(int t, int& i, int& k, size_t& base,
                                       int& ld) const {
    i = walk_row(t);
    k = t - i * (i + 1) / 2;
    base = (size_t)t * W * W;
    ld = W;
  }
};

// The triangle walk read in place from the row-major (n, n) square (lam_tpu's
// packed=False): TriangleWalk's order and terms, tile (i, k) at rows i*W,
// columns k*W, row stride n. Offsets are size_t: n*n passes 2^31 from
// n ~ 46341.
template <int W = TB>
struct SquareWalk {
  static constexpr int width = W;
  int n;
  __device__ __forceinline__ bool transposed(int i, int k) const {
    return k < i;
  }
  __device__ __forceinline__ void tile(int t, int& i, int& k, size_t& base,
                                       int& ld) const {
    i = walk_row(t);
    k = t - i * (i + 1) / 2;
    base = (size_t)i * W * n + (size_t)k * W;
    ld = n;
  }
};

struct TableWalk {
  static constexpr int width = TB;
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
  static constexpr int width = TB;
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

// Column of the tile that lane `lane` holds in slot q (0..width/32): groups of
// VEC columns, 32*VEC columns apart, so each group is one coalesced
// 512-byte segment across the warp.
template <int VEC>
__device__ __forceinline__ int lane_col(int lane, int q) {
  return (q / VEC) * (32 * VEC) + lane * VEC + (q % VEC);
}

// P is the operand of the direct terms (read at column tile k), Q that of
// the transpose terms (read at row tile i). SUB is the number of transpose
// partial rows a block writes: 1 (the 8 warps' column sums reduced in
// shared memory) or WARPS (each warp's own row, no shared-memory pass).
template <class Plane, class Vec, class Walk, int SUB = 1>
__global__ void __launch_bounds__(THREADS)
symm_pass1(Plane A, Vec P, Vec Q, Walk W,
           typename Plane::acc_t* __restrict__ part_d,
           typename Plane::acc_t* __restrict__ part_t) {
  using acc_t = typename Plane::acc_t;
  constexpr int VEC = Plane::VEC;
  constexpr int TBW = Walk::width;
  constexpr int STRIPS_W = strips_of<TBW>;
  constexpr int COLS_PER_LANE = cols_per_lane_of<TBW>;
  static_assert(SUB == 1 || SUB == WARPS, "SUB is 1 or WARPS");

  const int t = blockIdx.x / STRIPS_W;
  const int s = blockIdx.x % STRIPS_W;
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
    pk[q] = P.get(k * TBW + lane_col<VEC>(lane, q)) * sc;
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
    if (lane == 0) part_d[(size_t)t * TBW + r] = d;
    if (offdiag) {
      const acc_t pi = Q.get(i * TBW + r) * sc;
#pragma unroll
      for (int q = 0; q < COLS_PER_LANE; ++q) tacc[q] += a[q] * pi;
    }
  }

  if (offdiag) {  // uniform across the block
    if constexpr (SUB == WARPS) {
      acc_t* out = part_t + (((size_t)t * STRIPS_W + s) * WARPS + warp) * TBW;
#pragma unroll
      for (int q = 0; q < COLS_PER_LANE; ++q)
        out[lane_col<VEC>(lane, q)] = tacc[q];
    } else {
      __shared__ acc_t red[WARPS][TBW];
#pragma unroll
      for (int q = 0; q < COLS_PER_LANE; ++q)
        red[warp][lane_col<VEC>(lane, q)] = tacc[q];
      __syncthreads();
      acc_t* out = part_t + ((size_t)t * STRIPS_W + s) * TBW;
      for (int c = threadIdx.x; c < TBW; c += THREADS) {
        acc_t v = red[0][c];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) v += red[w][c];
        out[c] = v;
      }
    }
  }
}

// The q16 planes under the tensor-core product engines: pass 1 is
// q16_bf16_pass1<MODE>. MMA_DEF is the bf16 engine of the solver's q16
// kernels; the other modes are the q16 probes' (csrc/q16_probe.cu).
enum MmaMode { MMA_DEF, MMA_SPLIT, MMA_HI, MMA_HYBRID };

template <int MODE>
struct Q16MmaPlane {
  using acc_t = float;
  static constexpr int mode = MODE;
  const short* __restrict__ q;
  const float* __restrict__ s;
};
using Q16Bf16Plane = Q16MmaPlane<MMA_DEF>;

template <class Plane>
struct is_mma_plane : std::false_type {};
template <int MODE>
struct is_mma_plane<Q16MmaPlane<MODE>> : std::true_type {};

constexpr int BF_LD = TB + 8;  // bf16 row stride of the staged strip
constexpr int BF_VECS = ROWS * TB / 8 / THREADS;  // 16-byte loads a thread

// What a mode stages in shared memory, in this order: A parts of the strip
// [ROWS][BF_LD] (ah; and al = a - ah where A = 2), PK bf16 parts of the
// direct operand p_k * s [TB] and P parts of the transpose operand
// p_i * s [ROWS] (p1 = bf16(x); p2, p3 the bf16 of what is left where
// P = 3), and for MMA_HYBRID the f32 direct operand [TB].
template <int MODE>
struct MmaSmem {
  static constexpr int A = MODE == MMA_DEF ? 1 : 2;
  static constexpr int P = MODE == MMA_HI || MODE == MMA_HYBRID ? 3 : 1;
  static constexpr int PK = MODE == MMA_HYBRID ? 0 : P;
  static constexpr int PKF = MODE == MMA_HYBRID ? TB : 0;
  static constexpr int bf16s = A * ROWS * BF_LD + PK * TB + P * ROWS;
  static constexpr int bytes =
      bf16s * (int)sizeof(__nv_bfloat16) + PKF * (int)sizeof(float);
};

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

// Eight int16 of one 16-byte load split exactly into bf16 ah + al: ah keeps
// the value's top 8 significant bits (nearest even), al = a - ah is an
// integer of at most 8 significant bits, so bf16 holds it exactly.
__device__ __forceinline__ void bf16x8_split_i16x8(const int4 x, uint4& hi,
                                                   uint4& lo) {
  const int w[4] = {x.x, x.y, x.z, x.w};
  unsigned h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float e0 = (float)(int)(short)(w[j] & 0xffff);
    const float e1 = (float)(w[j] >> 16);
    const __nv_bfloat16 h0 = __float2bfloat16_rn(e0);
    const __nv_bfloat16 h1 = __float2bfloat16_rn(e1);
    h[j] = bf16_pair(h0, h1);
    l[j] = bf16_pair(__float2bfloat16_rn(__fsub_rn(e0, __bfloat162float(h0))),
                     __float2bfloat16_rn(__fsub_rn(e1, __bfloat162float(h1))));
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// x as NP bf16 parts: x rounded (NP = 1), or x = p1 + p2 + p3 to within
// f32 rounding (NP = 3; __fsub_rn, so no contraction alters a residual).
template <int NP>
__device__ __forceinline__ void bf16_parts(float x, __nv_bfloat16* out,
                                           int stride) {
  const __nv_bfloat16 p1 = __float2bfloat16_rn(x);
  out[0] = p1;
  if constexpr (NP == 3) {
    const float r1 = __fsub_rn(x, __bfloat162float(p1));
    const __nv_bfloat16 p2 = __float2bfloat16_rn(r1);
    out[stride] = p2;
    out[2 * stride] =
        __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(p2)));
  }
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

// One k-chunk of a split product: the products of the A parts a[ia] and the
// operand parts b[ip] with ia + ip < 3 (hi: all but al * p3, which lies
// below f32 rounding; split: ah * p and al * p). MMA_DEF accumulates its one
// product in d across chunks; the other modes take the main product ah * p1
// of each chunk into a zeroed accumulator and add it to d with a rounded
// f32 add, and the smaller products into dc: a tensor core's own
// accumulation is less careful than an f32 add.
template <int MODE>
__device__ __forceinline__ void mma_parts(float d[4], float dc[4],
                                          unsigned a[][4], unsigned b[][2]) {
  if constexpr (MODE == MMA_DEF) {
    mma_bf16(d, a[0], b[0]);
  } else {
    float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16(m, a[0], b[0]);
#pragma unroll
    for (int ia = 0; ia < MmaSmem<MODE>::A; ++ia)
#pragma unroll
      for (int ip = 0; ip < MmaSmem<MODE>::P; ++ip)
        if (ia + ip > 0 && ia + ip < 3) mma_bf16(dc, a[ia], b[ip]);
#pragma unroll
    for (int r = 0; r < 4; ++r) d[r] = __fadd_rn(d[r], m[r]);
  }
}

// Four 8 x 8 bf16 matrices from shared memory into the fragment a[0..3]
// (ldmatrix .x4): lane i gives the address of row i % 8 of matrix i / 8;
// lane l gets row l / 4, columns 2 (l % 4) .. +1 of each (TRANS: column
// l / 4, rows 2 (l % 4) .. +1), the lower index in the lower half, as
// mma_bf16's A operand takes them.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(unsigned a[4],
                                        const __nv_bfloat16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(addr) : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(addr) : "memory");
}

// The products of one staged strip: warps 0-3 the direct term of its rows
// into out_d[0 .. ROWS), warps 4-7 (if offdiag) its transpose term into
// out_t[0 .. TB), from the bf16 parts of the strip [A][ROWS][BF_LD] and of
// the operands (MmaSmem<MODE>'s layout: pk, pi, and pkf for MMA_HYBRID).
// LDSM: each A part's fragments by ldmatrix, one instruction where the
// 32-bit and 16-bit loads take four and eight (the strip walk's
// consumers); the same fragments, so the same products.
template <int MODE, bool LDSM = false>
__device__ __forceinline__ void mma_strip(const __nv_bfloat16* strip,
                                          const __nv_bfloat16* pk,
                                          const __nv_bfloat16* pi,
                                          const float* pkf, bool offdiag,
                                          int warp, int lane,
                                          float* __restrict__ out_d,
                                          float* __restrict__ out_t) {
  using S = MmaSmem<MODE>;
  const int g = lane / 4;
  const int c4 = lane % 4;
  const int lr = lane % 8;  // ldmatrix: the row of its matrix lane gives
  const int lq = lane / 8;  // and the matrix
  if (warp < 4) {
    if constexpr (MODE == MMA_HYBRID) {
      // direct on the CUDA cores: 16 strip rows a warp, each lane 8 column
      // pairs 64 apart, f32 FMAs, then a warp sum
      for (int rr = 0; rr < 16; ++rr) {
        const int r = 16 * warp + rr;
        const __nv_bfloat16* eh = strip + r * BF_LD + 2 * lane;
        const __nv_bfloat16* el = eh + ROWS * BF_LD;
        float d = 0.0f;
#pragma unroll
        for (int j = 0; j < TB / 64; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 64 * j + e;
            const float a = __fadd_rn(__bfloat162float(eh[c]),
                                      __bfloat162float(el[c]));
            d = fmaf(a, pkf[c + 2 * lane], d);
          }
        }
        d = warp_sum(d);
        if (lane == 0) out_d[r] = d;
      }
    } else {
      // direct: D(r, 0) = sum_c strip(16 warp + r, c) pk(c)
      const __nv_bfloat16* row = strip + (16 * warp + g) * BF_LD + 2 * c4;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int kc = 0; kc < TB; kc += 16) {
        unsigned a[S::A][4];
        unsigned b[S::P][2];
        if constexpr (LDSM) {
          // matrices (rows 0-7 | 8-15) x (columns kc | kc + 8)
#pragma unroll
          for (int ia = 0; ia < S::A; ++ia)
            ldsm_x4<false>(a[ia], strip + ia * ROWS * BF_LD +
                                      (16 * warp + lr + (lq & 1) * 8) * BF_LD +
                                      kc + (lq >> 1) * 8);
        } else {
#pragma unroll
          for (int ia = 0; ia < S::A; ++ia) {
            const __nv_bfloat16* ra = row + ia * ROWS * BF_LD;
            a[ia][0] = ld_bf16x2(ra + kc);
            a[ia][1] = ld_bf16x2(ra + 8 * BF_LD + kc);
            a[ia][2] = ld_bf16x2(ra + kc + 8);
            a[ia][3] = ld_bf16x2(ra + 8 * BF_LD + kc + 8);
          }
        }
#pragma unroll
        for (int ip = 0; ip < S::P; ++ip) {
          const __nv_bfloat16* pp = pk + ip * TB + kc + 2 * c4;
          b[ip][0] = g == 0 ? ld_bf16x2(pp) : 0u;
          b[ip][1] = g == 0 ? ld_bf16x2(pp + 8) : 0u;
        }
        mma_parts<MODE>(d, dc, a, b);
      }
      if (c4 == 0) {
        float* out = out_d + 16 * warp + g;
        if constexpr (MODE == MMA_DEF) {
          out[0] = d[0];
          out[8] = d[2];
        } else {
          out[0] = __fadd_rn(d[0], dc[0]);
          out[8] = __fadd_rn(d[2], dc[2]);
        }
      }
    }
  } else if (offdiag) {  // uniform across the warp
    // transpose: D(c, 0) = sum_r strip(r, c) pi(r), columns 128 (warp - 4) ..
    unsigned b[ROWS / 16][S::P][2];
#pragma unroll
    for (int kr = 0; kr < ROWS / 16; ++kr)
#pragma unroll
      for (int ip = 0; ip < S::P; ++ip) {
        const __nv_bfloat16* pp = pi + ip * ROWS + 16 * kr + 2 * c4;
        b[kr][ip][0] = g == 0 ? ld_bf16x2(pp) : 0u;
        b[kr][ip][1] = g == 0 ? ld_bf16x2(pp + 8) : 0u;
      }
    for (int c0 = 128 * (warp - 4); c0 < 128 * (warp - 3); c0 += 16) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kr = 0; kr < ROWS / 16; ++kr) {
        // A^T(m, j) = strip(16 kr + j, c0 + m)
        unsigned a[S::A][4];
        if constexpr (LDSM) {
          // matrices (rows 16 kr + 0-7 | 8-15) x (columns c0 | c0 + 8),
          // transposed
#pragma unroll
          for (int ia = 0; ia < S::A; ++ia)
            ldsm_x4<true>(a[ia], strip + ia * ROWS * BF_LD +
                                     (16 * kr + lr + (lq >> 1) * 8) * BF_LD +
                                     c0 + (lq & 1) * 8);
        } else {
#pragma unroll
          for (int ia = 0; ia < S::A; ++ia) {
            const __nv_bfloat16* e = strip + ia * ROWS * BF_LD +
                                     (16 * kr + 2 * c4) * BF_LD + c0 + g;
            a[ia][0] = bf16_pair(e[0], e[BF_LD]);
            a[ia][1] = bf16_pair(e[8], e[BF_LD + 8]);
            a[ia][2] = bf16_pair(e[8 * BF_LD], e[9 * BF_LD]);
            a[ia][3] = bf16_pair(e[8 * BF_LD + 8], e[9 * BF_LD + 8]);
          }
        }
        mma_parts<MODE>(d, dc, a, b[kr]);
      }
      if (c4 == 0) {
        if constexpr (MODE == MMA_DEF) {
          out_t[c0 + g] = d[0];
          out_t[c0 + g + 8] = d[2];
        } else {
          out_t[c0 + g] = __fadd_rn(d[0], dc[0]);
          out_t[c0 + g + 8] = __fadd_rn(d[2], dc[2]);
        }
      }
    }
  }
}

// Pass 1 of the tensor-core engines, same blocks and outputs as symm_pass1:
// block (t, s) writes part_d[t][s*ROWS .. +ROWS) and, for a tile with a
// transpose term, part_t[t][s][0 .. TB). MMA_HYBRID takes the direct term
// as f32 FMAs on the CUDA cores (a = ah + al, exact) and only the transpose
// term on the tensor cores.
template <int MODE, class Walk>
__global__ void __launch_bounds__(THREADS)
q16_bf16_pass1(Q16MmaPlane<MODE> A, F32Vec P, F32Vec Q, Walk W,
               float* __restrict__ part_d, float* __restrict__ part_t) {
  using S = MmaSmem<MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* strip = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* pk = strip + S::A * ROWS * BF_LD;
  __nv_bfloat16* pi = pk + S::PK * TB;
  float* pkf = reinterpret_cast<float*>(pi + S::P * ROWS);

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
      const int at = (v / (TB / 8)) * BF_LD + (v % (TB / 8)) * 8;
      if constexpr (S::A == 1) {
        *reinterpret_cast<uint4*>(strip + at) = bf16x8_of_i16x8(raw[u]);
      } else {
        bf16x8_split_i16x8(raw[u], *reinterpret_cast<uint4*>(strip + at),
                           *reinterpret_cast<uint4*>(strip + ROWS * BF_LD + at));
      }
    }
  }
  for (int c = threadIdx.x; c < TB; c += THREADS) {
    const float x = __fmul_rn(P.get(k * TB + c), sc);
    if constexpr (S::PKF > 0)
      pkf[c] = x;
    else
      bf16_parts<S::PK>(x, pk + c, TB);
  }
  if (threadIdx.x < ROWS)
    bf16_parts<S::P>(__fmul_rn(Q.get(i * TB + s * ROWS + threadIdx.x), sc),
                     pi + threadIdx.x, ROWS);
  __syncthreads();

  mma_strip<MODE>(strip, pk, pi, pkf, offdiag, warp, lane,
                  part_d + (size_t)t * TB + s * ROWS,
                  part_t + ((size_t)t * STRIPS + s) * TB);
}

// Pass 1 of any walk: symm_pass1 with a tile reader (SUB transpose partial
// rows a block), or q16_bf16_pass1 at TB.
template <class Plane, class Vec, class Walk, int SUB = 1>
int pass1(Plane A, Vec P, Vec Q, Walk W, int tiles,
          typename Plane::acc_t* part_d, typename Plane::acc_t* part_t,
          cudaStream_t stream) {
  if constexpr (is_mma_plane<Plane>::value) {
    static_assert(Walk::width == TB && SUB == 1, "the mma pass is at TB");
    constexpr int MODE = Plane::mode;
    constexpr int bytes = MmaSmem<MODE>::bytes;
    // the staged strip needs the opt-in shared-memory size, set once for
    // each instantiation and device (devices past 63 set it every call)
    static std::atomic<unsigned long long> opted_in{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (!(opted_in.load(std::memory_order_acquire) & bit)) {
      e = cudaFuncSetAttribute(q16_bf16_pass1<MODE, Walk>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
      if (e != cudaSuccess) return (int)e;
      opted_in.fetch_or(bit, std::memory_order_release);
    }
    q16_bf16_pass1<MODE, Walk><<<tiles * STRIPS, THREADS, bytes, stream>>>(
        A, P, Q, W, part_d, part_t);
  } else {
    constexpr int strips = strips_of<Walk::width>;
    symm_pass1<Plane, Vec, Walk, SUB><<<tiles * strips, THREADS, 0, stream>>>(
        A, P, Q, W, part_d, part_t);
  }
  return (int)cudaGetLastError();
}

// y[i*W + r] = sum_{k<=i} part_d[t(i,k)][r] + sum_{j>i} sum_s part_t[t(j,i)][s][r]
// over the PARTS transpose partial rows s of each tile, at tile width W.
// Block: P2_COLS consecutive outputs (one row-tile i, since P2_COLS divides
// W) x P2_GROUPS strided partial sums, combined in a fixed order. PDL:
// launched as a programmatic dependent of pass 1 (csrc/strip_walk.cuh,
// kernel 15-bcast on zero tiles), it first waits for pass 1's writes.
// AHEAD: a thread asks for AHEAD of its terms at once, then adds them in
// the same order (the same bits): with PARTS = 64 (probe P4s) row tile 0's
// threads sum ~150 terms each, a chain of dependent loads one at a time.
template <int W, int PARTS, class acc_t, class Out, bool PDL = false,
          int AHEAD = 1>
__global__ void __launch_bounds__(THREADS)
symm_pass2(const acc_t* __restrict__ part_d, const acc_t* __restrict__ part_t,
           int nblk, Out out) {
  if constexpr (PDL) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ acc_t red[P2_GROUPS][P2_COLS];
  const int col = threadIdx.x % P2_COLS;
  const int grp = threadIdx.x / P2_COLS;
  const int row = blockIdx.x * P2_COLS + col;
  const int i = row / W;
  const int r = row % W;
  const int n_direct = i + 1;
  const int n_terms = n_direct + (nblk - 1 - i) * PARTS;
  const size_t tdiag0 = (size_t)i * (i + 1) / 2;

  acc_t v = acc_t(0);
  int m = grp;
  if constexpr (AHEAD > 1) {
    for (; m + (AHEAD - 1) * P2_GROUPS < n_terms; m += AHEAD * P2_GROUPS) {
      acc_t x[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int mu = m + u * P2_GROUPS;
        const int mt = mu - n_direct;
        const int j = i + 1 + mt / PARTS;
        x[u] = mu < n_direct
                   ? part_d[(tdiag0 + mu) * W + r]
                   : part_t[(((size_t)j * (j + 1) / 2 + i) * PARTS +
                             mt % PARTS) * W + r];
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) v += x[u];
    }
  }
  for (; m < n_terms; m += P2_GROUPS) {
    if (m < n_direct) {
      v += part_d[(tdiag0 + m) * W + r];
    } else {
      const int mt = m - n_direct;
      const int j = i + 1 + mt / PARTS;
      const size_t tj = (size_t)j * (j + 1) / 2 + i;
      v += part_t[(tj * PARTS + mt % PARTS) * W + r];
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
// PDL: launched as a programmatic dependent of pass 1 (csrc/strip_walk.cuh,
// kernel 16), it first waits for pass 1's writes.
template <class acc_t, class Out, bool PDL = false>
__global__ void __launch_bounds__(THREADS)
slab_pass2(const acc_t* __restrict__ part_d, const acc_t* __restrict__ part_t,
           const int* __restrict__ d_ptr, const int* __restrict__ d_ids,
           const int* __restrict__ t_ptr, const int* __restrict__ t_ids,
           int ms, Out yd, Out yt) {
  if constexpr (PDL) asm volatile("griddepcontrol.wait;\n" ::: "memory");
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
// sums as in slab_pass2; PDL as there (kernels 18 and 19).
template <class acc_t, class Out, bool PDL = false>
__global__ void __launch_bounds__(THREADS)
rect_pass2(const acc_t* __restrict__ part_d, const acc_t* __restrict__ part_t,
           int mb, int cb, Out yd, Out yt) {
  if constexpr (PDL) asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

// The triangle walk at tile width W with SUB transpose partial rows a
// strip: part_d T*W, part_t T*strips_of<W>*SUB*W elements. The walk reads
// the packed buffer (TriangleWalk) or the square in place (SquareWalk).
template <int W = TB, int SUB = 1, class Plane, class Vec, class Out,
          class Walk = TriangleWalk<W>>
int launch(Plane A, Vec P, Out Y, typename Plane::acc_t* part_d,
           typename Plane::acc_t* part_t, int nblk, cudaStream_t stream,
           Walk walk = Walk{}) {
  static_assert(Walk::width == W, "the walk's tile width is W");
  const int T = nblk * (nblk + 1) / 2;
  const int e = pass1<Plane, Vec, Walk, SUB>(A, P, P, walk, T, part_d,
                                             part_t, stream);
  if (e != 0) return e;
  symm_pass2<W, strips_of<W> * SUB, typename Plane::acc_t, Out>
      <<<nblk * W / P2_COLS, THREADS, 0, stream>>>(part_d, part_t, nblk, Y);
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
