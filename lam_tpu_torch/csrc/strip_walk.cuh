// The strip walk: pass 1 of thirteen kernels, a persistent grid fed by TMA
// bulk copies, in place of symm_pass1 and q16_bf16_pass1
// (csrc/symm_walk.cuh):
//
//   kernel 16  lam_gemv_q16_symm_slab  the q16 plane, one rank's band-pair
//                                      tables (TableWalk), one operand p
//   kernel 18  lam_gemv_q16_dual       the q16 plane, the rectangle
//                                      (RectWalk), p and q
//   kernel 18-bf16  lam_gemv_q16_dual_bf16  kernel 18's bf16 engine: the
//                                      same plane and operands, bf16
//                                      tensor-core products
//                                      (strip_mma_pass1)
//   kernel 19  lam_gemv_fq_dual        the fq cascade (three int16 planes,
//                                      f64 sums), the rectangle, the (hi,
//                                      lo) pairs of p and q
//   kernel 15-bcast on zero tiles  lam_gemv_fq_symm_zero  the fq
//                                      cascade whose q2/q3 tiles are zero:
//                                      q1 alone, f64 sums, the packed
//                                      triangle (TriangleWalk), symm_pass2
//   kernel 9-bcast on a zero tile  lam_gemv_df64_symm_slab_zero  the
//                                      df64 pair whose lo tile is zero: the
//                                      f32 hi plane alone, f64 sums, the
//                                      band-pair tables
//   kernel 12-bcast on a zero tile  lam_gemv_df64_dual_zero  the df64
//                                      pair of the rectangle whose lo tile
//                                      is zero: the f32 hi plane alone, f64
//                                      sums, the (hi, lo) pairs of p and q
//   kernel 17-bcast on zero tiles  lam_gemv_fq_symm_slab_zero  the fq
//                                      cascade of the band-pair tables
//                                      whose q2/q3 tiles are zero: q1
//                                      alone, f64 sums
//   kernel 19-bcast on zero tiles  lam_gemv_fq_dual_zero  the fq cascade
//                                      of the rectangle whose q2/q3 tiles
//                                      are zero: q1 alone, f64 sums, the
//                                      (hi, lo) pairs of p and q
//   probe P4s  lam_gemv_q16_symm_sub8   (csrc/q16_probe.cu) the q16 plane
//                                      of the packed triangle, exact
//                                      products, each summing warp's
//                                      transpose row kept (SUB = WARPS:
//                                      8 rows a strip, no reduction, no
//                                      consumer barrier), symm_pass2
//   probe P5s  lam_gemv_q16_symm_split  (csrc/q16_probe.cu) the q16 plane
//                                      of the packed triangle, each value
//                                      split into bf16 ah + al, tensor-core
//                                      products (strip_mma_pass1), symm_pass2
//   probe P5h  lam_gemv_q16_symm_hi     the same plane and split, p * s in
//                                      three bf16 parts, five products
//                                      (strip_mma_pass1 from the raw stage)
//   probe P5y  lam_gemv_q16_symm_hybrid  P5h's transpose term, the direct
//                                      term as f32 FMAs on the CUDA cores
//
// Each keeps its two-pass walk as a control (lam_gemv_*_twopass; the five
// zero-tile walks: the tile-reading entry points lam_gemv_fq_symm_bcast,
// lam_gemv_df64_symm_slab_bcast, lam_gemv_df64_dual_bcast,
// lam_gemv_fq_symm_slab_bcast and lam_gemv_fq_dual_bcast, which a non-zero
// tile takes), and every other kernel runs the two-pass walk.
//
// What bounds them: bytes. Every stored element is read once, 2 B (q16) or
// 6 B (fq), for 4 flops (its direct and its transpose product): kernel 16
// 55.05 MB at rank 0 of G=2 (16.4 us at 3.35 TB/s), kernel 18 26.2 MB and
// kernel 19 78.6 MB at the (2560, 5120) half-slab of the 2 x 2 grid (7.8
// and 23.5 us). The unit of work is symm_pass1's (tile, 64-row strip):
// 64 KB of each plane, about 2.6 us of one SM's share of the card's
// bandwidth. symm_pass1 gives each strip its own block and pays, around
// those bytes, fixed costs that nothing overlaps: dependent reads of the
// walk tables and the scales, sixteen operand loads a lane before the
// first byte of the tile is asked for, the transpose reduction behind a
// block-wide barrier, and pass 2's launch gap. The fq cascade also spends
// three int -> f64 conversions an element (16 a clock on an SM), which
// must overlap the stream.
//
// What the design does about them:
//  * A persistent grid of one block an SM (the SM count read once and
//    cached); block b walks strips b, b + grid, ... (840 strips at G=2 on
//    132 SMs, 400 on the half-slab).
//  * The block's last warp is the producer. One thread reads the next
//    strip's tile (the table entries it/kt, or i, k of the rectangle) and
//    its scales before it waits for a free stage, writes the scales and
//    whether the tile has a transpose term into the stage's header, and
//    fills the stage with TMA 1-D bulk copies (UBLKCP in the SASS): the
//    stage's rows of each plane (contiguous in the (T*TB, TB) planes),
//    evict-first in L2, and evict-last the direct operand at column tile k
//    and the transpose operand at the stage's rows of row tile i. So no
//    consumer waits on a dependent global read: the producer runs ahead.
//  * A stage holds SR rows of a strip: the whole 64-row strip (64 KB) for
//    kernel 16, 32 rows for kernels 18 (32 KB) and 19 (a 64-row strip of
//    fq's three planes is 192 KB, more than the ring can hold twice; a
//    stage of 32 rows is 96 KB). Stage j of a strip is read by the consumer
//    warps that own its rows (warps 4j .. 4j+3 at SR = 32), which wait on
//    its full barrier, read their rows and the operands from shared memory
//    as 16-byte vectors (a warp reads 512 contiguous bytes of a plane's
//    row: no bank conflict), and release it on its empty barrier as soon as
//    their rows are summed, or (EARLY, kernel 18) as soon as they hold them
//    in registers. The ring's counter runs on across strips, so the
//    producer fills the next strip's stage j while this strip is summed.
//  * The ring holds a multiple of a strip's stages, so each slot is read by
//    one group of warps only, in order. An mbarrier's parity wait cannot
//    tell the phase it waits for from the one two before: a group that
//    waited on a slot whose previous fill it had not itself seen complete
//    would pass at once, on the old bytes (the first layout tried for
//    kernel 19, three 16-row stages, hung or faulted so).
//  * The 8 consumer warps reduce the transpose sums through shared memory
//    on a named barrier of their own (bar.sync 1, 256), in rounds of RW
//    warps' rows, while the producer streams on. Probe P4s (SUB = WARPS)
//    does not: each warp stores its own transpose row to global memory
//    where symm_pass1<..., WARPS> stores it and goes on to its next strip,
//    so no consumer waits for another (the TPU probe's transpose tree
//    stopped at 8 sublanes, each summed once at the end).
//  * Kernel 19 converts its int16 values to f64 by bits (BITS): the three
//    conversions an element, at 16 a clock on an SM, were 3/8 of a strip's
//    share of the card's bandwidth; by bits each is one add at 64 a clock.
//  * The five zero-tile walks (generate mode's broadcast tiles, known zero
//    when the operator is built) read only the plane that is not zero: the
//    q1 of 15-bcast (the triangle's (i, k) from walk_row in the producer),
//    of 17-bcast (the band-pair tables, the scales per walk position of
//    the rank's own table) and of 19-bcast (the rectangle, the direct
//    operand p and the transpose operand q), in 32-row stages of 32 KB,
//    four of them (two for 17- and 19-bcast), EARLY, converted by bits and
//    multiplied by its f64 scale; the f32 hi of 9-bcast (the band-pair tables) and of
//    12-bcast (the rectangle, the direct operand p and the transpose
//    operand q), in 32-row stages of 64 KB (9-bcast, as kernel 19's) or
//    16-row stages of 32 KB, four of them (12-bcast), formed as (double)h
//    + 0.0, DF64TilePlane's element with l = +0.0. EARLY is not tried on
//    an f32 plane: a warp's raw rows would hold 128 registers (StripCfg
//    takes it only for an int16 plane). The tile-reading walks spent an
//    I2F.F64 a
//    value (three for the fq cascade) and read the tile from L2 as often
//    as they streamed the plane (PERF.md section 6). symm_pass2 is the
//    triangle's pass 2, a programmatic dependent as slab_pass2 and
//    rect_pass2 are.
//  * Kernel 18-bf16's consumers (strip_mma_pass1, MMA) run q16_bf16_pass1's
//    tensor-core products. Its mma.sync fragments read 16-bit pairs of
//    eight rows at once; on a raw stage, whose rows are 1024 bytes apart,
//    the eight row groups fall in one bank. So every consumer warp converts
//    its share of each stage (by bits: the exact f32 of each int16, then
//    round to nearest even) into q16_bf16_pass1's bf16 strip, whose rows
//    are padded to TB + 8, with the direct operand p_k * s and the
//    transpose operand q_i * s (__fmul_rn, then bf16), and releases the
//    stage; after a barrier of the consumers warps 0-3 run the direct term
//    and warps 4-7 the transpose term, as q16_bf16_pass1 does, the A
//    fragments taken with ldmatrix (.trans for the transpose term: one
//    instruction where q16_bf16_pass1 issues four 32-bit or eight 16-bit
//    loads); a second barrier guards the strip buffer until every warp has
//    read it. Probe P5s's consumers (MMA_SPLIT, on the triangle) split
//    each value by bits into bf16 ah + al, into the two parts of
//    q16_bf16_pass1<MMA_SPLIT>'s strip, and take both parts' fragments
//    with ldmatrix.
//  * Probes P5h and P5y (MMA_HI, MMA_HYBRID; RAW) keep no bf16 strip: the
//    producer lands each 1 KB row of the strip in a row padded to TB + 8
//    int16 (one bulk copy a row, 64 a strip; ldmatrix's eight rows then
//    fall in eight bank groups), and the consumers take raw int16
//    fragments with ldmatrix and split them by bits in registers into the
//    control's ah + al, in the same fragment positions. Warps 0-3 run the
//    direct term of their 16 rows (hi: the chain of mma_parts over the 32
//    k-chunks, each chunk's fragment asked for before the products of the
//    one before; hybrid: mma_strip's f32 FMAs on each value by bits, which
//    is exactly ah + al); warps 4-7 the transpose term of their 128
//    columns in two halves of four 16-column blocks, the four blocks'
//    chains interleaved over the strip's four 16-row chunks (32
//    accumulators). Each warp makes the operand parts (bf16_parts of p_k *
//    s and q_i * s) it needs: a direct warp p_k's in a buffer of its own,
//    a transpose warp q_i's in registers. No barrier joins the consumers:
//    each releases the stage when it has read it.
//  * Pass 2 (slab_pass2 or rect_pass2) is a programmatic dependent launch
//    (cudaLaunchAttributeProgrammaticStreamSerialization): its blocks are
//    scheduled while pass 1 drains its last strips and wait
//    (griddepcontrol.wait) for pass 1's writes before they read a partial.
//
// Sizes, from sweeps on an H100 (PERF.md section 6; the chosen ones at
// SlabQ16Cfg, DualQ16Cfg, DualFQCfg, DualBf16Cfg, SymmQ1Cfg, SlabHiCfg,
// DualHiCfg, SlabQ1Cfg, DualQ1Cfg, SymmSplitCfg, SymmHiCfg,
// SymmHybridCfg and SymmSub8Cfg below). Kernel 16: two
// stages (136 KB) and a 16 KB reduction buffer; a third stage was slower,
// and so were two blocks an SM of one stage each, the int16 -> f32
// conversion by bits (csrc/q16_probe.cu's magic), an earlier pass-2
// trigger and pass 2 as an ordinary launch; eight 8 KB copies a strip,
// contiguous ranges of strips and a double-buffered reduction were as fast
// as what is kept. Kernels 18 and 19: two, eight or four copies a
// plane's stage, a grid of 100 blocks (4 strips each) and conversion by
// bits for kernel 18 were as fast as what is kept; a grid of one block a
// strip (400), 80 or 67 blocks, pass 2 as an ordinary launch, and for
// kernel 18 a third 64 KB stage, 16-row stages or 32-row stages in a ring
// of two were slower, and so was a pass 2 whose loads were unrolled to be
// issued together; kernel 19's 16-row stages, four of them, were slower
// than its two 32-row stages. EARLY brought kernel 18's pass 1 to the read
// floor of its plane; conversion by bits made kernel 19 faster. Kernel
// 18-bf16: two 32-row stages (one strip in flight), conversion by bits and
// ldmatrix each made it faster; 64-row stages (two, or one), four 32-row
// stages, 16-row stages (four or eight), a second bf16 buffer (the next
// strip converted while this one is multiplied, one barrier a strip), the
// transpose chains unrolled to interleave, and a grid of 100 blocks were
// as fast or slower. The summing walks (all but 18-bf16's): summing a row
// one 16-byte vector at a time into both sums (half the values live), not
// its whole 16 values first, made kernels 16, 18, 19 and the zero-tile
// walks of 15-bcast and 9-bcast faster, and let 15-bcast's f64 walk take
// EARLY without a spill. 19-bcast's zero-tile walk: 17-bcast's sizes were
// the fastest; four 32-row stages (in one or two reduction rounds) and
// 16-row stages (four or eight) were 1-4% slower, 64-row stages (two, or
// one) 5-10%, two reduction rounds of two stages as fast, EARLY off 10%
// and conversion by instruction 7% slower; grids of 100-126 blocks (the
// half-slab's 400 strips in whole rounds or fewer) 0.5-1.5% and 80 blocks
// 13% slower than one block an SM. P5s: two 32-row stages and one 64-row
// stage were as fast, 16- and 8-row stages 7% and 15% slower. P5h and
// P5y: through a bf16 strip buffer (the converting consumers, 32- or
// 64-row stages) 3-7% (hi) and 33-38% (hybrid) slower than the raw
// stage; all eight transpose blocks at once (64 accumulators: 16-row
// stages fit in 168 registers, 32- and 64-row ones spilled) 6-11% slower
// than two halves of four; a third stage as fast; the direct fragments
// two chunks ahead, the B fragments one ahead, a hand-interleaved direct
// chain and all eight warps taking transpose blocks beside the direct
// chains 1-31% slower; the packed split conversion 2-4% faster. P4s:
// EARLY 32-row stages, four (or two) of them, 2% faster than kernel 16's
// two 64-row stages; 16-row stages, six 32-row stages, a third 64-row
// stage, conversion by bits and part_t stored with an L2 evict-last hint
// as fast or up to 1% slower; its pass 2 (symm_pass2 over 64 rows a tile)
// took ~40% of its time, and asking for 8 terms a thread at once (AHEAD)
// made the walk 13% faster (4 or 16-32 at once, and an L2 bulk prefetch
// of each block's partials, slower; blocks of 16 outputs, not 32, 1%
// faster, not taken: symm_pass2's blocks are every triangle walk's).
//
// The bits: inside a strip nothing of symm_pass1's order changes. Warp w
// sums rows w*8 .. w*8+7 in that order, lane l holds columns lane_col<8>(l,
// q), d is the sum over q then the warp butterfly; the consumers repeat
// symm_pass1's expressions as written (pk = p * sc and pi = q * sc;
// Q16Plane's exact int16 -> f32, FQPlane's ((e1*c1 + e2*c2) + e3*c3) in f64
// with every product exact, on the same exact values whether converted by
// instruction or by bits; DF64Vec's hi + lo in f64; d += a * pk and tacc
// += a * pi), so nvcc contracts them into the same FMAs; the transpose
// column sums are added over the 8 warps in the order w = 0 .. 7 (a round
// of RW < 8 warps carries the sum on in registers, the same additions),
// or (SUB = WARPS) kept apart, each warp's row the two-pass walk's row.
// Each block writes part_d[t][r] and part_t[t][s][c] (part_t[t][s][w][c] at
// SUB = WARPS) as symm_pass1 does, so pass 2 sums the same partials in the
// same order: (yd, yt) equal the two-pass walk's bit for bit. The f32
// plane of 9-bcast and 12-bcast is read as DF64TilePlane reads it, four
// columns a 16-byte vector
// (lane_col<4>); on the rectangle symm_pass1 reads pk = P.get(k*TB + c) * 1
// and pi = Q.get(i*TB + r) * 1 from the two (hi, lo) pairs, the strip walk
// the same sums from the stage, and both write part_d[i*cb + k][r] and
// part_t[i*cb + k][s][c], which rect_pass2 sums.
//
// The zero-tile walks drop terms, and keep the bits all the same. With e2 =
// e3 = 0, FQPlane's element (e1*c1 + 0*c2) + 0*c3 (every product exact)
// equals e1*c1 unless e1*c1 is a zero, and then it is a zero too; so is
// (double)h + l against (double)h + 0.0 with l = +-0. Two such elements
// differ at most in the sign of a zero. An element enters the sums only
// as a product a * pk or a * pi added to an accumulator that starts at
// +0.0 (d, tacc; the warp sums, the reduction and pass 2 add such sums): in
// round-to-nearest x + y is -0.0 only where x and y are both -0.0, so no
// accumulator is ever -0.0, a zero term leaves it as it was (a +0.0 one
// too, and a fused multiply-add of a zero product the same), and the sign
// of a zero term never reaches a sum. Any finite scales: zero, -0.0 and
// negative ones give such zero terms; a non-finite scale would not.

#pragma once

#include "symm_walk.cuh"
#include "tma.cuh"

namespace {

constexpr int STRIP_THREADS = (WARPS + 1) * 32;  // + the producer warp

// Eight int16 of one 16-byte vector as T (float or double), exactly: with
// the conversion instruction (I2F, 16 a clock on an SM), or by bits (BITS):
// each value biased to unsigned u = e + 2^15 (a sign-bit xor of the pair)
// and placed in the mantissa of 2^23 (f32) or 2^52 (f64), which is then
// 2^23 + u or 2^52 + u exactly; one add of -(2^23 + 2^15) or -(2^52 +
// 2^15) leaves e, exactly (csrc/q16_probe.cu's magic, with byte permutes).
template <class T, bool BITS>
__device__ __forceinline__ void values8_of_i16x8(const int4 x, T v[8]) {
  if constexpr (BITS) {
    const unsigned w[4] = {(unsigned)x.x, (unsigned)x.y, (unsigned)x.z,
                           (unsigned)x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned u = w[j] ^ 0x80008000u;
      if constexpr (sizeof(T) == 4) {
        v[2 * j] = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5410)) -
                   8421376.0f;
        v[2 * j + 1] = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5432)) -
                       8421376.0f;
      } else {
        v[2 * j] = __hiloint2double(0x43300000, (int)(u & 0xffffu)) -
                   4503599627403264.0;
        v[2 * j + 1] =
            __hiloint2double(0x43300000, (int)(u >> 16)) - 4503599627403264.0;
      }
    }
  } else {
    int e[8];
    i32x8_of_i16x8(x, e);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (T)e[j];
  }
}

// The planes of a strip walk: NP planes of packed tiles (elem_t: int16
// against one f32 scale per tile, SCALED; or f32), each read VEC values a
// 16-byte vector at the columns lane_col<VEC> of the two-pass walk's plane
// type. values() gives a lane's VEC tile values of one row from the stage
// (x: the first plane's vector, the others plane_bytes apart; c: the
// tile's scales), the two-pass plane type's expressions on the same
// values; FOLD: the scale is folded into the operands (pk = p * c, pi = q
// * c), as Q16Plane::p_scale does, and not into the values.
//
// NP = 1, the q16 plane: Q16Plane's exact int16 -> f32, f32 sums. NP = 3,
// the fq cascade: FQPlane's q1*s1 + q2*s2 + q3*s3 formed in f64, f64 sums.
template <int NP_>
struct StripPlanes {
  static constexpr int NP = NP_;
  static_assert(NP == 1 || NP == 3, "the q16 plane or the fq cascade");
  static constexpr bool TILES = false, SCALED = true, FOLD = NP == 1;
  static constexpr int VEC = 8;
  using elem_t = short;
  using acc_t = std::conditional_t<NP == 1, float, double>;
  const short* q[NP];
  const float* s[NP];

  // one plane's values from a vector held in registers (EARLY)
  template <bool BITS>
  __device__ __forceinline__ static void values_of(const int4 x,
                                                   const acc_t*,
                                                   acc_t v[VEC]) {
    static_assert(NP == 1, "one plane's vector");
    values8_of_i16x8<float, BITS>(x, v);
  }

  template <bool BITS>
  __device__ __forceinline__ static void values(const unsigned char* x,
                                                int plane_bytes,
                                                const acc_t c[NP],
                                                acc_t v[VEC]) {
    const int4* w = reinterpret_cast<const int4*>(x);
    if constexpr (NP == 1) {
      values_of<BITS>(w[0], c, v);
    } else {
      double e1[8], e2[8], e3[8];
      values8_of_i16x8<double, BITS>(w[0], e1);
      values8_of_i16x8<double, BITS>(w[plane_bytes / 16], e2);
      values8_of_i16x8<double, BITS>(w[2 * plane_bytes / 16], e3);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = (e1[j] * c[0] + e2[j] * c[1]) + e3[j] * c[2];
    }
  }
};

// The fq cascade of kernel 19's broadcast mode, its own type so that the
// full-plane walks keep their code: mask[pl], as FQTilePlane's, FULL_MASK
// for a plane of every tile, TILE_MASK for ONE (TB, TB) tile that every
// tile reads (q2/q3): a stage's rows of tile t sit at (row0 * TB) & mask.
struct StripTilePlanes : StripPlanes<3> {
  static constexpr bool TILES = true;
  size_t mask[NP];
};

// The fq cascade whose q2 and q3 are zero tiles (kernel 15-bcast in
// generate mode): q1 alone against s1, each value e1 * c1 in f64 (exact),
// f64 sums; the zero terms e2 * c2 and e3 * c3 dropped (the bits: see the
// top of this file).
struct StripQ1Planes {
  static constexpr int NP = 1, VEC = 8;
  static constexpr bool TILES = false, SCALED = true, FOLD = false;
  using elem_t = short;
  using acc_t = double;
  const short* q[NP];
  const float* s[NP];

  template <bool BITS>
  __device__ __forceinline__ static void values_of(const int4 x,
                                                   const double c[NP],
                                                   double v[VEC]) {
    double e[8];
    values8_of_i16x8<double, BITS>(x, e);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = e[j] * c[0];
  }

  template <bool BITS>
  __device__ __forceinline__ static void values(const unsigned char* x, int,
                                                const double c[NP],
                                                double v[VEC]) {
    values_of<BITS>(*reinterpret_cast<const int4*>(x), c, v);
  }
};

// The df64 pair whose lo is a zero tile (kernel 9-bcast in generate mode):
// the f32 hi plane alone, no scale, each value DF64TilePlane's (double)h +
// (double)l with l = +0.0, kept as written (it turns -0.0 into +0.0; x +
// 0.0 is not x, so nvcc keeps the add), f64 sums.
struct StripHiPlanes {
  static constexpr int NP = 1, VEC = 4;
  static constexpr bool TILES = false, SCALED = false, FOLD = false;
  using elem_t = float;
  using acc_t = double;
  const float* q[NP];

  template <bool BITS>
  __device__ __forceinline__ static void values(const unsigned char* x, int,
                                                const double*,
                                                double v[VEC]) {
    const float4 h = *reinterpret_cast<const float4*>(x);
    v[0] = (double)h.x + 0.0;
    v[1] = (double)h.y + 0.0;
    v[2] = (double)h.z + 0.0;
    v[3] = (double)h.w + 0.0;
  }
};

// The operands: NV f32 arrays a vector (1: f32; 2: an (hi, lo) pair formed
// in f64 as DF64Vec does), the direct one d read at column tile k and the
// transpose one t at the strip's rows of row tile i (t = d in kernel 16's
// symmetric walk).
template <int NV_>
struct StripVecs {
  static constexpr int NV = NV_;
  static_assert(NV == 1 || NV == 2, "f32 or an (hi, lo) pair");
  using acc_t = std::conditional_t<NV == 1, float, double>;
  const float* d[NV];
  const float* t[NV];
};

template <int NP>
struct StripHeader {
  float sc[NP];  // the tile's scales
  int offdiag;   // the tile has a transpose term
};

// A stage: SR rows of each plane (SR x TB elem_t each), the direct operand
// at column tile k (NV x TB f32), the transpose operand at the stage's rows
// (NV x SR f32), the header. The ring holds S stages, then the transpose
// reduction buffer of RW warps' rows. BITS: the consumers convert int16 to
// f32 or f64 by bits (values8_of_i16x8), not with the conversion
// instruction. EARLY (one plane only): each consumer warp takes its rows
// and operand entries into registers and releases the stage before it sums
// them.
// MODE (one plane, f32 operands): the consumers are tensor-core ones
// (strip_mma_pass1) of the product engine MODE (NO_MMA: the summing
// consumers). MMA_DEF and MMA_SPLIT: every consumer warp converts its
// share of each stage to bf16 into one padded strip buffer
// (MmaSmem<MODE>), in place of the reduction buffer, releases the stage,
// and runs q16_bf16_pass1<MODE>'s products on the buffer. MMA_HI and
// MMA_HYBRID (RAW, one stage a strip): no strip buffer; the producer lands
// each row of the stage in a row padded to TB + 8 int16, and the consumers
// take raw int16 fragments with ldmatrix and split them in registers
// (strip_raw_consumers).
constexpr int NO_MMA = -1;

template <class Planes, class Vecs, int SR_, int S_, int RW_,
          bool BITS_ = false, bool EARLY_ = false, int MODE_ = NO_MMA,
          int SUB_ = 1>
struct StripCfg {
  using acc_t = typename Planes::acc_t;
  static_assert(std::is_same<acc_t, typename Vecs::acc_t>::value,
                "the planes' sums and the operands are of one type");
  using planes_t = Planes;
  static constexpr int NP = Planes::NP, NV = Vecs::NV, VEC = Planes::VEC;
  static constexpr int SR = SR_, S = S_, RW = RW_, MODE = MODE_;
  static constexpr int SUB = SUB_;  // transpose partial rows a strip
  static constexpr bool BITS = BITS_, EARLY = EARLY_, MMA = MODE != NO_MMA;
  // the engines hi and hybrid from the raw stage, def and split through
  // the bf16 strip buffer
  static constexpr bool RAW = MODE == MMA_HI || MODE == MMA_HYBRID;
  static_assert(!EARLY || (NP == 1 && VEC == 8),
                "one int16 plane's rows fit the registers");
  static_assert(!MMA || (NP == 1 && NV == 1 && Planes::FOLD && !EARLY && BITS
                         && (RAW || MODE == MMA_DEF || MODE == MMA_SPLIT)),
                "the tensor-core consumers take the q16 plane and f32 "
                "operands and convert by bits: the engines def or split "
                "through the bf16 strip buffer, hi or hybrid from the raw "
                "stage (RAW)");
  static_assert(!RAW || (MMA && SR == ROWS),
                "raw fragments: the tensor-core consumers, one stage a "
                "strip");
  static_assert(SUB == 1 || (SUB == WARPS && !MMA),
                "the transpose sums reduced over the warps (1), or each "
                "summing warp's own row kept (WARPS)");
  static constexpr int SPS = ROWS / SR;           // stages a strip
  static constexpr int WPS = SR / ROWS_PER_WARP;  // consumer warps a stage
  static constexpr int READERS = MMA ? WARPS : WPS;  // warps that read one
  static constexpr int ROW_LD = RAW ? BF_LD : TB;  // a staged row, elements
  static constexpr int COPY_BYTES =  // a plane's rows of a stage
      SR * TB * (int)sizeof(typename Planes::elem_t);
  static constexpr int PLANE_BYTES =
      SR * ROW_LD * (int)sizeof(typename Planes::elem_t);
  static constexpr int PK_OFF = NP * PLANE_BYTES;
  static constexpr int PI_OFF = PK_OFF + NV * TB * (int)sizeof(float);
  static constexpr int HDR_OFF = PI_OFF + NV * SR * (int)sizeof(float);
  static constexpr int STAGE_BYTES =
      (HDR_OFF + (int)sizeof(StripHeader<NP>) + 127) / 128 * 128;
  // RAW: each direct warp's bf16 parts of the direct operand; SUB =
  // WARPS: no reduction
  static constexpr int RED_BYTES =
      RAW            ? WARPS / 2 * MmaSmem<MODE>::PK * TB * 2
      : MMA          ? MmaSmem<MODE>::bytes
      : SUB == WARPS ? 0
                     : RW * TB * (int)sizeof(acc_t);
  static constexpr int SMEM = S * STAGE_BYTES + RED_BYTES;
  static_assert(SR % ROWS_PER_WARP == 0 && ROWS % SR == 0,
                "a stage is whole warps' rows of one strip");
  static_assert(TB % SR == 0,
                "a stage never crosses a tile: a broadcast tile's stage is "
                "one contiguous copy");
  static_assert(S % SPS == 0, "each slot read by one group of warps");
  static_assert(WARPS % RW == 0, "reduction rounds of whole warps");
  static_assert(SMEM + 2 * S * 8 <= 232448, "a block's shared memory");
};

// The eight kernels' sizes, from the sweeps (PERF.md section 6):
//  * kernel 16: the 64 KB strip as one stage, two stages;
//  * kernel 18: 32-row stages of 32 KB, six of them (four were as fast or
//    a little slower), EARLY: with the stage released once the warps hold
//    their rows, the ring refills while they sum, and pass 1 reads at the
//    card's measured read floor;
//  * kernel 18-bf16: 32-row stages of 32 KB, two of them (one strip in
//    flight), conversion by bits, the transpose sums not reduced (the
//    tensor cores sum each column over the strip) and one 66 KB bf16 strip
//    buffer in the reduction buffer's place: 138 KB;
//  * kernel 19: 32-row stages of the three fq planes (96 KB and 4 KB of
//    (hi, lo) operand each), two of them, the transpose sums reduced in two
//    rounds of 4 warps' f64 rows (16 KB): 217 KB; BITS, since the three
//    int16 -> f64 conversions an element held it back (at 16 a clock on an
//    SM they are 3/8 of a strip's time; by bits, 3 adds at 64);
//  * kernel 15-bcast on zero tiles: 32-row stages of the q1 plane (32 KB
//    and 4 KB of (hi, lo) operand each), four of them, EARLY, BITS, the
//    f64 transpose sums in one round (32 KB): 177 KB; EARLY made it
//    faster (64-row stages, two of them, and 16-row stages, eight, were as
//    fast; six 32-row stages in two reduction rounds, and conversion by
//    instruction, slower);
//  * kernel 9-bcast on a zero tile: 32-row stages of the f32 hi plane (64
//    KB and 4 KB of (hi, lo) operand each), two of them, the f64 transpose
//    sums in one round (32 KB): 169 KB (16-row stages, four or eight, as
//    fast or slower; EARLY would hold 128 registers of raw f32 rows).
using SlabQ16Cfg = StripCfg<StripPlanes<1>, StripVecs<1>, ROWS, 2, WARPS>;
using DualQ16Cfg =
    StripCfg<StripPlanes<1>, StripVecs<1>, 32, 6, WARPS, false, true>;
using DualFQCfg = StripCfg<StripPlanes<3>, StripVecs<2>, 32, 2, WARPS / 2, true>;
using DualFQTileCfg =
    StripCfg<StripTilePlanes, StripVecs<2>, 32, 2, WARPS / 2, true>;
using DualBf16Cfg =
    StripCfg<StripPlanes<1>, StripVecs<1>, 32, 2, WARPS, true, false, MMA_DEF>;
using SymmQ1Cfg =
    StripCfg<StripQ1Planes, StripVecs<2>, 32, 4, WARPS, true, true>;
using SlabHiCfg = StripCfg<StripHiPlanes, StripVecs<2>, 32, 2, WARPS>;
//  * kernel 12-bcast on a zero tile: 16-row stages of the f32 hi plane
//    (32 KB and 4 KB of (hi, lo) operand each), four of them, the f64
//    transpose sums in one round: 177 KB (9-bcast's two 32-row stages, and
//    four 16-row stages reduced in two or four rounds, were 1-2% slower, a
//    single 64-row stage 34%; RectWalk: every tile has a transpose term);
//  * kernel 17-bcast on zero tiles: 32-row stages of the q1 plane, two of
//    them, EARLY, BITS, the transpose sums in one round: 105 KB (15-bcast's
//    four stages 6% slower, as were six in four rounds or a single 64-row
//    stage; four 16-row stages, or two 32-row ones in two or four rounds,
//    1-3%; EARLY off 12% and conversion by instruction 6% slower).
using DualHiCfg = StripCfg<StripHiPlanes, StripVecs<2>, 16, 4, WARPS>;
using SlabQ1Cfg =
    StripCfg<StripQ1Planes, StripVecs<2>, 32, 2, WARPS, true, true>;
//  * kernel 19-bcast on zero tiles: 32-row stages of the q1 plane (32 KB
//    and 4 KB of (hi, lo) operand each), two of them, EARLY, BITS, the
//    transpose sums in one round: 105 KB, 17-bcast's sizes on the
//    rectangle;
//  * probe P5s (split): kernel 18-bf16's sizes, two 32-row stages, and the
//    two-part strip buffer of MmaSmem<MMA_SPLIT> (131 KB): 200 KB;
//  * probes P5h and P5y (RAW): one padded 64-row stage a strip (69 KB),
//    two of them, and for hi the direct warps' operand parts (12 KB):
//    150 KB (hi), 138 KB (hybrid).
using DualQ1Cfg = SlabQ1Cfg;
using SymmSplitCfg =
    StripCfg<StripPlanes<1>, StripVecs<1>, 32, 2, WARPS, true, false,
             MMA_SPLIT>;
using SymmHiCfg = StripCfg<StripPlanes<1>, StripVecs<1>, ROWS, 2, WARPS, true,
                           false, MMA_HI>;
using SymmHybridCfg = StripCfg<StripPlanes<1>, StripVecs<1>, ROWS, 2, WARPS,
                               true, false, MMA_HYBRID>;
//  * probe P4s (sub8): 32-row stages of 32 KB, four of them, EARLY, each
//    summing warp's transpose row kept (SUB = WARPS: no reduction buffer):
//    137 KB.
using SymmSub8Cfg = StripCfg<StripPlanes<1>, StripVecs<1>, 32, 4, WARPS,
                             false, true, NO_MMA, WARPS>;

// Operand entry i of a vector staged as NV arrays `stride` apart: F32Vec's
// and DF64Vec's get.
template <int NV>
__device__ __forceinline__ typename StripVecs<NV>::acc_t vec_value(
    const float* x, int i, int stride) {
  if constexpr (NV == 1)
    return x[i];
  else
    return (double)x[i] + (double)x[stride + i];
}

// Eight consecutive values from shared memory (16-byte aligned) into
// registers, or out of them.
__device__ __forceinline__ void load8(const float* x, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(x)[0];
  const float4 b = reinterpret_cast<const float4*>(x)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* x, const float v[8]) {
  reinterpret_cast<float4*>(x)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(x)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(double* x, const double v[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    reinterpret_cast<double2*>(x)[j] = make_double2(v[2 * j], v[2 * j + 1]);
}

// VEC consecutive values (VEC = 8, or 4 for an f32 plane's columns) into
// registers or out of them.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* x, float v[VEC]) {
  if constexpr (VEC == 8) {
    load8(x, v);
  } else {
    static_assert(VEC == 4, "8 or 4 values");
    const float4 a = *reinterpret_cast<const float4*>(x);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
}

template <int VEC, class T>
__device__ __forceinline__ void store_vec(T* x, const T v[VEC]) {
  if constexpr (VEC == 8) {
    store8(x, v);
  } else {
    static_assert(VEC == 4 && sizeof(T) == 8, "8 values, or 4 f64");
    reinterpret_cast<double2*>(x)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(x)[1] = make_double2(v[2], v[3]);
  }
}

// Eight int16 of one 16-byte vector as eight bf16, each the value rounded
// to nearest even: the exact f32 values made by bits (values8_of_i16x8),
// then rounded, the bf16 of bf16x8_of_i16x8.
__device__ __forceinline__ uint4 bf16x8_by_bits(const int4 x) {
  float v[8];
  values8_of_i16x8<float, true>(x, v);
  unsigned o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = bf16_pair(__float2bfloat16_rn(v[2 * j]),
                     __float2bfloat16_rn(v[2 * j + 1]));
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Eight int16 of one 16-byte vector split exactly into bf16 ah + al, by
// bits: the exact f32 values (values8_of_i16x8), ah each rounded to
// nearest even, al = a - ah in f32, exact and of at most 8 significant bits
// (|al| <= 128), whose bf16 is the top half of its f32. The values of
// bf16x8_split_i16x8, without its conversion instructions.
__device__ __forceinline__ void bf16x8_split_by_bits(const int4 x, uint4& hi,
                                                     uint4& lo) {
  float v[8];
  values8_of_i16x8<float, true>(x, v);
  unsigned h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h[j] = bf16_pair(__float2bfloat16_rn(v[2 * j]),
                     __float2bfloat16_rn(v[2 * j + 1]));
    const float r0 = __fsub_rn(v[2 * j], __uint_as_float(h[j] << 16));
    const float r1 =
        __fsub_rn(v[2 * j + 1], __uint_as_float(h[j] & 0xffff0000u));
    l[j] = __byte_perm(__float_as_uint(r0), __float_as_uint(r1), 0x7632);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// The consumer warps' barrier; the producer warp takes no part.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(WARPS * 32) : "memory");
}

// The ring's barriers: full[s] completes when stage s is filled (the
// producer's arrive and the copies' bytes), empty[s] when its READERS
// consumer warps have released it.
template <class Cfg>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Cfg::READERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer, one thread: block b's strips b, b + gridDim.x, ... of the
// tiles * STRIPS of the walk (tile t at rows t*TB of each plane), each as
// SPS stages of the ring.
template <class Cfg, class Planes, class Vecs, class Walk>
__device__ __forceinline__ void strip_producer(const Planes& A,
                                               const Vecs& V, const Walk& W,
                                               int tiles, unsigned char* smem,
                                               uint64_t* full,
                                               uint64_t* empty) {
  constexpr int NP = Cfg::NP, NV = Cfg::NV, SR = Cfg::SR, S = Cfg::S;
  constexpr int SPS = Cfg::SPS;
  const int strips = tiles * STRIPS;
  const int step = gridDim.x;
  const uint64_t once = evict_first_policy();
  const uint64_t keep = evict_last_policy();
  int g = blockIdx.x;
  int t = g / STRIPS, i, k, ld;
  size_t base;
  float sc[NP];  // an unscaled plane's header carries 1
#pragma unroll
  for (int pl = 0; pl < NP; ++pl) sc[pl] = 1.0f;
  bool first = Planes::SCALED;  // the first tile's scales are read behind
                                // its copies
  W.tile(t, i, k, base, ld);
  for (int pos = 0; g < strips;) {
    const int s = g % STRIPS;
    // the next strip's tile, read before this one waits
    const int gn = g + step;
    int tn = t, in = i, kn = k;
    float scn[NP];
    const bool next_tile = gn < strips && gn / STRIPS != t;
    if (next_tile) {
      tn = gn / STRIPS;
      W.tile(tn, in, kn, base, ld);
      if constexpr (Planes::SCALED) {
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) scn[pl] = __ldg(A.s[pl] + tn);
      }
    }
    const bool off = W.transposed(i, k);
    for (int j = 0; j < SPS; ++j, ++pos) {
      const int slot = pos % S;
      // the first pass over the ring finds every stage free
      mbar_wait(&empty[slot], ((pos / S) & 1) ^ 1);
      unsigned char* stage = smem + slot * Cfg::STAGE_BYTES;
      mbar_expect(&full[slot],
                  NP * Cfg::COPY_BYTES + NV * TB * (int)sizeof(float) +
                      (off ? NV * SR * (int)sizeof(float) : 0));
      const size_t row0 = (size_t)t * TB + s * ROWS + j * SR;
#pragma unroll
      for (int pl = 0; pl < NP; ++pl) {
        if constexpr (Cfg::RAW)
          // one copy a row, into a row padded to ROW_LD: ldmatrix's eight
          // rows of a fragment then fall in eight bank groups
          for (int r = 0; r < SR; ++r)
            bulk_copy(stage + r * Cfg::ROW_LD * (int)sizeof(short),
                      A.q[pl] + (row0 + r) * TB, TB * (int)sizeof(short),
                      &full[slot], once);
        else if constexpr (Planes::TILES)
          // a broadcast tile is read at every tile: kept in L2, not
          // streamed
          bulk_copy(stage + pl * Cfg::PLANE_BYTES,
                    A.q[pl] + ((row0 * TB) & A.mask[pl]), Cfg::PLANE_BYTES,
                    &full[slot], A.mask[pl] == FULL_MASK ? once : keep);
        else
          bulk_copy(stage + pl * Cfg::PLANE_BYTES, A.q[pl] + row0 * TB,
                    Cfg::PLANE_BYTES, &full[slot], once);
      }
#pragma unroll
      for (int v = 0; v < NV; ++v)
        bulk_copy(stage + Cfg::PK_OFF + v * TB * (int)sizeof(float),
                  V.d[v] + (size_t)k * TB, TB * (int)sizeof(float),
                  &full[slot], keep);
      if (off) {
#pragma unroll
        for (int v = 0; v < NV; ++v)
          bulk_copy(stage + Cfg::PI_OFF + v * SR * (int)sizeof(float),
                    V.t[v] + (size_t)i * TB + s * ROWS + j * SR,
                    SR * (int)sizeof(float), &full[slot], keep);
      }
      if constexpr (Planes::SCALED) {
        if (first) {
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) sc[pl] = __ldg(A.s[pl] + t);
          first = false;
        }
      }
      StripHeader<NP>* hdr =
          reinterpret_cast<StripHeader<NP>*>(stage + Cfg::HDR_OFF);
#pragma unroll
      for (int pl = 0; pl < NP; ++pl) hdr->sc[pl] = sc[pl];
      hdr->offdiag = off;
      // the arrive releases the header to the consumers' wait
      mbar_arrive(&full[slot]);
    }
    g = gn;
    if (next_tile) {
      t = tn; i = in; k = kn;
      if constexpr (Planes::SCALED) {
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) sc[pl] = scn[pl];
      }
    }
  }
}

// The summing consumers: warp w sums the strip's rows w*8 .. w*8+7 on the
// CUDA cores.
template <class Cfg>
__device__ __forceinline__ void strip_sum_consumers(
    int tiles, unsigned char* smem, uint64_t* full, uint64_t* empty,
    typename Cfg::acc_t* __restrict__ part_d,
    typename Cfg::acc_t* __restrict__ part_t) {
  using acc_t = typename Cfg::acc_t;
  using Planes = typename Cfg::planes_t;
  constexpr int NP = Cfg::NP, NV = Cfg::NV, SR = Cfg::SR, S = Cfg::S;
  constexpr int RW = Cfg::RW, SPS = Cfg::SPS, WPS = Cfg::WPS;
  constexpr int VEC = Cfg::VEC;
  constexpr int ELEM = (int)sizeof(typename Planes::elem_t);
  constexpr int COLS_PER_LANE = cols_per_lane_of<TB>;  // 16
  constexpr int GROUPS = COLS_PER_LANE / VEC;  // 16-byte vectors a row
  constexpr int COLS_PER_THREAD = TB / (WARPS * 32);   // of the reduction
  acc_t* red = reinterpret_cast<acc_t*>(smem + S * Cfg::STAGE_BYTES);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int strips = tiles * STRIPS;
  const int step = gridDim.x;

  // the consumers: warp w sums the strip's rows w*8 .. w*8+7, which are
  // rows wr .. wr+7 of stage `j` of the strip
  const int j = warp / WPS;
  const int wr = (warp % WPS) * ROWS_PER_WARP;
  for (int g = blockIdx.x, pos = j; g < strips; g += step, pos += SPS) {
    const int t = g / STRIPS;
    const int s = g % STRIPS;
    // pass 2 may be scheduled once every block is on its last strip; it
    // waits for this grid's end before it reads a partial
    if (g + step >= strips)
      asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    const int slot = pos % S;
    mbar_wait(&full[slot], (pos / S) & 1);
    const unsigned char* stage = smem + slot * Cfg::STAGE_BYTES;
    const StripHeader<NP> hdr =
        *reinterpret_cast<const StripHeader<NP>*>(stage + Cfg::HDR_OFF);
    acc_t c[NP];
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) c[pl] = hdr.sc[pl];
    // Q16Plane::p_scale (the scale folded into p and q), FQPlane's and
    // DF64TilePlane's 1
    const acc_t sc = Planes::FOLD ? c[0] : acc_t(1);
    const bool off = hdr.offdiag != 0;  // uniform across the block

    acc_t pk[COLS_PER_LANE];
    acc_t tacc[COLS_PER_LANE];
    const float* pks = reinterpret_cast<const float*>(stage + Cfg::PK_OFF);
#pragma unroll
    for (int h = 0; h < GROUPS; ++h) {  // columns lane_col<VEC>(lane, VEC h ..)
      float x[NV][VEC];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        load_vec<VEC>(pks + v * TB + h * 32 * VEC + lane * VEC, x[v]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if constexpr (NV == 1)
          pk[VEC * h + e] = x[0][e] * sc;
        else
          pk[VEC * h + e] = ((double)x[0][e] + (double)x[1][e]) * sc;
      }
    }
#pragma unroll
    for (int qq = 0; qq < COLS_PER_LANE; ++qq) tacc[qq] = acc_t(0);

    const unsigned char* rows = stage + wr * TB * ELEM;
    const float* pis = reinterpret_cast<const float*>(stage + Cfg::PI_OFF);
    constexpr int KEEP = Cfg::EARLY ? ROWS_PER_WARP : 1;
    int4 raw[KEEP][2];  // EARLY: the warp's rows, then the release
    acc_t pir[KEEP];
    if constexpr (Cfg::EARLY) {
#pragma unroll
      for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          raw[rr][h] = *reinterpret_cast<const int4*>(
              rows + (rr * TB + h * 256 + lane * 8) * (int)sizeof(short));
        pir[rr] = vec_value<NV>(pis, wr + rr, SR) * sc;
      }
      __syncwarp();  // every lane's reads of the stage before the release
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    constexpr int UNROLL = Cfg::EARLY ? ROWS_PER_WARP : 2;
#pragma unroll UNROLL
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;  // row of the strip
      // a row's 16-byte vectors one at a time, each into both sums: the
      // same terms in the same order as a whole row's values first (d
      // over q = 0 .. 15, tacc[q] over the rows), with half the values
      // live (faster on every strip walk, none spilling)
      const acc_t pi =
          Cfg::EARLY ? pir[rr] : vec_value<NV>(pis, wr + rr, SR) * sc;
      acc_t d = acc_t(0);
#pragma unroll
      for (int h = 0; h < GROUPS; ++h) {
        acc_t a[VEC];
        if constexpr (Cfg::EARLY)
          Planes::template values_of<Cfg::BITS>(raw[rr][h], c, a);
        else
          Planes::template values<Cfg::BITS>(
              rows + (rr * TB + h * 32 * VEC + lane * VEC) * ELEM,
              Cfg::PLANE_BYTES, c, a);
#pragma unroll
        for (int qq = 0; qq < VEC; ++qq) d += a[qq] * pk[VEC * h + qq];
        if (off) {
#pragma unroll
          for (int qq = 0; qq < VEC; ++qq) tacc[VEC * h + qq] += a[qq] * pi;
        }
      }
      d = warp_sum(d);
      if (lane == 0) part_d[(size_t)t * TB + s * ROWS + r] = d;
    }
    if constexpr (!Cfg::EARLY) {
      __syncwarp();  // every lane's reads of the stage before the release
      if (lane == 0) mbar_arrive(&empty[slot]);
    }

    if constexpr (Cfg::SUB == WARPS) {
      // each warp's own transpose row, at symm_pass1<..., SUB = WARPS>'s
      // place and columns: no shared-memory pass and no barrier, so the
      // warp goes on to its next strip at once
      if (off) {
        acc_t* out =
            part_t + (((size_t)t * STRIPS + s) * WARPS + warp) * TB;
#pragma unroll
        for (int h = 0; h < GROUPS; ++h)
          store_vec<VEC>(out + h * 32 * VEC + lane * VEC, tacc + VEC * h);
      }
    } else if (off) {
      // rounds of RW warps' rows, each column's sum carried on in order
      acc_t sum[COLS_PER_THREAD] = {};
#pragma unroll
      for (int round = 0; round < WARPS / RW; ++round) {
        if (warp / RW == round) {
#pragma unroll
          for (int h = 0; h < GROUPS; ++h)
            store_vec<VEC>(red + (warp % RW) * TB + h * 32 * VEC + lane * VEC,
                           tacc + VEC * h);
        }
        consumers_sync();
#pragma unroll
        for (int u = 0; u < COLS_PER_THREAD; ++u) {
          const int col = threadIdx.x + u * WARPS * 32;
#pragma unroll
          for (int w = 0; w < RW; ++w) {
            const acc_t x = red[w * TB + col];
            sum[u] = round == 0 && w == 0 ? x : sum[u] + x;
          }
        }
        consumers_sync();  // every read of red before its next writes
      }
      acc_t* out = part_t + ((size_t)t * STRIPS + s) * TB;
#pragma unroll
      for (int u = 0; u < COLS_PER_THREAD; ++u)
        out[threadIdx.x + u * WARPS * 32] = sum[u];
    }
  }
}

// Block b walks strips b, b + gridDim.x, ... of the tiles * STRIPS of the
// walk (tile t at rows t*TB of each plane): the last warp's first thread
// fills the ring, the WARPS warps before it sum.
template <class Cfg, class Planes, class Vecs, class Walk>
__global__ void __launch_bounds__(STRIP_THREADS, 1)
strip_pass1(Planes A, Vecs V, Walk W, int tiles,
            typename Cfg::acc_t* __restrict__ part_d,
            typename Cfg::acc_t* __restrict__ part_t) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[Cfg::S], empty[Cfg::S];
  ring_init<Cfg>(full, empty);
  if (threadIdx.x / 32 == WARPS) {
    if (threadIdx.x % 32 == 0)
      strip_producer<Cfg>(A, V, W, tiles, smem, full, empty);
    return;
  }
  strip_sum_consumers<Cfg>(tiles, smem, full, empty, part_d, part_t);
}

// The two int16 of a 32-bit word as exact f32 by bits (values8_of_i16x8's
// expressions): v0 from the lower half, v1 from the upper.
__device__ __forceinline__ void pair_by_bits(unsigned w, float& v0,
                                             float& v1) {
  const unsigned u = w ^ 0x80008000u;
  v0 = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5410)) - 8421376.0f;
  v1 = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5432)) - 8421376.0f;
}

// Four raw int16 fragment registers (ldmatrix of the padded stage rows)
// split by bits into the A parts a[0] = ah and a[1] = al, each element in
// its own position: the fragments ldmatrix gives of q16_bf16_pass1's two
// bf16 buffers. bf16x8_split_by_bits' values (the exact f32 by bits, ah
// rounded to nearest even, al = a - ah exact and its f32's top half), with
// each pair rounded by one packed conversion (cvt.rn.bf16x2.f32).
__device__ __forceinline__ void split_fragment(const unsigned r[4],
                                               unsigned a[2][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v0, v1;
    pair_by_bits(r[e], v0, v1);
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);  // v0 low
    const unsigned hb = *reinterpret_cast<const unsigned*>(&h);
    const float r0 = __fsub_rn(v0, __uint_as_float(hb << 16));
    const float r1 = __fsub_rn(v1, __uint_as_float(hb & 0xffff0000u));
    a[0][e] = hb;
    a[1][e] = __byte_perm(__float_as_uint(r0), __float_as_uint(r1), 0x7632);
  }
}

// The B fragment of one 16-deep k-chunk from the f32 operand x[0 .. 16)
// (shared memory): lanes with g = lane / 4 == 0 hold the P bf16 parts of
// x[2c .. 2c+1] and x[2c+8 .. 2c+9] (c = lane % 4), as mma_strip loads them
// from q16_bf16_pass1's parts; every other lane zeros.
template <int P>
__device__ __forceinline__ void operand_fragment(const float* x, float sc,
                                                 int lane, unsigned b[][2]) {
  const int c4 = lane % 4;
  __nv_bfloat16 v[4][3];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    bf16_parts<P>(__fmul_rn(x[2 * c4 + (e & 1) + (e >> 1) * 8], sc), v[e], 1);
#pragma unroll
  for (int ip = 0; ip < P; ++ip) {
    b[ip][0] = lane < 4 ? bf16_pair(v[0][ip], v[1][ip]) : 0u;
    b[ip][1] = lane < 4 ? bf16_pair(v[2][ip], v[3][ip]) : 0u;
  }
}

// The tensor-core consumers of a RAW configuration (engines hi, hybrid):
// q16_bf16_pass1's products straight from the raw int16 strip,
// one stage a strip. Warp w < 4 takes the direct term of the strip's rows
// 16w .. 16w+15: for hi, each 16-deep k-chunk's A fragment by
// ldmatrix (the next one asked for before this one's products), split by
// bits, against its own copy of the direct operand's bf16 parts
// (bf16_parts of p_k * s, written once a strip), the products of
// mma_parts in mma_strip's order; for hybrid, mma_strip's f32 FMAs on each
// value by bits (exactly ah + al) against p_k * s. Warps 4-7 take the
// transpose term of columns 128 (w - 4) .. +128, in two halves of four
// 16-column blocks: each block its own accumulator chain over the strip's
// four 16-row chunks in mma_strip's order (the chains are independent, so
// the four interleave), the A fragments by ldmatrix .trans, the operand
// parts of q_i * s made in registers. Each warp releases the stage when it
// has read it; no barrier joins the warps.
template <class Cfg>
__device__ __forceinline__ void strip_raw_consumers(
    int tiles, unsigned char* smem, uint64_t* full, uint64_t* empty,
    float* __restrict__ part_d, float* __restrict__ part_t) {
  constexpr int MODE = Cfg::MODE, S = Cfg::S, LD = Cfg::ROW_LD;
  using M = MmaSmem<MODE>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int lr = lane % 8, lq = lane / 8;  // ldmatrix's row and matrix
  const int strips = tiles * STRIPS;
  const int step = gridDim.x;
  for (int gs = blockIdx.x, pos = 0; gs < strips; gs += step, ++pos) {
    const int t = gs / STRIPS;
    const int s = gs % STRIPS;
    // pass 2 may be scheduled once every block is on its last strip
    if (gs + step >= strips)
      asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    const int slot = pos % S;
    mbar_wait(&full[slot], (pos / S) & 1);
    const unsigned char* stage = smem + slot * Cfg::STAGE_BYTES;
    const StripHeader<1> hdr =
        *reinterpret_cast<const StripHeader<1>*>(stage + Cfg::HDR_OFF);
    const float sc = hdr.sc[0];
    const short* raw = reinterpret_cast<const short*>(stage);
    if (warp < WARPS / 2) {
      const float* pks = reinterpret_cast<const float*>(stage + Cfg::PK_OFF);
      const short* rows = raw + 16 * warp * LD;
      float* out = part_d + (size_t)t * TB + s * ROWS + 16 * warp;
      if constexpr (MODE == MMA_HYBRID) {
        // mma_strip's direct term on the CUDA cores: lane l holds the
        // column pairs 64 jj + 2 l (+1), d over jj, then e, as there
        float pkf[TB / 32];
#pragma unroll
        for (int jj = 0; jj < TB / 64; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            pkf[2 * jj + e] = __fmul_rn(pks[64 * jj + e + 2 * lane], sc);
#pragma unroll 4
        for (int rr = 0; rr < 16; ++rr) {
          const unsigned* row =
              reinterpret_cast<const unsigned*>(rows + rr * LD) + lane;
          float d = 0.0f;
#pragma unroll
          for (int jj = 0; jj < TB / 64; ++jj) {
            float a0, a1;
            pair_by_bits(row[32 * jj], a0, a1);
            d = fmaf(a0, pkf[2 * jj], d);
            d = fmaf(a1, pkf[2 * jj + 1], d);
          }
          d = warp_sum(d);
          if (lane == 0) out[rr] = d;
        }
      } else {
        __nv_bfloat16* pkw =
            reinterpret_cast<__nv_bfloat16*>(smem + S * Cfg::STAGE_BYTES) +
            warp * M::PK * TB;
        for (int c = lane; c < TB; c += 32)
          bf16_parts<M::PK>(__fmul_rn(pks[c], sc), pkw + c, TB);
        __syncwarp();  // the parts before any lane reads them
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float dc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        // matrices (rows 0-7 | 8-15) x (columns kc | kc + 8)
        const __nv_bfloat16* frag = reinterpret_cast<const __nv_bfloat16*>(
            rows + (lr + (lq & 1) * 8) * LD + (lq >> 1) * 8);
        unsigned r[4];
        ldsm_x4<false>(r, frag);
#pragma unroll 4
        for (int kc = 0; kc < TB; kc += 16) {
          unsigned a[2][4], b[M::P][2];
          split_fragment(r, a);
          if (kc + 16 < TB) ldsm_x4<false>(r, frag + kc + 16);
#pragma unroll
          for (int ip = 0; ip < M::P; ++ip) {
            const __nv_bfloat16* pp = pkw + ip * TB + kc + 2 * c4;
            b[ip][0] = g == 0 ? ld_bf16x2(pp) : 0u;
            b[ip][1] = g == 0 ? ld_bf16x2(pp + 8) : 0u;
          }
          mma_parts<MODE>(d, dc, a, b);
        }
        if (c4 == 0) {
          out[g] = __fadd_rn(d[0], dc[0]);
          out[g + 8] = __fadd_rn(d[2], dc[2]);
        }
      }
    } else if (hdr.offdiag) {  // uniform across the block
      constexpr int CB = TB / (WARPS / 2) / 16 / 2;  // 16-column blocks a half
      const float* pis = reinterpret_cast<const float*>(stage + Cfg::PI_OFF);
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        const int c0 = (warp - WARPS / 2) * 2 * CB * 16 + h * CB * 16;
        float d[CB][4], dc[CB][4];
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[cb][e] = dc[cb][e] = 0.0f;
#pragma unroll
        for (int kr = 0; kr < ROWS / 16; ++kr) {
          unsigned b[M::P][2];
          operand_fragment<M::P>(pis + 16 * kr, sc, lane, b);
          // A^T(m, j) = strip(16 kr + j, c0 + 16 cb + m): matrices (rows
          // 0-7 | 8-15) x (columns | + 8), transposed; each block's
          // fragment asked for before the products of the one before
          const __nv_bfloat16* frag = reinterpret_cast<const __nv_bfloat16*>(
              raw + (16 * kr + lr + (lq >> 1) * 8) * LD + c0 + (lq & 1) * 8);
          unsigned r[4];
          ldsm_x4<true>(r, frag);
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) {
            unsigned a[2][4];
            split_fragment(r, a);
            if (cb + 1 < CB) ldsm_x4<true>(r, frag + 16 * (cb + 1));
            mma_parts<MODE>(d[cb], dc[cb], a, b);
          }
        }
        if (c4 == 0) {
          float* out = part_t + ((size_t)t * STRIPS + s) * TB + c0;
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) {
            out[16 * cb + g] = __fadd_rn(d[cb][0], dc[cb][0]);
            out[16 * cb + g + 8] = __fadd_rn(d[cb][2], dc[cb][2]);
          }
        }
      }
    }
    __syncwarp();  // every lane's reads of the stage before the release
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
}

// strip_pass1 with the tensor-core consumers (Cfg::MMA) of the engine
// Cfg::MODE: for each strip, every consumer warp waits for each of its
// stages, converts its share of the stage's int16 rows to bf16 (by bits:
// MMA_DEF rounds to nearest even, the bf16 of q16_bf16_pass1; MMA_SPLIT
// splits each value exactly into ah + al, the parts of
// bf16x8_split_i16x8) into the strip's bf16 buffer, and with its first
// stage the direct operand p_k * s and with each the transpose operand
// q_i * s (__fmul_rn, then bf16), releases the stage, and then the warps
// run q16_bf16_pass1<MODE>'s products on the buffer (mma_strip, its
// fragments taken with ldmatrix): the same operands in the same fragments
// and the same k-chunk order, so the same bits. The buffer is read by
// every warp and rewritten for the next strip: a barrier of the consumers
// after the conversion and one after the products.
template <class Cfg, class Planes, class Vecs, class Walk>
__global__ void __launch_bounds__(STRIP_THREADS, 1)
strip_mma_pass1(Planes A, Vecs V, Walk W, int tiles,
                float* __restrict__ part_d, float* __restrict__ part_t) {
  static_assert(Cfg::MMA, "the tensor-core consumers");
  using M = MmaSmem<Cfg::MODE>;
  constexpr int SR = Cfg::SR, S = Cfg::S, SPS = Cfg::SPS;
  constexpr int VECS = SR * TB / 8 / THREADS;  // 16-byte vectors a thread
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  ring_init<Cfg>(full, empty);
  if (threadIdx.x / 32 == WARPS) {
    if (threadIdx.x % 32 == 0)
      strip_producer<Cfg>(A, V, W, tiles, smem, full, empty);
    return;
  }

  if constexpr (Cfg::RAW) {
    strip_raw_consumers<Cfg>(tiles, smem, full, empty, part_d, part_t);
    return;
  }
  __nv_bfloat16* strip =
      reinterpret_cast<__nv_bfloat16*>(smem + S * Cfg::STAGE_BYTES);
  __nv_bfloat16* pk = strip + M::A * ROWS * BF_LD;
  __nv_bfloat16* pi = pk + M::PK * TB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int strips = tiles * STRIPS;
  const int step = gridDim.x;
  for (int g = blockIdx.x, pos = 0; g < strips; g += step) {
    const int t = g / STRIPS;
    const int s = g % STRIPS;
    // pass 2 may be scheduled once every block is on its last strip
    if (g + step >= strips)
      asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    bool off = false;
    for (int j = 0; j < SPS; ++j, ++pos) {
      const int slot = pos % S;
      mbar_wait(&full[slot], (pos / S) & 1);
      const unsigned char* stage = smem + slot * Cfg::STAGE_BYTES;
      const StripHeader<1> hdr =
          *reinterpret_cast<const StripHeader<1>*>(stage + Cfg::HDR_OFF);
      const float sc = hdr.sc[0];
      off = hdr.offdiag != 0;  // uniform across the block
      const int4* raw = reinterpret_cast<const int4*>(stage);
#pragma unroll
      for (int u = 0; u < VECS; ++u) {
        const int v = threadIdx.x + u * THREADS;
        const int at = (j * SR + v / (TB / 8)) * BF_LD + (v % (TB / 8)) * 8;
        if constexpr (M::A == 1)
          *reinterpret_cast<uint4*>(strip + at) = bf16x8_by_bits(raw[v]);
        else
          bf16x8_split_by_bits(
              raw[v], *reinterpret_cast<uint4*>(strip + at),
              *reinterpret_cast<uint4*>(strip + ROWS * BF_LD + at));
      }
      if (j == 0) {
        const float* pks =
            reinterpret_cast<const float*>(stage + Cfg::PK_OFF);
        for (int c = threadIdx.x; c < TB; c += THREADS)
          pk[c] = __float2bfloat16_rn(__fmul_rn(pks[c], sc));
      }
      if (off && threadIdx.x < SR) {
        const float* pis =
            reinterpret_cast<const float*>(stage + Cfg::PI_OFF);
        pi[j * SR + threadIdx.x] =
            __float2bfloat16_rn(__fmul_rn(pis[threadIdx.x], sc));
      }
      __syncwarp();  // every lane's reads of the stage before the release
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    consumers_sync();  // the buffer complete
    mma_strip<Cfg::MODE, true>(strip, pk, pi, nullptr, off, warp, lane,
                               part_d + (size_t)t * TB + s * ROWS,
                               part_t + ((size_t)t * STRIPS + s) * TB);
    consumers_sync();  // every read of the buffer before the next strip's
  }
}

// Pass 1 on the strip walk over `tiles` tiles of W, configured by Cfg:
// refuses operands the bulk copies cannot take (16-byte alignment).
template <class Cfg, class Planes, class Vecs, class Walk>
int launch_strip_pass1(Planes A, Vecs V, Walk W, int tiles,
                       typename Cfg::acc_t* part_d,
                       typename Cfg::acc_t* part_t, cudaStream_t stream) {
  if (tiles <= 0) return (int)cudaErrorInvalidValue;
  for (int pl = 0; pl < Planes::NP; ++pl)
    if (reinterpret_cast<uintptr_t>(A.q[pl]) % 16)
      return (int)cudaErrorInvalidValue;
  for (int v = 0; v < Vecs::NV; ++v)
    if (reinterpret_cast<uintptr_t>(V.d[v]) % 16 ||
        reinterpret_cast<uintptr_t>(V.t[v]) % 16)
      return (int)cudaErrorInvalidValue;
  static bool sized[MAX_DEVICES];  // shared memory above 48 KB allowed
  auto kernel = [] {
    if constexpr (Cfg::MMA)
      return strip_mma_pass1<Cfg, Planes, Vecs, Walk>;
    else
      return strip_pass1<Cfg, Planes, Vecs, Walk>;
  }();
  int dev, sms;
  const int e = device_and_sms(kernel, Cfg::SMEM, sized, &dev, &sms);
  if (e != (int)cudaSuccess) return e;
  const int strips = tiles * STRIPS;
  kernel<<<sms < strips ? sms : strips, STRIP_THREADS, Cfg::SMEM, stream>>>(
      A, V, W, tiles, part_d, part_t);
  return (int)cudaGetLastError();
}

// A pass 2 of THREADS-thread blocks as a programmatic dependent of what the
// stream ran last: it may be scheduled before that ends, and waits for it
// (griddepcontrol.wait) before it reads.
template <class... Params, class... Args>
int launch_dependent(void (*kernel)(Params...), int blocks,
                     cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Kernels 16, 9-bcast and 17-bcast (zero tiles) on the strip walk: pass 1
// over the T packed tiles of the rank's walk (W.packed), then slab_pass2
// over the lists L.
template <class Cfg, class Planes, class Vecs, class Out>
int launch_strip_slab(Planes A, Vecs V, TableWalk W, SlabLists L, Out YD,
                      Out YT, typename Cfg::acc_t* part_d,
                      typename Cfg::acc_t* part_t, int T, int ms,
                      cudaStream_t stream) {
  using acc_t = typename Cfg::acc_t;
  if (T <= 0 || ms <= 0 || ms % TB || W.n <= 0 || W.n % TB || !W.packed)
    return (int)cudaErrorInvalidValue;
  const int e = launch_strip_pass1<Cfg>(A, V, W, T, part_d, part_t, stream);
  if (e != (int)cudaSuccess) return e;
  return launch_dependent(slab_pass2<acc_t, Out, true>, (ms + W.n) / P2_COLS,
                          stream, (const acc_t*)part_d, (const acc_t*)part_t,
                          L.d_ptr, L.d_ids, L.t_ptr, L.t_ids, ms, YD, YT);
}

// Kernel 15-bcast (zero tiles) and probes P4s, P5s, P5h and P5y on the
// strip walk: pass 1 over the T = nblk(nblk+1)/2 tiles of the packed
// triangle, then symm_pass2 over the Cfg's SUB transpose rows a strip.
template <class Cfg, class Planes, class Vecs, class Out>
int launch_strip_tri(Planes A, Vecs V, Out Y, typename Cfg::acc_t* part_d,
                     typename Cfg::acc_t* part_t, int nblk,
                     cudaStream_t stream) {
  using acc_t = typename Cfg::acc_t;
  if (nblk <= 0) return (int)cudaErrorInvalidValue;
  const int e = launch_strip_pass1<Cfg>(A, V, TriangleWalk<>{},
                                        nblk * (nblk + 1) / 2, part_d,
                                        part_t, stream);
  if (e != (int)cudaSuccess) return e;
  // P4s's 64 rows a tile: each of row tile 0's threads sums ~150 of them,
  // asked for 8 at a time (one at a time took 40% longer)
  constexpr int AHEAD = Cfg::SUB == 1 ? 1 : 8;
  return launch_dependent(
      symm_pass2<TB, STRIPS * Cfg::SUB, acc_t, Out, true, AHEAD>,
      nblk * TB / P2_COLS, stream, (const acc_t*)part_d, (const acc_t*)part_t,
      nblk, Y);
}

// Kernels 18, 19, 12-bcast and 19-bcast (zero tiles) on the strip walk:
// pass 1 over the mb x cb tiles of the rectangle, then rect_pass2.
template <class Cfg, class Planes, class Vecs, class Out>
int launch_strip_dual(Planes A, Vecs V, Out YD, Out YT,
                      typename Cfg::acc_t* part_d,
                      typename Cfg::acc_t* part_t, int mb, int cb,
                      cudaStream_t stream) {
  using acc_t = typename Cfg::acc_t;
  if (mb <= 0 || cb <= 0) return (int)cudaErrorInvalidValue;
  const int e = launch_strip_pass1<Cfg>(A, V, RectWalk{cb}, mb * cb, part_d,
                                        part_t, stream);
  if (e != (int)cudaSuccess) return e;
  return launch_dependent(rect_pass2<acc_t, Out, true>,
                          (mb + cb) * TB / P2_COLS, stream,
                          (const acc_t*)part_d, (const acc_t*)part_t, mb, cb,
                          YD, YT);
}

}  // namespace
