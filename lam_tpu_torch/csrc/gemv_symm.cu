// Symmetric matvec over walk-order packed lower-triangle tiles, for Hopper
// (sm_90a), and the dual matvec over a dense rectangle of the same tiles.
// Thirty-one kernels share one design:
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
//   lam_gemv_f32_symm_square   gemv_f32_symm(packed=False) (:455): the
//                              walk over the full square, in place
//   lam_gemv_df64_symm_square  gemv_df64_symm(packed=False) (:1008)
//   lam_gemv_df64_symm_bcast   gemv_df64_symm's broadcast lo tile
//                              (_lo_plane_map :991)
//   lam_gemv_fq_symm_bcast     gemv_fq_symm's broadcast q2/q3 tiles
//                              (:2182-2199)
//   lam_gemv_fq_symm_zero      the same, q2/q3 zero tiles (generate
//                              mode's, lam_tpu's "exact-zero residual
//                              planes" :2183-2185): q1 alone on the strip
//                              walk
//   lam_gemv_f32_symm_slab  replaces lam_tpu/ops/gemv.py:gemv_f32_symm_slab
//                            (:552; _gemv_f32_symm_slab_kernel)
//   lam_gemv_df64_symm_slab  replaces lam_tpu/ops/gemv.py:gemv_df64_symm_slab
//                            (:1267; _gemv_df64_symm_slab_kernel)
//   lam_gemv_q16_symm_slab   replaces lam_tpu/ops/gemv.py:gemv_q16_symm_slab
//                            (:2310; _gemv_q16_symm_slab_kernel); pass 1
//                            on the strip walk (below)
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
//                       (:2544; _gemv_q16_dual_kernel, its 'vpu' form);
//                       pass 1 on the strip walk
//   lam_gemv_fq_dual    replaces lam_tpu/ops/gemv.py:gemv_fq_dual
//                       (:2624; _gemv_fq_dual_kernel); pass 1 on the strip
//                       walk
//   lam_gemv_df64_symm_slab_bcast  gemv_df64_symm_slab's broadcast lo tile
//                                  (_lo_plane_map :991, used at :1307)
//   lam_gemv_df64_symm_slab_zero   the same, lo a zero tile (generate
//                                  mode's): hi alone on the strip walk
//   lam_gemv_fq_symm_slab_bcast    gemv_fq_symm_slab's broadcast q2/q3
//                                  tiles (:2420-2427, :2434-2437)
//   lam_gemv_fq_symm_slab_zero     the same, q2/q3 zero tiles (generate
//                                  mode's): q1 alone on the strip walk
//   lam_gemv_df64_dual_bcast       gemv_df64_dual's broadcast lo tile
//                                  (:1695-1696)
//   lam_gemv_df64_dual_zero        the same, lo a zero tile (generate
//                                  mode's): hi alone on the strip walk
//   lam_gemv_fq_dual_bcast         gemv_fq_dual's broadcast q2/q3 tiles
//                                  (:2637-2644); the strip walk
//   lam_gemv_fq_dual_zero          the same, q2/q3 zero tiles (generate
//                                  mode's): q1 alone on the strip walk
//
// with the controls of the strip walk, kept for the bit check and the
// in-turn timing on the same bytes (on no solver's path): each is its
// kernel on the two-pass walk below
//
//   lam_gemv_q16_symm_slab_twopass  lam_gemv_q16_symm_slab
//   lam_gemv_q16_dual_twopass       lam_gemv_q16_dual
//   lam_gemv_fq_dual_twopass        lam_gemv_fq_dual
//   lam_gemv_q16_dual_bf16_twopass  lam_gemv_q16_dual_bf16
//   lam_gemv_fq_symm_bcast          lam_gemv_fq_symm_zero
//   lam_gemv_df64_symm_slab_bcast   lam_gemv_df64_symm_slab_zero
//   lam_gemv_df64_dual_bcast        lam_gemv_df64_dual_zero
//   lam_gemv_fq_symm_slab_bcast     lam_gemv_fq_symm_slab_zero
//   lam_gemv_fq_dual_bcast          lam_gemv_fq_dual_zero
//
// (the last five are kernels too: the walks of a tile that is not zero)
//
// and the bf16 product engine of the three q16 kernels (lam_tpu's
// LAM_Q16_IMPL "mxu" bodies, chosen by ops/gemv.py `_q16_impl`):
//
//   lam_gemv_q16_symm_bf16       _gemv_q16_symm_multi_kernel, impl="mxu"
//                                (:1955-1976, via _gemv_q16_symm_blocked)
//   lam_gemv_q16_symm_slab_bf16  _gemv_q16_symm_slab_kernel, impl="mxu"
//                                (:2266-2303)
//   lam_gemv_q16_dual_bf16       _gemv_q16_dual_kernel, impl="mxu"
//                                (:2502-2537); pass 1 on the strip walk
//                                with tensor-core consumers
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
//    closed-form triangle index for the whole-triangle kernels (over the
//    packed buffer, or over the full square in place for the square
//    walk), the tables for the slab kernels, the row-major rectangle index
//    for the dual kernels; it also says whether the tile has a transpose
//    term (k < i in a triangle, always in a rectangle). Pass 1 is the same
//    code for all of them, with one operand vector for the direct terms
//    and one for the transpose terms (the same vector in a symmetric
//    walk).
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
//  * Kernels 16 (the q16 band-pair walk, a rank's 55 MB plane at G=2), 18
//    (q16) and 19 (fq) (the dual walks of a (2560, 5120) half-slab, 400
//    strips) are the ones whose pass 1 paid most for one block a strip:
//    around each 64 KB strip of a plane, dependent table and scale reads,
//    the loads of the operands, a block-wide barrier, and a partly-filled
//    last wave. Their pass 1 is the strip walk of csrc/strip_walk.cuh: a
//    persistent grid, one producer warp streaming strips (16-row stages of
//    them for fq's three planes) and their slices of the operands into a
//    shared-memory ring with TMA bulk copies, the table and scale reads
//    done by the producer ahead of the consumers, the transpose reduction
//    on a barrier of the consumer warps only, and pass 2 (slab_pass2,
//    rect_pass2) launched as a programmatic dependent. Inside a strip it
//    sums in symm_pass1's order and writes the same partials, so its bits
//    are the two-pass walk's (the controls lam_gemv_*_twopass).
//  * The broadcast modes of kernels 15, 9, 12, 17 and 19 on zero tiles (generate
//    mode's only tiles, known zero when the operator is built) run the
//    strip walk over the one plane that is not zero, q1 or hi: the
//    tile-reading walks spent an int -> f64 conversion a value (three for
//    fq), read the tile from L2 as often as they streamed the plane, and
//    paid the two-pass walk's fixed costs. The dropped zero terms never
//    change a sum's bits (csrc/strip_walk.cuh), so they give the
//    full-plane kernels' bits over zero planes.
//  * Kernel 18-bf16 (the bf16 engine of kernel 18) runs the same walk with
//    tensor-core consumers (strip_mma_pass1): each stage is converted to
//    bf16 into q16_bf16_pass1's padded strip layout, released, and
//    multiplied with q16_bf16_pass1's mma.sync chains, its fragments taken
//    with ldmatrix; the same products in the same order, so the bits of
//    q16_bf16_pass1 and rect_pass2 (lam_gemv_q16_dual_bf16_twopass).
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
//
// The code of this design is csrc/symm_walk.cuh (and csrc/strip_walk.cuh,
// pass 1 of kernels 16, 18, 18-bf16, 19 and the zero-tile walks of 15-bcast,
// 9-bcast, 12-bcast and 17-bcast); csrc/q16_probe.cu instantiates
// symm_walk.cuh for the q16 probes too (the triangle walk at tb=1024, with
// unreduced transpose partials, and three more tensor-core modes).

#include "strip_walk.cuh"

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

// The other storage modes of kernels 1, 2 and 15 (lam_tpu's packed=False
// and the broadcast tiles of generate mode), each its own entry point with
// the packed kernel's arguments, scratch and order of sums.
//
// Square walk: a (and a_hi, a_lo) is the row-major (n, n) square, n =
// nblk*TB; only its lower-triangle tiles are read, in place. Gives the
// packed kernel's bits on pack_tri_host of the same square.
extern "C" int lam_gemv_f32_symm_square(const float* a, const float* p,
                                        float* y, float* part_d,
                                        float* part_t, int nblk,
                                        void* stream) {
  return launch(F32Plane{a}, F32Vec{p}, F32Out{y}, part_d, part_t, nblk,
                (cudaStream_t)stream, SquareWalk<>{nblk * TB});
}

extern "C" int lam_gemv_df64_symm_square(const float* a_hi, const float* a_lo,
                                         const float* p_hi, const float* p_lo,
                                         float* y_hi, float* y_lo,
                                         double* part_d, double* part_t,
                                         int nblk, void* stream) {
  return launch(DF64Plane{a_hi, a_lo}, DF64Vec{p_hi, p_lo},
                DF64Out{y_hi, y_lo}, part_d, part_t, nblk,
                (cudaStream_t)stream, SquareWalk<>{nblk * TB});
}

// Broadcast lo tile: a_hi the packed (T*TB, TB) plane, a_lo ONE (TB, TB)
// tile read at every walk position. A zero tile gives lam_gemv_df64_symm's
// bits over a zero lo plane.
extern "C" int lam_gemv_df64_symm_bcast(const float* a_hi, const float* a_lo,
                                        const float* p_hi, const float* p_lo,
                                        float* y_hi, float* y_lo,
                                        double* part_d, double* part_t,
                                        int nblk, void* stream) {
  return launch(DF64TilePlane{a_hi, a_lo}, DF64Vec{p_hi, p_lo},
                DF64Out{y_hi, y_lo}, part_d, part_t, nblk,
                (cudaStream_t)stream);
}

// Broadcast q2/q3 tiles: q2 (bcast2 != 0) and q3 (bcast3 != 0) each ONE
// (TB, TB) tile, or the full plane; the scale tables per walk position as
// in lam_gemv_fq_symm, whose bits a zero tile gives over a zero plane.
extern "C" int lam_gemv_fq_symm_bcast(
    const short* q1, const short* q2, const short* q3, const float* s1,
    const float* s2, const float* s3, const float* p_hi, const float* p_lo,
    float* y_hi, float* y_lo, double* part_d, double* part_t, int bcast2,
    int bcast3, int nblk, void* stream) {
  return launch(FQTilePlane{q1, q2, q3, s1, s2, s3,
                            bcast2 ? TILE_MASK : FULL_MASK,
                            bcast3 ? TILE_MASK : FULL_MASK, 0.0, 0.0, 0.0},
                DF64Vec{p_hi, p_lo}, DF64Out{y_hi, y_lo}, part_d, part_t,
                nblk, (cudaStream_t)stream);
}

// Broadcast q2/q3 tiles that hold only zeros (generate mode's, counted
// when its operator was built): lam_gemv_fq_symm_bcast's arguments without
// q2, q3, s2 and s3, none of which is read. q1 streams through the strip
// walk (csrc/strip_walk.cuh, StripQ1Planes) and gives lam_gemv_fq_symm's
// bits over zero planes, for any finite s2, s3.
extern "C" int lam_gemv_fq_symm_zero(const short* q1, const float* s1,
                                     const float* p_hi, const float* p_lo,
                                     float* y_hi, float* y_lo,
                                     double* part_d, double* part_t,
                                     int nblk, void* stream) {
  return launch_strip_tri<SymmQ1Cfg>(
      StripQ1Planes{{q1}, {s1}}, StripVecs<2>{{p_hi, p_lo}, {p_hi, p_lo}},
      DF64Out{y_hi, y_lo}, part_d, part_t, nblk, (cudaStream_t)stream);
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
// Walk: the strip walk (csrc/strip_walk.cuh); lt is not read (packed).
extern "C" int lam_gemv_q16_symm_slab(
    const short* q1, const float* s1, const float* p, const int* it,
    const int* kt, const int* lt, const int* d_ptr, const int* d_ids,
    const int* t_ptr, const int* t_ids, float* yd, float* yt, float* part_d,
    float* part_t, int T, int ms, int n, void* stream) {
  return launch_strip_slab<SlabQ16Cfg>(
      StripPlanes<1>{{q1}, {s1}}, StripVecs<1>{{p}, {p}},
      TableWalk{it, kt, lt, n, 1}, SlabLists{d_ptr, d_ids, t_ptr, t_ids},
      F32Out{yd}, F32Out{yt}, part_d, part_t, T, ms, (cudaStream_t)stream);
}

// The control of lam_gemv_q16_symm_slab: the same arguments and bits on the
// two-pass walk of csrc/symm_walk.cuh. Not on a solver's path
// (lam_tpu_torch/ops/probe.py gemv_q16_symm_slab_twopass).
extern "C" int lam_gemv_q16_symm_slab_twopass(
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

// The broadcast modes of kernels 9 and 17 (generate mode on the band
// pairs): the packed walk-order buffer starts tile t at t*TB*TB, as the
// packed triangle does, so DF64TilePlane and FQTilePlane read the tile
// there too. df64: a_hi the packed (T*TB, TB) plane, a_lo ONE (TB, TB) tile
// (the slab storage takes no tile: lam_tpu refuses it). A zero tile gives
// lam_gemv_df64_symm_slab's bits over a zero lo plane.
extern "C" int lam_gemv_df64_symm_slab_bcast(
    const float* a_hi, const float* a_lo, const float* p_hi,
    const float* p_lo, const int* it, const int* kt, const int* lt,
    const int* d_ptr, const int* d_ids, const int* t_ptr, const int* t_ids,
    float* yd_hi, float* yd_lo, float* yt_hi, float* yt_lo, double* part_d,
    double* part_t, int T, int ms, int n, void* stream) {
  return launch_slab(DF64TilePlane{a_hi, a_lo}, DF64Vec{p_hi, p_lo},
                     TableWalk{it, kt, lt, n, 1},
                     SlabLists{d_ptr, d_ids, t_ptr, t_ids},
                     DF64Out{yd_hi, yd_lo}, DF64Out{yt_hi, yt_lo}, part_d,
                     part_t, T, ms, (cudaStream_t)stream);
}

// A lo tile that holds only zeros (generate mode's, counted when its
// operator was built): lam_gemv_df64_symm_slab_bcast's arguments
// without a_lo, which is not read. a_hi streams through the strip walk
// (csrc/strip_walk.cuh, StripHiPlanes) and gives lam_gemv_df64_symm_slab's
// bits over a zero lo plane.
extern "C" int lam_gemv_df64_symm_slab_zero(
    const float* a_hi, const float* p_hi, const float* p_lo, const int* it,
    const int* kt, const int* lt, const int* d_ptr, const int* d_ids,
    const int* t_ptr, const int* t_ids, float* yd_hi, float* yd_lo,
    float* yt_hi, float* yt_lo, double* part_d, double* part_t, int T, int ms,
    int n, void* stream) {
  return launch_strip_slab<SlabHiCfg>(
      StripHiPlanes{{a_hi}}, StripVecs<2>{{p_hi, p_lo}, {p_hi, p_lo}},
      TableWalk{it, kt, lt, n, 1}, SlabLists{d_ptr, d_ids, t_ptr, t_ids},
      DF64Out{yd_hi, yd_lo}, DF64Out{yt_hi, yt_lo}, part_d, part_t, T, ms,
      (cudaStream_t)stream);
}

// fq: q2 (bcast2 != 0) and q3 (bcast3 != 0) each ONE (TB, TB) tile, or the
// full plane; the scale tables per walk position as in lam_gemv_fq_symm_slab,
// whose bits zero tiles give over zero planes.
extern "C" int lam_gemv_fq_symm_slab_bcast(
    const short* q1, const short* q2, const short* q3, const float* s1,
    const float* s2, const float* s3, const float* p_hi, const float* p_lo,
    const int* it, const int* kt, const int* lt, const int* d_ptr,
    const int* d_ids, const int* t_ptr, const int* t_ids, float* yd_hi,
    float* yd_lo, float* yt_hi, float* yt_lo, double* part_d, double* part_t,
    int T, int ms, int n, int bcast2, int bcast3, void* stream) {
  return launch_slab(FQTilePlane{q1, q2, q3, s1, s2, s3,
                                 bcast2 ? TILE_MASK : FULL_MASK,
                                 bcast3 ? TILE_MASK : FULL_MASK, 0.0, 0.0,
                                 0.0},
                     DF64Vec{p_hi, p_lo}, TableWalk{it, kt, lt, n, 1},
                     SlabLists{d_ptr, d_ids, t_ptr, t_ids},
                     DF64Out{yd_hi, yd_lo}, DF64Out{yt_hi, yt_lo}, part_d,
                     part_t, T, ms, (cudaStream_t)stream);
}

// q2 and q3 tiles that hold only zeros (generate mode's, counted when its
// operator was built): lam_gemv_fq_symm_slab_bcast's arguments without q2,
// q3, s2, s3 and the flags, none of which is read. q1 streams through the
// strip walk (csrc/strip_walk.cuh, StripQ1Planes) against s1 per walk
// position and gives lam_gemv_fq_symm_slab's bits over zero planes, for any
// finite s2, s3.
extern "C" int lam_gemv_fq_symm_slab_zero(
    const short* q1, const float* s1, const float* p_hi, const float* p_lo,
    const int* it, const int* kt, const int* lt, const int* d_ptr,
    const int* d_ids, const int* t_ptr, const int* t_ids, float* yd_hi,
    float* yd_lo, float* yt_hi, float* yt_lo, double* part_d, double* part_t,
    int T, int ms, int n, void* stream) {
  return launch_strip_slab<SlabQ1Cfg>(
      StripQ1Planes{{q1}, {s1}}, StripVecs<2>{{p_hi, p_lo}, {p_hi, p_lo}},
      TableWalk{it, kt, lt, n, 1}, SlabLists{d_ptr, d_ids, t_ptr, t_ids},
      DF64Out{yd_hi, yd_lo}, DF64Out{yt_hi, yt_lo}, part_d, part_t, T, ms,
      (cudaStream_t)stream);
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

// The broadcast mode of kernel 12 (generate mode on the symmetric 2-D
// grid): a_lo ONE (TB, TB) tile read at every tile of the rectangle, whose
// tile t starts at t*TB*TB. A zero tile gives lam_gemv_df64_dual's bits
// over a zero lo plane.
extern "C" int lam_gemv_df64_dual_bcast(
    const float* a_hi, const float* a_lo, const float* p_hi, const float* p_lo,
    const float* q_hi, const float* q_lo, float* yd_hi, float* yd_lo,
    float* yt_hi, float* yt_lo, double* part_d, double* part_t, int mb, int cb,
    void* stream) {
  return launch_dual(DF64TilePlane{a_hi, a_lo}, DF64Vec{p_hi, p_lo},
                     DF64Vec{q_hi, q_lo}, DF64Out{yd_hi, yd_lo},
                     DF64Out{yt_hi, yt_lo}, part_d, part_t, mb, cb,
                     (cudaStream_t)stream);
}

// A lo tile that holds only zeros (generate mode's, counted when its
// operator was built): lam_gemv_df64_dual_bcast's arguments without a_lo,
// which is not read. a_hi streams through the strip walk
// (csrc/strip_walk.cuh, StripHiPlanes on RectWalk), p read at each tile's
// column tile and q at its row tile, and gives lam_gemv_df64_dual's bits
// over a zero lo plane.
extern "C" int lam_gemv_df64_dual_zero(
    const float* a_hi, const float* p_hi, const float* p_lo,
    const float* q_hi, const float* q_lo, float* yd_hi, float* yd_lo,
    float* yt_hi, float* yt_lo, double* part_d, double* part_t, int mb,
    int cb, void* stream) {
  return launch_strip_dual<DualHiCfg>(
      StripHiPlanes{{a_hi}}, StripVecs<2>{{p_hi, p_lo}, {q_hi, q_lo}},
      DF64Out{yd_hi, yd_lo}, DF64Out{yt_hi, yt_lo}, part_d, part_t, mb, cb,
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
// sums. Walk: the strip walk (csrc/strip_walk.cuh); every plane and vector
// pointer 16-byte aligned (the bulk copies).
extern "C" int lam_gemv_q16_dual(const short* q1, const float* s1,
                                 const float* p, const float* q, float* yd,
                                 float* yt, float* part_d, float* part_t,
                                 int mb, int cb, void* stream) {
  return launch_strip_dual<DualQ16Cfg>(
      StripPlanes<1>{{q1}, {s1}}, StripVecs<1>{{p}, {q}}, F32Out{yd},
      F32Out{yt}, part_d, part_t, mb, cb, (cudaStream_t)stream);
}

// The control of lam_gemv_q16_dual: the same arguments and bits on the
// two-pass walk. Not on a solver's path (lam_tpu_torch/ops/probe.py
// gemv_q16_dual_twopass).
extern "C" int lam_gemv_q16_dual_twopass(const short* q1, const float* s1,
                                         const float* p, const float* q,
                                         float* yd, float* yt, float* part_d,
                                         float* part_t, int mb, int cb,
                                         void* stream) {
  return launch_dual(Q16Plane{q1, s1, 0.0f}, F32Vec{p}, F32Vec{q}, F32Out{yd},
                     F32Out{yt}, part_d, part_t, mb, cb, (cudaStream_t)stream);
}

// fq: q1*s1[t] + q2*s2[t] + q3*s3[t] formed and walked in f64. Walk: the
// strip walk; every plane and vector pointer 16-byte aligned.
extern "C" int lam_gemv_fq_dual(
    const short* q1, const short* q2, const short* q3, const float* s1,
    const float* s2, const float* s3, const float* p_hi, const float* p_lo,
    const float* q_hi, const float* q_lo, float* yd_hi, float* yd_lo,
    float* yt_hi, float* yt_lo, double* part_d, double* part_t, int mb, int cb,
    void* stream) {
  return launch_strip_dual<DualFQCfg>(
      StripPlanes<3>{{q1, q2, q3}, {s1, s2, s3}},
      StripVecs<2>{{p_hi, p_lo}, {q_hi, q_lo}}, DF64Out{yd_hi, yd_lo},
      DF64Out{yt_hi, yt_lo}, part_d, part_t, mb, cb, (cudaStream_t)stream);
}

// The broadcast mode of kernel 19 (generate mode on the symmetric 2-D grid):
// q2 (bcast2 != 0) and q3 (bcast3 != 0) each ONE (TB, TB) tile, or the full
// plane. The producer copies a stage's rows of a tile plane from the tile,
// at the stage's offset within its tile (StripTilePlanes::mask), kept in L2
// (evict-last); the consumers are kernel 19's, so zero tiles give
// lam_gemv_fq_dual's bits over zero planes.
extern "C" int lam_gemv_fq_dual_bcast(
    const short* q1, const short* q2, const short* q3, const float* s1,
    const float* s2, const float* s3, const float* p_hi, const float* p_lo,
    const float* q_hi, const float* q_lo, float* yd_hi, float* yd_lo,
    float* yt_hi, float* yt_lo, double* part_d, double* part_t, int mb, int cb,
    int bcast2, int bcast3, void* stream) {
  return launch_strip_dual<DualFQTileCfg>(
      StripTilePlanes{{{q1, q2, q3}, {s1, s2, s3}},
                      {FULL_MASK, bcast2 ? TILE_MASK : FULL_MASK,
                       bcast3 ? TILE_MASK : FULL_MASK}},
      StripVecs<2>{{p_hi, p_lo}, {q_hi, q_lo}}, DF64Out{yd_hi, yd_lo},
      DF64Out{yt_hi, yt_lo}, part_d, part_t, mb, cb, (cudaStream_t)stream);
}

// q2 and q3 tiles that hold only zeros (generate mode's, counted when its
// operator was built): lam_gemv_fq_dual_bcast's arguments without q2, q3,
// s2, s3 and the flags, none of which is read. q1 streams through the
// strip walk (csrc/strip_walk.cuh, StripQ1Planes) against s1 and gives
// lam_gemv_fq_dual_bcast's bits over zero tiles, which are
// lam_gemv_fq_dual's over zero planes, for any finite s2, s3.
extern "C" int lam_gemv_fq_dual_zero(
    const short* q1, const float* s1, const float* p_hi, const float* p_lo,
    const float* q_hi, const float* q_lo, float* yd_hi, float* yd_lo,
    float* yt_hi, float* yt_lo, double* part_d, double* part_t, int mb, int cb,
    void* stream) {
  return launch_strip_dual<DualQ1Cfg>(
      StripQ1Planes{{q1}, {s1}}, StripVecs<2>{{p_hi, p_lo}, {q_hi, q_lo}},
      DF64Out{yd_hi, yd_lo}, DF64Out{yt_hi, yt_lo}, part_d, part_t, mb, cb,
      (cudaStream_t)stream);
}

// The control of lam_gemv_fq_dual: the same arguments and bits on the
// two-pass walk (lam_tpu_torch/ops/probe.py gemv_fq_dual_twopass).
extern "C" int lam_gemv_fq_dual_twopass(
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

// Walk: the strip walk with tensor-core consumers (csrc/strip_walk.cuh,
// strip_mma_pass1); every plane and vector pointer 16-byte aligned.
extern "C" int lam_gemv_q16_dual_bf16(const short* q1, const float* s1,
                                      const float* p, const float* q,
                                      float* yd, float* yt, float* part_d,
                                      float* part_t, int mb, int cb,
                                      void* stream) {
  return launch_strip_dual<DualBf16Cfg>(
      StripPlanes<1>{{q1}, {s1}}, StripVecs<1>{{p}, {q}}, F32Out{yd},
      F32Out{yt}, part_d, part_t, mb, cb, (cudaStream_t)stream);
}

// The control of lam_gemv_q16_dual_bf16: the same arguments and bits on the
// two-pass walk (q16_bf16_pass1 and rect_pass2; lam_tpu_torch/ops/probe.py
// gemv_q16_dual_bf16_twopass).
extern "C" int lam_gemv_q16_dual_bf16_twopass(const short* q1, const float* s1,
                                              const float* p, const float* q,
                                              float* yd, float* yt,
                                              float* part_d, float* part_t,
                                              int mb, int cb, void* stream) {
  return launch_dual(Q16Bf16Plane{q1, s1}, F32Vec{p}, F32Vec{q}, F32Out{yd},
                     F32Out{yt}, part_d, part_t, mb, cb, (cudaStream_t)stream);
}
