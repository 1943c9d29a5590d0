// Masked 5-point Laplacian with the fused p . y dot, for Hopper (sm_90a):
// the inner matvec of the heat-equation demo's mixed-precision solve.
//
//   lam_laplace5_f32_halo  replaces lam_tpu/ops/stencil.py:laplace5_f32_halo
//                          (:92; Pallas kernel _laplace5_kernel, pallas_call
//                          at :131)
//
// with its earlier two-launch walk kept as the control, for the bit check
// and the in-turn timing on the same grid (on no solver's path):
//
//   lam_laplace5_f32_halo_twopass  laplace5 + sum_partials below
//                                  (lam_tpu_torch/ops/probe.py
//                                  laplace5_f32_halo_twopass)
//
// Contract: p and y are (H, W) row-major f32 with W a multiple of
// COLS_PER_WARP (128, the wrapper's rule) and 16-byte aligned; up and dn are
// (1, W) f32 rows, 16-byte aligned. For rows < nrows and columns < nxi
//
//   y[i,j] = 4 p[i,j] - p[i-1,j] - p[i+1,j] - p[i,j-1] - p[i,j+1]
//
// with up[j] as p[-1,j], dn[j] as p[H,j] and 0 beyond the side columns;
// y = 0 elsewhere. *dot = sum over the grid of p * y.
//
// What bounds it: a call must read p once and write y once, 8 B per grid
// cell, for 7 flops (the stencil's 5 and the dot's 2): bytes, far from the
// compute roof. 10.5 MB at the demo's 1024 x 1280 grid (3.1 us at 3.35
// TB/s, and L2-resident, so a call there costs about a launch) and 134 MB
// at 4096 x 4096 (40 us, streamed from HBM).
//
// How the design meets that: the TPU kernel walked (tbr, W) row blocks in
// VMEM and gathered each block's two halo rows with strided slices. Here a
// block owns a patch of 32 rows x 128 columns, a warp 8 rows of it and a
// lane 4 columns (one 16-byte load a row); the west and east neighbours
// are the adjacent lanes' values (warp shuffles), and the lanes at the
// strip's ends load the one column beyond it. The dot is taken in the same
// pass (the TPU kernel's point: no second read of p and y), in double from
// the exact f32 products, in a fixed order: each thread sums its cells row
// by row, a warp butterfly and then thread 0 in warp order sum a block's,
// each block writes one partial, and one block sums the partials with a
// 256-wide stride and then a fixed tree. No float atomics: results repeat
// bitwise, and with them CG iteration counts.
//
// The control (laplace5 + sum_partials) lets a lane march down its 8 rows
// with one 16-byte load ahead, and sums the partials in a second, one-block
// launch. On the demo's grid (320 blocks of 4 warps, ~10 warps an SM) the
// call is a few latencies long, and a kernel boundary is a large share of
// it. The kernel (laplace5_inflight, then sum_partials<true>):
//  * issues all of a lane's loads before its first cell: its 10 rows (the
//    8 it owns and the two around them) and, for the strip's end lanes,
//    the 8 columns beyond it, unrolled into registers; then it forms and
//    sums the 8 rows in the control's order;
//  * launches pass 2 as a programmatic dependent
//    (cudaLaunchAttributeProgrammaticStreamSerialization): each block of
//    pass 1 allows it once its partial is written
//    (griddepcontrol.launch_dependents), and its one block waits for pass
//    1's end (griddepcontrol.wait) before it reads a partial, so the launch
//    gap is hidden behind pass 1's last blocks;
//  * keeps the control's grid: a warp's 8 x 128 cells are the unit of the
//    fixed summation tree, so the demo's grid keeps its 1280 warps.
// No TMA: the demo's grid is L2-resident and a warp's rows are ten
// coalesced 16-byte loads a lane. The sweep behind these choices (PERF.md
// section 6): on the demo's grid most of pass 1 is the launch and block
// scheduling of its grid (an empty kernel of the same grid) and the moving
// of its bytes (a copy of p into y); the stencil and the f64 dot (two f32
// -> f64 conversions a cell, at 16 a clock an SM) add less than either. A
// last-block reduction (an integer ticket, the block that draws the last
// one sums the partials) was slower than pass 2 as a dependent launch on
// both grids, and allowing pass 2 at pass 1's start rather than its end was
// slower on the demo's grid.
// The cells, their masking and the dot's tree are the control's: (y, *dot)
// equal the control's bit for bit.
//
// Rounding: 4p is exact in f32, so the first term is one fused
// multiply-add, 4p - north rounded once; then south, west and east are
// subtracted in that order with one rounding each, as the plain PyTorch
// version does (4.0 * p - north - south - west - east): y is bitwise equal
// to it.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = 8;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;  // 32
constexpr int VEC = 4;                                 // columns per lane
constexpr int COLS_PER_WARP = 32 * VEC;                // 128
constexpr int SUM_THREADS = 256;                       // the partials' pass

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 4c - n - s - w - e, rounded as the plain version rounds it
__device__ __forceinline__ float cell(float c, float n, float s, float w, float e) {
  return __fsub_rn(__fsub_rn(__fsub_rn(__fmaf_rn(4.0f, c, -n), s), w), e);
}

// One row of a lane's 4 cells, masked to rows < nrows and columns < nxi,
// written to y and added to the lane's dot in the fixed order x, y, z, w.
__device__ __forceinline__ void row_cells(float4 prev, float4 cur, float4 next,
                                          float west, float east, float* yrow,
                                          int r, int c0, int nrows, int nxi,
                                          double& acc) {
  float4 out;
  out.x = cell(cur.x, prev.x, next.x, west, cur.y);
  out.y = cell(cur.y, prev.y, next.y, cur.x, cur.z);
  out.z = cell(cur.z, prev.z, next.z, cur.y, cur.w);
  out.w = cell(cur.w, prev.w, next.w, cur.z, east);
  if (r >= nrows) {
    out = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else if (c0 + VEC > nxi) {
    if (c0 + 0 >= nxi) out.x = 0.0f;
    if (c0 + 1 >= nxi) out.y = 0.0f;
    if (c0 + 2 >= nxi) out.z = 0.0f;
    if (c0 + 3 >= nxi) out.w = 0.0f;
  }
  *reinterpret_cast<float4*>(yrow + c0) = out;
  acc += (double)cur.x * out.x;
  acc += (double)cur.y * out.y;
  acc += (double)cur.z * out.z;
  acc += (double)cur.w * out.w;
}

// The block's partial, in thread 0: the warps' butterflies added in warp
// order.
__device__ __forceinline__ double block_partial(double acc, int warp,
                                                int lane) {
  __shared__ double warp_part[WARPS];
  acc = warp_sum(acc);
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += warp_part[w];
  }
  return s;
}

// The control's pass 1: a lane marches down its rows holding the rows
// above, at and below in registers, one load ahead.
__global__ void __launch_bounds__(THREADS)
laplace5(const float* __restrict__ p, const float* __restrict__ up,
         const float* __restrict__ dn, float* __restrict__ y,
         double* __restrict__ partials, int H, int W, int nrows, int nxi) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * COLS_PER_WARP + lane * VEC;
  const int r0 = (blockIdx.y * WARPS + warp) * ROWS_PER_WARP;
  const int r1 = min(r0 + ROWS_PER_WARP, H);
  double acc = 0.0;

  if (r0 < H) {  // warp-uniform; every warp reaches the barrier below
    float4 prev = r0 == 0 ? load4(up + c0) : load4(p + (size_t)(r0 - 1) * W + c0);
    float4 cur = load4(p + (size_t)r0 * W + c0);
    for (int r = r0; r < r1; ++r) {
      const float* row = p + (size_t)r * W;
      const float4 next = r + 1 == H ? load4(dn + c0) : load4(row + W + c0);
      float west = __shfl_up_sync(0xffffffffu, cur.w, 1);
      float east = __shfl_down_sync(0xffffffffu, cur.x, 1);
      if (lane == 0) west = c0 > 0 ? __ldg(row + c0 - 1) : 0.0f;
      if (lane == 31) east = c0 + VEC < W ? __ldg(row + c0 + VEC) : 0.0f;
      row_cells(prev, cur, next, west, east, y + (size_t)r * W, r, c0, nrows,
                nxi, acc);
      prev = cur;
      cur = next;
    }
  }

  const double s = block_partial(acc, warp, lane);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// Pass 2, one block: each thread sums a fixed stride of the partials in
// order, then a fixed tree adds the threads' sums. PDL: launched as a
// programmatic dependent of pass 1 (the kernel), it first waits for pass
// 1's writes; the control launches it as an ordinary kernel.
template <bool PDL>
__global__ void __launch_bounds__(SUM_THREADS)
sum_partials(const double* __restrict__ partials, int n, float* __restrict__ dot) {
  if constexpr (PDL) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ double part[SUM_THREADS];
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += SUM_THREADS) s += partials[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int half = SUM_THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) *dot = (float)part[0];
}

// The kernel's pass 1: the control's cells and sums, with all of a lane's
// loads issued before its first cell.
__global__ void __launch_bounds__(THREADS)
laplace5_inflight(const float* __restrict__ p, const float* __restrict__ up,
                  const float* __restrict__ dn, float* __restrict__ y,
                  double* __restrict__ partials, int H, int W, int nrows,
                  int nxi) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * COLS_PER_WARP + lane * VEC;
  const int r0 = (blockIdx.y * WARPS + warp) * ROWS_PER_WARP;
  double acc = 0.0;

  if (r0 < H) {  // warp-uniform; every warp reaches the barrier below
    // rows r0 - 1 .. r0 + 8 (up above row 0, dn below row H - 1), and the
    // column beyond the strip on each side of the warp's rows
    float4 v[ROWS_PER_WARP + 2];
    float west[ROWS_PER_WARP], east[ROWS_PER_WARP];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP + 2; ++j) {
      const int r = r0 - 1 + j;
      const float* row = r < 0 ? up : r < H ? p + (size_t)r * W : dn;
      v[j] = r <= H ? load4(row + c0) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const float* row = p + (size_t)(r0 + j) * W;
      const bool live = r0 + j < H;
      west[j] = lane == 0 && live && c0 > 0 ? __ldg(row + c0 - 1) : 0.0f;
      east[j] = lane == 31 && live && c0 + VEC < W ? __ldg(row + c0 + VEC)
                                                   : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = r0 + j;
      if (r < H) {  // warp-uniform
        const float4 cur = v[j + 1];
        float w = __shfl_up_sync(0xffffffffu, cur.w, 1);
        float e = __shfl_down_sync(0xffffffffu, cur.x, 1);
        if (lane == 0) w = west[j];
        if (lane == 31) e = east[j];
        row_cells(v[j], cur, v[j + 2], w, e, y + (size_t)r * W, r, c0, nrows,
                  nxi, acc);
      }
    }
  }

  const double s = block_partial(acc, warp, lane);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
  // pass 2's one block may be scheduled once every block is here; it waits
  // for this grid's end before it reads a partial
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

dim3 grid_of(int H, int W) {
  return dim3(W / COLS_PER_WARP, (H + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
}

// The grid of an (H, W) call, or an empty one for a shape outside the
// contract.
dim3 checked_grid(int H, int W) {
  if (H <= 0 || W <= 0 || W % COLS_PER_WARP) return dim3(0);
  const dim3 grid = grid_of(H, W);
  return grid.y > 65535 ? dim3(0) : grid;
}

}  // namespace

// The number of partial sums (doubles) the caller allocates for an (H, W)
// grid: one per block.
extern "C" int lam_laplace5_blocks(int H, int W) {
  const dim3 g = grid_of(H, W);
  return (int)(g.x * g.y);
}

// (y, *dot) of the masked stencil above: laplace5_inflight, then
// sum_partials as its programmatic dependent; `partials` holds
// lam_laplace5_blocks(H, W) doubles of scratch. Returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for a shape outside the
// contract above.
extern "C" int lam_laplace5_f32_halo(const float* p, const float* up,
                                     const float* dn, float* y,
                                     double* partials, float* dot, int H,
                                     int W, int nrows, int nxi, void* stream) {
  const dim3 grid = checked_grid(H, W);
  if (grid.x == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  laplace5_inflight<<<grid, THREADS, 0, s>>>(p, up, dn, y, partials, H, W,
                                             nrows, nxi);
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(SUM_THREADS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, sum_partials<true>,
                                 (const double*)partials,
                                 (int)(grid.x * grid.y), dot);
}

// The control of lam_laplace5_f32_halo: the same arguments and bits, as
// laplace5 and then sum_partials, an ordinary launch. Not on a solver's
// path (lam_tpu_torch/ops/probe.py laplace5_f32_halo_twopass).
extern "C" int lam_laplace5_f32_halo_twopass(const float* p, const float* up,
                                             const float* dn, float* y,
                                             double* partials, float* dot,
                                             int H, int W, int nrows, int nxi,
                                             void* stream) {
  const dim3 grid = checked_grid(H, W);
  if (grid.x == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  laplace5<<<grid, THREADS, 0, s>>>(p, up, dn, y, partials, H, W, nrows, nxi);
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  sum_partials<false><<<1, SUM_THREADS, 0, s>>>(partials,
                                                (int)(grid.x * grid.y), dot);
  return (int)cudaGetLastError();
}
