// Masked 5-point Laplacian with the fused p . y dot, for Hopper (sm_90a):
// the inner matvec of the heat-equation demo's mixed-precision solve.
//
//   lam_laplace5_f32_halo  replaces lam_tpu/ops/stencil.py:laplace5_f32_halo
//                          (:92; Pallas kernel _laplace5_kernel, pallas_call
//                          at :131)
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
// warp owns a strip of 128 columns (each lane 4, one 16-byte load per row)
// and ROWS_PER_WARP consecutive rows, and marches down them holding the
// rows above, at and below in registers: each row of the strip is loaded
// once, and only the two rows bordering the strip are loaded a second
// time, by the neighbouring strips (through L2). The west and east
// neighbours are the adjacent lanes' values (warp shuffles); the lanes at
// the strip's ends load the one column beyond it. The dot is taken in the
// same pass (the TPU kernel's point: no second read of p and y), in double
// from the exact f32 products: each thread sums its cells in order, a warp
// butterfly and then warp 0 in order sum a block's, each block writes one
// partial, and a second one-block pass in the same entry point sums the
// partials in a fixed order. No float atomics: results repeat bitwise,
// and with them CG iteration counts.
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
      *reinterpret_cast<float4*>(y + (size_t)r * W + c0) = out;
      acc += (double)cur.x * out.x;
      acc += (double)cur.y * out.y;
      acc += (double)cur.z * out.z;
      acc += (double)cur.w * out.w;
      prev = cur;
      cur = next;
    }
  }

  __shared__ double warp_part[WARPS];
  acc = warp_sum(acc);
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += warp_part[w];
    partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// one block: each thread sums a fixed stride of the partials in order,
// then a fixed tree adds the threads' sums
__global__ void __launch_bounds__(SUM_THREADS)
sum_partials(const double* __restrict__ partials, int n, float* __restrict__ dot) {
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

dim3 grid_of(int H, int W) {
  return dim3(W / COLS_PER_WARP, (H + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
}

}  // namespace

// The number of partial sums (doubles) the caller allocates for an (H, W)
// grid: one per block.
extern "C" int lam_laplace5_blocks(int H, int W) {
  const dim3 g = grid_of(H, W);
  return (int)(g.x * g.y);
}

// (y, *dot) of the masked stencil above; `partials` holds
// lam_laplace5_blocks(H, W) doubles of scratch. Returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for a shape outside the
// contract above.
extern "C" int lam_laplace5_f32_halo(const float* p, const float* up,
                                     const float* dn, float* y,
                                     double* partials, float* dot, int H,
                                     int W, int nrows, int nxi, void* stream) {
  if (H <= 0 || W <= 0 || W % COLS_PER_WARP) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of(H, W);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  laplace5<<<grid, THREADS, 0, s>>>(p, up, dn, y, partials, H, W, nrows, nxi);
  int code = (int)cudaGetLastError();
  if (code != 0) return code;
  sum_partials<<<1, SUM_THREADS, 0, s>>>(partials, (int)(grid.x * grid.y), dot);
  return (int)cudaGetLastError();
}
