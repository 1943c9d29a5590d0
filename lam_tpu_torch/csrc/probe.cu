// A read-only stream of an int16 plane, for Hopper (sm_90a): the card's
// measured read floor for the bytes of a q16 plane.
//
//   lam_stream_i16   replaces scripts/q16_probe.py:_floor_kernel (:91,
//                    pallas_call :139) and scripts/q16_probe2.py:_floor_kernel
//                    (:89, pallas_call :142), the TPU's pure-stream probes:
//                    the q16 plane streamed with no conversion and no
//                    products, folded into a sum so the reads stay live.
//
// What bounds it: bytes only (one integer add per element). Pass 1 gives
// each of `blocks` blocks a grid-stride share of the plane's 16-byte
// vectors, read with streaming loads (__ldcs, neighbouring threads on
// neighbouring vectors); each thread sums its int16 values in int64, the
// block reduces its threads in a fixed order and writes one partial. Pass 2
// (one block) sums the partials in a fixed order into one int64 checksum.
// Integer sums are exact, so the checksum equals the plain version's
// plane.long().sum() bit for bit, whatever the order.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ long long block_sum(long long v) {
  __shared__ long long red[WARPS];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  long long s = 0;
  if (threadIdx.x == 0)
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;  // meaningful in thread 0 only
}

// The sum of the eight int16 of one 16-byte vector.
__device__ __forceinline__ int sum_i16x8(const int4 q) {
  const int w[4] = {q.x, q.y, q.z, q.w};
  int s = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) s += (int)(short)(w[j] & 0xffff) + (w[j] >> 16);
  return s;
}

__global__ void __launch_bounds__(THREADS)
stream_pass1(const int4* __restrict__ x, long long nvec,
             long long* __restrict__ part) {
  const long long stride = (long long)gridDim.x * THREADS;
  long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long acc = 0;
  for (; v + 3 * stride < nvec; v += 4 * stride) {  // four loads in flight
    int4 q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) q[u] = __ldcs(x + v + u * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc += sum_i16x8(q[u]);
  }
  for (; v < nvec; v += stride) acc += sum_i16x8(__ldcs(x + v));
  const long long b = block_sum(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
}

__global__ void __launch_bounds__(THREADS)
stream_pass2(const long long* __restrict__ part, int blocks,
             long long* __restrict__ out) {
  long long acc = 0;
  for (int b = threadIdx.x; b < blocks; b += THREADS) acc += part[b];
  const long long s = block_sum(acc);
  if (threadIdx.x == 0) out[0] = s;
}

}  // namespace

// checksum[0] = sum of the nvec * 8 int16 values at plane (16-byte
// aligned); part holds `blocks` int64 partials. Returns cudaGetLastError()
// after the launches.
extern "C" int lam_stream_i16(const short* plane, long long nvec, int blocks,
                              long long* part, long long* checksum,
                              void* stream) {
  if (nvec <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  stream_pass1<<<blocks, THREADS, 0, s>>>(
      reinterpret_cast<const int4*>(plane), nvec, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stream_pass2<<<1, THREADS, 0, s>>>(part, blocks, checksum);
  return (int)cudaGetLastError();
}
