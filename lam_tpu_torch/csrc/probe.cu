// Read-only streams of an int16 plane, for Hopper (sm_90a): the card's
// measured read floor for the bytes of a q16 plane, and the same stream
// with each value converted to f32.
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
//
//   lam_convert_i16  replaces scripts/q16_probe.py:_convert_kernel (:110,
//                    via _micro_pass :126, pallas_call :139): the plane
//                    streamed with each int16 converted to f32 (the I2F
//                    the exact q16 walk does for every element) and folded,
//                    with no products. The TPU folded in f32 into a (tb, 128)
//                    accumulator; here each thread sums its converted values
//                    in f32 in the stream's order, then the block and pass 2
//                    sum the threads and blocks in f64 in a fixed order: the
//                    result repeats bit for bit and is exact where every
//                    thread's f32 sum is (the probes' tridiagonal plane).
//                    Bound: bytes, as lam_stream_i16.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <class T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T red[WARPS];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  T s = 0;
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

// The f32 sum of the eight int16 of one 16-byte vector, each converted.
__device__ __forceinline__ float fold_f32x8(const int4 q, float acc) {
  const int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc += (float)(int)(short)(w[j] & 0xffff);
    acc += (float)(w[j] >> 16);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
convert_pass1(const int4* __restrict__ x, long long nvec,
              double* __restrict__ part) {
  const long long stride = (long long)gridDim.x * THREADS;
  long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  float acc = 0.0f;
  for (; v + 3 * stride < nvec; v += 4 * stride) {  // four loads in flight
    int4 q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) q[u] = __ldcs(x + v + u * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc = fold_f32x8(q[u], acc);
  }
  for (; v < nvec; v += stride) acc = fold_f32x8(__ldcs(x + v), acc);
  const double b = block_sum((double)acc);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
}

template <class T>
__global__ void __launch_bounds__(THREADS)
stream_pass2(const T* __restrict__ part, int blocks, T* __restrict__ out) {
  T acc = 0;
  for (int b = threadIdx.x; b < blocks; b += THREADS) acc += part[b];
  const T s = block_sum(acc);
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

// sum[0] = the sum of the nvec * 8 int16 values at plane (16-byte aligned),
// each converted to f32, summed in f32 by thread and in f64 across threads
// and blocks; part holds `blocks` f64 partials.
extern "C" int lam_convert_i16(const short* plane, long long nvec, int blocks,
                               double* part, double* sum, void* stream) {
  if (nvec <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  convert_pass1<<<blocks, THREADS, 0, s>>>(
      reinterpret_cast<const int4*>(plane), nvec, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stream_pass2<<<1, THREADS, 0, s>>>(part, blocks, sum);
  return (int)cudaGetLastError();
}
