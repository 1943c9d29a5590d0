// The strip walk: pass 1 of kernel 16 (lam_gemv_q16_symm_slab, one rank's
// band-pair walk of the packed int16 q1 plane), a persistent grid fed by
// TMA bulk copies. It replaces symm_pass1<Q16Plane, F32Vec, TableWalk> on
// that kernel only; the two-pass walk of csrc/symm_walk.cuh stays the
// control (lam_gemv_q16_symm_slab_twopass) and the walk of every other
// kernel.
//
// What bounds it: bytes. Every stored element is read once, 2 B, for 4
// flops (its direct and its transpose product): 55.05 MB at rank 0 of G=2
// (105 tiles), 16.4 us at 3.35 TB/s. The unit of work is symm_pass1's
// (tile, 64-row strip), 64 KB, about 2.6 us of one SM's share of the
// card's bandwidth; symm_pass1 gives each strip its own block (840 at G=2,
// a partly-filled last wave) and pays, around those 64 KB, fixed costs
// that nothing overlaps: dependent reads of the walk tables and the scale,
// sixteen loads of p a lane before the first byte of the tile is asked
// for, and the transpose reduction behind a block-wide barrier.
//
// What the design does about them:
//  * A persistent grid of one block an SM (the SM count read once and
//    cached); block b walks strips b, b + grid, ... (840 strips on 132
//    SMs: 6 or 7 each).
//  * The block's last warp is the producer. One thread reads the next
//    strip's table entries it/kt and scale s1 before it waits for a free
//    stage, writes the scale and whether the tile has a transpose term
//    into the stage's header, and fills the stage with TMA 1-D bulk copies
//    (UBLKCP in the SASS): the strip as one 64 KB copy (a strip is
//    contiguous in the (T*TB, TB) plane), evict-first in L2, and
//    evict-last the 2 KB of p at column tile k and the 64 entries of p at
//    the strip's rows of row tile i. So no consumer waits on a dependent
//    global read at the start of a strip: the producer runs a stage ahead.
//  * The WARPS consumer warps wait on a stage's full barrier, read their
//    rows and p from shared memory as 16-byte vectors (a warp reads 512
//    contiguous bytes of a row: no bank conflict), release the stage on
//    its empty barrier as soon as their rows are summed, and reduce the
//    transpose sums through shared memory on a named barrier of the
//    consumer warps only (bar.sync 1, 256), while the producer streams the
//    next strip.
//  * Pass 2 is slab_pass2, launched as a programmatic dependent launch
//    (cudaLaunchAttributeProgrammaticStreamSerialization): its blocks are
//    scheduled while pass 1 drains its last strips and wait
//    (griddepcontrol.wait) for pass 1's writes before they read part_d and
//    part_t.
//
// Sizes, from a sweep on an H100 (PERF.md section 6): two stages (136 KB
// and a 16 KB reduction buffer). A third stage was slower, and so were two
// blocks an SM of one stage each, the int16 -> f32 conversion by bits
// (csrc/q16_probe.cu's magic), an earlier pass-2 trigger and pass 2 as an
// ordinary launch. Eight 8 KB copies a strip, contiguous ranges of strips
// and a double-buffered reduction were as fast as what is kept.
//
// The bits: inside a strip nothing of symm_pass1's order changes. Warp w
// sums rows w*8 .. w*8+7 in that order, lane l holds columns lane_col<8>(l,
// q), d is the sum over q then the warp butterfly, pk = p * sc and pi =
// p * sc are rounded as there, and the transpose column sums are added
// over the 8 warps in the order w = 0 .. 7. The int16 -> f32 conversion is
// exact. Each block writes part_d[t][r] and part_t[t][s][c] as
// symm_pass1 does, so slab_pass2 sums the same partials in the same order:
// (yd, yt) equal the two-pass walk's bit for bit.

#pragma once

#include "symm_walk.cuh"
#include "tma.cuh"

namespace {

// A stage: the strip (ROWS x TB int16), p at column tile k (TB f32), p at
// the strip's rows of row tile i (ROWS f32), the header. The ring holds
// STRIP_STAGES of them, then the transpose reduction buffer.
constexpr int STRIP_STAGES = 2;
constexpr int STRIP_BYTES = ROWS * TB * (int)sizeof(short);  // 64 KB
constexpr int PK_OFF = STRIP_BYTES;
constexpr int PI_OFF = PK_OFF + TB * (int)sizeof(float);
constexpr int HDR_OFF = PI_OFF + ROWS * (int)sizeof(float);
constexpr int STAGE_BYTES = HDR_OFF + 128;
constexpr int RED_BYTES = WARPS * TB * (int)sizeof(float);
constexpr int STRIP_SMEM = STRIP_STAGES * STAGE_BYTES + RED_BYTES;
constexpr int STRIP_THREADS = (WARPS + 1) * 32;  // + the producer warp

struct StripHeader {
  float sc;     // the tile's scale
  int offdiag;  // the tile has a transpose term
};

// Eight int16 of one 16-byte vector as f32 (exact), as load_i16x8 does.
__device__ __forceinline__ void f32x8_of_i16x8(const int4 x, float v[8]) {
  const int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = (float)(int)(short)(w[j] & 0xffff);
    v[2 * j + 1] = (float)(w[j] >> 16);
  }
}

// The consumer warps' barrier; the producer warp takes no part.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(WARPS * 32) : "memory");
}

// Block b walks strips b, b + gridDim.x, ... of the T * STRIPS.
__global__ void __launch_bounds__(STRIP_THREADS, 1)
strip_pass1(const short* __restrict__ q, const float* __restrict__ s1,
            const float* __restrict__ p, const int* __restrict__ it,
            const int* __restrict__ kt, int T, float* __restrict__ part_d,
            float* __restrict__ part_t) {
  constexpr int S = STRIP_STAGES;
  constexpr int COLS_PER_LANE = cols_per_lane_of<TB>;  // 16
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  float* red = reinterpret_cast<float*>(smem + S * STAGE_BYTES);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int strips = T * STRIPS;
  const int step = gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {  // the producer: one thread issues every copy
    if (lane == 0) {
      const uint64_t once = evict_first_policy();
      const uint64_t keep = evict_last_policy();
      int st = 0;
      uint32_t phase = 0;
      int g = blockIdx.x;
      int t = g / STRIPS;
      int i = __ldg(it + t), k = __ldg(kt + t);
      float sc = __ldg(s1 + t);
      while (g < strips) {
        const int s = g % STRIPS;
        // the next strip's tile, read before this one waits
        const int gn = g + step;
        int tn = t, in = i, kn = k;
        float scn = sc;
        if (gn < strips && gn / STRIPS != t) {
          tn = gn / STRIPS;
          in = __ldg(it + tn);
          kn = __ldg(kt + tn);
          scn = __ldg(s1 + tn);
        }
        const bool off = k < i;
        mbar_wait(&empty[st], phase ^ 1);  // the first pass finds it free
        unsigned char* stage = smem + st * STAGE_BYTES;
        StripHeader* hdr = reinterpret_cast<StripHeader*>(stage + HDR_OFF);
        hdr->sc = sc;
        hdr->offdiag = off;
        // the arrive releases the header to the consumers' wait
        mbar_expect_tx(&full[st], STRIP_BYTES + TB * (int)sizeof(float) +
                                      (off ? ROWS * (int)sizeof(float) : 0));
        bulk_copy(stage, q + ((size_t)t * TB + (size_t)s * ROWS) * TB,
                  STRIP_BYTES, &full[st], once);
        bulk_copy(stage + PK_OFF, p + (size_t)k * TB,
                  TB * (int)sizeof(float), &full[st], keep);
        if (off)
          bulk_copy(stage + PI_OFF, p + (size_t)i * TB + s * ROWS,
                    ROWS * (int)sizeof(float), &full[st], keep);
        if (++st == S) { st = 0; phase ^= 1; }
        g = gn; t = tn; i = in; k = kn; sc = scn;
      }
    }
    return;
  }

  // the consumers: warp w sums the strip's rows w*8 .. w*8+7
  int st = 0;
  uint32_t phase = 0;
  for (int g = blockIdx.x; g < strips; g += step) {
    const int t = g / STRIPS;
    const int s = g % STRIPS;
    // pass 2 may be scheduled once every block is on its last strip; it
    // waits for this grid's end before it reads a partial
    if (g + step >= strips)
      asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    mbar_wait(&full[st], phase);
    const unsigned char* stage = smem + st * STAGE_BYTES;
    const StripHeader hdr =
        *reinterpret_cast<const StripHeader*>(stage + HDR_OFF);
    const float sc = hdr.sc;
    const bool off = hdr.offdiag != 0;  // uniform across the block

    float pk[COLS_PER_LANE];
    float tacc[COLS_PER_LANE];
    const float* pks = reinterpret_cast<const float*>(stage + PK_OFF);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // columns lane_col<8>(lane, 8h .. 8h+7)
      const float4* v = reinterpret_cast<const float4*>(pks + h * 256 +
                                                        lane * 8);
      const float4 x0 = v[0], x1 = v[1];
      pk[8 * h + 0] = x0.x * sc; pk[8 * h + 1] = x0.y * sc;
      pk[8 * h + 2] = x0.z * sc; pk[8 * h + 3] = x0.w * sc;
      pk[8 * h + 4] = x1.x * sc; pk[8 * h + 5] = x1.y * sc;
      pk[8 * h + 6] = x1.z * sc; pk[8 * h + 7] = x1.w * sc;
    }
#pragma unroll
    for (int qq = 0; qq < COLS_PER_LANE; ++qq) tacc[qq] = 0.0f;

    const short* rows = reinterpret_cast<const short*>(stage) +
                        warp * ROWS_PER_WARP * TB;
    const float* pis = reinterpret_cast<const float*>(stage + PI_OFF);
#pragma unroll 2
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;  // row of the strip
      float a[COLS_PER_LANE];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f32x8_of_i16x8(*reinterpret_cast<const int4*>(rows + rr * TB +
                                                      h * 256 + lane * 8),
                       a + 8 * h);
      float d = 0.0f;
#pragma unroll
      for (int qq = 0; qq < COLS_PER_LANE; ++qq) d += a[qq] * pk[qq];
      d = warp_sum(d);
      if (lane == 0) part_d[(size_t)t * TB + s * ROWS + r] = d;
      if (off) {
        const float pi = pis[r] * sc;
#pragma unroll
        for (int qq = 0; qq < COLS_PER_LANE; ++qq) tacc[qq] += a[qq] * pi;
      }
    }
    __syncwarp();  // every lane's reads of the stage before the release
    if (lane == 0) mbar_arrive(&empty[st]);
    if (++st == S) { st = 0; phase ^= 1; }

    if (off) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4* v = reinterpret_cast<float4*>(red + warp * TB + h * 256 +
                                              lane * 8);
        v[0] = make_float4(tacc[8 * h + 0], tacc[8 * h + 1], tacc[8 * h + 2],
                           tacc[8 * h + 3]);
        v[1] = make_float4(tacc[8 * h + 4], tacc[8 * h + 5], tacc[8 * h + 6],
                           tacc[8 * h + 7]);
      }
      consumers_sync();
      float* out = part_t + ((size_t)t * STRIPS + s) * TB;
      for (int c = threadIdx.x; c < TB; c += WARPS * 32) {
        float v = red[c];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) v += red[w * TB + c];
        out[c] = v;
      }
      consumers_sync();  // every read of red before the next strip's writes
    }
  }
}

// Kernel 16 on the strip walk: pass 1 over the T packed tiles of the
// rank's walk (tile t at rows t*TB of q), then slab_pass2 over the lists L
// as a programmatic dependent launch.
int launch_strip_slab(const short* q, const float* s1, const float* p,
                      const int* it, const int* kt, SlabLists L, float* yd,
                      float* yt, float* part_d, float* part_t, int T, int ms,
                      int n, cudaStream_t stream) {
  if (T <= 0 || ms <= 0 || ms % TB || n <= 0 || n % TB)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(p) % 16)
    return (int)cudaErrorInvalidValue;  // the bulk copies' alignment
  static bool sized[MAX_DEVICES];  // shared memory above 48 KB allowed
  int dev, sms;
  int e = device_and_sms(strip_pass1, STRIP_SMEM, sized, &dev, &sms);
  if (e != (int)cudaSuccess) return e;
  const int strips = T * STRIPS;
  strip_pass1<<<sms < strips ? sms : strips, STRIP_THREADS, STRIP_SMEM,
                stream>>>(q, s1, p, it, kt, T, part_d, part_t);
  e = (int)cudaGetLastError();
  if (e != (int)cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((ms + n) / P2_COLS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, slab_pass2<float, F32Out, true>, (const float*)part_d,
      (const float*)part_t, L.d_ptr, L.d_ids, L.t_ptr, L.t_ids, ms,
      F32Out{yd}, F32Out{yt});
}

}  // namespace
