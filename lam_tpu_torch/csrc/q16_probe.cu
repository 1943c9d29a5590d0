// The q16 probe variants of kernel 14's triangle walk, for Hopper (sm_90a):
// lam_tpu's TPU experiments on the q16 walk (scripts/q16_probe*.py), each
// as a variant of the walk of csrc/symm_walk.cuh, over the same packed int16
// plane and per-tile power-of-two scales, with the same arguments, outputs
// and two passes as lam_gemv_q16_symm.
//
//   lam_gemv_q16_symm_magic   replaces scripts/q16_probe.py:_pair_kernel
//                             (:169, magic=True; gemv_pair :232, pallas_call
//                             :270): the int16 -> f32 dequantization without
//                             a conversion instruction. Each 32-bit word w
//                             of a 16-byte load gives u = ((w >> sh) &
//                             0xffff) ^ 0x8000 (the int16 biased by 2^15)
//                             and a = __int_as_float(u | 0x4B000000) -
//                             8421376.0f (2^23 + u minus 2^23 + 2^15): one
//                             LOP3 and one FADD a value, exact, so y equals
//                             lam_gemv_q16_symm's bit for bit. (magic=False,
//                             int16 pairs unpacked from int32 lanes, is what
//                             load_i16x8 does in every q16 kernel.)
//   lam_gemv_q16_symm_tb1024  replaces scripts/q16_probe.py's base walk at
//                             tb=1024 (main :342-363) and q16_probe3.py's
//                             full kernel at tb=1024 (:44-80, :99): kernel
//                             14's exact walk on 1024-wide tiles (a lane
//                             holds 32 columns; 16 strips a tile; the
//                             shared-memory reduction red[8][1024] is 32 KB).
//   lam_gemv_q16_symm_sub8    replaces scripts/q16_probe2.py:_multi_kernel
//                             (:157, sub=8; gemv_q16_multi :202, pallas_call
//                             :241), whose transpose tree stops at 8
//                             sublanes: each warp writes its own transpose
//                             row, 8 rows a strip, with no shared-memory
//                             pass or barrier, and pass 2 sums 64 partial
//                             rows a tile in a fixed order. part_t is 8x
//                             kernel 14's. On the strip walk with exact
//                             summing consumers (SymmSub8Cfg): each
//                             consumer warp stores its row and goes on to
//                             its next strip, with no consumer barrier.
//   lam_gemv_q16_symm_split   replace scripts/q16_probe4.py:_mxu_kernel
//   lam_gemv_q16_symm_hi      (:63; gemv_q16_mxu :156, pallas_call :206) in
//   lam_gemv_q16_symm_hybrid  its modes split, hi and hybrid (mode def is
//                             lam_gemv_q16_symm_bf16): q16_bf16_pass1 with
//                             the strip split exactly into bf16 ah + al.
//                             split rounds x = p * s once to bf16 and takes
//                             ah * x + al * x; hi splits x into three bf16
//                             parts and takes the five products above f32
//                             rounding (f32-faithful, the TPU's HIGHEST
//                             precision); hybrid takes the direct term as f32
//                             FMAs on the CUDA cores and the transpose term as
//                             hi does.
//
// sub8 runs on the strip walk (csrc/strip_walk.cuh, strip_pass1 over the
// packed triangle, symm_pass2 over 64 rows a tile as a programmatic
// dependent launch); split, hi and hybrid on the strip walk with
// tensor-core consumers (strip_mma_pass1 over the packed triangle, the
// split made by bits, fragments taken with ldmatrix; split converts each
// stage into a bf16 strip buffer, SymmSplitCfg; hi and hybrid split raw
// int16 fragments in registers, SymmHiCfg and SymmHybridCfg). Each one's
// two-pass walk (symm_pass1<..., WARPS> for sub8, q16_bf16_pass1 for the
// others, then symm_pass2) stays as its control with the same arguments
// and bits,
//
//   lam_gemv_q16_symm_sub8_twopass     lam_gemv_q16_symm_sub8
//   lam_gemv_q16_symm_split_twopass    lam_gemv_q16_symm_split
//   lam_gemv_q16_symm_hi_twopass       lam_gemv_q16_symm_hi
//   lam_gemv_q16_symm_hybrid_twopass   lam_gemv_q16_symm_hybrid
//
// which no solver runs (lam_tpu_torch/ops/probe.py CONTROLS). Their p
// must be 16-byte aligned (the bulk copies).
//
// The TPU scripts' P (tiles a grid step, the DMA block size) has no
// counterpart: blocks run in no order on 132 SMs, and P=8 is kernel 14's
// blocked form. What bounds each: bytes, as kernel 14 (2 B a stored element
// read once, the scales, p and y; the bound counts only the function's
// bytes, so sub8's 8x partials, 8 rows of TB f32 a strip of an
// off-diagonal tile written and read back, are the walk's own cost and
// not the bound's). The strip walks run one block an SM
// (csrc/strip_walk.cuh).
//
// Scratch (elements): part_d T*tb, part_t T*(tb/64)*tb (sub8: 8x that), f32,
// T = nblk(nblk+1)/2 of the plane's tile width tb (1024 for tb1024, else
// 512). Returns cudaGetLastError() after the launches.

#include "strip_walk.cuh"

namespace {

struct Q16MagicPlane {
  using acc_t = float;
  static constexpr int VEC = 8;
  const short* __restrict__ q;
  const float* __restrict__ s;
  float sc;
  __device__ __forceinline__ void set_tile(int t) { sc = __ldg(s + t); }
  __device__ __forceinline__ acc_t p_scale() const { return sc; }
  __device__ __forceinline__ void load(size_t off, acc_t v[VEC]) const {
    const int4 x = __ldcs(reinterpret_cast<const int4*>(q + off));
    const unsigned w[4] = {(unsigned)x.x, (unsigned)x.y, (unsigned)x.z,
                           (unsigned)x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __int_as_float((int)(((w[j] & 0xffffu) ^ 0x8000u) |
                                      0x4B000000u)) - 8421376.0f;
      v[2 * j + 1] = __int_as_float((int)(((w[j] >> 16) ^ 0x8000u) |
                                          0x4B000000u)) - 8421376.0f;
    }
  }
};

}  // namespace

extern "C" int lam_gemv_q16_symm_magic(const short* q1, const float* s1,
                                       const float* p, float* y,
                                       float* part_d, float* part_t, int nblk,
                                       void* stream) {
  return launch(Q16MagicPlane{q1, s1, 0.0f}, F32Vec{p}, F32Out{y}, part_d,
                part_t, nblk, (cudaStream_t)stream);
}

extern "C" int lam_gemv_q16_symm_tb1024(const short* q1, const float* s1,
                                        const float* p, float* y,
                                        float* part_d, float* part_t,
                                        int nblk, void* stream) {
  return launch<1024>(Q16Plane{q1, s1, 0.0f}, F32Vec{p}, F32Out{y}, part_d,
                      part_t, nblk, (cudaStream_t)stream);
}

extern "C" int lam_gemv_q16_symm_sub8(const short* q1, const float* s1,
                                      const float* p, float* y, float* part_d,
                                      float* part_t, int nblk, void* stream) {
  return launch_strip_tri<SymmSub8Cfg>(StripPlanes<1>{{q1}, {s1}},
                                       StripVecs<1>{{p}, {p}}, F32Out{y},
                                       part_d, part_t, nblk,
                                       (cudaStream_t)stream);
}

extern "C" int lam_gemv_q16_symm_sub8_twopass(const short* q1,
                                              const float* s1, const float* p,
                                              float* y, float* part_d,
                                              float* part_t, int nblk,
                                              void* stream) {
  return launch<TB, WARPS>(Q16Plane{q1, s1, 0.0f}, F32Vec{p}, F32Out{y},
                           part_d, part_t, nblk, (cudaStream_t)stream);
}

extern "C" int lam_gemv_q16_symm_split(const short* q1, const float* s1,
                                       const float* p, float* y,
                                       float* part_d, float* part_t, int nblk,
                                       void* stream) {
  return launch_strip_tri<SymmSplitCfg>(StripPlanes<1>{{q1}, {s1}},
                                        StripVecs<1>{{p}, {p}}, F32Out{y},
                                        part_d, part_t, nblk,
                                        (cudaStream_t)stream);
}

extern "C" int lam_gemv_q16_symm_split_twopass(const short* q1,
                                               const float* s1,
                                               const float* p, float* y,
                                               float* part_d, float* part_t,
                                               int nblk, void* stream) {
  return launch(Q16MmaPlane<MMA_SPLIT>{q1, s1}, F32Vec{p}, F32Out{y}, part_d,
                part_t, nblk, (cudaStream_t)stream);
}

extern "C" int lam_gemv_q16_symm_hi(const short* q1, const float* s1,
                                    const float* p, float* y, float* part_d,
                                    float* part_t, int nblk, void* stream) {
  return launch_strip_tri<SymmHiCfg>(StripPlanes<1>{{q1}, {s1}},
                                     StripVecs<1>{{p}, {p}}, F32Out{y},
                                     part_d, part_t, nblk,
                                     (cudaStream_t)stream);
}

extern "C" int lam_gemv_q16_symm_hi_twopass(const short* q1, const float* s1,
                                            const float* p, float* y,
                                            float* part_d, float* part_t,
                                            int nblk, void* stream) {
  return launch(Q16MmaPlane<MMA_HI>{q1, s1}, F32Vec{p}, F32Out{y}, part_d,
                part_t, nblk, (cudaStream_t)stream);
}

extern "C" int lam_gemv_q16_symm_hybrid(const short* q1, const float* s1,
                                        const float* p, float* y,
                                        float* part_d, float* part_t,
                                        int nblk, void* stream) {
  return launch_strip_tri<SymmHybridCfg>(StripPlanes<1>{{q1}, {s1}},
                                         StripVecs<1>{{p}, {p}}, F32Out{y},
                                         part_d, part_t, nblk,
                                         (cudaStream_t)stream);
}

extern "C" int lam_gemv_q16_symm_hybrid_twopass(const short* q1,
                                                const float* s1,
                                                const float* p, float* y,
                                                float* part_d, float* part_t,
                                                int nblk, void* stream) {
  return launch(Q16MmaPlane<MMA_HYBRID>{q1, s1}, F32Vec{p}, F32Out{y}, part_d,
                part_t, nblk, (cudaStream_t)stream);
}
