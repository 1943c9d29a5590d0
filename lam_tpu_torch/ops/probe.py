"""The q16 probes: lam_tpu's TPU experiments on the q16 walk, on the card.

lam_tpu measured which design choices of its q16 kernel cost time with
standalone Pallas kernels in scripts/q16_probe{,2,3,4}.py, on a
tridiagonal plane whose result is known in closed form. Each is a kernel
here, with a plain PyTorch version beside it:

    stream_i16            <- q16_probe.py _floor_kernel (:91, pallas_call
                             :139), q16_probe2.py _floor_kernel (:89, :142)
    convert_f32_sum       <- q16_probe.py _convert_kernel (:110, via
                             _micro_pass :126, :139)
    gemv_q16_symm_magic   <- q16_probe.py _pair_kernel, magic=True (:169;
                             gemv_pair :232, :270)
    gemv_q16_symm_tb1024  <- q16_probe.py's base walk at tb=1024 (:342-363)
                             and q16_probe3.py's full kernel at tb=1024
    gemv_q16_symm_sub8    <- q16_probe2.py _multi_kernel, sub=8 (:157;
                             gemv_q16_multi :202, :241)
    gemv_q16_symm_split   <- q16_probe4.py _mxu_kernel, mode split (:63;
    gemv_q16_symm_hi         gemv_q16_mxu :156, :206), hi and hybrid
    gemv_q16_symm_hybrid

The scripts' other variants are kernels of the solver: `pair` (int16
pairs unpacked from int32 lanes) is what every q16 kernel's load does,
`multi` with sub=1 is kernel 14's blocked form (`gemv.gemv_q16_symm`, exact
products) and mxu mode `def` is `gemv.gemv_q16_symm_bf16`. The scripts' P,
tiles a TPU grid step, has no counterpart on the card. `tridiag_q1` builds
the scripts' plane on the device.

`stream_i16` returns the int64 sum of an int16 plane's values, read once
in 16-byte streaming loads (csrc/probe.cu): timed on a kernel's plane it is
the card's measured read floor for those bytes, beside the data sheet's
3.35 TB/s. `convert_f32_sum` is the same stream with each value converted
to f32 and summed in f32 by thread, in f64 across threads. The six walks
(csrc/q16_probe.cu) compute kernel 14's y ~= A @ p over a packed q16
plane (int16 walk-order triangle tiles, T or padded Ts of them, against
per-tile power-of-two scales s1, folded into p per tile): `magic`
dequantizes without a conversion instruction (exact: y equals kernel 14's
bit for bit), `tb1024` walks 1024-wide tiles, `sub8` keeps 8 unreduced
transpose partial rows a strip, `split`, `hi` and `hybrid` take their
products on the tensor cores from an exact bf16 split ah + al of the tile
(split: with p * s rounded to bf16; hi: f32-faithful, p * s split into
three bf16 parts; hybrid: hi's transpose term, the direct term as f32
FMAs). Their plain versions: the exact f32 walk, `split` with p * s
rounded to bf16.

`sub8` runs on the strip walk (csrc/strip_walk.cuh) with exact summing
consumers, each warp storing its own transpose row with no barrier;
`split`, `hi` and `hybrid` on the strip walk with tensor-core consumers.
Their p must be 16-byte aligned on the card. Their two-pass walks are
their controls, `gemv_q16_symm_sub8_twopass`,
`gemv_q16_symm_split_twopass`, `gemv_q16_symm_hi_twopass` and
`gemv_q16_symm_hybrid_twopass`, with the same arguments, checks and bits.

Beside them, the earlier walks of six solver kernels that a later walk
replaced, kept as controls: `gemv_df64_rows` is kernel 6's function
(`gemv.gemv_df64_cols`) on the dense_rows walk of csrc/gemv_dense.cu; on
the two-pass walk of csrc/symm_walk.cuh `gemv_q16_symm_slab_twopass` is
kernel 16's (`gemv.gemv_q16_symm_slab`, exact products),
`gemv_q16_dual_twopass` kernel 18's (`gemv.gemv_q16_dual`, exact products),
`gemv_fq_dual_twopass` kernel 19's (`gemv.gemv_fq_dual`) and
`gemv_q16_dual_bf16_twopass` kernel 18-bf16's (`gemv.gemv_q16_dual_bf16`,
q16_bf16_pass1 and rect_pass2); `laplace5_f32_halo_twopass` is kernel 20's
(`stencil.laplace5_f32_halo`) in csrc/stencil.cu's two launches. Each gives
its kernel's bits on the same bytes, takes its arguments and refuses what
it refuses; chip_smoke.py times each in turns with its kernel.

These are measuring tools, not kernels of the solver's path: they stay out
of the solver's registry (lam_tpu_torch.ops.KERNELS) and keep their own,
`PROBES` (launches) and `PROBES_PLAIN` (calls), with `reset_counters()`
and `counters()`. As in lam_tpu_torch.ops, a CUDA tensor launches the
kernel or raises, and only a CPU tensor takes the plain version.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from lam_tpu_torch.ops import gemv, layout, stencil

BLOCKS_PER_SM = 8
SCALE = 2.0 ** -14   # the probe plane's scale: q = 16384 holds 1.0
MAGIC = 0x4B000000   # the bits of 2^23
MAGIC_BIAS = 8421376.0  # 2^23 + 2^15


def tridiag_q1(n, tb, *, pad_to=None, device):
    """The q16 probes' plane (scripts/q16_probe.py:51 build_q1, and
    q16_probe2.py:50 with pad_to=8), built on `device` with no host copy
    of it: the walk-order q1 plane of the {2,1} tridiagonal n x n matrix
    with the diagonal taken out (its off-diagonal 1 stored as 16384 against
    scale 2^-14), as (q1 (Tp*tb, tb) int16, scales (Tp,) f32, it, kt (Tp,)
    int32). With pad_to, the tile count T is padded to a multiple of it
    with (nblk-1, nblk-1) tiles of scale 0 (their band is stored, as the
    script's are, and their scale makes them inert)."""
    if tb < layout._LANES or tb & (tb - 1) or n % tb:
        raise ValueError(f"tridiag_q1: n={n} must be a multiple of a "
                         f"power-of-two tb >= {layout._LANES}, got tb={tb}")
    device = torch.device(device)
    nblk = n // tb
    it, kt = layout._symm_tables(nblk)
    T = len(it)
    Tp = T if pad_to is None else -(-T // pad_to) * pad_to
    it = np.concatenate([it, np.full(Tp - T, nblk - 1, np.int32)])
    kt = np.concatenate([kt, np.full(Tp - T, nblk - 1, np.int32)])
    it, kt = (torch.from_numpy(x).to(device) for x in (it, kt))
    q1 = torch.zeros(Tp * tb, tb, dtype=torch.int16, device=device)
    tiles = q1.view(Tp, tb, tb)
    qval = round(1.0 / SCALE)
    band = torch.nonzero(it == kt).flatten()[:, None]
    r = torch.arange(tb - 1, device=device)
    tiles[band, r, r + 1] = qval
    tiles[band, r + 1, r] = qval
    tiles[torch.nonzero(it == kt + 1).flatten(), 0, tb - 1] = qval
    sc = torch.zeros(Tp, dtype=torch.float32, device=device)
    sc[:T] = SCALE
    return q1, sc, it, kt


def magic_f32(q):
    """int16 -> f32 as csrc/q16_probe.cu dequantizes, by bits alone: the
    int16 biased to unsigned by a sign-bit xor, ORed into the mantissa of
    2^23, read as f32, minus 2^23 + 2^15. Exact: equal to q.float()."""
    u = (q.to(torch.int32) & 0xFFFF) ^ 0x8000
    return (u | MAGIC).view(torch.float32) - MAGIC_BIAS


_I2F = re.compile(r"^(?:@!?U?P\w+\s+)?(I2FP?(?:\.\w+)*)\s")


def f32_conversions(sass_lines):
    """The instructions among a kernel's SASS lines (`_build.sass()`) that
    convert an integer to f32: I2F/I2FP with no F64 destination."""
    out = []
    for line in sass_lines:
        m = _I2F.match(line.split("*/", 1)[-1].strip())
        if m and ".F64" not in m.group(1):
            out.append(line)
    return out


# -- the streams --------------------------------------------------------------

def stream_i16_plain(plane):
    """Plain PyTorch checksum: the int64 sum of the plane's values."""
    stream_i16_plain.calls += 1
    return plane.to(torch.int64).sum()


def convert_f32_sum_plain(plane):
    """Plain PyTorch sum of the plane's values in f64 (exact where the
    kernel's per-thread f32 sums are)."""
    convert_f32_sum_plain.calls += 1
    return plane.to(torch.float64).sum()


def _stream(wrapper, plain, entry, dtype, plane):
    what = wrapper.__name__
    if plane.dtype != torch.int16 or not plane.is_contiguous():
        raise ValueError(f"{what}: plane must be a contiguous int16 tensor")
    if plane.numel() == 0 or plane.numel() % 8:
        raise ValueError(f"{what}: {plane.numel()} elements, need a "
                         "positive multiple of 8")
    if plane.device.type == "cpu":
        return plain(plane)
    if plane.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {plane.device}")
    if plane.data_ptr() % 16:
        raise ValueError(f"{what}: plane must be 16-byte aligned")
    from lam_tpu_torch.ops._build import library
    lib = library()
    sms = torch.cuda.get_device_properties(plane.device).multi_processor_count
    blocks = BLOCKS_PER_SM * sms
    part = torch.empty(blocks, dtype=dtype, device=plane.device)
    out = torch.empty((), dtype=dtype, device=plane.device)
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(plane.data_ptr(), plane.numel() // 8,
                                   blocks, part.data_ptr(), out.data_ptr(),
                                   stream)
    wrapper.launches += 1
    gemv._raise_on(what, code)
    return out


def stream_i16(plane):
    """The int64 sum of a contiguous int16 tensor (any shape, a multiple
    of 8 elements, 16-byte aligned on the card): on a CUDA tensor the
    streaming kernel of csrc/probe.cu, on a CPU tensor the plain
    version."""
    return _stream(stream_i16, stream_i16_plain, "lam_stream_i16",
                   torch.int64, plane)


def convert_f32_sum(plane):
    """The f64 sum of a contiguous int16 tensor's values, each converted to
    f32 and summed in f32 by each of the kernel's threads (a multiple of 8
    elements, 16-byte aligned on the card): on a CUDA tensor the converting
    stream of csrc/probe.cu, on a CPU tensor the plain version."""
    return _stream(convert_f32_sum, convert_f32_sum_plain, "lam_convert_i16",
                   torch.float64, plane)


def convert_threads(device):
    """Threads of the converting stream on `device`: each sums at most
    ceil(numel / 8 / threads) 16-byte vectors in f32."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return BLOCKS_PER_SM * sms * 256


# -- the walks ----------------------------------------------------------------

def _walk_plain(q1, s1, p, what, tile_f32=None, rounding=None):
    tb, nblk, _ = layout.packed_geometry(q1.shape, p.shape[0], what,
                                         padded=True)
    T = layout.tri_tile_count(nblk)
    tiles = (tile_f32 or (lambda q: q.to(torch.float32)))(q1[:T * tb])
    return gemv._walk(tiles.reshape(T, tb, tb), p, nblk, s1[:T], rounding)


def gemv_q16_symm_magic_plain(q1, s1, p):
    """Plain version of `gemv_q16_symm_magic`: the exact f32 walk, the
    tiles dequantized by `magic_f32`."""
    gemv_q16_symm_magic_plain.calls += 1
    return _walk_plain(q1, s1, p, "gemv_q16_symm_magic", magic_f32)


def gemv_q16_symm_tb1024_plain(q1, s1, p):
    """Plain version of `gemv_q16_symm_tb1024`: the exact f32 walk."""
    gemv_q16_symm_tb1024_plain.calls += 1
    return _walk_plain(q1, s1, p, "gemv_q16_symm_tb1024")


def gemv_q16_symm_sub8_plain(q1, s1, p):
    """Plain version of `gemv_q16_symm_sub8`: the exact f32 walk."""
    gemv_q16_symm_sub8_plain.calls += 1
    return _walk_plain(q1, s1, p, "gemv_q16_symm_sub8")


def gemv_q16_symm_split_plain(q1, s1, p):
    """Plain version of `gemv_q16_symm_split`: exact tile values against
    p * s rounded to bf16 (nearest even), f32 sums."""
    gemv_q16_symm_split_plain.calls += 1
    return _walk_plain(q1, s1, p, "gemv_q16_symm_split", rounding=gemv._bf16)


def gemv_q16_symm_hi_plain(q1, s1, p):
    """Plain version of `gemv_q16_symm_hi`: the exact f32 walk (what the
    TPU's HIGHEST-precision dots compute)."""
    gemv_q16_symm_hi_plain.calls += 1
    return _walk_plain(q1, s1, p, "gemv_q16_symm_hi")


def gemv_q16_symm_hybrid_plain(q1, s1, p):
    """Plain version of `gemv_q16_symm_hybrid`: the exact f32 walk."""
    gemv_q16_symm_hybrid_plain.calls += 1
    return _walk_plain(q1, s1, p, "gemv_q16_symm_hybrid")


def _walk(wrapper, plain, tb, sub, q1, s1, p, tma=False):
    """A probe walk: checks, then the plain version on a CPU tensor or the
    kernel lam_<wrapper name> on a CUDA one (sub: transpose partial rows
    a strip kept apart; tma: p must be 16-byte aligned on the card, as
    the strip walk's bulk copies take it)."""
    what = wrapper.__name__
    gemv._check(what, {"q1": q1, "s1": s1, "p": p}, q1.device)
    if tma:
        gemv._check_tma(what, {"p": p})
    geometry = layout.packed_geometry(q1.shape, p.shape[0], what,
                                      padded=True)
    if geometry[0] != tb:
        raise ValueError(f"{what}: takes tb={tb} tiles, got tb={geometry[0]}")
    gemv._check_scales(what, geometry[2], {"s1": s1})
    if q1.device.type == "cpu":
        return plain(q1, s1, p)
    from lam_tpu_torch.ops._build import library
    lib = library()
    nblk = geometry[1]
    T = layout.tri_tile_count(nblk)
    strips = lib.lam_symm_strips() * tb // lib.lam_symm_tile()
    y = torch.empty_like(p)
    part_d = torch.empty(T * tb, dtype=torch.float32, device=q1.device)
    part_t = torch.empty(T * strips * sub * tb, dtype=torch.float32,
                         device=q1.device)
    with torch.cuda.device(q1.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"lam_{what}")(q1.data_ptr(), s1.data_ptr(),
                                           p.data_ptr(), y.data_ptr(),
                                           part_d.data_ptr(),
                                           part_t.data_ptr(), nblk, stream)
    wrapper.launches += 1
    gemv._raise_on(what, code)
    return y


def gemv_q16_symm_magic(q1, s1, p):
    """Kernel 14's exact walk (tb=512) with the bit-trick dequantization:
    no int -> f32 conversion instruction; y equals `gemv.gemv_q16_symm`'s
    exact body bit for bit."""
    return _walk(gemv_q16_symm_magic, gemv_q16_symm_magic_plain, 512, 1,
                 q1, s1, p)


def gemv_q16_symm_tb1024(q1, s1, p):
    """Kernel 14's exact walk on a plane of 1024-wide tiles."""
    return _walk(gemv_q16_symm_tb1024, gemv_q16_symm_tb1024_plain, 1024, 1,
                 q1, s1, p)


def gemv_q16_symm_sub8(q1, s1, p):
    """Kernel 14's exact walk (tb=512) with each warp's transpose partial
    row kept: 8 a strip, summed by pass 2 (8x the partial bytes). The
    strip walk: p 16-byte aligned on the card."""
    return _walk(gemv_q16_symm_sub8, gemv_q16_symm_sub8_plain, 512, 8,
                 q1, s1, p, tma=True)


def gemv_q16_symm_split(q1, s1, p):
    """The q16 walk (tb=512) on the tensor cores: tile a = ah + al split
    exactly into bf16, p * s rounded once to bf16, f32 sums. The strip
    walk with tensor-core consumers (csrc/strip_walk.cuh): p 16-byte
    aligned on the card."""
    return _walk(gemv_q16_symm_split, gemv_q16_symm_split_plain, 512, 1,
                 q1, s1, p, tma=True)


def gemv_q16_symm_hi(q1, s1, p):
    """The q16 walk (tb=512) on the tensor cores with f32-faithful
    products: ah + al against p * s split into three bf16 parts, the five
    products above f32 rounding, f32 sums. The strip walk with
    tensor-core consumers: p 16-byte aligned on the card."""
    return _walk(gemv_q16_symm_hi, gemv_q16_symm_hi_plain, 512, 1,
                 q1, s1, p, tma=True)


def gemv_q16_symm_hybrid(q1, s1, p):
    """The q16 walk (tb=512): the direct term as f32 FMAs on the CUDA
    cores, the transpose term on the tensor cores as in `hi`. The strip
    walk with tensor-core consumers: p 16-byte aligned on the card."""
    return _walk(gemv_q16_symm_hybrid, gemv_q16_symm_hybrid_plain, 512, 1,
                 q1, s1, p, tma=True)


# -- the controls -------------------------------------------------------------

def gemv_df64_rows_plain(a_hi, a_lo, p_hi, p_lo, blk):
    """Plain version of `gemv_df64_rows`: `gemv.gemv_df64_cols_plain`'s
    f64 product."""
    gemv_df64_rows_plain.calls += 1
    return gemv._df64_cols(a_hi, a_lo, p_hi, p_lo, blk)


def gemv_df64_rows(a_hi, a_lo, p_hi, p_lo, blk):
    """`gemv.gemv_df64_cols` (the same arguments, checks and bits) on the
    dense_rows walk: (y_hi, y_lo) (m,) = A[:, blk*nb:(blk+1)*nb] @ p for
    A = a_hi + a_lo, p = p_hi + p_lo (nb,); with nb = n and blk = 0, the
    bits of `gemv.gemv_df64` on the square or row block."""
    what = "gemv_df64_rows"
    blk, m, n, nb = gemv._df64_cols_geometry(what, a_hi, a_lo, p_hi, p_lo,
                                             blk)
    if a_hi.device.type == "cpu":
        return gemv_df64_rows_plain(a_hi, a_lo, p_hi, p_lo, blk)
    from lam_tpu_torch.ops._build import library
    lib = library()
    y_hi = torch.empty(m, dtype=torch.float32, device=a_hi.device)
    y_lo = torch.empty(m, dtype=torch.float32, device=a_hi.device)
    c0 = blk * nb * a_hi.element_size()  # the block's first column, bytes
    with torch.cuda.device(a_hi.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lam_gemv_df64_rows(a_hi.data_ptr() + c0,
                                      a_lo.data_ptr() + c0, p_hi.data_ptr(),
                                      p_lo.data_ptr(), y_hi.data_ptr(),
                                      y_lo.data_ptr(), m, nb, n, stream)
    gemv_df64_rows.launches += 1
    gemv._raise_on(what, code)
    return y_hi, y_lo


def gemv_q16_symm_slab_twopass_plain(q1_slab, sc1, p, it, kt, lt, *, ms):
    """Plain version of `gemv_q16_symm_slab_twopass`:
    `gemv.gemv_q16_symm_slab_plain`'s f32 walk."""
    gemv_q16_symm_slab_twopass_plain.calls += 1
    return gemv._q16_slab_parts(q1_slab, sc1, p, it, kt, lt, ms)


def gemv_q16_symm_slab_twopass(q1_slab, sc1, p, it, kt, lt, *, ms):
    """`gemv.gemv_q16_symm_slab` with exact products (the same arguments,
    checks and bits) on the two-pass walk: (yd (ms,), yt (n,))."""
    return gemv._q16_slab(gemv_q16_symm_slab_twopass,
                          gemv_q16_symm_slab_twopass_plain,
                          "lam_gemv_q16_symm_slab_twopass", q1_slab, sc1, p,
                          it, kt, lt, ms)


def gemv_q16_dual_twopass_plain(q1buf, sc, p, q):
    """Plain version of `gemv_q16_dual_twopass`:
    `gemv.gemv_q16_dual_plain`'s f32 walk."""
    gemv_q16_dual_twopass_plain.calls += 1
    return gemv._q16_dual_parts(q1buf, sc, p, q)


def gemv_q16_dual_twopass(q1buf, sc, p, q):
    """`gemv.gemv_q16_dual` with exact products (the same arguments,
    checks and bits) on the two-pass walk: (S @ p, S^T @ q)."""
    return gemv._q16_dual(gemv_q16_dual_twopass, gemv_q16_dual_twopass_plain,
                          "lam_gemv_q16_dual_twopass", q1buf, sc, p, q)


def gemv_fq_dual_twopass_plain(q1, q2, q3, s1, s2, s3, p_hi, p_lo, q_hi,
                               q_lo):
    """Plain version of `gemv_fq_dual_twopass`:
    `gemv.gemv_fq_dual_plain`'s f64 walk."""
    gemv_fq_dual_twopass_plain.calls += 1
    return gemv._fq_dual_parts(((q1, s1), (q2, s2), (q3, s3)), p_hi, p_lo,
                               q_hi, q_lo)


def gemv_fq_dual_twopass(q1, q2, q3, s1, s2, s3, p_hi, p_lo, q_hi, q_lo, *,
                         comp=None):
    """`gemv.gemv_fq_dual` (the same arguments, checks and bits) on the
    two-pass walk: (yd_hi, yd_lo, yt_hi, yt_lo)."""
    return gemv._fq_dual(gemv_fq_dual_twopass, gemv_fq_dual_twopass_plain,
                         "lam_gemv_fq_dual_twopass", q1, q2, q3, s1, s2, s3,
                         p_hi, p_lo, q_hi, q_lo, comp)


def gemv_q16_dual_bf16_twopass_plain(q1buf, sc, p, q):
    """Plain version of `gemv_q16_dual_bf16_twopass`:
    `gemv.gemv_q16_dual_bf16_plain`'s bf16 walk."""
    gemv_q16_dual_bf16_twopass_plain.calls += 1
    return gemv._q16_dual_bf16_parts(q1buf, sc, p, q)


def gemv_q16_dual_bf16_twopass(q1buf, sc, p, q):
    """`gemv.gemv_q16_dual_bf16` (the same arguments, checks and bits) on
    the two-pass walk: (S @ p, S^T @ q) with bf16 tensor-core products."""
    return gemv._q16_dual(gemv_q16_dual_bf16_twopass,
                          gemv_q16_dual_bf16_twopass_plain,
                          "lam_gemv_q16_dual_bf16_twopass", q1buf, sc, p, q)


def gemv_q16_symm_sub8_twopass_plain(q1, s1, p):
    """Plain version of `gemv_q16_symm_sub8_twopass`:
    `gemv_q16_symm_sub8_plain`'s exact f32 walk."""
    gemv_q16_symm_sub8_twopass_plain.calls += 1
    return _walk_plain(q1, s1, p, "gemv_q16_symm_sub8_twopass")


def gemv_q16_symm_sub8_twopass(q1, s1, p):
    """`gemv_q16_symm_sub8` (the same arguments, checks and bits) on the
    two-pass walk, symm_pass1 with 8 transpose rows a strip and
    symm_pass2."""
    return _walk(gemv_q16_symm_sub8_twopass,
                 gemv_q16_symm_sub8_twopass_plain, 512, 8, q1, s1, p,
                 tma=True)


def gemv_q16_symm_split_twopass_plain(q1, s1, p):
    """Plain version of `gemv_q16_symm_split_twopass`:
    `gemv_q16_symm_split_plain`'s walk."""
    gemv_q16_symm_split_twopass_plain.calls += 1
    return _walk_plain(q1, s1, p, "gemv_q16_symm_split_twopass",
                       rounding=gemv._bf16)


def gemv_q16_symm_split_twopass(q1, s1, p):
    """`gemv_q16_symm_split` (the same arguments, checks and bits) on the
    two-pass walk, q16_bf16_pass1 and symm_pass2."""
    return _walk(gemv_q16_symm_split_twopass,
                 gemv_q16_symm_split_twopass_plain, 512, 1, q1, s1, p,
                 tma=True)


def gemv_q16_symm_hi_twopass_plain(q1, s1, p):
    """Plain version of `gemv_q16_symm_hi_twopass`:
    `gemv_q16_symm_hi_plain`'s exact f32 walk."""
    gemv_q16_symm_hi_twopass_plain.calls += 1
    return _walk_plain(q1, s1, p, "gemv_q16_symm_hi_twopass")


def gemv_q16_symm_hi_twopass(q1, s1, p):
    """`gemv_q16_symm_hi` (the same arguments, checks and bits) on the
    two-pass walk, q16_bf16_pass1 and symm_pass2."""
    return _walk(gemv_q16_symm_hi_twopass, gemv_q16_symm_hi_twopass_plain,
                 512, 1, q1, s1, p, tma=True)


def gemv_q16_symm_hybrid_twopass_plain(q1, s1, p):
    """Plain version of `gemv_q16_symm_hybrid_twopass`:
    `gemv_q16_symm_hybrid_plain`'s exact f32 walk."""
    gemv_q16_symm_hybrid_twopass_plain.calls += 1
    return _walk_plain(q1, s1, p, "gemv_q16_symm_hybrid_twopass")


def gemv_q16_symm_hybrid_twopass(q1, s1, p):
    """`gemv_q16_symm_hybrid` (the same arguments, checks and bits) on the
    two-pass walk, q16_bf16_pass1 and symm_pass2."""
    return _walk(gemv_q16_symm_hybrid_twopass,
                 gemv_q16_symm_hybrid_twopass_plain, 512, 1, q1, s1, p,
                 tma=True)


def laplace5_f32_halo_twopass_plain(p2d, up_edge, dn_edge, nrows_valid, *,
                                    nxi):
    """Plain version of `laplace5_f32_halo_twopass`:
    `stencil.laplace5_f32_halo_plain`'s cells and sum."""
    laplace5_f32_halo_twopass_plain.calls += 1
    y = stencil.laplace5_masked(p2d, up_edge, dn_edge, nrows_valid, nxi)
    return y, torch.sum(p2d * y)


def laplace5_f32_halo_twopass(p2d, up_edge, dn_edge, nrows_valid, *, nxi,
                              tbr):
    """`stencil.laplace5_f32_halo` (the same arguments, checks and bits) in
    two launches: the stencil and its blocks' partial dots, then one block
    that sums them."""
    return stencil._laplace5(laplace5_f32_halo_twopass,
                             laplace5_f32_halo_twopass_plain,
                             "lam_laplace5_f32_halo_twopass", p2d, up_edge,
                             dn_edge, nrows_valid, nxi, tbr)


CONTROLS = (gemv_df64_rows, gemv_q16_symm_slab_twopass, gemv_q16_dual_twopass,
            gemv_fq_dual_twopass, gemv_q16_dual_bf16_twopass,
            laplace5_f32_halo_twopass, gemv_q16_symm_sub8_twopass,
            gemv_q16_symm_split_twopass, gemv_q16_symm_hi_twopass,
            gemv_q16_symm_hybrid_twopass)  # not TPU kernels
PROBES = (stream_i16, convert_f32_sum, gemv_q16_symm_magic,
          gemv_q16_symm_tb1024, gemv_q16_symm_sub8, gemv_q16_symm_split,
          gemv_q16_symm_hi, gemv_q16_symm_hybrid) + CONTROLS
PROBES_PLAIN = (stream_i16_plain, convert_f32_sum_plain,
                gemv_q16_symm_magic_plain, gemv_q16_symm_tb1024_plain,
                gemv_q16_symm_sub8_plain, gemv_q16_symm_split_plain,
                gemv_q16_symm_hi_plain, gemv_q16_symm_hybrid_plain,
                gemv_df64_rows_plain, gemv_q16_symm_slab_twopass_plain,
                gemv_q16_dual_twopass_plain, gemv_fq_dual_twopass_plain,
                gemv_q16_dual_bf16_twopass_plain,
                laplace5_f32_halo_twopass_plain,
                gemv_q16_symm_sub8_twopass_plain,
                gemv_q16_symm_split_twopass_plain,
                gemv_q16_symm_hi_twopass_plain,
                gemv_q16_symm_hybrid_twopass_plain)


def reset_counters():
    for fn in PROBES:
        fn.launches = 0
    for fn in PROBES_PLAIN:
        fn.calls = 0


def counters():
    """{name: count} of probe kernel launches and plain-version calls."""
    out = {fn.__name__: fn.launches for fn in PROBES}
    out.update({fn.__name__: fn.calls for fn in PROBES_PLAIN})
    return out


reset_counters()
