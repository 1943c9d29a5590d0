"""Matvecs over packed lower-triangle storage and over full squares.

Each function here replaces one Pallas kernel of lam_tpu/ops/gemv.py.
The symmetric ones work on the walk-order packed layout of
`layout.pack_tri_host`:

    gemv_f32_symm   <- gemv_f32_symm(packed=True)   (gemv.py:455)
    gemv_df64_symm  <- gemv_df64_symm(packed=True)  (gemv.py:1008)
    gemv_dfq_symm   <- gemv_dfq_symm                (gemv.py:1172)
    gemv_q16_symm   <- gemv_q16_symm                (gemv.py:2065)
    gemv_fq_symm    <- gemv_fq_symm                 (gemv.py:2164)

`gemv_dfq_symm` reads the dfq storage: the f32 hi plane plus the lo
plane quantized to int16 against one power-of-two scale per tile
(`layout.quantize_lo_tiles`), T tiles exactly. The q16 and fq kernels
read the fq cascade of `layout.quantize_fq_tiles`: int16 planes against
per-tile power-of-two scales, stored padded to a multiple of Q16_P
tiles (the pad tiles are never read). The dense ones take a row-major
(m, n) matrix, square or a row block, the full-square engine:

    gemv_f32        <- gemv_f32 (both impls)        (gemv.py:143)
    gemv_df64       <- gemv_df64                    (gemv.py:812)

The row shards of the 1-D sharded backends (lam_tpu_torch/parallel) add
four. The ring's partial matvecs read one column block of a rank's row
block in place; the band-pair slab walks read one rank's share of the
triangle, steered by int32 walk tables (it, kt, lt), from its full-row
slab or from its walk-order packed buffer, and return the direct terms
yd over the rank's rows and the transpose terms yt over all columns:

    gemv_f32_cols        <- gemv_f32_cols           (gemv.py:216)
    gemv_df64_cols       <- gemv_df64_cols          (gemv.py:761)
    gemv_f32_symm_slab   <- gemv_f32_symm_slab      (gemv.py:552)
    gemv_df64_symm_slab  <- gemv_df64_symm_slab     (gemv.py:1267)

On a CUDA tensor a wrapper launches the hand-written Hopper kernel of
csrc/gemv_symm.cu or csrc/gemv_dense.cu (built at first use by
`_build`) on the current stream, or raises. On a CPU tensor, and only
there, it runs the plain PyTorch version beside it (`*_plain`), which
the CPU tests hold against the JAX package and chip_smoke.py holds the
kernel against on the card.

Each wrapper counts its kernel launches in `.launches`, and each plain
version its calls in `.calls`, so a run can show which path it took
(`reset_counters`, `counters`: the registry of lam_tpu_torch.ops, which
covers the stencil kernel too).
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from lam_tpu_torch.ops import layout
from lam_tpu_torch.precision import split_f64


def _walk_into(yd, yt, tiles, p, it, kt, lt, scale=None):
    """Plain walk of tiles (T, tb, tb) sitting at blocks (it, kt) of the
    matrix, p (n,) in the tiles' dtype, tables int64: direct terms
    A p_kt are added into the row tiles yd[lt], transpose terms A^T p_it
    of the off-diagonal tiles into the column tiles yt[kt]. A per-tile
    `scale` (T,) is folded into p."""
    tb = tiles.shape[1]
    pb = p.reshape(-1, tb)
    pk, pi = pb[kt], pb[it]
    if scale is not None:
        pk, pi = pk * scale[:, None], pi * scale[:, None]
    yd.index_add_(0, lt, torch.einsum("tij,tj->ti", tiles, pk))
    off = torch.nonzero(kt < it).flatten()
    if off.numel():
        trans = torch.einsum("tij,ti->tj", tiles[off], pi[off])
        yt.index_add_(0, kt[off], trans)


def _walk(tiles, p, nblk, scale=None):
    """Plain triangle walk: tiles (T, tb, tb) and p (n,) in one dtype.
    Direct terms scatter by row tile, transpose terms (off-diagonal tiles
    only) by column tile. A per-tile `scale` (T,) is folded into p."""
    tb = tiles.shape[1]
    it, kt = (torch.as_tensor(x, dtype=torch.long, device=tiles.device)
              for x in layout._symm_tables(nblk))
    y = torch.zeros(nblk, tb, dtype=p.dtype, device=p.device)
    _walk_into(y, y, tiles, p, it, kt, it, scale)
    return y.reshape(-1)


def gemv_f32_symm_plain(a, p):
    """Plain PyTorch y = A @ p in f32 over packed tiles a (T*tb, tb)."""
    gemv_f32_symm_plain.calls += 1
    tb, nblk, T = layout.packed_geometry(a.shape, p.shape[0],
                                         "gemv_f32_symm")
    return _walk(a.reshape(T, tb, tb), p, nblk)


def gemv_df64_symm_plain(a_hi, a_lo, p_hi, p_lo):
    """Plain PyTorch (y_hi, y_lo) = A @ p, computed in float64 from the
    (hi, lo) planes and returned as the f32 split of the f64 result."""
    gemv_df64_symm_plain.calls += 1
    tb, nblk, T = layout.packed_geometry(a_hi.shape, p_hi.shape[0],
                                         "gemv_df64_symm")
    tiles = (a_hi.to(torch.float64) + a_lo.to(torch.float64)).reshape(
        T, tb, tb)
    p = p_hi.to(torch.float64) + p_lo.to(torch.float64)
    return split_f64(_walk(tiles, p, nblk))


def gemv_dfq_symm_plain(a_hi, a_loq, sc, p_hi, p_lo):
    """Plain PyTorch (y_hi, y_lo) = A @ p, computed in float64 from the
    tiles hi + loq * sc (exact products, one rounding per element) and
    returned as the f32 split of the f64 result."""
    gemv_dfq_symm_plain.calls += 1
    tb, nblk, T = layout.packed_geometry(a_hi.shape, p_hi.shape[0],
                                         "gemv_dfq_symm")
    tiles = (a_hi.to(torch.float64).reshape(T, tb, tb)
             + a_loq.to(torch.float64).reshape(T, tb, tb)
             * sc.to(torch.float64)[:, None, None])
    p = p_hi.to(torch.float64) + p_lo.to(torch.float64)
    return split_f64(_walk(tiles, p, nblk))


def gemv_q16_symm_plain(q1, s1, p):
    """Plain PyTorch y ~= A @ p in f32 from the q1 plane (int16 tiles,
    per-tile power-of-two scales s1, folded into p per tile), over the
    real triangle tiles of an exact or padded plane."""
    gemv_q16_symm_plain.calls += 1
    tb, nblk, _ = layout.packed_geometry(q1.shape, p.shape[0],
                                         "gemv_q16_symm", padded=True)
    T = layout.tri_tile_count(nblk)
    tiles = q1[:T * tb].to(torch.float32).reshape(T, tb, tb)
    return _walk(tiles, p, nblk, s1[:T])


def gemv_fq_symm_plain(q1, q2, q3, s1, s2, s3, p_hi, p_lo):
    """Plain PyTorch (y_hi, y_lo) = A @ p, computed in float64 from the
    three-plane fq cascade over the real triangle tiles and returned as
    the f32 split of the f64 result."""
    gemv_fq_symm_plain.calls += 1
    tb, nblk, _ = layout.packed_geometry(q1.shape, p_hi.shape[0],
                                         "gemv_fq_symm", padded=True)
    T = layout.tri_tile_count(nblk)
    tiles = sum(q[:T * tb].to(torch.float64).reshape(T, tb, tb)
                * s[:T].to(torch.float64)[:, None, None]
                for q, s in ((q1, s1), (q2, s2), (q3, s3)))
    p = p_hi.to(torch.float64) + p_lo.to(torch.float64)
    return split_f64(_walk(tiles, p, nblk))


def gemv_f32_plain(a, p):
    """Plain PyTorch y = A @ p in f32 for a row-major (m, n) f32 A."""
    gemv_f32_plain.calls += 1
    return torch.mv(a, p)


def gemv_df64_plain(a_hi, a_lo, p_hi, p_lo):
    """Plain PyTorch (y_hi, y_lo) = A @ p for A = a_hi + a_lo (m, n),
    computed in float64 and returned as the f32 split of the result."""
    gemv_df64_plain.calls += 1
    a = a_hi.to(torch.float64) + a_lo.to(torch.float64)
    return split_f64(torch.mv(a, p_hi.to(torch.float64)
                              + p_lo.to(torch.float64)))


def gemv_f32_cols_plain(a, p_blk, blk):
    """Plain PyTorch y = A[:, blk*nb:(blk+1)*nb] @ p_blk in f32."""
    gemv_f32_cols_plain.calls += 1
    nb = p_blk.shape[0]
    return torch.mv(a[:, blk * nb:(blk + 1) * nb], p_blk)


def gemv_df64_cols_plain(a_hi, a_lo, p_hi, p_lo, blk):
    """Plain PyTorch (y_hi, y_lo) = A[:, blk*nb:(blk+1)*nb] @ p for
    A = a_hi + a_lo, computed in float64, returned as the f32 split."""
    gemv_df64_cols_plain.calls += 1
    nb = p_hi.shape[0]
    cols = slice(blk * nb, (blk + 1) * nb)
    a = a_hi[:, cols].to(torch.float64) + a_lo[:, cols].to(torch.float64)
    return split_f64(torch.mv(a, p_hi.to(torch.float64)
                              + p_lo.to(torch.float64)))


def _slab_parts(a, p, it, kt, lt, ms, tb, packed):
    """Plain slab walk in a's dtype: (yd (ms,), yt (n,)). `a` is the
    (T*tb, tb) walk-order buffer (packed) or the (ms, n) slab, whose tile
    t is then the block (lt[t], kt[t]) of its tile grid."""
    it, kt, lt = (x.to(torch.long) for x in (it, kt, lt))
    n = p.shape[0]
    if packed:
        tiles = a.reshape(-1, tb, tb)
    else:
        tiles = a.reshape(ms // tb, tb, n // tb, tb).permute(0, 2, 1, 3)[
            lt, kt]
    yd = torch.zeros(ms // tb, tb, dtype=p.dtype, device=p.device)
    yt = torch.zeros(n // tb, tb, dtype=p.dtype, device=p.device)
    _walk_into(yd, yt, tiles, p, it, kt, lt)
    return yd.reshape(-1), yt.reshape(-1)


def gemv_f32_symm_slab_plain(a_slab, p, it, kt, lt, *, ms=None,
                             packed=False, tb=None):
    """Plain PyTorch slab walk in f32: (yd (ms,), yt (n,))."""
    gemv_f32_symm_slab_plain.calls += 1
    tb, ms = _slab_geometry("gemv_f32_symm_slab", a_slab, p, it, kt, lt,
                            ms, packed, tb)
    _check_walk(*_host_tables(it, kt, lt), p.shape[0] // tb, ms // tb)
    return _slab_parts(a_slab, p, it, kt, lt, ms, tb, packed)


def gemv_df64_symm_slab_plain(a_hi, a_lo, p_hi, p_lo, it, kt, lt, *,
                              ms=None, packed=False, tb=None):
    """Plain PyTorch slab walk of A = a_hi + a_lo computed in float64:
    (yd_hi, yd_lo, yt_hi, yt_lo), the f32 splits of yd and yt."""
    gemv_df64_symm_slab_plain.calls += 1
    tb, ms = _slab_geometry("gemv_df64_symm_slab", a_hi, p_hi, it, kt, lt,
                            ms, packed, tb)
    _check_walk(*_host_tables(it, kt, lt), p_hi.shape[0] // tb, ms // tb)
    a = a_hi.to(torch.float64) + a_lo.to(torch.float64)
    p = p_hi.to(torch.float64) + p_lo.to(torch.float64)
    yd, yt = _slab_parts(a, p, it, kt, lt, ms, tb, packed)
    return (*split_f64(yd), *split_f64(yt))


_DTYPES = {"a": torch.float32, "q": torch.int16, "s": torch.float32,
           "p": torch.float32, "t": torch.int32}
_TABLES = ("it", "kt", "lt")


def _check(what, tensors, device):
    """Raise ValueError unless every tensor is a contiguous tensor on
    `device` (cpu or cuda) of its kind's dtype: the planes (a*: f32;
    q* and *q, the quantized planes: int16) 2-D, the scale tables (s*:
    f32), vectors (p*: f32) and walk tables (it, kt, lt: int32) 1-D."""
    for name, x in tensors.items():
        kind = ("t" if name in _TABLES else
                "q" if name.endswith("q") else name[0])
        if x.dim() != (2 if kind in "aq" else 1):
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}")
        dtype = _DTYPES[kind]
        if x.dtype != dtype:
            raise ValueError(f"{what}: {name} must be "
                             f"{str(dtype).split('.')[-1]}, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{what}: {name} is on {x.device}, "
                             f"expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if x.is_cuda and kind in "aq" and x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned "
                             "(the kernels read it as 16-byte vectors)")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {device}")


def _kernel_geometry(geometry, what, lib):
    """(nblk, part_d elements, part_t elements) of a `packed_geometry`.
    The kernel walks the T real triangle tiles only, so the partials are
    sized by T, never by a padded plane's tile count."""
    tb, nblk, _ = geometry
    if tb != lib.lam_symm_tile():
        raise ValueError(f"{what}: the CUDA kernel takes tb="
                         f"{lib.lam_symm_tile()} tiles, got tb={tb}")
    T = layout.tri_tile_count(nblk)
    return nblk, T * tb, T * lib.lam_symm_strips() * tb


def _check_scales(what, T, scales):
    """Raise unless every scale table has one entry per stored tile."""
    for name, s in scales.items():
        if tuple(s.shape) != (T,):
            raise ValueError(f"{what}: {name} table shape "
                             f"{tuple(s.shape)} != ({T},)")


def _raise_on(what, code):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def gemv_f32_symm(a, p):
    """y = A @ p for symmetric f32 A stored as packed lower-triangle
    tiles a (T*tb, tb); p (n,) f32. Exact f32 products with f32
    accumulation (no TF32, no bf16)."""
    what = "gemv_f32_symm"
    _check(what, {"a": a, "p": p}, a.device)
    if a.device.type == "cpu":
        return gemv_f32_symm_plain(a, p)
    from lam_tpu_torch.ops._build import library
    lib = library()
    nblk, n_d, n_t = _kernel_geometry(
        layout.packed_geometry(a.shape, p.shape[0], what), what, lib)
    y = torch.empty_like(p)
    part_d = torch.empty(n_d, dtype=torch.float32, device=a.device)
    part_t = torch.empty(n_t, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lam_gemv_f32_symm(a.data_ptr(), p.data_ptr(), y.data_ptr(),
                                     part_d.data_ptr(), part_t.data_ptr(),
                                     nblk, stream)
    gemv_f32_symm.launches += 1
    _raise_on(what, code)
    return y


def gemv_df64_symm(a_hi, a_lo, p_hi, p_lo, *, comp=None):
    """(y_hi, y_lo) = A @ p for symmetric A = a_hi + a_lo stored as
    packed lower-triangle (hi, lo) f32 planes, p = p_hi + p_lo.

    The kernel accumulates in native f64 (csrc/gemv_symm.cu), so the
    TPU kernel's compensation budgets 'nolow' and 'full' are both met
    and `comp` selects nothing; other values raise as in lam_tpu. The
    single (tb, tb) broadcast-zero lo tile of lam_tpu's generate mode is
    not ported."""
    what = "gemv_df64_symm"
    if comp not in (None, "nolow", "full"):
        raise ValueError(f"comp={comp!r} must be one of ('full', 'nolow')")
    if a_lo.shape != a_hi.shape:
        raise NotImplementedError(
            f"{what}: lo plane {tuple(a_lo.shape)} must match the hi plane "
            f"{tuple(a_hi.shape)}; the broadcast-zero lo tile is not "
            "ported yet")
    if p_lo.shape != p_hi.shape:
        raise ValueError(f"{what}: p_hi {tuple(p_hi.shape)} and p_lo "
                         f"{tuple(p_lo.shape)} differ")
    _check(what, {"a_hi": a_hi, "a_lo": a_lo, "p_hi": p_hi, "p_lo": p_lo},
           a_hi.device)
    if a_hi.device.type == "cpu":
        return gemv_df64_symm_plain(a_hi, a_lo, p_hi, p_lo)
    from lam_tpu_torch.ops._build import library
    lib = library()
    nblk, n_d, n_t = _kernel_geometry(
        layout.packed_geometry(a_hi.shape, p_hi.shape[0], what), what, lib)
    y_hi = torch.empty_like(p_hi)
    y_lo = torch.empty_like(p_hi)
    part_d = torch.empty(n_d, dtype=torch.float64, device=a_hi.device)
    part_t = torch.empty(n_t, dtype=torch.float64, device=a_hi.device)
    with torch.cuda.device(a_hi.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lam_gemv_df64_symm(
            a_hi.data_ptr(), a_lo.data_ptr(), p_hi.data_ptr(),
            p_lo.data_ptr(), y_hi.data_ptr(), y_lo.data_ptr(),
            part_d.data_ptr(), part_t.data_ptr(), nblk, stream)
    gemv_df64_symm.launches += 1
    _raise_on(what, code)
    return y_hi, y_lo


def gemv_dfq_symm(a_hi, a_loq, sc, p_hi, p_lo, *, comp=None):
    """(y_hi, y_lo) = A @ p for symmetric A in the dfq storage: the f32
    hi plane of the packed lower triangle (T*tb, tb) plus the lo plane
    quantized to int16 tiles a_loq against the (T,) per-tile power-of-two
    scales sc (6 B per stored element, ~2^-39 tile-relative accuracy);
    p = p_hi + p_lo.

    The kernel forms hi + loq * sc and accumulates in native f64, so
    `comp` selects nothing, as in `gemv_df64_symm`."""
    what = "gemv_dfq_symm"
    if comp not in (None, "nolow", "full"):
        raise ValueError(f"comp={comp!r} must be one of ('full', 'nolow')")
    if a_loq.shape != a_hi.shape:
        raise ValueError(f"quantized lo plane shape {tuple(a_loq.shape)} != "
                         f"hi plane {tuple(a_hi.shape)}")
    if p_lo.shape != p_hi.shape:
        raise ValueError(f"{what}: p_hi {tuple(p_hi.shape)} and p_lo "
                         f"{tuple(p_lo.shape)} differ")
    _check(what, {"a_hi": a_hi, "a_loq": a_loq, "sc": sc, "p_hi": p_hi,
                  "p_lo": p_lo}, a_hi.device)
    geometry = layout.packed_geometry(a_hi.shape, p_hi.shape[0], what)
    _check_scales(what, geometry[2], {"sc": sc})
    if a_hi.device.type == "cpu":
        return gemv_dfq_symm_plain(a_hi, a_loq, sc, p_hi, p_lo)
    from lam_tpu_torch.ops._build import library
    lib = library()
    nblk, n_d, n_t = _kernel_geometry(geometry, what, lib)
    y_hi = torch.empty_like(p_hi)
    y_lo = torch.empty_like(p_hi)
    part_d = torch.empty(n_d, dtype=torch.float64, device=a_hi.device)
    part_t = torch.empty(n_t, dtype=torch.float64, device=a_hi.device)
    with torch.cuda.device(a_hi.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lam_gemv_dfq_symm(
            a_hi.data_ptr(), a_loq.data_ptr(), sc.data_ptr(),
            p_hi.data_ptr(), p_lo.data_ptr(), y_hi.data_ptr(),
            y_lo.data_ptr(), part_d.data_ptr(), part_t.data_ptr(), nblk,
            stream)
    gemv_dfq_symm.launches += 1
    _raise_on(what, code)
    return y_hi, y_lo


def gemv_q16_symm(q1, s1, p):
    """y ~= A @ p for symmetric A stored as the q1 plane of the fq
    cascade: int16 walk-order triangle tiles (T or padded Ts tiles)
    against per-tile power-of-two scales s1, p (n,) f32. 2 B per stored
    element; ~2^-16 tile-relative operator error. Exact int16 -> f32
    conversion, the scale folded into p, exact f32 products with f32
    accumulation (no TF32, no bf16) at every n."""
    what = "gemv_q16_symm"
    _check(what, {"q1": q1, "s1": s1, "p": p}, q1.device)
    geometry = layout.packed_geometry(q1.shape, p.shape[0], what,
                                      padded=True)
    _check_scales(what, geometry[2], {"s1": s1})
    if q1.device.type == "cpu":
        return gemv_q16_symm_plain(q1, s1, p)
    from lam_tpu_torch.ops._build import library
    lib = library()
    nblk, n_d, n_t = _kernel_geometry(geometry, what, lib)
    y = torch.empty_like(p)
    part_d = torch.empty(n_d, dtype=torch.float32, device=q1.device)
    part_t = torch.empty(n_t, dtype=torch.float32, device=q1.device)
    with torch.cuda.device(q1.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lam_gemv_q16_symm(q1.data_ptr(), s1.data_ptr(),
                                     p.data_ptr(), y.data_ptr(),
                                     part_d.data_ptr(), part_t.data_ptr(),
                                     nblk, stream)
    gemv_q16_symm.launches += 1
    _raise_on(what, code)
    return y


def gemv_fq_symm(q1, q2, q3, s1, s2, s3, p_hi, p_lo, *, comp=None):
    """(y_hi, y_lo) = A @ p for symmetric A in the fully-quantized fq
    storage: three int16 walk-order triangle planes (T or padded Ts
    tiles) against per-tile power-of-two scale tables, 6 B per stored
    element, ~2^-48 tile-relative accuracy; p = p_hi + p_lo.

    The kernel forms the cascade and accumulates in native f64, so
    `comp` selects nothing, as in `gemv_df64_symm`. lam_tpu's single
    (tb, tb) broadcast q2/q3 tile of generate mode is not ported."""
    what = "gemv_fq_symm"
    if comp not in (None, "nolow", "full"):
        raise ValueError(f"comp={comp!r} must be one of ('full', 'nolow')")
    for name, q in (("q2", q2), ("q3", q3)):
        if q.shape != q1.shape:
            tb = q1.shape[1]
            if tuple(q.shape) == (tb, tb):
                raise NotImplementedError(
                    f"{what}: {name} is one broadcast ({tb}, {tb}) tile; "
                    "the broadcast zero planes are not ported yet")
            raise ValueError(f"{name} plane shape {tuple(q.shape)} != q1 "
                             f"plane {tuple(q1.shape)} (or one broadcast "
                             f"({tb}, {tb}) tile)")
    if p_lo.shape != p_hi.shape:
        raise ValueError(f"{what}: p_hi {tuple(p_hi.shape)} and p_lo "
                         f"{tuple(p_lo.shape)} differ")
    _check(what, {"q1": q1, "q2": q2, "q3": q3, "s1": s1, "s2": s2,
                  "s3": s3, "p_hi": p_hi, "p_lo": p_lo}, q1.device)
    geometry = layout.packed_geometry(q1.shape, p_hi.shape[0], what,
                                      padded=True)
    _check_scales(what, geometry[2], {"s1": s1, "s2": s2, "s3": s3})
    if q1.device.type == "cpu":
        return gemv_fq_symm_plain(q1, q2, q3, s1, s2, s3, p_hi, p_lo)
    from lam_tpu_torch.ops._build import library
    lib = library()
    nblk, n_d, n_t = _kernel_geometry(geometry, what, lib)
    y_hi = torch.empty_like(p_hi)
    y_lo = torch.empty_like(p_hi)
    part_d = torch.empty(n_d, dtype=torch.float64, device=q1.device)
    part_t = torch.empty(n_t, dtype=torch.float64, device=q1.device)
    with torch.cuda.device(q1.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lam_gemv_fq_symm(
            q1.data_ptr(), q2.data_ptr(), q3.data_ptr(), s1.data_ptr(),
            s2.data_ptr(), s3.data_ptr(), p_hi.data_ptr(), p_lo.data_ptr(),
            y_hi.data_ptr(), y_lo.data_ptr(), part_d.data_ptr(),
            part_t.data_ptr(), nblk, stream)
    gemv_fq_symm.launches += 1
    _raise_on(what, code)
    return y_hi, y_lo


def _dense_geometry(what, a, *ps):
    """(m, n) of a row-major matrix and its operand vector(s). Raises
    unless both sides are multiples of 128, the rule of lam_tpu's
    `_fit_tile` (gemv.py:61-76), so the kernel needs no ragged row or
    column, and unless a CUDA operand is 16-byte aligned (the kernel
    reads p as 16-byte vectors too)."""
    m, n = a.shape
    for p in ps:
        if p.shape[0] != n:
            raise ValueError(f"{what}: p has {p.shape[0]} entries, A has "
                             f"{n} columns")
        if p.is_cuda and p.data_ptr() % 16:
            raise ValueError(f"{what}: p must be 16-byte aligned")
    for name, dim in (("rows", m), ("cols", n)):
        if dim < layout._LANES or dim % layout._LANES:
            raise ValueError(
                f"{name}={dim} is not a multiple of any usable tile (min "
                f"{layout._LANES}); pad the operand (see "
                "lam_tpu_torch/solver/operators.py)")
    return m, n


def gemv_f32(a, p):
    """y = A @ p for a row-major (m, n) f32 A, square or a row block of
    a larger matrix, and p (n,) f32; m and n multiples of 128. Exact f32
    products with f32 accumulation (no TF32, no bf16). lam_tpu's two
    impls ('dot', 'vpu') compute this one function."""
    what = "gemv_f32"
    _check(what, {"a": a, "p": p}, a.device)
    m, n = _dense_geometry(what, a, p)
    if a.device.type == "cpu":
        return gemv_f32_plain(a, p)
    from lam_tpu_torch.ops._build import library
    lib = library()
    y = torch.empty(m, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lam_gemv_f32(a.data_ptr(), p.data_ptr(), y.data_ptr(),
                                m, n, stream)
    gemv_f32.launches += 1
    _raise_on(what, code)
    return y


def gemv_df64(a_hi, a_lo, p_hi, p_lo, *, comp=None):
    """(y_hi, y_lo) = A @ p for a row-major (m, n) A = a_hi + a_lo held
    as two f32 planes, p = p_hi + p_lo; m and n multiples of 128.

    The kernel forms hi + lo and accumulates in native f64 and returns
    the f32 split of the f64 result, so `comp` selects nothing, as in
    `gemv_df64_symm`."""
    what = "gemv_df64"
    if comp not in (None, "nolow", "full"):
        raise ValueError(f"comp={comp!r} must be one of ('full', 'nolow')")
    if a_lo.shape != a_hi.shape:
        raise ValueError(f"{what}: a_lo {tuple(a_lo.shape)} and a_hi "
                         f"{tuple(a_hi.shape)} differ")
    if p_lo.shape != p_hi.shape:
        raise ValueError(f"{what}: p_hi {tuple(p_hi.shape)} and p_lo "
                         f"{tuple(p_lo.shape)} differ")
    _check(what, {"a_hi": a_hi, "a_lo": a_lo, "p_hi": p_hi, "p_lo": p_lo},
           a_hi.device)
    m, n = _dense_geometry(what, a_hi, p_hi, p_lo)
    if a_hi.device.type == "cpu":
        return gemv_df64_plain(a_hi, a_lo, p_hi, p_lo)
    from lam_tpu_torch.ops._build import library
    lib = library()
    y_hi = torch.empty(m, dtype=torch.float32, device=a_hi.device)
    y_lo = torch.empty(m, dtype=torch.float32, device=a_hi.device)
    with torch.cuda.device(a_hi.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lam_gemv_df64(a_hi.data_ptr(), a_lo.data_ptr(),
                                 p_hi.data_ptr(), p_lo.data_ptr(),
                                 y_hi.data_ptr(), y_lo.data_ptr(), m, n,
                                 stream)
    gemv_df64.launches += 1
    _raise_on(what, code)
    return y_hi, y_lo


def _cols_geometry(what, a, blk, *ps):
    """(m, n, nb) of a column-block matvec of a (m, n) matrix against
    the (nb,) operand block(s) ps, block index blk (a host int); raises
    lam_tpu's ValueError for a width that is not a whole number of
    blocks, and the dense rules (multiples of 128, 16-byte aligned
    operands) for the (m, nb) block that is read."""
    m, n = a.shape
    nb = ps[0].shape[0]
    if nb == 0 or n % nb:
        raise ValueError(f"cols={n} not divisible by block size nb={nb}")
    if not 0 <= blk < n // nb:
        raise ValueError(f"{what}: block index {blk} outside the "
                         f"{n // nb} column blocks of width {nb}")
    _dense_geometry(what, a[:, :nb], *ps)
    return m, n, nb


def gemv_f32_cols(a, p_blk, blk):
    """y (m,) = A[:, blk*nb:(blk+1)*nb] @ p_blk for a row-major (m, n)
    f32 A and p_blk (nb,) f32, n a multiple of nb; blk is a host int.
    The kernel reads the column block in place; exact f32 products with
    f32 accumulation (no TF32, no bf16)."""
    what = "gemv_f32_cols"
    _check(what, {"a": a, "p_blk": p_blk}, a.device)
    blk = operator.index(blk)
    m, n, nb = _cols_geometry(what, a, blk, p_blk)
    if a.device.type == "cpu":
        return gemv_f32_cols_plain(a, p_blk, blk)
    from lam_tpu_torch.ops._build import library
    lib = library()
    y = torch.empty(m, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lam_gemv_f32_cols(a.data_ptr(), p_blk.data_ptr(),
                                     y.data_ptr(), m, n, nb, blk, stream)
    gemv_f32_cols.launches += 1
    _raise_on(what, code)
    return y


def gemv_df64_cols(a_hi, a_lo, p_hi, p_lo, blk):
    """(y_hi, y_lo) (m,) = A[:, blk*nb:(blk+1)*nb] @ p for a row-major
    (m, n) A = a_hi + a_lo and the (nb,) operand block p = p_hi + p_lo;
    blk is a host int. Formed and accumulated in native f64 and returned
    as the f32 split."""
    what = "gemv_df64_cols"
    if a_lo.shape != a_hi.shape:
        raise ValueError(f"{what}: a_lo {tuple(a_lo.shape)} and a_hi "
                         f"{tuple(a_hi.shape)} differ")
    if p_lo.shape != p_hi.shape:
        raise ValueError(f"{what}: p_hi {tuple(p_hi.shape)} and p_lo "
                         f"{tuple(p_lo.shape)} differ")
    _check(what, {"a_hi": a_hi, "a_lo": a_lo, "p_hi": p_hi, "p_lo": p_lo},
           a_hi.device)
    blk = operator.index(blk)
    m, n, nb = _cols_geometry(what, a_hi, blk, p_hi, p_lo)
    if a_hi.device.type == "cpu":
        return gemv_df64_cols_plain(a_hi, a_lo, p_hi, p_lo, blk)
    from lam_tpu_torch.ops._build import library
    lib = library()
    y_hi = torch.empty(m, dtype=torch.float32, device=a_hi.device)
    y_lo = torch.empty(m, dtype=torch.float32, device=a_hi.device)
    with torch.cuda.device(a_hi.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lam_gemv_df64_cols(a_hi.data_ptr(), a_lo.data_ptr(),
                                      p_hi.data_ptr(), p_lo.data_ptr(),
                                      y_hi.data_ptr(), y_lo.data_ptr(), m, n,
                                      nb, blk, stream)
    gemv_df64_cols.launches += 1
    _raise_on(what, code)
    return y_hi, y_lo


def _slab_geometry(what, a, p, it, kt, lt, ms, packed, tb):
    """(tb, ms) of a slab walk; raises lam_tpu's ValueErrors. Packed: a
    is (T*tb, tb) with T the tables' length and ms (the slab's row count)
    given. Slab: a is (ms, n) and tb (default SYMM_TB) divides both."""
    n = p.shape[0]
    T = it.shape[0]
    if kt.shape != it.shape or lt.shape != it.shape:
        raise ValueError(f"{what}: walk tables it {tuple(it.shape)}, kt "
                         f"{tuple(kt.shape)}, lt {tuple(lt.shape)} differ")
    if packed:
        tb = a.shape[1]
        if tb < layout._LANES or tb & (tb - 1):
            raise ValueError(f"{what}: packed tile width {tb} must be a "
                             f"power-of-two multiple of {layout._LANES}")
        if n % tb or a.shape[0] % tb:
            raise ValueError(f"{what}: n={n} and packed rows "
                             f"{a.shape[0]} must be multiples of tb={tb}")
        if a.shape[0] // tb != T:
            raise ValueError(f"packed slab has {a.shape[0] // tb} tiles but "
                             f"the walk table has {T}")
        if ms is None or ms % tb:
            raise ValueError("packed slab needs ms (a multiple of tb)")
        return tb, ms
    tb = layout.SYMM_TB if tb is None else tb
    ms_a, n_a = a.shape
    if n_a != n:
        raise ValueError(f"slab width {n_a} != p length {n}")
    if ms is not None and ms != ms_a:
        raise ValueError(f"{what}: ms={ms} but the slab has {ms_a} rows")
    if tb < layout._LANES or tb & (tb - 1) or ms_a % tb or n % tb:
        raise ValueError(
            f"tb={tb} unusable for slab shape ({ms_a}, {n}): the tile "
            "tables require tb to be a power-of-two multiple of 128 "
            "dividing the band size")
    return tb, ms_a


def _host_tables(it, kt, lt):
    return tuple(x.cpu().numpy().astype(np.int64) for x in (it, kt, lt))


def _check_walk(it, kt, lt, nblk, mst):
    """Raise ValueError unless every walk entry is a lower-triangle tile
    of the nblk-tile grid (0 <= kt <= it < nblk) on one of the slab's mst
    row tiles: the kernels read and write where the tables point."""
    if it.size and (kt.min() < 0 or (kt > it).any() or it.max() >= nblk
                    or lt.min() < 0 or lt.max() >= mst):
        raise ValueError(f"walk tables out of range: need 0 <= kt <= it < "
                         f"{nblk} and 0 <= lt < {mst}")


def _csr(keys, ids, nkeys):
    """(ptr (nkeys + 1,), ids grouped by key, walk order kept)."""
    ptr = np.zeros(nkeys + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=nkeys), out=ptr[1:])
    return ptr, ids[np.argsort(keys, kind="stable")]


def _slab_lists(it, kt, lt, nblk, mst):
    """The second pass's lists of a slab walk, on the tables' device:
    (d_ptr, d_ids) the tiles of each slab row tile, (t_ptr, t_ids) the
    off-diagonal tiles of each column tile, in walk order. Built on the
    host after checking the tables, once per set of table tensors (kept
    on kt): the read-back synchronises once, not at every call."""
    key = (it.data_ptr(), lt.data_ptr(), it._version, kt._version,
           lt._version, nblk, mst)
    got = getattr(kt, "_slab_lists", None)
    if got is None or got[0] != key:
        i, k, l = _host_tables(it, kt, lt)
        _check_walk(i, k, l, nblk, mst)
        off = np.flatnonzero(k < i)
        lists = (*_csr(l, np.arange(i.size), mst), *_csr(k[off], off, nblk))
        got = (key, tuple(torch.from_numpy(x.astype(np.int32)).to(kt.device)
                          for x in lists))
        kt._slab_lists = got
    return got[1]


def _slab_launch(what, lib, tb, it, kt, lt, ms, n, acc_dtype, device):
    """(T, list pointers, part_d, part_t) of a slab kernel launch."""
    if tb != lib.lam_symm_tile():
        raise ValueError(f"{what}: the CUDA kernel takes tb="
                         f"{lib.lam_symm_tile()} tiles, got tb={tb}")
    T = it.shape[0]
    lists = _slab_lists(it, kt, lt, n // tb, ms // tb)
    part_d = torch.empty(T * tb, dtype=acc_dtype, device=device)
    part_t = torch.empty(T * lib.lam_symm_strips() * tb, dtype=acc_dtype,
                         device=device)
    return T, [x.data_ptr() for x in lists], part_d, part_t


def gemv_f32_symm_slab(a_slab, p, it, kt, lt, *, ms=None, packed=False,
                       tb=None):
    """Partial symmetric f32 matvec over one rank's band-pair walk:
    returns (yd (ms,), yt (n,)), the direct terms over the slab's rows
    and the transpose terms over all columns; the matvec is the sum over
    ranks of yt plus yd placed at each rank's rows.

    packed=False: a_slab is the rank's (ms, n) row-major slab of full
    rows (only the walk's tiles are read; tb defaults to SYMM_TB).
    packed=True: a_slab is the (T*tb, tb) walk-order buffer of those
    tiles and ms (the slab's row count) must be given. it/kt/lt: (T,)
    int32 tables of tile t's row tile, column tile and slab row tile.
    Exact f32 products with f32 accumulation (no TF32, no bf16)."""
    what = "gemv_f32_symm_slab"
    _check(what, {"a_slab": a_slab, "p": p, "it": it, "kt": kt, "lt": lt},
           a_slab.device)
    tb, ms = _slab_geometry(what, a_slab, p, it, kt, lt, ms, packed, tb)
    if a_slab.device.type == "cpu":
        return gemv_f32_symm_slab_plain(a_slab, p, it, kt, lt, ms=ms,
                                        packed=packed, tb=tb)
    from lam_tpu_torch.ops._build import library
    lib = library()
    n = p.shape[0]
    T, lists, part_d, part_t = _slab_launch(what, lib, tb, it, kt, lt, ms,
                                            n, torch.float32, a_slab.device)
    yd = torch.empty(ms, dtype=torch.float32, device=a_slab.device)
    yt = torch.empty(n, dtype=torch.float32, device=a_slab.device)
    with torch.cuda.device(a_slab.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lam_gemv_f32_symm_slab(
            a_slab.data_ptr(), p.data_ptr(), it.data_ptr(), kt.data_ptr(),
            lt.data_ptr(), *lists, yd.data_ptr(), yt.data_ptr(),
            part_d.data_ptr(), part_t.data_ptr(), T, ms, n, int(packed),
            stream)
    gemv_f32_symm_slab.launches += 1
    _raise_on(what, code)
    return yd, yt


def gemv_df64_symm_slab(a_hi, a_lo, p_hi, p_lo, it, kt, lt, *, ms=None,
                        packed=False, tb=None):
    """The df64 twin of `gemv_f32_symm_slab` for A = a_hi + a_lo and
    p = p_hi + p_lo: returns (yd_hi, yd_lo, yt_hi, yt_lo), formed and
    accumulated in native f64. lam_tpu's single (tb, tb) broadcast-zero
    lo tile of generate mode is not ported."""
    what = "gemv_df64_symm_slab"
    if a_lo.shape != a_hi.shape:
        raise NotImplementedError(
            f"{what}: lo plane {tuple(a_lo.shape)} must match the hi plane "
            f"{tuple(a_hi.shape)}; the broadcast-zero lo tile is not "
            "ported yet")
    if p_lo.shape != p_hi.shape:
        raise ValueError(f"{what}: p_hi {tuple(p_hi.shape)} and p_lo "
                         f"{tuple(p_lo.shape)} differ")
    _check(what, {"a_hi": a_hi, "a_lo": a_lo, "p_hi": p_hi, "p_lo": p_lo,
                  "it": it, "kt": kt, "lt": lt}, a_hi.device)
    tb, ms = _slab_geometry(what, a_hi, p_hi, it, kt, lt, ms, packed, tb)
    if a_hi.device.type == "cpu":
        return gemv_df64_symm_slab_plain(a_hi, a_lo, p_hi, p_lo, it, kt, lt,
                                         ms=ms, packed=packed, tb=tb)
    from lam_tpu_torch.ops._build import library
    lib = library()
    n = p_hi.shape[0]
    T, lists, part_d, part_t = _slab_launch(what, lib, tb, it, kt, lt, ms,
                                            n, torch.float64, a_hi.device)
    out = [torch.empty(size, dtype=torch.float32, device=a_hi.device)
           for size in (ms, ms, n, n)]
    with torch.cuda.device(a_hi.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lam_gemv_df64_symm_slab(
            a_hi.data_ptr(), a_lo.data_ptr(), p_hi.data_ptr(),
            p_lo.data_ptr(), it.data_ptr(), kt.data_ptr(), lt.data_ptr(),
            *lists, *(y.data_ptr() for y in out), part_d.data_ptr(),
            part_t.data_ptr(), T, ms, n, int(packed), stream)
    gemv_df64_symm_slab.launches += 1
    _raise_on(what, code)
    return tuple(out)


KERNELS = (gemv_f32_symm, gemv_df64_symm, gemv_dfq_symm, gemv_q16_symm,
           gemv_fq_symm, gemv_f32, gemv_df64, gemv_f32_cols, gemv_df64_cols,
           gemv_f32_symm_slab, gemv_df64_symm_slab)
PLAIN = (gemv_f32_symm_plain, gemv_df64_symm_plain, gemv_dfq_symm_plain,
         gemv_q16_symm_plain, gemv_fq_symm_plain, gemv_f32_plain,
         gemv_df64_plain, gemv_f32_cols_plain, gemv_df64_cols_plain,
         gemv_f32_symm_slab_plain, gemv_df64_symm_slab_plain)


def reset_counters():
    """Zero every kernel module's counters (lam_tpu_torch.ops)."""
    from lam_tpu_torch import ops
    ops.reset_counters()


def counters():
    """{name: count} over every kernel module (lam_tpu_torch.ops)."""
    from lam_tpu_torch import ops
    return ops.counters()
