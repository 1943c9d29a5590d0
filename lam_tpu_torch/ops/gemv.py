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

On a CUDA tensor a wrapper launches the hand-written Hopper kernel of
csrc/gemv_symm.cu or csrc/gemv_dense.cu (built at first use by
`_build`) on the current stream, or raises. On a CPU tensor, and only
there, it runs the plain PyTorch version beside it (`*_plain`), which
the CPU tests hold against the JAX package and chip_smoke.py holds the
kernel against on the card.

Each wrapper counts its kernel launches in `.launches`, and each plain
version its calls in `.calls`, so a run can show which path it took
(`reset_counters`, `counters`).
"""

from __future__ import annotations

import torch

from lam_tpu_torch.ops import layout
from lam_tpu_torch.precision import split_f64


def _walk(tiles, p, nblk, scale=None):
    """Plain triangle walk: tiles (T, tb, tb) and p (n,) in one dtype.
    Direct terms scatter by row tile, transpose terms (off-diagonal tiles
    only) by column tile. A per-tile `scale` (T,) is folded into p."""
    tb = tiles.shape[1]
    it, kt = (torch.as_tensor(x, dtype=torch.long, device=tiles.device)
              for x in layout._symm_tables(nblk))
    pb = p.reshape(nblk, tb)
    pk, pi = pb[kt], pb[it]
    if scale is not None:
        pk, pi = pk * scale[:, None], pi * scale[:, None]
    direct = torch.einsum("tij,tj->ti", tiles, pk)
    y = torch.zeros(nblk, tb, dtype=p.dtype, device=p.device)
    y.index_add_(0, it, direct)
    off = torch.nonzero(kt < it).flatten()
    if off.numel():
        trans = torch.einsum("tij,ti->tj", tiles[off], pi[off])
        y.index_add_(0, kt[off], trans)
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


_DTYPES = {"a": torch.float32, "q": torch.int16, "s": torch.float32,
           "p": torch.float32}


def _check(what, tensors, device):
    """Raise ValueError unless every tensor is a contiguous tensor on
    `device` (cpu or cuda) of its kind's dtype: the planes (a*: f32;
    q* and *q, the quantized planes: int16) 2-D, the scale tables (s*:
    f32) and vectors (p_*: f32) 1-D."""
    for name, x in tensors.items():
        kind = "q" if name.endswith("q") else name[0]
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


KERNELS = (gemv_f32_symm, gemv_df64_symm, gemv_dfq_symm, gemv_q16_symm,
           gemv_fq_symm, gemv_f32, gemv_df64)
PLAIN = (gemv_f32_symm_plain, gemv_df64_symm_plain, gemv_dfq_symm_plain,
         gemv_q16_symm_plain, gemv_fq_symm_plain, gemv_f32_plain,
         gemv_df64_plain)


def reset_counters():
    for fn in KERNELS:
        fn.launches = 0
    for fn in PLAIN:
        fn.calls = 0


def counters():
    """{name: count} of kernel launches and plain-version calls."""
    out = {fn.__name__: fn.launches for fn in KERNELS}
    out.update({fn.__name__: fn.calls for fn in PLAIN})
    return out


reset_counters()
