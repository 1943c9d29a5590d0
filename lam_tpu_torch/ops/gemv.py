"""Matvecs over packed lower-triangle storage and over full squares.

Each function here replaces one Pallas kernel of lam_tpu/ops/gemv.py.
The symmetric ones work on the walk-order packed layout of
`layout.pack_tri_host`:

    gemv_f32_symm   <- gemv_f32_symm(packed=True)   (gemv.py:455)
    gemv_df64_symm  <- gemv_df64_symm(packed=True)  (gemv.py:1008)
    gemv_dfq_symm   <- gemv_dfq_symm                (gemv.py:1172)
    gemv_q16_symm   <- gemv_q16_symm                (gemv.py:2065)
    gemv_fq_symm    <- gemv_fq_symm                 (gemv.py:2164)

with the other storage modes of three of them, each a kernel of its own
with its own counter and plain version, to which the public function
routes by the operand's shape: the full (n, n) square read in place
(lam_tpu's packed=False; a square of one 512-wide tile is its own packed
buffer) and generate mode's broadcast tiles, one (tb, tb) tile that every
walk position reads (lam_tpu's constant index map):

    gemv_f32_symm_square   <- gemv_f32_symm(packed=False)       (:455)
    gemv_df64_symm_square  <- gemv_df64_symm(packed=False)      (:1008)
    gemv_df64_symm_bcast   <- gemv_df64_symm, (tb, tb) lo tile  (:991)
    gemv_fq_symm_bcast     <- gemv_fq_symm, (tb, tb) q2/q3      (:2182)

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

and the band-pair walks of the quantized storages, over a rank's packed
walk-order planes of exactly T tiles (no Q16_P padding) with one scale
per walk position, the diagonal term left to the operator:

    gemv_q16_symm_slab   <- gemv_q16_symm_slab      (gemv.py:2310)
    gemv_fq_symm_slab    <- gemv_fq_symm_slab       (gemv.py:2405)
    gemv_dfq_symm_slab   <- gemv_dfq_symm_slab      (gemv.py:1386)

The symmetric 2-D grid (lam_tpu_torch/parallel/pcg2d_symm.py) adds the
five dual matvecs of its off-diagonal ranks: both products (S @ p,
S^T @ q) of a dense rectangle S (ms, n) in one pass over its tiles, stored
row-major (tile t = li * (n/tb) + k at rows t*tb of a (T*tb, tb) buffer,
`layout.pack_rect_host`); T may exceed the rectangle's tile count, and the
trailing pad tiles and their scales are never read:

    gemv_f32_dual        <- gemv_f32_dual           (gemv.py:1556)
    gemv_df64_dual       <- gemv_df64_dual          (gemv.py:1682)
    gemv_dfq_dual        <- gemv_dfq_dual           (gemv.py:1763)
    gemv_q16_dual        <- gemv_q16_dual           (gemv.py:2544)
    gemv_fq_dual         <- gemv_fq_dual            (gemv.py:2624)

Generate mode on the meshes hands four of the shard kernels one (tb, tb)
tile for the lo plane or for q2 and q3, as one device does kernels 2 and
15: broadcast modes of their own, to which the public wrappers route by
the operand's shape (the band pairs' slab storage takes no tile, as in
lam_tpu):

    gemv_df64_symm_slab_bcast  <- gemv_df64_symm_slab, lo tile (:991)
    gemv_fq_symm_slab_bcast    <- gemv_fq_symm_slab, q2/q3 tiles (:2420)
    gemv_df64_dual_bcast       <- gemv_df64_dual, lo tile      (:1695)
    gemv_fq_dual_bcast         <- gemv_fq_dual, q2/q3 tiles    (:2637)

Generate mode's tiles hold only zeros ("exact-zero residual planes",
lam_tpu :2183-2185). Five of the broadcast modes (all but kernel 2's)
have a kernel of their own for such tiles, which reads only the plane
that is not zero and gives the full-plane kernel's bits over zero
planes. The operators choose it
when they are built, where their tiles are counted zero
(`solver.operators.zero_tiles_of`), never by a read at a matvec; any
other tile keeps the tile-reading mode:

    gemv_fq_symm_zero          <- gemv_fq_symm, zero q2/q3 tiles (:2182)
    gemv_df64_symm_slab_zero   <- gemv_df64_symm_slab, zero lo tile (:991)
    gemv_df64_dual_zero        <- gemv_df64_dual, zero lo tile (:1695)
    gemv_fq_symm_slab_zero     <- gemv_fq_symm_slab, zero q2/q3 tiles (:2420)
    gemv_fq_dual_zero          <- gemv_fq_dual, zero q2/q3 tiles (:2637)

The three q16 matvecs have two product engines, as in lam_tpu, chosen
per call by `_q16_impl` from the module attribute `_Q16_IMPL` (read from
LAM_Q16_IMPL at import; "auto", the default, "mxu" or "vpu"; any other
value raises ValueError) and the operand length: "vpu", exact f32
products (the kernels above), below Q16_MXU_MIN_N under "auto"; "mxu",
both operands of every product rounded to bf16 (the converted int16 tile
value and p * s, nearest even) and the exact products summed in f32, the
TPU's single-pass DEFAULT-precision MXU dots, at n >= Q16_MXU_MIN_N
under "auto". The bf16 engine's wrappers are kernels of their own, with
their own counters and plain versions:

    gemv_q16_symm_bf16       <- _gemv_q16_symm_multi_kernel "mxu" (:1955)
    gemv_q16_symm_slab_bf16  <- _gemv_q16_symm_slab_kernel "mxu"  (:2266)
    gemv_q16_dual_bf16       <- _gemv_q16_dual_kernel "mxu"       (:2502)

`gemv_q16_symm` and `gemv_q16_symm_slab` choose on p's length (the padded
n), `gemv_q16_dual` on the larger of p's and q's. `gemv_q16_symm` takes
the bf16 engine only on a plane of a multiple of Q16_P tiles with nblk >=
2, where lam_tpu runs its blocked grid; other planes keep exact products
under any engine, as lam_tpu's one-tile grid does. Tests and scripts flip
the engine by assigning `_Q16_IMPL`.

On a CUDA tensor a wrapper launches the hand-written Hopper kernel of
csrc/gemv_symm.cu or csrc/gemv_dense.cu (built at first use by
`_build`) on the current stream, or raises; no engine falls back to the
other. On a CPU tensor, and only
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
import os

import numpy as np
import torch

from lam_tpu_torch.ops import layout
# lam_tpu's gemv module holds its layout too: the same names at its path
from lam_tpu_torch.ops.layout import (  # noqa: F401
    DF64_SYMM_TB, Q16_P, SYMM_TB, TILE_K, TILE_M, pack_rect_host,
    pack_tri_host, padded_tri_tile_count, quantize_fq_tiles,
    quantize_lo_tiles, tri_tile_count)
from lam_tpu_torch.precision import split_f64


Q16_MXU_MIN_N = 16384
_Q16_IMPLS = ("auto", "mxu", "vpu")


def _checked_q16_impl(value):
    if value not in _Q16_IMPLS:
        raise ValueError(f"LAM_Q16_IMPL={value!r} must be one of "
                         f"{_Q16_IMPLS}")
    return value


# the q16 product engine (module docstring); lam_tpu reads the same
# variable (lam_tpu/ops/gemv.py:327)
_Q16_IMPL = _checked_q16_impl(os.environ.get("LAM_Q16_IMPL", "auto"))


def _q16_impl(n):
    """'mxu' (bf16 products) or 'vpu' (exact f32 products) for an operand
    of length n, by lam_tpu's rule (lam_tpu/ops/gemv.py:331-334)."""
    impl = _checked_q16_impl(_Q16_IMPL)
    if impl == "auto":
        return "mxu" if n >= Q16_MXU_MIN_N else "vpu"
    return impl


def _bf16(x):
    """f32 x rounded to bf16 (nearest even) and back: exact in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _walk_into(yd, yt, tiles, p, it, kt, lt, scale=None, rounding=None):
    """Plain walk of tiles (T, tb, tb) sitting at blocks (it, kt) of the
    matrix, p (n,) in the tiles' dtype, tables int64: direct terms
    A p_kt are added into the row tiles yd[lt], transpose terms A^T p_it
    of the off-diagonal tiles into the column tiles yt[kt]. A per-tile
    `scale` (T,) is folded into p, then `rounding` applied to the
    operand slices."""
    tb = tiles.shape[1]
    pb = p.reshape(-1, tb)
    pk, pi = pb[kt], pb[it]
    if scale is not None:
        pk, pi = pk * scale[:, None], pi * scale[:, None]
    if rounding is not None:
        pk, pi = rounding(pk), rounding(pi)
    yd.index_add_(0, lt, torch.einsum("tij,tj->ti", tiles, pk))
    off = torch.nonzero(kt < it).flatten()
    if off.numel():
        trans = torch.einsum("tij,ti->tj", tiles[off], pi[off])
        yt.index_add_(0, kt[off], trans)


def _walk(tiles, p, nblk, scale=None, rounding=None):
    """Plain triangle walk: tiles (T, tb, tb) and p (n,) in one dtype.
    Direct terms scatter by row tile, transpose terms (off-diagonal tiles
    only) by column tile. A per-tile `scale` (T,) is folded into p."""
    tb = tiles.shape[1]
    it, kt = (torch.as_tensor(x, dtype=torch.long, device=tiles.device)
              for x in layout._symm_tables(nblk))
    y = torch.zeros(nblk, tb, dtype=p.dtype, device=p.device)
    _walk_into(y, y, tiles, p, it, kt, it, scale, rounding)
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


def gemv_q16_symm_bf16_plain(q1, s1, p):
    """The bf16 engine of `gemv_q16_symm_plain`: each tile value and each
    scaled operand value p * s rounded to bf16, exact products, f32
    sums."""
    gemv_q16_symm_bf16_plain.calls += 1
    tb, nblk, _ = layout.packed_geometry(q1.shape, p.shape[0],
                                         "gemv_q16_symm", padded=True)
    T = layout.tri_tile_count(nblk)
    tiles = _bf16(q1[:T * tb].to(torch.float32)).reshape(T, tb, tb)
    return _walk(tiles, p, nblk, s1[:T], _bf16)


def gemv_fq_symm_plain(q1, q2, q3, s1, s2, s3, p_hi, p_lo):
    """Plain PyTorch (y_hi, y_lo) = A @ p, computed in float64 from the
    three-plane fq cascade over the real triangle tiles and returned as
    the f32 split of the f64 result."""
    gemv_fq_symm_plain.calls += 1
    return _fq_symm_parts(((q1, s1), (q2, s2), (q3, s3)), p_hi, p_lo)


def _fq_symm_parts(planes, p_hi, p_lo):
    """The f64 triangle walk of the fq cascade over the real tiles:
    `planes` the (plane, scale table) pairs, q1's first, each later plane
    of q1's shape or one (tb, tb) tile that every tile reads."""
    tb, nblk, _ = layout.packed_geometry(planes[0][0].shape, p_hi.shape[0],
                                         "gemv_fq_symm", padded=True)
    T = layout.tri_tile_count(nblk)
    tiles = sum(q.reshape(-1, tb, tb)[:T].to(torch.float64)
                * s[:T].to(torch.float64)[:, None, None]
                for q, s in planes)
    p = p_hi.to(torch.float64) + p_lo.to(torch.float64)
    return split_f64(_walk(tiles, p, nblk))


def gemv_fq_symm_bcast_plain(q1, q2, q3, s1, s2, s3, p_hi, p_lo):
    """`gemv_fq_symm_plain` with q2 and/or q3 one broadcast (tb, tb) tile
    (lam_tpu's pinned block (0, 0), gemv.py:2182-2199), expanded over the
    walk."""
    gemv_fq_symm_bcast_plain.calls += 1
    return _fq_symm_parts(((q1, s1), (q2, s2), (q3, s3)), p_hi, p_lo)


def gemv_fq_symm_zero_plain(q1, s1, p_hi, p_lo):
    """`gemv_fq_symm_bcast_plain` over zero q2/q3 tiles, which are not
    taken: the f64 walk of q1 against s1."""
    gemv_fq_symm_zero_plain.calls += 1
    return _fq_symm_parts(((q1, s1),), p_hi, p_lo)


def _fit_tile(dim, preferred, name):
    """Largest power-of-two tile <= preferred that divides dim, at least
    128 (lam_tpu/ops/gemv.py:61-76)."""
    t = 1 << (min(preferred, dim).bit_length() - 1)
    while t >= layout._LANES:
        if dim % t == 0:
            return t
        t //= 2
    raise ValueError(
        f"{name}={dim} is not a multiple of any usable tile (min "
        f"{layout._LANES}); pad the operand (see "
        "lam_tpu_torch/solver/operators.py)")


def _square_geometry(n):
    """(tb, nblk, T) of the square walk over an (n, n) square: lam_tpu's
    tile for packed=False (SYMM_TB fitted to n)."""
    tb = _fit_tile(n, layout.SYMM_TB, "rows")
    nblk = n // tb
    return tb, nblk, layout.tri_tile_count(nblk)


def _square_tiles(a, n):
    """The lower-triangle tiles (T, tb, tb) of an (n, n) square in walk
    order, as pack_tri_host lays them out, and nblk."""
    tb, nblk, _ = _square_geometry(n)
    it, kt = (torch.as_tensor(x, dtype=torch.long, device=a.device)
              for x in layout._symm_tables(nblk))
    return a.reshape(nblk, tb, nblk, tb).permute(0, 2, 1, 3)[it, kt], nblk


def gemv_f32_symm_square_plain(a, p):
    """Plain PyTorch y = A @ p in f32 over the lower-triangle tiles of the
    (n, n) square a: the packed walk of those tiles."""
    gemv_f32_symm_square_plain.calls += 1
    tiles, nblk = _square_tiles(a, p.shape[0])
    return _walk(tiles, p, nblk)


def gemv_df64_symm_square_plain(a_hi, a_lo, p_hi, p_lo):
    """Plain PyTorch (y_hi, y_lo) = A @ p over the lower-triangle tiles of
    the (n, n) squares a_hi + a_lo, in float64, as the f32 split."""
    gemv_df64_symm_square_plain.calls += 1
    n = p_hi.shape[0]
    tiles, nblk = _square_tiles(a_hi.to(torch.float64)
                                + a_lo.to(torch.float64), n)
    p = p_hi.to(torch.float64) + p_lo.to(torch.float64)
    return split_f64(_walk(tiles, p, nblk))


def gemv_df64_symm_bcast_plain(a_hi, a_lo, p_hi, p_lo):
    """`gemv_df64_symm_plain` with the lo plane one broadcast (tb, tb)
    tile (lam_tpu's _lo_plane_map, gemv.py:991), added to every tile."""
    gemv_df64_symm_bcast_plain.calls += 1
    tb, nblk, T = layout.packed_geometry(a_hi.shape, p_hi.shape[0],
                                         "gemv_df64_symm")
    tiles = (a_hi.to(torch.float64).reshape(T, tb, tb)
             + a_lo.to(torch.float64).reshape(1, tb, tb))
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
    return _df64_cols(a_hi, a_lo, p_hi, p_lo, blk)


def _df64_cols(a_hi, a_lo, p_hi, p_lo, blk):
    nb = p_hi.shape[0]
    cols = slice(blk * nb, (blk + 1) * nb)
    a = a_hi[:, cols].to(torch.float64) + a_lo[:, cols].to(torch.float64)
    return split_f64(torch.mv(a, p_hi.to(torch.float64)
                              + p_lo.to(torch.float64)))


def _slab_parts(a, p, it, kt, lt, ms, tb, packed, scale=None,
                rounding=None):
    """Plain slab walk in a's dtype: (yd (ms,), yt (n,)). `a` is the
    (T*tb, tb) walk-order buffer (packed) or the (ms, n) slab, whose tile
    t is then the block (lt[t], kt[t]) of its tile grid. A per-tile
    `scale` (T,) is folded into p, then `rounding` applied."""
    it, kt, lt = (x.to(torch.long) for x in (it, kt, lt))
    n = p.shape[0]
    if packed:
        tiles = a.reshape(-1, tb, tb)
    else:
        tiles = a.reshape(ms // tb, tb, n // tb, tb).permute(0, 2, 1, 3)[
            lt, kt]
    yd = torch.zeros(ms // tb, tb, dtype=p.dtype, device=p.device)
    yt = torch.zeros(n // tb, tb, dtype=p.dtype, device=p.device)
    _walk_into(yd, yt, tiles, p, it, kt, lt, scale, rounding)
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


def _tile_plane(x, like):
    """x as a plane of like's shape: x itself, or one (tb, tb) broadcast
    tile repeated at every tile position (lam_tpu's constant (0, 0) index
    map), so a broadcast mode's plain version is its full-plane one's."""
    if x.shape == like.shape:
        return x
    return x.repeat(like.shape[0] // x.shape[0], 1)


def gemv_df64_symm_slab_bcast_plain(a_hi, a_lo, p_hi, p_lo, it, kt, lt, *,
                                    ms):
    """`gemv_df64_symm_slab_plain(packed=True)` with the lo plane one
    broadcast (tb, tb) tile, expanded over the walk."""
    gemv_df64_symm_slab_bcast_plain.calls += 1
    tb, ms = _slab_geometry("gemv_df64_symm_slab", a_hi, p_hi, it, kt, lt,
                            ms, True, None)
    _check_walk(*_host_tables(it, kt, lt), p_hi.shape[0] // tb, ms // tb)
    tiles = a_hi.to(torch.float64) + _tile_plane(a_lo, a_hi).to(
        torch.float64)
    return _df64_slab_parts(tiles, p_hi, p_lo, it, kt, lt, ms, tb)


def gemv_df64_symm_slab_zero_plain(a_hi, p_hi, p_lo, it, kt, lt, *, ms):
    """`gemv_df64_symm_slab_bcast_plain` over a zero lo tile, which is
    not taken: the f64 walk of the hi plane."""
    gemv_df64_symm_slab_zero_plain.calls += 1
    tb, ms = _slab_geometry("gemv_df64_symm_slab", a_hi, p_hi, it, kt, lt,
                            ms, True, None)
    _check_walk(*_host_tables(it, kt, lt), p_hi.shape[0] // tb, ms // tb)
    return _df64_slab_parts(a_hi.to(torch.float64), p_hi, p_lo, it, kt, lt,
                            ms, tb)


def gemv_q16_symm_slab_plain(q1_slab, sc1, p, it, kt, lt, *, ms):
    """Plain PyTorch q16 slab walk in f32 over the (T*tb, tb) int16 q1
    plane, the per-tile scales sc1 (T,) folded into p: (yd (ms,),
    yt (n,))."""
    gemv_q16_symm_slab_plain.calls += 1
    return _q16_slab_parts(q1_slab, sc1, p, it, kt, lt, ms)


def _q16_slab_parts(q1_slab, sc1, p, it, kt, lt, ms):
    tb, ms = _slab_geometry("gemv_q16_symm_slab", q1_slab, p, it, kt, lt,
                            ms, True, None)
    _check_walk(*_host_tables(it, kt, lt), p.shape[0] // tb, ms // tb)
    return _slab_parts(q1_slab.to(torch.float32), p, it, kt, lt, ms, tb,
                       True, sc1)


def gemv_q16_symm_slab_bf16_plain(q1_slab, sc1, p, it, kt, lt, *, ms):
    """The bf16 engine of `gemv_q16_symm_slab_plain`: tile values and
    scaled operand values rounded to bf16, exact products, f32 sums."""
    gemv_q16_symm_slab_bf16_plain.calls += 1
    tb, ms = _slab_geometry("gemv_q16_symm_slab", q1_slab, p, it, kt, lt,
                            ms, True, None)
    _check_walk(*_host_tables(it, kt, lt), p.shape[0] // tb, ms // tb)
    return _slab_parts(_bf16(q1_slab.to(torch.float32)), p, it, kt, lt, ms,
                       tb, True, sc1, _bf16)


def _df64_slab_parts(tiles, p_hi, p_lo, it, kt, lt, ms, tb):
    """The f64 walk of dequantized (T*tb, tb) f64 tiles, as f32 pairs."""
    p = p_hi.to(torch.float64) + p_lo.to(torch.float64)
    yd, yt = _slab_parts(tiles, p, it, kt, lt, ms, tb, True)
    return (*split_f64(yd), *split_f64(yt))


def gemv_fq_symm_slab_plain(q1, q2, q3, s1, s2, s3, p_hi, p_lo, it, kt, lt,
                            *, ms):
    """Plain PyTorch fq slab walk, computed in float64 from the cascade
    q1*s1 + q2*s2 + q3*s3 (each product exact): (yd_hi, yd_lo, yt_hi,
    yt_lo), the f32 splits of yd and yt."""
    gemv_fq_symm_slab_plain.calls += 1
    return _fq_slab_parts(((q1, s1), (q2, s2), (q3, s3)), p_hi, p_lo, it, kt,
                          lt, ms)


def gemv_fq_symm_slab_bcast_plain(q1, q2, q3, s1, s2, s3, p_hi, p_lo, it,
                                  kt, lt, *, ms):
    """`gemv_fq_symm_slab_plain` with q2 and/or q3 one broadcast (tb, tb)
    tile, expanded over the walk."""
    gemv_fq_symm_slab_bcast_plain.calls += 1
    return _fq_slab_parts(((q1, s1), (_tile_plane(q2, q1), s2),
                           (_tile_plane(q3, q1), s3)), p_hi, p_lo, it, kt,
                          lt, ms)


def gemv_fq_symm_slab_zero_plain(q1, s1, p_hi, p_lo, it, kt, lt, *, ms):
    """`gemv_fq_symm_slab_bcast_plain` over zero q2/q3 tiles, which are
    not taken: the f64 slab walk of q1 against s1."""
    gemv_fq_symm_slab_zero_plain.calls += 1
    return _fq_slab_parts(((q1, s1),), p_hi, p_lo, it, kt, lt, ms)


def _fq_slab_parts(planes, p_hi, p_lo, it, kt, lt, ms):
    """The f64 slab walk of the fq cascade: `planes` the (plane, scale
    table) pairs, q1's first, each of q1's shape."""
    q1 = planes[0][0]
    tb, ms = _slab_geometry("gemv_fq_symm_slab", q1, p_hi, it, kt, lt, ms,
                            True, None)
    _check_walk(*_host_tables(it, kt, lt), p_hi.shape[0] // tb, ms // tb)
    tiles = sum(q.to(torch.float64) * s.to(torch.float64).repeat_interleave(
        tb)[:, None] for q, s in planes)
    return _df64_slab_parts(tiles, p_hi, p_lo, it, kt, lt, ms, tb)


def gemv_dfq_symm_slab_plain(ah_slab, alq_slab, sc, p_hi, p_lo, it, kt, lt,
                             *, ms):
    """Plain PyTorch dfq slab walk, computed in float64 from the tiles
    hi + loq * sc (exact products): (yd_hi, yd_lo, yt_hi, yt_lo)."""
    gemv_dfq_symm_slab_plain.calls += 1
    tb, ms = _slab_geometry("gemv_dfq_symm_slab", ah_slab, p_hi, it, kt, lt,
                            ms, True, None)
    _check_walk(*_host_tables(it, kt, lt), p_hi.shape[0] // tb, ms // tb)
    tiles = (ah_slab.to(torch.float64) + alq_slab.to(torch.float64)
             * sc.to(torch.float64).repeat_interleave(tb)[:, None])
    return _df64_slab_parts(tiles, p_hi, p_lo, it, kt, lt, ms, tb)


def _dual_geometry(buf, p, q, what):
    """(tb, mb, cb) of a dual matvec: the rectangle of q.shape[0] rows
    and p.shape[0] columns in tb-wide tiles; raises lam_tpu's ValueErrors
    (lam_tpu/ops/gemv.py:1494-1509)."""
    tb = buf.shape[1]
    n, ms = p.shape[0], q.shape[0]
    if tb < layout._LANES or tb & (tb - 1):
        raise ValueError(f"{what}: packed tile width {tb} must be a "
                         f"power-of-two multiple of {layout._LANES}")
    if n % tb or ms % tb or buf.shape[0] % tb:
        raise ValueError(f"{what}: n={n}, ms={ms} and packed rows "
                         f"{buf.shape[0]} must be multiples of tb={tb}")
    mb, cb = ms // tb, n // tb
    if buf.shape[0] // tb < mb * cb:
        raise ValueError(
            f"{what}: packed buffer has {buf.shape[0] // tb} tiles, "
            f"rectangle ({ms}, {n}) needs {mb * cb}")
    return tb, mb, cb


def _dual_parts(tiles, p, q, mb, cb, scale=None, rounding=None):
    """Plain dual matvec of the first mb*cb row-major tiles of `tiles`
    (T, tb, tb), p (n,) and q (ms,) in the tiles' dtype: (S @ p (ms,),
    S^T @ q (n,)). A per-tile `scale` (T,) is folded into p and q, then
    `rounding` applied."""
    tb = tiles.shape[1]
    t4 = tiles[:mb * cb].reshape(mb, cb, tb, tb)
    pk = p.reshape(1, cb, tb).expand(mb, cb, tb)
    ql = q.reshape(mb, 1, tb).expand(mb, cb, tb)
    if scale is not None:
        sc = scale[:mb * cb].reshape(mb, cb, 1)
        pk, ql = pk * sc, ql * sc
    if rounding is not None:
        pk, ql = rounding(pk), rounding(ql)
    yd = torch.einsum("lkij,lkj->li", t4, pk)
    yt = torch.einsum("lkij,lki->kj", t4, ql)
    return yd.reshape(-1), yt.reshape(-1)


def _dual_df64_parts(tiles, p_hi, p_lo, q_hi, q_lo, mb, cb):
    """The f64 dual matvec of f64 tiles (T, tb, tb), as f32 pairs."""
    p = p_hi.to(torch.float64) + p_lo.to(torch.float64)
    q = q_hi.to(torch.float64) + q_lo.to(torch.float64)
    yd, yt = _dual_parts(tiles, p, q, mb, cb)
    return (*split_f64(yd), *split_f64(yt))


def gemv_f32_dual_plain(buf, p, q):
    """Plain PyTorch (S @ p, S^T @ q) in f32 over the row-major tiles of
    buf (T*tb, tb)."""
    gemv_f32_dual_plain.calls += 1
    tb, mb, cb = _dual_geometry(buf, p, q, "gemv_f32_dual")
    return _dual_parts(buf.reshape(-1, tb, tb), p, q, mb, cb)


def gemv_df64_dual_plain(buf_hi, buf_lo, p_hi, p_lo, q_hi, q_lo):
    """Plain PyTorch dual matvec of S = buf_hi + buf_lo computed in
    float64: (yd_hi, yd_lo, yt_hi, yt_lo), the f32 splits of S @ p and
    S^T @ q."""
    gemv_df64_dual_plain.calls += 1
    tb, mb, cb = _dual_geometry(buf_hi, p_hi, q_hi, "gemv_df64_dual")
    rows = mb * cb * tb
    tiles = (buf_hi[:rows].to(torch.float64)
             + buf_lo[:rows].to(torch.float64)).reshape(-1, tb, tb)
    return _dual_df64_parts(tiles, p_hi, p_lo, q_hi, q_lo, mb, cb)


def gemv_df64_dual_bcast_plain(buf_hi, buf_lo, p_hi, p_lo, q_hi, q_lo):
    """`gemv_df64_dual_plain` with the lo plane one broadcast (tb, tb)
    tile, expanded over the rectangle."""
    gemv_df64_dual_bcast_plain.calls += 1
    tb, mb, cb = _dual_geometry(buf_hi, p_hi, q_hi, "gemv_df64_dual")
    tiles = (buf_hi.to(torch.float64) + _tile_plane(buf_lo, buf_hi).to(
        torch.float64))[:mb * cb * tb].reshape(-1, tb, tb)
    return _dual_df64_parts(tiles, p_hi, p_lo, q_hi, q_lo, mb, cb)


def gemv_df64_dual_zero_plain(buf_hi, p_hi, p_lo, q_hi, q_lo):
    """`gemv_df64_dual_bcast_plain` over a zero lo tile, which is not
    taken: the f64 dual matvec of the hi rectangle."""
    gemv_df64_dual_zero_plain.calls += 1
    tb, mb, cb = _dual_geometry(buf_hi, p_hi, q_hi, "gemv_df64_dual")
    tiles = buf_hi[:mb * cb * tb].to(torch.float64).reshape(-1, tb, tb)
    return _dual_df64_parts(tiles, p_hi, p_lo, q_hi, q_lo, mb, cb)


def gemv_dfq_dual_plain(buf_hi, buf_loq, sc, p_hi, p_lo, q_hi, q_lo):
    """Plain PyTorch dfq dual matvec, computed in float64 from the tiles
    hi + loq * sc (exact products): (yd_hi, yd_lo, yt_hi, yt_lo)."""
    gemv_dfq_dual_plain.calls += 1
    tb, mb, cb = _dual_geometry(buf_hi, p_hi, q_hi, "gemv_dfq_dual")
    rows, nt = mb * cb * tb, mb * cb
    tiles = (buf_hi[:rows].to(torch.float64).reshape(nt, tb, tb)
             + buf_loq[:rows].to(torch.float64).reshape(nt, tb, tb)
             * sc[:nt].to(torch.float64)[:, None, None])
    return _dual_df64_parts(tiles, p_hi, p_lo, q_hi, q_lo, mb, cb)


def gemv_q16_dual_plain(q1buf, sc, p, q):
    """Plain PyTorch q16 dual matvec in f32 over the int16 q1 tiles, the
    per-tile scales sc folded into p and q: (S @ p, S^T @ q)."""
    gemv_q16_dual_plain.calls += 1
    return _q16_dual_parts(q1buf, sc, p, q)


def _q16_dual_parts(q1buf, sc, p, q):
    tb, mb, cb = _dual_geometry(q1buf, p, q, "gemv_q16_dual")
    tiles = q1buf[:mb * cb * tb].to(torch.float32).reshape(-1, tb, tb)
    return _dual_parts(tiles, p, q, mb, cb, sc)


def gemv_q16_dual_bf16_plain(q1buf, sc, p, q):
    """The bf16 engine of `gemv_q16_dual_plain`: tile values and scaled
    operand values rounded to bf16, exact products, f32 sums."""
    gemv_q16_dual_bf16_plain.calls += 1
    return _q16_dual_bf16_parts(q1buf, sc, p, q)


def _q16_dual_bf16_parts(q1buf, sc, p, q):
    tb, mb, cb = _dual_geometry(q1buf, p, q, "gemv_q16_dual")
    tiles = _bf16(q1buf[:mb * cb * tb].to(torch.float32)).reshape(-1, tb, tb)
    return _dual_parts(tiles, p, q, mb, cb, sc, _bf16)


def gemv_fq_dual_plain(q1, q2, q3, s1, s2, s3, p_hi, p_lo, q_hi, q_lo):
    """Plain PyTorch fq dual matvec, computed in float64 from the cascade
    q1*s1 + q2*s2 + q3*s3 (each product exact): (yd_hi, yd_lo, yt_hi,
    yt_lo)."""
    gemv_fq_dual_plain.calls += 1
    return _fq_dual_parts(((q1, s1), (q2, s2), (q3, s3)), p_hi, p_lo, q_hi,
                          q_lo)


def gemv_fq_dual_bcast_plain(q1, q2, q3, s1, s2, s3, p_hi, p_lo, q_hi,
                             q_lo):
    """`gemv_fq_dual_plain` with q2 and/or q3 one broadcast (tb, tb) tile,
    expanded over the rectangle."""
    gemv_fq_dual_bcast_plain.calls += 1
    return _fq_dual_parts(((q1, s1), (_tile_plane(q2, q1), s2),
                           (_tile_plane(q3, q1), s3)), p_hi, p_lo, q_hi, q_lo)


def gemv_fq_dual_zero_plain(q1, s1, p_hi, p_lo, q_hi, q_lo):
    """`gemv_fq_dual_bcast_plain` over zero q2/q3 tiles, which are not
    taken: the f64 dual matvec of q1 against s1."""
    gemv_fq_dual_zero_plain.calls += 1
    return _fq_dual_parts(((q1, s1),), p_hi, p_lo, q_hi, q_lo)


def _fq_dual_parts(planes, p_hi, p_lo, q_hi, q_lo):
    """The f64 dual walk of the fq cascade over the rectangle's real
    tiles: `planes` the (plane, scale table) pairs, q1's first, each of
    q1's shape."""
    q1 = planes[0][0]
    tb, mb, cb = _dual_geometry(q1, p_hi, q_hi, "gemv_fq_dual")
    rows, nt = mb * cb * tb, mb * cb
    tiles = sum(q[:rows].to(torch.float64).reshape(nt, tb, tb)
                * s[:nt].to(torch.float64)[:, None, None]
                for q, s in planes)
    return _dual_df64_parts(tiles, p_hi, p_lo, q_hi, q_lo, mb, cb)


_DTYPES = {"a": torch.float32, "q": torch.int16, "s": torch.float32,
           "p": torch.float32, "t": torch.int32}
_TABLES = ("it", "kt", "lt")


def _check(what, tensors, device):
    """Raise ValueError unless every tensor is a contiguous tensor on
    `device` (cpu or cuda) of its kind's dtype: the planes (a*: f32;
    q* and *q, the quantized planes: int16) 2-D, the scale tables (s*:
    f32), vectors (p*, and q_* of the dual matvecs: f32) and walk tables
    (it, kt, lt: int32) 1-D."""
    for name, x in tensors.items():
        kind = ("t" if name in _TABLES else
                "p" if name.startswith("q_") else
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


def _check_tma(what, vectors):
    """Raise ValueError unless every CUDA vector is 16-byte aligned: the
    strip walk (csrc/strip_walk.cuh) copies its slices with TMA, which
    takes no other address."""
    for name, x in vectors.items():
        if x.is_cuda and x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned (the "
                             "strip walk copies it with TMA)")


def _raise_on(what, code):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def _tri_call(wrapper, entry, operands, geometry, pairs, flags=()):
    """Launch the triangle-walk kernel `entry` of csrc/gemv_symm.cu for
    `wrapper` on the current stream: `operands` are the planes, scale
    tables and operand vector(s) in the entry point's order (the last one
    of length n), `flags` its int arguments before nblk. Returns y in
    f32, or with pairs=True (an f64 walk) (y_hi, y_lo)."""
    from lam_tpu_torch.ops._build import library
    lib = library()
    what = wrapper.__name__
    nblk, n_d, n_t = _kernel_geometry(geometry, what, lib)
    device = operands[-1].device
    acc_dtype = torch.float64 if pairs else torch.float32
    out = [torch.empty_like(operands[-1]) for _ in range(2 if pairs else 1)]
    part_d = torch.empty(n_d, dtype=acc_dtype, device=device)
    part_t = torch.empty(n_t, dtype=acc_dtype, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            *(x.data_ptr() for x in (*operands, *out, part_d, part_t)),
            *flags, nblk, stream)
    wrapper.launches += 1
    _raise_on(what, code)
    return tuple(out) if pairs else out[0]


def _square(a, n):
    """True where `a` is the full (n, n) square of more than one 512-wide
    tile: the square walk's operand (lam_tpu's packed=False). A square of
    one tile is its own packed buffer, and either walk gives its
    product."""
    return tuple(a.shape) == (n, n) and n > layout.SYMM_TB


def gemv_f32_symm(a, p):
    """y = A @ p for symmetric f32 A stored as packed lower-triangle
    tiles a (T*tb, tb), or as the full (n, n) square, of which only the
    lower-triangle tiles are read (`gemv_f32_symm_square`); p (n,) f32.
    Exact f32 products with f32 accumulation (no TF32, no bf16)."""
    what = "gemv_f32_symm"
    if _square(a, p.shape[0]):
        return gemv_f32_symm_square(a, p)
    _check(what, {"a": a, "p": p}, a.device)
    geometry = layout.packed_geometry(a.shape, p.shape[0], what)
    if a.device.type == "cpu":
        return gemv_f32_symm_plain(a, p)
    return _tri_call(gemv_f32_symm, "lam_gemv_f32_symm", (a, p), geometry,
                     False)


def gemv_f32_symm_square(a, p):
    """y = A @ p for symmetric f32 A held as the row-major (n, n) square
    (lam_tpu's gemv_f32_symm(packed=False)): the triangle walk reads the
    lower-triangle tiles in place, half the bytes of a dense matvec and
    the packed kernel's sums, in its order."""
    what = "gemv_f32_symm_square"
    _check(what, {"a": a, "p": p}, a.device)
    n = p.shape[0]
    if tuple(a.shape) != (n, n):
        raise ValueError(f"symmetric gemv needs a square matrix, got "
                         f"{tuple(a.shape)}")
    geometry = _square_geometry(n)
    if a.device.type == "cpu":
        return gemv_f32_symm_square_plain(a, p)
    return _tri_call(gemv_f32_symm_square, "lam_gemv_f32_symm_square",
                     (a, p), geometry, False)


def gemv_df64_symm(a_hi, a_lo, p_hi, p_lo, *, comp=None):
    """(y_hi, y_lo) = A @ p for symmetric A = a_hi + a_lo, p = p_hi + p_lo,
    the (hi, lo) f32 planes stored as packed lower-triangle tiles; the lo
    plane may be one (tb, tb) broadcast tile that every tile reads
    (`gemv_df64_symm_bcast`: generate mode's zero lo plane, lam_tpu's
    _lo_plane_map); or both planes full (n, n) squares, read in place
    (`gemv_df64_symm_square`).

    The kernel accumulates in native f64 (csrc/gemv_symm.cu), so the
    TPU kernel's compensation budgets 'nolow' and 'full' are both met
    and `comp` selects nothing; other values raise as in lam_tpu."""
    what = "gemv_df64_symm"
    _comp_and_pairs(what, comp, p_hi, p_lo)
    tb = a_hi.shape[-1]
    if _square(a_hi, p_hi.shape[0]):
        if a_lo.shape != a_hi.shape:
            raise ValueError(
                f"{what}: lo plane must match the hi plane "
                f"{tuple(a_hi.shape)}, got {tuple(a_lo.shape)}: the single "
                f"({tb}, {tb}) broadcast tile goes with the packed hi "
                "plane only")
        return gemv_df64_symm_square(a_hi, a_lo, p_hi, p_lo)
    if a_lo.shape != a_hi.shape:
        if tuple(a_lo.shape) == (tb, tb):
            return gemv_df64_symm_bcast(a_hi, a_lo, p_hi, p_lo)
        raise ValueError(
            f"{what}: lo plane must match the hi plane {tuple(a_hi.shape)} "
            f"or be a single ({tb}, {tb}) broadcast tile, got "
            f"{tuple(a_lo.shape)}")
    _check(what, {"a_hi": a_hi, "a_lo": a_lo, "p_hi": p_hi, "p_lo": p_lo},
           a_hi.device)
    geometry = layout.packed_geometry(a_hi.shape, p_hi.shape[0], what)
    if a_hi.device.type == "cpu":
        return gemv_df64_symm_plain(a_hi, a_lo, p_hi, p_lo)
    return _tri_call(gemv_df64_symm, "lam_gemv_df64_symm",
                     (a_hi, a_lo, p_hi, p_lo), geometry, True)


def gemv_df64_symm_square(a_hi, a_lo, p_hi, p_lo, *, comp=None):
    """The df64 twin of `gemv_f32_symm_square` (lam_tpu's
    gemv_df64_symm(packed=False)): (hi, lo) full (n, n) squares, their
    lower-triangle tiles read in place, formed and accumulated in native
    f64 and returned as the f32 split."""
    what = "gemv_df64_symm_square"
    _comp_and_pairs(what, comp, p_hi, p_lo)
    _check(what, {"a_hi": a_hi, "a_lo": a_lo, "p_hi": p_hi, "p_lo": p_lo},
           a_hi.device)
    n = p_hi.shape[0]
    if tuple(a_hi.shape) != (n, n) or a_lo.shape != a_hi.shape:
        raise ValueError(f"symmetric df64 gemv needs square planes, got "
                         f"{tuple(a_hi.shape)} and {tuple(a_lo.shape)}")
    geometry = _square_geometry(n)
    if a_hi.device.type == "cpu":
        return gemv_df64_symm_square_plain(a_hi, a_lo, p_hi, p_lo)
    return _tri_call(gemv_df64_symm_square, "lam_gemv_df64_symm_square",
                     (a_hi, a_lo, p_hi, p_lo), geometry, True)


def gemv_df64_symm_bcast(a_hi, a_lo, p_hi, p_lo, *, comp=None):
    """`gemv_df64_symm` over the packed hi plane (T*tb, tb) and ONE
    (tb, tb) lo tile that every walk position reads at the element's row
    and column within its tile (lam_tpu's constant (0, 0) index map, any
    tile, not only a zero one). Only the hi plane streams from memory; on
    a zero tile the result is the full-plane kernel's over a zero plane,
    bit for bit."""
    what = "gemv_df64_symm_bcast"
    _comp_and_pairs(what, comp, p_hi, p_lo)
    _check(what, {"a_hi": a_hi, "a_lo": a_lo, "p_hi": p_hi, "p_lo": p_lo},
           a_hi.device)
    tb = a_hi.shape[1]
    if tuple(a_lo.shape) != (tb, tb):
        raise ValueError(f"{what}: the lo tile must be ({tb}, {tb}), got "
                         f"{tuple(a_lo.shape)}")
    geometry = layout.packed_geometry(a_hi.shape, p_hi.shape[0], what)
    if a_hi.device.type == "cpu":
        return gemv_df64_symm_bcast_plain(a_hi, a_lo, p_hi, p_lo)
    return _tri_call(gemv_df64_symm_bcast, "lam_gemv_df64_symm_bcast",
                     (a_hi, a_lo, p_hi, p_lo), geometry, True)


def gemv_dfq_symm(a_hi, a_loq, sc, p_hi, p_lo, *, comp=None):
    """(y_hi, y_lo) = A @ p for symmetric A in the dfq storage: the f32
    hi plane of the packed lower triangle (T*tb, tb) plus the lo plane
    quantized to int16 tiles a_loq against the (T,) per-tile power-of-two
    scales sc (6 B per stored element, ~2^-39 tile-relative accuracy);
    p = p_hi + p_lo.

    The kernel forms hi + loq * sc and accumulates in native f64, so
    `comp` selects nothing, as in `gemv_df64_symm`."""
    what = "gemv_dfq_symm"
    _comp_and_pairs(what, comp, p_hi, p_lo)
    if a_loq.shape != a_hi.shape:
        raise ValueError(f"quantized lo plane shape {tuple(a_loq.shape)} != "
                         f"hi plane {tuple(a_hi.shape)}")
    _check(what, {"a_hi": a_hi, "a_loq": a_loq, "sc": sc, "p_hi": p_hi,
                  "p_lo": p_lo}, a_hi.device)
    geometry = layout.packed_geometry(a_hi.shape, p_hi.shape[0], what)
    _check_scales(what, geometry[2], {"sc": sc})
    if a_hi.device.type == "cpu":
        return gemv_dfq_symm_plain(a_hi, a_loq, sc, p_hi, p_lo)
    return _tri_call(gemv_dfq_symm, "lam_gemv_dfq_symm",
                     (a_hi, a_loq, sc, p_hi, p_lo), geometry, True)


def gemv_q16_symm(q1, s1, p):
    """y ~= A @ p for symmetric A stored as the q1 plane of the fq
    cascade: int16 walk-order triangle tiles (T or padded Ts tiles)
    against per-tile power-of-two scales s1, p (n,) f32. 2 B per stored
    element; ~2^-16 tile-relative operator error. Exact int16 -> f32
    conversion and the scale folded into p; the product engine is
    `_q16_impl(n)`: exact f32 products with f32 accumulation (no TF32, no
    bf16) under 'vpu', `gemv_q16_symm_bf16` under 'mxu'. As in lam_tpu,
    'mxu' reaches only planes of a multiple of Q16_P tiles with nblk >= 2
    (its blocked grid, lam_tpu/ops/gemv.py:2089); any other plane takes
    the one-tile grid, whose body is exact (:2091-2136)."""
    if _q16_impl(p.shape[0]) == "mxu" and _q16_blocked(q1, p):
        return gemv_q16_symm_bf16(q1, s1, p)
    return _q16_symm(gemv_q16_symm, gemv_q16_symm_plain,
                     "lam_gemv_q16_symm", q1, s1, p)


def gemv_q16_symm_bf16(q1, s1, p):
    """The bf16 product engine of `gemv_q16_symm` (lam_tpu's 'mxu' body):
    each tile value and each scaled operand value p * s rounded to bf16
    (nearest even), the exact products summed in f32 on the tensor
    cores; ~2^-9 operator error."""
    return _q16_symm(gemv_q16_symm_bf16, gemv_q16_symm_bf16_plain,
                     "lam_gemv_q16_symm_bf16", q1, s1, p)


def _q16_blocked(q1, p):
    """True where lam_tpu's gemv_q16_symm runs its blocked grid: a stored
    tile count that is a multiple of Q16_P, and nblk >= 2."""
    _, nblk, T = layout.packed_geometry(q1.shape, p.shape[0],
                                        "gemv_q16_symm", padded=True)
    return T % layout.Q16_P == 0 and nblk >= 2


def _q16_symm(wrapper, plain, entry, q1, s1, p):
    """The q16 triangle walk of one engine: checks, then the plain
    version on a CPU tensor or the kernel `entry` on a CUDA one."""
    what = "gemv_q16_symm"
    _check(what, {"q1": q1, "s1": s1, "p": p}, q1.device)
    geometry = layout.packed_geometry(q1.shape, p.shape[0], what,
                                      padded=True)
    _check_scales(what, geometry[2], {"s1": s1})
    if q1.device.type == "cpu":
        return plain(q1, s1, p)
    return _tri_call(wrapper, entry, (q1, s1, p), geometry, False)


def _fq_checks(what, comp, q1, q2, q3, s1, s2, s3, p_hi, p_lo):
    """The fq triangle walk's checks; returns its packed geometry."""
    _comp_and_pairs(what, comp, p_hi, p_lo)
    _check(what, {"q1": q1, "q2": q2, "q3": q3, "s1": s1, "s2": s2,
                  "s3": s3, "p_hi": p_hi, "p_lo": p_lo}, q1.device)
    geometry = layout.packed_geometry(q1.shape, p_hi.shape[0], what,
                                      padded=True)
    _check_scales(what, geometry[2], {"s1": s1, "s2": s2, "s3": s3})
    return geometry


def gemv_fq_symm(q1, q2, q3, s1, s2, s3, p_hi, p_lo, *, comp=None):
    """(y_hi, y_lo) = A @ p for symmetric A in the fully-quantized fq
    storage: three int16 walk-order triangle planes (T or padded Ts
    tiles) against per-tile power-of-two scale tables, 6 B per stored
    element, ~2^-48 tile-relative accuracy; p = p_hi + p_lo. q2 and q3 may
    each be one (tb, tb) broadcast tile (`gemv_fq_symm_bcast`: generate
    mode's zero residual planes).

    The kernel forms the cascade and accumulates in native f64, so
    `comp` selects nothing, as in `gemv_df64_symm`."""
    what = "gemv_fq_symm"
    if _has_tile(q1, q2, q3):
        return gemv_fq_symm_bcast(q1, q2, q3, s1, s2, s3, p_hi, p_lo,
                                  comp=comp)
    geometry = _fq_checks(what, comp, q1, q2, q3, s1, s2, s3, p_hi, p_lo)
    if q1.device.type == "cpu":
        return gemv_fq_symm_plain(q1, q2, q3, s1, s2, s3, p_hi, p_lo)
    return _tri_call(gemv_fq_symm, "lam_gemv_fq_symm",
                     (q1, q2, q3, s1, s2, s3, p_hi, p_lo), geometry, True)


def gemv_fq_symm_bcast(q1, q2, q3, s1, s2, s3, p_hi, p_lo, *, comp=None):
    """`gemv_fq_symm` with q2 and/or q3 ONE (tb, tb) tile that every walk
    position reads at the element's row and column within its tile
    (lam_tpu's pinned block (0, 0), any tile); the other one, if any, a
    plane of q1's shape. The scale tables stay per tile. Only q1 streams
    from memory where both are tiles; on zero tiles the result is the
    full-plane kernel's over zero planes, bit for bit."""
    what = "gemv_fq_symm_bcast"
    _check_tiles(q1, q2, q3)
    geometry = _fq_checks(what, comp, q1, q2, q3, s1, s2, s3, p_hi, p_lo)
    if q1.device.type == "cpu":
        return gemv_fq_symm_bcast_plain(q1, q2, q3, s1, s2, s3, p_hi, p_lo)
    return _tri_call(gemv_fq_symm_bcast, "lam_gemv_fq_symm_bcast",
                     (q1, q2, q3, s1, s2, s3, p_hi, p_lo), geometry, True,
                     (int(q2.shape != q1.shape), int(q3.shape != q1.shape)))


def gemv_fq_symm_zero(q1, s1, p_hi, p_lo, *, comp=None):
    """`gemv_fq_symm_bcast` over q2 and q3 tiles that hold only zeros
    (generate mode's), which it does not take: (y_hi, y_lo) = A @ p for
    A = q1 * s1, q1 alone streamed through the strip walk
    (csrc/strip_walk.cuh), with the bits of `gemv_fq_symm` over zero
    q2/q3 planes and any finite s2, s3."""
    what = "gemv_fq_symm_zero"
    _comp_and_pairs(what, comp, p_hi, p_lo)
    _check(what, {"q1": q1, "s1": s1, "p_hi": p_hi, "p_lo": p_lo},
           q1.device)
    geometry = layout.packed_geometry(q1.shape, p_hi.shape[0], what,
                                      padded=True)
    _check_scales(what, geometry[2], {"s1": s1})
    if q1.device.type == "cpu":
        return gemv_fq_symm_zero_plain(q1, s1, p_hi, p_lo)
    _check_tma(what, {"p_hi": p_hi, "p_lo": p_lo})
    return _tri_call(gemv_fq_symm_zero, "lam_gemv_fq_symm_zero",
                     (q1, s1, p_hi, p_lo), geometry, True)


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


def _df64_cols_geometry(what, a_hi, a_lo, p_hi, p_lo, blk):
    """(blk, m, n, nb) of a df64 column-block matvec; raises unless the
    planes and operand halves match and pass `_check` and
    `_cols_geometry`."""
    if a_lo.shape != a_hi.shape:
        raise ValueError(f"{what}: a_lo {tuple(a_lo.shape)} and a_hi "
                         f"{tuple(a_hi.shape)} differ")
    if p_lo.shape != p_hi.shape:
        raise ValueError(f"{what}: p_hi {tuple(p_hi.shape)} and p_lo "
                         f"{tuple(p_lo.shape)} differ")
    _check(what, {"a_hi": a_hi, "a_lo": a_lo, "p_hi": p_hi, "p_lo": p_lo},
           a_hi.device)
    blk = operator.index(blk)
    return (blk, *_cols_geometry(what, a_hi, blk, p_hi, p_lo))


def gemv_df64_cols(a_hi, a_lo, p_hi, p_lo, blk):
    """(y_hi, y_lo) (m,) = A[:, blk*nb:(blk+1)*nb] @ p for a row-major
    (m, n) A = a_hi + a_lo and the (nb,) operand block p = p_hi + p_lo;
    blk is a host int. Formed and accumulated in native f64 and returned
    as the f32 split."""
    what = "gemv_df64_cols"
    blk, m, n, nb = _df64_cols_geometry(what, a_hi, a_lo, p_hi, p_lo, blk)
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


def _slab_call(wrapper, entry, operands, it, kt, lt, ms, tb, pairs,
               flags=()):
    """Launch the slab kernel `entry` of csrc/gemv_symm.cu for `wrapper`
    on the current stream: `operands` are the planes, scale tables and
    operand vector(s) in the entry point's order (the last one a vector of
    length n), `flags` its trailing int arguments. Returns (yd, yt) in
    f32, or with pairs=True (an f64 walk) (yd_hi, yd_lo, yt_hi, yt_lo)."""
    from lam_tpu_torch.ops._build import library
    lib = library()
    what = wrapper.__name__
    device, n = operands[-1].device, operands[-1].shape[0]
    if tb != lib.lam_symm_tile():
        raise ValueError(f"{what}: the CUDA kernel takes tb="
                         f"{lib.lam_symm_tile()} tiles, got tb={tb}")
    T = it.shape[0]
    lists = _slab_lists(it, kt, lt, n // tb, ms // tb)
    acc_dtype = torch.float64 if pairs else torch.float32
    part_d = torch.empty(T * tb, dtype=acc_dtype, device=device)
    part_t = torch.empty(T * lib.lam_symm_strips() * tb, dtype=acc_dtype,
                         device=device)
    out = [torch.empty(size, dtype=torch.float32, device=device)
           for size in ((ms, ms, n, n) if pairs else (ms, n))]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            *(x.data_ptr() for x in (*operands, it, kt, lt, *lists, *out,
                                     part_d, part_t)),
            T, ms, n, *flags, stream)
    wrapper.launches += 1
    _raise_on(what, code)
    return tuple(out)


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
    return _slab_call(gemv_f32_symm_slab, "lam_gemv_f32_symm_slab",
                      (a_slab, p), it, kt, lt, ms, tb, False,
                      (int(packed),))


def gemv_df64_symm_slab(a_hi, a_lo, p_hi, p_lo, it, kt, lt, *, ms=None,
                        packed=False, tb=None):
    """The df64 twin of `gemv_f32_symm_slab` for A = a_hi + a_lo and
    p = p_hi + p_lo: returns (yd_hi, yd_lo, yt_hi, yt_lo), formed and
    accumulated in native f64. With packed=True the lo plane may be one
    (tb, tb) broadcast tile (`gemv_df64_symm_slab_bcast`: generate mode's
    zero lo plane); the slab storage takes none, as in lam_tpu."""
    what = "gemv_df64_symm_slab"
    if a_lo.shape != a_hi.shape:
        if not packed:
            raise ValueError(f"plane shapes differ: {tuple(a_hi.shape)} vs "
                             f"{tuple(a_lo.shape)}")
        tb = a_hi.shape[-1]
        if tuple(a_lo.shape) == (tb, tb):
            return gemv_df64_symm_slab_bcast(a_hi, a_lo, p_hi, p_lo, it, kt,
                                             lt, ms=ms)
        raise ValueError(
            f"{what}: lo plane must match the hi plane {tuple(a_hi.shape)} "
            f"or be a single ({tb}, {tb}) broadcast tile, got "
            f"{tuple(a_lo.shape)}")
    if p_lo.shape != p_hi.shape:
        raise ValueError(f"{what}: p_hi {tuple(p_hi.shape)} and p_lo "
                         f"{tuple(p_lo.shape)} differ")
    _check(what, {"a_hi": a_hi, "a_lo": a_lo, "p_hi": p_hi, "p_lo": p_lo,
                  "it": it, "kt": kt, "lt": lt}, a_hi.device)
    tb, ms = _slab_geometry(what, a_hi, p_hi, it, kt, lt, ms, packed, tb)
    if a_hi.device.type == "cpu":
        return gemv_df64_symm_slab_plain(a_hi, a_lo, p_hi, p_lo, it, kt, lt,
                                         ms=ms, packed=packed, tb=tb)
    return _slab_call(gemv_df64_symm_slab, "lam_gemv_df64_symm_slab",
                      (a_hi, a_lo, p_hi, p_lo), it, kt, lt, ms, tb, True,
                      (int(packed),))


def gemv_df64_symm_slab_bcast(a_hi, a_lo, p_hi, p_lo, it, kt, lt, *, ms,
                              comp=None):
    """`gemv_df64_symm_slab(packed=True)` over the packed hi plane (T*tb,
    tb) and ONE (tb, tb) lo tile that every walk position reads at the
    element's row and column within its tile (lam_tpu's constant (0, 0)
    index map, any tile). Only the hi plane streams from memory; on a zero
    tile the result is the full-plane kernel's over a zero plane, bit for
    bit."""
    what = "gemv_df64_symm_slab_bcast"
    _comp_and_pairs(what, comp, p_hi, p_lo)
    _check(what, {"a_hi": a_hi, "a_lo": a_lo, "p_hi": p_hi, "p_lo": p_lo,
                  "it": it, "kt": kt, "lt": lt}, a_hi.device)
    tb, ms = _slab_geometry(what, a_hi, p_hi, it, kt, lt, ms, True, None)
    if tuple(a_lo.shape) != (tb, tb):
        raise ValueError(f"{what}: the lo tile must be ({tb}, {tb}), got "
                         f"{tuple(a_lo.shape)}")
    if a_hi.device.type == "cpu":
        return gemv_df64_symm_slab_bcast_plain(a_hi, a_lo, p_hi, p_lo, it,
                                               kt, lt, ms=ms)
    return _slab_call(gemv_df64_symm_slab_bcast,
                      "lam_gemv_df64_symm_slab_bcast",
                      (a_hi, a_lo, p_hi, p_lo), it, kt, lt, ms, tb, True)


def gemv_df64_symm_slab_zero(a_hi, p_hi, p_lo, it, kt, lt, *, ms,
                             comp=None):
    """`gemv_df64_symm_slab_bcast` over a lo tile that holds only zeros
    (generate mode's), which it does not take: (yd_hi, yd_lo, yt_hi,
    yt_lo) of the packed hi plane alone, streamed through the strip walk
    (csrc/strip_walk.cuh), with the bits of `gemv_df64_symm_slab(packed=
    True)` over a zero lo plane."""
    what = "gemv_df64_symm_slab_zero"
    _comp_and_pairs(what, comp, p_hi, p_lo)
    _check(what, {"a_hi": a_hi, "p_hi": p_hi, "p_lo": p_lo, "it": it,
                  "kt": kt, "lt": lt}, a_hi.device)
    tb, ms = _slab_geometry(what, a_hi, p_hi, it, kt, lt, ms, True, None)
    if a_hi.device.type == "cpu":
        return gemv_df64_symm_slab_zero_plain(a_hi, p_hi, p_lo, it, kt, lt,
                                              ms=ms)
    _check_tma(what, {"p_hi": p_hi, "p_lo": p_lo})
    return _slab_call(gemv_df64_symm_slab_zero,
                      "lam_gemv_df64_symm_slab_zero", (a_hi, p_hi, p_lo), it,
                      kt, lt, ms, tb, True)


def _comp_and_pairs(what, comp, p_hi, p_lo):
    if comp not in (None, "nolow", "full"):
        raise ValueError(f"comp={comp!r} must be one of ('full', 'nolow')")
    if p_lo.shape != p_hi.shape:
        raise ValueError(f"{what}: p_hi {tuple(p_hi.shape)} and p_lo "
                         f"{tuple(p_lo.shape)} differ")


def gemv_q16_symm_slab(q1_slab, sc1, p, it, kt, lt, *, ms):
    """Partial q16 matvec over one rank's band-pair walk, the fq twin of
    `gemv_f32_symm_slab(packed=True)`: the rank's triangle tiles as the
    int16 q1 plane (T*tb, tb) of the fq cascade against the per-tile
    power-of-two scales sc1 (T,), one per walk position; 2 B per element
    read. Returns (yd (ms,), yt (n,)) in f32; the caller places yd at the
    rank's rows, adds the diagonal term the planes do not carry, and sums
    the ranks' parts. Exact int16 -> f32 conversion and the scale folded
    into p; the product engine is `_q16_impl(n)`: exact f32 products with
    f32 accumulation (no TF32, no bf16) under 'vpu',
    `gemv_q16_symm_slab_bf16` under 'mxu'."""
    if _q16_impl(p.shape[0]) == "mxu":
        return gemv_q16_symm_slab_bf16(q1_slab, sc1, p, it, kt, lt, ms=ms)
    return _q16_slab(gemv_q16_symm_slab, gemv_q16_symm_slab_plain,
                     "lam_gemv_q16_symm_slab", q1_slab, sc1, p, it, kt, lt,
                     ms)


def gemv_q16_symm_slab_bf16(q1_slab, sc1, p, it, kt, lt, *, ms):
    """The bf16 product engine of `gemv_q16_symm_slab` (lam_tpu's 'mxu'
    body): tile values and scaled operand values rounded to bf16 (nearest
    even), the exact products summed in f32 on the tensor cores."""
    return _q16_slab(gemv_q16_symm_slab_bf16, gemv_q16_symm_slab_bf16_plain,
                     "lam_gemv_q16_symm_slab_bf16", q1_slab, sc1, p, it, kt,
                     lt, ms)


def _q16_slab(wrapper, plain, entry, q1_slab, sc1, p, it, kt, lt, ms):
    """The q16 slab walk of one engine (see `_q16_symm`)."""
    what = "gemv_q16_symm_slab"
    _check(what, {"q1": q1_slab, "s1": sc1, "p": p, "it": it, "kt": kt,
                  "lt": lt}, q1_slab.device)
    _check_tma(what, {"p": p})
    tb, ms = _slab_geometry(what, q1_slab, p, it, kt, lt, ms, True, None)
    _check_scales(what, it.shape[0], {"scale": sc1})
    if q1_slab.device.type == "cpu":
        return plain(q1_slab, sc1, p, it, kt, lt, ms=ms)
    return _slab_call(wrapper, entry, (q1_slab, sc1, p), it, kt, lt, ms, tb,
                      False)


def gemv_fq_symm_slab(q1, q2, q3, s1, s2, s3, p_hi, p_lo, it, kt, lt, *,
                      ms, comp=None):
    """Partial fully-quantized matvec over one rank's band-pair walk, the
    fq twin of `gemv_df64_symm_slab(packed=True)`: three int16 cascade
    planes (T*tb, tb) against per-tile power-of-two scale tables (T,), 6 B
    per element; p = p_hi + p_lo. Returns (yd_hi, yd_lo, yt_hi, yt_lo);
    the diagonal term is not included (the operator holds it as an exact
    slab-order pair).

    The kernel forms the cascade and accumulates in native f64, so `comp`
    selects nothing, as in `gemv_fq_symm`. q2 and q3 may each be one
    (tb, tb) broadcast tile (`gemv_fq_symm_slab_bcast`: generate mode's
    zero residual planes)."""
    what = "gemv_fq_symm_slab"
    if _has_tile(q1, q2, q3):
        return gemv_fq_symm_slab_bcast(q1, q2, q3, s1, s2, s3, p_hi, p_lo,
                                       it, kt, lt, ms=ms, comp=comp)
    tb, ms = _fq_slab_checks(what, comp, q1, q2, q3, s1, s2, s3, p_hi, p_lo,
                             it, kt, lt, ms)
    if q1.device.type == "cpu":
        return gemv_fq_symm_slab_plain(q1, q2, q3, s1, s2, s3, p_hi, p_lo,
                                       it, kt, lt, ms=ms)
    return _slab_call(gemv_fq_symm_slab, "lam_gemv_fq_symm_slab",
                      (q1, q2, q3, s1, s2, s3, p_hi, p_lo), it, kt, lt, ms,
                      tb, True)


def _has_tile(q1, q2, q3):
    """True where q2 or q3 is not a plane of q1's shape: the broadcast
    mode's operands (which raise there unless one (tb, tb) tile each)."""
    return q2.shape != q1.shape or q3.shape != q1.shape


def _check_tiles(q1, q2, q3):
    """Raise lam_tpu's ValueError unless q2 and q3 are each a plane of
    q1's shape or one (tb, tb) tile."""
    tb = q1.shape[-1]
    for name, q in (("q2", q2), ("q3", q3)):
        if q.shape != q1.shape and tuple(q.shape) != (tb, tb):
            raise ValueError(f"{name} plane shape {tuple(q.shape)} != q1 "
                             f"plane {tuple(q1.shape)} (or one broadcast "
                             f"({tb}, {tb}) tile)")


def _fq_slab_checks(what, comp, q1, q2, q3, s1, s2, s3, p_hi, p_lo, it, kt,
                    lt, ms):
    """The fq slab walk's checks; returns (tb, ms)."""
    _comp_and_pairs(what, comp, p_hi, p_lo)
    _check_tiles(q1, q2, q3)
    _check(what, {"q1": q1, "q2": q2, "q3": q3, "s1": s1, "s2": s2,
                  "s3": s3, "p_hi": p_hi, "p_lo": p_lo, "it": it, "kt": kt,
                  "lt": lt}, q1.device)
    tb, ms = _slab_geometry(what, q1, p_hi, it, kt, lt, ms, True, None)
    _check_scales(what, it.shape[0], {"s1": s1, "s2": s2, "s3": s3})
    return tb, ms


def gemv_fq_symm_slab_bcast(q1, q2, q3, s1, s2, s3, p_hi, p_lo, it, kt, lt,
                            *, ms, comp=None):
    """`gemv_fq_symm_slab` with q2 and/or q3 ONE (tb, tb) tile that every
    walk position reads at the element's row and column within its tile
    (lam_tpu's pinned block (0, 0), any tile); the other one, if any, a
    plane of q1's shape. The scale tables stay per walk position. Only q1
    streams from memory where both are tiles; on zero tiles the result is
    the full-plane kernel's over zero planes, bit for bit."""
    what = "gemv_fq_symm_slab_bcast"
    tb, ms = _fq_slab_checks(what, comp, q1, q2, q3, s1, s2, s3, p_hi, p_lo,
                             it, kt, lt, ms)
    if q1.device.type == "cpu":
        return gemv_fq_symm_slab_bcast_plain(q1, q2, q3, s1, s2, s3, p_hi,
                                             p_lo, it, kt, lt, ms=ms)
    return _slab_call(gemv_fq_symm_slab_bcast, "lam_gemv_fq_symm_slab_bcast",
                      (q1, q2, q3, s1, s2, s3, p_hi, p_lo), it, kt, lt, ms,
                      tb, True,
                      (int(q2.shape != q1.shape), int(q3.shape != q1.shape)))


def gemv_fq_symm_slab_zero(q1, s1, p_hi, p_lo, it, kt, lt, *, ms,
                           comp=None):
    """`gemv_fq_symm_slab_bcast` over q2 and q3 tiles that hold only zeros
    (generate mode's), which it does not take: (yd_hi, yd_lo, yt_hi,
    yt_lo) of A = q1 * s1 (s1 per walk position), q1 alone streamed
    through the strip walk (csrc/strip_walk.cuh), with the bits of
    `gemv_fq_symm_slab` over zero q2/q3 planes and any finite s2, s3."""
    what = "gemv_fq_symm_slab_zero"
    _comp_and_pairs(what, comp, p_hi, p_lo)
    _check(what, {"q1": q1, "s1": s1, "p_hi": p_hi, "p_lo": p_lo, "it": it,
                  "kt": kt, "lt": lt}, q1.device)
    tb, ms = _slab_geometry(what, q1, p_hi, it, kt, lt, ms, True, None)
    _check_scales(what, it.shape[0], {"s1": s1})
    if q1.device.type == "cpu":
        return gemv_fq_symm_slab_zero_plain(q1, s1, p_hi, p_lo, it, kt, lt,
                                            ms=ms)
    _check_tma(what, {"p_hi": p_hi, "p_lo": p_lo})
    return _slab_call(gemv_fq_symm_slab_zero, "lam_gemv_fq_symm_slab_zero",
                      (q1, s1, p_hi, p_lo), it, kt, lt, ms, tb, True)


def gemv_dfq_symm_slab(ah_slab, alq_slab, sc, p_hi, p_lo, it, kt, lt, *,
                       ms, comp=None):
    """Partial quantized-lo matvec over one rank's band-pair walk, the dfq
    twin of `gemv_df64_symm_slab(packed=True)`: the f32 hi plane (T*tb,
    tb) of the rank's walk-order triangle tiles plus the lo plane as int16
    tiles against the per-tile power-of-two scales sc (T,), 6 B per
    element; p = p_hi + p_lo. Returns (yd_hi, yd_lo, yt_hi, yt_lo); the
    diagonal term is not included. Formed (hi + loq * sc) and accumulated
    in native f64, so `comp` selects nothing."""
    what = "gemv_dfq_symm_slab"
    _comp_and_pairs(what, comp, p_hi, p_lo)
    if alq_slab.shape != ah_slab.shape:
        raise ValueError(f"quantized lo plane shape {tuple(alq_slab.shape)} "
                         f"!= hi plane {tuple(ah_slab.shape)}")
    _check(what, {"a_hi": ah_slab, "a_loq": alq_slab, "sc": sc,
                  "p_hi": p_hi, "p_lo": p_lo, "it": it, "kt": kt, "lt": lt},
           ah_slab.device)
    tb, ms = _slab_geometry(what, ah_slab, p_hi, it, kt, lt, ms, True, None)
    _check_scales(what, it.shape[0], {"scale": sc})
    if ah_slab.device.type == "cpu":
        return gemv_dfq_symm_slab_plain(ah_slab, alq_slab, sc, p_hi, p_lo,
                                        it, kt, lt, ms=ms)
    return _slab_call(gemv_dfq_symm_slab, "lam_gemv_dfq_symm_slab",
                      (ah_slab, alq_slab, sc, p_hi, p_lo), it, kt, lt, ms,
                      tb, True)


def _dual_call(wrapper, entry, operands, tb, mb, cb, pairs, flags=()):
    """Launch the dual kernel `entry` of csrc/gemv_symm.cu for `wrapper`
    on the current stream: `operands` are the planes, scale tables and the
    p and q vector(s) in the entry point's order, `flags` its int
    arguments after mb and cb. Returns (yd, yt) in f32, or with pairs=True
    (an f64 walk) (yd_hi, yd_lo, yt_hi, yt_lo)."""
    from lam_tpu_torch.ops._build import library
    lib = library()
    what = wrapper.__name__
    device = operands[0].device
    if tb != lib.lam_symm_tile():
        raise ValueError(f"{what}: the CUDA kernel takes tb="
                         f"{lib.lam_symm_tile()} tiles, got tb={tb}")
    ms, n = mb * tb, cb * tb
    acc_dtype = torch.float64 if pairs else torch.float32
    part_d = torch.empty(mb * cb * tb, dtype=acc_dtype, device=device)
    part_t = torch.empty(mb * cb * lib.lam_symm_strips() * tb,
                         dtype=acc_dtype, device=device)
    out = [torch.empty(size, dtype=torch.float32, device=device)
           for size in ((ms, ms, n, n) if pairs else (ms, n))]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            *(x.data_ptr() for x in (*operands, *out, part_d, part_t)),
            mb, cb, *flags, stream)
    wrapper.launches += 1
    _raise_on(what, code)
    return tuple(out)


def _check_pairs(what, comp, p_hi, p_lo, q_hi, q_lo):
    _comp_and_pairs(what, comp, p_hi, p_lo)
    if q_lo.shape != q_hi.shape:
        raise ValueError(f"{what}: q_hi {tuple(q_hi.shape)} and q_lo "
                         f"{tuple(q_lo.shape)} differ")


def gemv_f32_dual(buf, p, q):
    """(S @ p, S^T @ q) for a dense f32 rectangle S (ms, n) stored as
    the (T*tb, tb) row-major tile packing `buf` (T >= ms/tb * n/tb; the
    trailing pad tiles are not read). p: (n,), q: (ms,), f32. One pass
    over S; exact f32 products with f32 accumulation (no TF32, no
    bf16)."""
    what = "gemv_f32_dual"
    _check(what, {"a": buf, "p": p, "q_": q}, buf.device)
    tb, mb, cb = _dual_geometry(buf, p, q, what)
    if buf.device.type == "cpu":
        return gemv_f32_dual_plain(buf, p, q)
    return _dual_call(gemv_f32_dual, "lam_gemv_f32_dual", (buf, p, q), tb,
                      mb, cb, False)


def gemv_df64_dual(buf_hi, buf_lo, p_hi, p_lo, q_hi, q_lo, *, comp=None):
    """The df64 twin of `gemv_f32_dual` for S = buf_hi + buf_lo, p = p_hi
    + p_lo and q = q_hi + q_lo: returns (yd_hi, yd_lo, yt_hi, yt_lo), the
    f32 splits of S @ p and S^T @ q, formed and accumulated in native f64,
    so `comp` selects nothing. The lo plane may be one (tb, tb) broadcast
    tile (`gemv_df64_dual_bcast`: generate mode's zero lo plane)."""
    what = "gemv_df64_dual"
    _check_pairs(what, comp, p_hi, p_lo, q_hi, q_lo)
    if buf_lo.shape != buf_hi.shape:
        tb = buf_hi.shape[1]
        if tuple(buf_lo.shape) == (tb, tb):
            return gemv_df64_dual_bcast(buf_hi, buf_lo, p_hi, p_lo, q_hi,
                                        q_lo)
        raise ValueError(
            f"{what}: lo plane must match the hi plane "
            f"{tuple(buf_hi.shape)} or be a single ({tb}, {tb}) broadcast "
            f"tile, got {tuple(buf_lo.shape)}")
    _check(what, {"a_hi": buf_hi, "a_lo": buf_lo, "p_hi": p_hi, "p_lo": p_lo,
                  "q_hi": q_hi, "q_lo": q_lo}, buf_hi.device)
    tb, mb, cb = _dual_geometry(buf_hi, p_hi, q_hi, what)
    if buf_hi.device.type == "cpu":
        return gemv_df64_dual_plain(buf_hi, buf_lo, p_hi, p_lo, q_hi, q_lo)
    return _dual_call(gemv_df64_dual, "lam_gemv_df64_dual",
                      (buf_hi, buf_lo, p_hi, p_lo, q_hi, q_lo), tb, mb, cb,
                      True)


def gemv_df64_dual_bcast(buf_hi, buf_lo, p_hi, p_lo, q_hi, q_lo, *,
                         comp=None):
    """`gemv_df64_dual` over the hi rectangle's tiles (T*tb, tb) and ONE
    (tb, tb) lo tile that every tile reads at the element's row and column
    within its tile (lam_tpu's constant (0, 0) index map, any tile). Only
    the hi plane streams from memory; on a zero tile the result is the
    full-plane kernel's over a zero plane, bit for bit."""
    what = "gemv_df64_dual_bcast"
    _check_pairs(what, comp, p_hi, p_lo, q_hi, q_lo)
    _check(what, {"a_hi": buf_hi, "a_lo": buf_lo, "p_hi": p_hi, "p_lo": p_lo,
                  "q_hi": q_hi, "q_lo": q_lo}, buf_hi.device)
    tb, mb, cb = _dual_geometry(buf_hi, p_hi, q_hi, what)
    if tuple(buf_lo.shape) != (tb, tb):
        raise ValueError(f"{what}: the lo tile must be ({tb}, {tb}), got "
                         f"{tuple(buf_lo.shape)}")
    if buf_hi.device.type == "cpu":
        return gemv_df64_dual_bcast_plain(buf_hi, buf_lo, p_hi, p_lo, q_hi,
                                          q_lo)
    return _dual_call(gemv_df64_dual_bcast, "lam_gemv_df64_dual_bcast",
                      (buf_hi, buf_lo, p_hi, p_lo, q_hi, q_lo), tb, mb, cb,
                      True)


def gemv_df64_dual_zero(buf_hi, p_hi, p_lo, q_hi, q_lo, *, comp=None):
    """`gemv_df64_dual_bcast` over a lo tile that holds only zeros
    (generate mode's), which it does not take: (yd_hi, yd_lo, yt_hi,
    yt_lo) of the hi rectangle alone, streamed through the strip walk
    (csrc/strip_walk.cuh), with the bits of `gemv_df64_dual` over a zero
    lo plane."""
    what = "gemv_df64_dual_zero"
    _check_pairs(what, comp, p_hi, p_lo, q_hi, q_lo)
    _check(what, {"a_hi": buf_hi, "p_hi": p_hi, "p_lo": p_lo, "q_hi": q_hi,
                  "q_lo": q_lo}, buf_hi.device)
    tb, mb, cb = _dual_geometry(buf_hi, p_hi, q_hi, what)
    if buf_hi.device.type == "cpu":
        return gemv_df64_dual_zero_plain(buf_hi, p_hi, p_lo, q_hi, q_lo)
    _check_tma(what, {"p_hi": p_hi, "p_lo": p_lo, "q_hi": q_hi,
                      "q_lo": q_lo})
    return _dual_call(gemv_df64_dual_zero, "lam_gemv_df64_dual_zero",
                      (buf_hi, p_hi, p_lo, q_hi, q_lo), tb, mb, cb, True)


def gemv_dfq_dual(buf_hi, buf_loq, sc, p_hi, p_lo, q_hi, q_lo, *,
                  comp=None):
    """The dfq twin of `gemv_df64_dual`: the f32 hi plane plus the lo
    plane as int16 tiles against the per-tile power-of-two scales sc (T,),
    one per tile of the buffer in row-major order (the pad tiles' scales
    are not read); 6 B per element. Returns (yd_hi, yd_lo, yt_hi, yt_lo).
    Formed (hi + loq * sc) and accumulated in native f64, so `comp`
    selects nothing."""
    what = "gemv_dfq_dual"
    _check_pairs(what, comp, p_hi, p_lo, q_hi, q_lo)
    if buf_loq.shape != buf_hi.shape:
        raise ValueError(f"quantized lo plane shape {tuple(buf_loq.shape)} "
                         f"!= hi plane {tuple(buf_hi.shape)}")
    _check(what, {"a_hi": buf_hi, "a_loq": buf_loq, "sc": sc, "p_hi": p_hi,
                  "p_lo": p_lo, "q_hi": q_hi, "q_lo": q_lo}, buf_hi.device)
    tb, mb, cb = _dual_geometry(buf_hi, p_hi, q_hi, what)
    _check_scales(what, buf_hi.shape[0] // tb, {"scale": sc})
    if buf_hi.device.type == "cpu":
        return gemv_dfq_dual_plain(buf_hi, buf_loq, sc, p_hi, p_lo, q_hi,
                                   q_lo)
    return _dual_call(gemv_dfq_dual, "lam_gemv_dfq_dual",
                      (buf_hi, buf_loq, sc, p_hi, p_lo, q_hi, q_lo), tb, mb,
                      cb, True)


def gemv_q16_dual(q1buf, sc, p, q):
    """The q16 twin of `gemv_f32_dual`: S as the int16 q1 plane of the fq
    cascade against the per-tile power-of-two scales sc (T,) (the pad
    tiles' scales are not read); 2 B per element read. Returns (S @ p,
    S^T @ q) in f32. Exact int16 -> f32 conversion and the scale folded
    into both p and q; the product engine is `_q16_impl` of the larger of
    n and ms (lam_tpu/ops/gemv.py:2553-2556): exact f32 products with f32
    accumulation (no TF32, no bf16) under 'vpu' (the strip walk: p and q
    16-byte aligned on the card), `gemv_q16_dual_bf16` under 'mxu'."""
    if _q16_impl(max(p.shape[0], q.shape[0])) == "mxu":
        return gemv_q16_dual_bf16(q1buf, sc, p, q)
    return _q16_dual(gemv_q16_dual, gemv_q16_dual_plain, "lam_gemv_q16_dual",
                     q1buf, sc, p, q)


def gemv_q16_dual_bf16(q1buf, sc, p, q):
    """The bf16 product engine of `gemv_q16_dual` (lam_tpu's 'mxu' body):
    tile values and scaled operand values rounded to bf16 (nearest even),
    the exact products summed in f32 on the tensor cores."""
    return _q16_dual(gemv_q16_dual_bf16, gemv_q16_dual_bf16_plain,
                     "lam_gemv_q16_dual_bf16", q1buf, sc, p, q)


def _q16_dual(wrapper, plain, entry, q1buf, sc, p, q):
    """The q16 dual matvec of one engine (see `_q16_symm`)."""
    what = "gemv_q16_dual"
    _check(what, {"q1": q1buf, "s1": sc, "p": p, "q_": q}, q1buf.device)
    _check_tma(what, {"p": p, "q": q})
    tb, mb, cb = _dual_geometry(q1buf, p, q, what)
    _check_scales(what, q1buf.shape[0] // tb, {"scale": sc})
    if q1buf.device.type == "cpu":
        return plain(q1buf, sc, p, q)
    return _dual_call(wrapper, entry, (q1buf, sc, p, q), tb, mb, cb, False)


def gemv_fq_dual(q1, q2, q3, s1, s2, s3, p_hi, p_lo, q_hi, q_lo, *,
                 comp=None):
    """The fq twin of `gemv_df64_dual`: S as the three int16 cascade
    planes against per-tile power-of-two scale tables (T,), 6 B per
    element (the pad tiles' scales are not read). Returns (yd_hi, yd_lo,
    yt_hi, yt_lo). The kernel forms the cascade and accumulates in native
    f64, so `comp` selects nothing; the strip walk takes p and q 16-byte
    aligned on the card. q2 and q3 may each be one (tb, tb) broadcast tile
    (`gemv_fq_dual_bcast`: generate mode's zero residual planes), unless
    q1 is one tile itself (lam_tpu's refusal)."""
    if _has_tile(q1, q2, q3):
        return gemv_fq_dual_bcast(q1, q2, q3, s1, s2, s3, p_hi, p_lo, q_hi,
                                  q_lo, comp=comp)
    return _fq_dual(gemv_fq_dual, gemv_fq_dual_plain, "lam_gemv_fq_dual",
                    q1, q2, q3, s1, s2, s3, p_hi, p_lo, q_hi, q_lo, comp)


def gemv_fq_dual_bcast(q1, q2, q3, s1, s2, s3, p_hi, p_lo, q_hi, q_lo, *,
                       comp=None):
    """`gemv_fq_dual` with q2 and/or q3 ONE (tb, tb) tile that every tile
    of the rectangle reads at the element's row and column within its tile
    (lam_tpu's pinned block (0, 0), any tile); the other one, if any, a
    plane of q1's shape. The scale tables stay per tile. On the strip walk
    a stage of a tile plane is copied from the tile, which stays in L2;
    on zero tiles the result is the full-plane kernel's over zero planes,
    bit for bit."""
    return _fq_dual(gemv_fq_dual_bcast, gemv_fq_dual_bcast_plain,
                    "lam_gemv_fq_dual_bcast", q1, q2, q3, s1, s2, s3, p_hi,
                    p_lo, q_hi, q_lo, comp,
                    (int(q2.shape != q1.shape), int(q3.shape != q1.shape)))


def _fq_dual(wrapper, plain, entry, q1, q2, q3, s1, s2, s3, p_hi, p_lo, q_hi,
             q_lo, comp, flags=()):
    """The fq dual matvec on the walk of the C entry point `entry`, with
    the broadcast flags `flags` where the entry point takes them."""
    what = "gemv_fq_dual"
    _check_pairs(what, comp, p_hi, p_lo, q_hi, q_lo)
    # a (tb, tb) q1 takes no tile: any other shape of q2/q3 raises here
    _check_tiles(q1, q2, q3)
    if _has_tile(q1, q2, q3) and not flags:
        raise ValueError(f"{wrapper.__name__} reads full q2/q3 planes; one "
                         "broadcast tile takes gemv_fq_dual_bcast")
    _check(what, {"q1": q1, "q2": q2, "q3": q3, "s1": s1, "s2": s2,
                  "s3": s3, "p_hi": p_hi, "p_lo": p_lo, "q_hi": q_hi,
                  "q_lo": q_lo}, q1.device)
    _check_tma(what, {"p_hi": p_hi, "p_lo": p_lo, "q_hi": q_hi,
                      "q_lo": q_lo})
    tb, mb, cb = _dual_geometry(q1, p_hi, q_hi, what)
    _check_scales(what, q1.shape[0] // tb, {"s1": s1, "s2": s2, "s3": s3})
    if q1.device.type == "cpu":
        return plain(q1, q2, q3, s1, s2, s3, p_hi, p_lo, q_hi, q_lo)
    return _dual_call(wrapper, entry,
                      (q1, q2, q3, s1, s2, s3, p_hi, p_lo, q_hi, q_lo), tb,
                      mb, cb, True, flags)


def gemv_fq_dual_zero(q1, s1, p_hi, p_lo, q_hi, q_lo, *, comp=None):
    """`gemv_fq_dual_bcast` over q2 and q3 tiles that hold only zeros
    (generate mode's), which it does not take: (yd_hi, yd_lo, yt_hi,
    yt_lo) of S = q1 * s1, q1 alone streamed through the strip walk
    (csrc/strip_walk.cuh), with the bits of `gemv_fq_dual` over zero
    q2/q3 planes and any finite s2, s3."""
    what = "gemv_fq_dual_zero"
    _check_pairs(what, comp, p_hi, p_lo, q_hi, q_lo)
    _check(what, {"q1": q1, "s1": s1, "p_hi": p_hi, "p_lo": p_lo,
                  "q_hi": q_hi, "q_lo": q_lo}, q1.device)
    tb, mb, cb = _dual_geometry(q1, p_hi, q_hi, what)
    _check_scales(what, q1.shape[0] // tb, {"s1": s1})
    if q1.device.type == "cpu":
        return gemv_fq_dual_zero_plain(q1, s1, p_hi, p_lo, q_hi, q_lo)
    _check_tma(what, {"p_hi": p_hi, "p_lo": p_lo, "q_hi": q_hi,
                      "q_lo": q_lo})
    return _dual_call(gemv_fq_dual_zero, "lam_gemv_fq_dual_zero",
                      (q1, s1, p_hi, p_lo, q_hi, q_lo), tb, mb, cb, True)


KERNELS = (gemv_f32_symm, gemv_df64_symm, gemv_dfq_symm, gemv_q16_symm,
           gemv_fq_symm, gemv_f32, gemv_df64, gemv_f32_cols, gemv_df64_cols,
           gemv_f32_symm_slab, gemv_df64_symm_slab, gemv_q16_symm_slab,
           gemv_fq_symm_slab, gemv_dfq_symm_slab, gemv_f32_dual,
           gemv_df64_dual, gemv_dfq_dual, gemv_q16_dual, gemv_fq_dual,
           gemv_q16_symm_bf16, gemv_q16_symm_slab_bf16, gemv_q16_dual_bf16,
           gemv_f32_symm_square, gemv_df64_symm_square, gemv_df64_symm_bcast,
           gemv_fq_symm_bcast, gemv_df64_symm_slab_bcast,
           gemv_fq_symm_slab_bcast, gemv_df64_dual_bcast, gemv_fq_dual_bcast,
           gemv_fq_symm_zero, gemv_df64_symm_slab_zero, gemv_df64_dual_zero,
           gemv_fq_symm_slab_zero, gemv_fq_dual_zero)
PLAIN = (gemv_f32_symm_plain, gemv_df64_symm_plain, gemv_dfq_symm_plain,
         gemv_q16_symm_plain, gemv_fq_symm_plain, gemv_f32_plain,
         gemv_df64_plain, gemv_f32_cols_plain, gemv_df64_cols_plain,
         gemv_f32_symm_slab_plain, gemv_df64_symm_slab_plain,
         gemv_q16_symm_slab_plain, gemv_fq_symm_slab_plain,
         gemv_dfq_symm_slab_plain, gemv_f32_dual_plain,
         gemv_df64_dual_plain, gemv_dfq_dual_plain, gemv_q16_dual_plain,
         gemv_fq_dual_plain, gemv_q16_symm_bf16_plain,
         gemv_q16_symm_slab_bf16_plain, gemv_q16_dual_bf16_plain,
         gemv_f32_symm_square_plain, gemv_df64_symm_square_plain,
         gemv_df64_symm_bcast_plain, gemv_fq_symm_bcast_plain,
         gemv_df64_symm_slab_bcast_plain, gemv_fq_symm_slab_bcast_plain,
         gemv_df64_dual_bcast_plain, gemv_fq_dual_bcast_plain,
         gemv_fq_symm_zero_plain, gemv_df64_symm_slab_zero_plain,
         gemv_df64_dual_zero_plain, gemv_fq_symm_slab_zero_plain,
         gemv_fq_dual_zero_plain)


def reset_counters():
    """Zero every kernel module's counters (lam_tpu_torch.ops)."""
    from lam_tpu_torch import ops
    ops.reset_counters()


def counters():
    """{name: count} over every kernel module (lam_tpu_torch.ops)."""
    from lam_tpu_torch import ops
    return ops.counters()
