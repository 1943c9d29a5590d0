"""Host-side layout contracts of the packed symmetric storage (numpy).

The layout half of lam_tpu/ops/gemv.py (`_symm_tables`,
`tri_tile_count`, `pack_tri_host`, `_packed_geometry`, gemv.py:275-406;
the fq additions `Q16_P`, `padded_tri_tile_count`,
`_symm_tables_padded`, `_pow2_scale`, `quantize_fq_tiles`, gemv.py:300,
:337-361, :1123, :1876; the dfq lo quantizer `quantize_lo_tiles`,
gemv.py:1134; the dual kernels' rectangle pack `pack_rect_host`,
gemv.py:1832), the tile widths `DF64_SYMM_TB` (gemv.py:988) and the
dense tile contract `TILE_M`, `TILE_K` (gemv.py:46-47), and the padding
rule of lam_tpu/solver/operators.py (`PAD_MULTIPLE`, `padded_size`,
operators.py:31-43), byte-for-byte. The values are fixed here as layout
contracts: the port reads none of the JAX package's LAM_TPU_* tuning
variables.

A symmetric n_p x n_p matrix (n_p = nblk * tb) is stored as its
nblk(nblk+1)/2 lower-triangle tb x tb tiles, stacked in row-major walk
order into one (T*tb, tb) buffer: tile t = i(i+1)/2 + k holds block
(i, k), k <= i. The fq planes are stored PADDED to Ts tiles, T rounded
up to a multiple of Q16_P, with all-zero pad tiles and zero pad scales.
"""

from __future__ import annotations

import functools

import numpy as np

SYMM_TB = 512        # tile width of the packed layout
DF64_SYMM_TB = 512   # the df64 band pairs' and symmetric grid's tile width
TILE_M = 256         # the dense tile contract, which sets the padding of
TILE_K = 1024        # a sharded full-square operator
PAD_MULTIPLE = 1024  # operators pad n up to a multiple of this
_LANES = 128         # smallest legal tile width
Q16_P = 8            # fq planes pad their tile count to a multiple of this


def padded_size(n, multiple=None):
    multiple = multiple or PAD_MULTIPLE
    return -(-n // multiple) * multiple


@functools.cache
def _symm_tables(nblk):
    """(it, kt) int32 walk tables: tile t sits at block (it[t], kt[t])."""
    iis, kks = [], []
    for i in range(nblk):
        for k in range(i + 1):
            iis.append(i)
            kks.append(k)
    return np.asarray(iis, np.int32), np.asarray(kks, np.int32)


def tri_tile_count(nblk):
    """Tiles in the lower triangle of an nblk x nblk tile grid."""
    return nblk * (nblk + 1) // 2


def padded_tri_tile_count(nblk, p=Q16_P):
    """Triangle tile count rounded up to a multiple of p: the stored
    plane size of the padded fq layout."""
    t = tri_tile_count(nblk)
    return -(-t // p) * p


@functools.cache
def _symm_tables_padded(nblk, p=Q16_P):
    """Walk tables padded to a multiple of p with inert (i=0, k=1)
    entries (k > i: neither a diagonal nor a transpose term; both block
    indices in range, hence nblk >= 2). The pad tiles are all zero with
    zero scales, so they contribute exactly 0."""
    if nblk < 2:
        raise ValueError("padded walk tables need nblk >= 2 (the inert "
                         "(0, 1) entry must be in range)")
    it, kt = _symm_tables(nblk)
    pad = padded_tri_tile_count(nblk, p) - len(it)
    if pad:
        it = np.concatenate([it, np.zeros(pad, np.int32)])
        kt = np.concatenate([kt, np.ones(pad, np.int32)])
    return it, kt


def _pow2_scale(m):
    """Smallest power of two >= m/32767, frexp-exact (no log2 rounding at
    power-of-two boundaries)."""
    fr, k = np.frexp(m / 32767.0)
    return 2.0 ** (int(k) - 1 if fr == 0.5 else int(k))


def quantize_lo_tiles(lo_packed, tb):
    """Quantize a packed (T*tb, tb) f32 lo plane to (int16 tiles,
    per-tile f32 power-of-two scales): the dfq storage's lo plane.
    q * scale is exact (a power-of-two scale) and |lo - q*scale| <=
    scale/2 elementwise; an all-zero tile keeps scale 0."""
    lo_packed = np.asarray(lo_packed, dtype=np.float32)
    T = lo_packed.shape[0] // tb
    q = np.empty_like(lo_packed, dtype=np.int16)
    scales = np.zeros((T,), dtype=np.float32)
    for t in range(T):
        tile = lo_packed[t * tb:(t + 1) * tb]
        m = float(np.abs(tile).max())
        if m == 0.0:
            q[t * tb:(t + 1) * tb] = 0
            continue
        scale = _pow2_scale(m)
        scales[t] = scale
        qt = np.rint(tile.astype(np.float64) / scale)
        q[t * tb:(t + 1) * tb] = np.clip(qt, -32767, 32767)
    return q, scales


def quantize_fq_tiles(a_packed, tb):
    """Quantize a packed (T*tb, tb) f64 buffer into the three-plane fq
    cascade: (q1, q2, q3 int16 planes, s1, s2, s3 (T,) f32 power-of-two
    scale tables). Each plane quantizes the residual the planes before it
    left; q*s is exact per plane and the residual after plane k is
    bounded by s_k/2 (~2^-48 of the tile's max after three planes)."""
    r = np.array(a_packed, dtype=np.float64, copy=True)
    T = r.shape[0] // tb
    qs, scs = [], []
    for _ in range(3):
        q = np.zeros(r.shape, dtype=np.int16)
        sc = np.zeros((T,), dtype=np.float32)
        for t in range(T):
            tile = r[t * tb:(t + 1) * tb]
            m = float(np.abs(tile).max())
            if m == 0.0:
                continue
            scale = _pow2_scale(m)
            sc[t] = scale
            qt = np.clip(np.rint(tile / scale), -32767, 32767)
            q[t * tb:(t + 1) * tb] = qt
            tile -= qt * scale  # exact: power-of-two scale
        qs.append(q)
        scs.append(sc)
    return qs[0], qs[1], qs[2], scs[0], scs[1], scs[2]


def pack_tri_host(a, tb, it=None, kt=None):
    """Pack a full square (n_p, n_p) host array into walk-order triangle
    tiles (T*tb, tb). With it/kt given, packs THAT walk; default is the
    row-major triangle walk."""
    a = np.asarray(a)
    if it is None:
        nblk = a.shape[0] // tb
        it, kt = _symm_tables(nblk)
    out = np.empty((len(it) * tb, tb), dtype=a.dtype)
    for t, (i, k) in enumerate(zip(it, kt)):
        out[t * tb:(t + 1) * tb] = a[i * tb:(i + 1) * tb,
                                     k * tb:(k + 1) * tb]
    return out


def pack_rect_host(s, tb, pad_tiles=0):
    """Pack a dense host rectangle (ms, n) into the row-major (T*tb, tb)
    tile layout of the dual kernels (tile t = li * (n/tb) + k holds block
    (li, k)), plus `pad_tiles` trailing zero tiles, which make a half-slab's
    buffer as long as a triangle's."""
    s = np.asarray(s)
    ms, n = s.shape
    mb, cb = ms // tb, n // tb
    out = np.zeros(((mb * cb + pad_tiles) * tb, tb), dtype=s.dtype)
    for li in range(mb):
        for k in range(cb):
            t = li * cb + k
            out[t * tb:(t + 1) * tb] = s[li * tb:(li + 1) * tb,
                                         k * tb:(k + 1) * tb]
    return out


def packed_geometry(buf_shape, n, what, padded=False):
    """(tb, nblk, T) of a packed buffer shape and operand length n; raises
    the same ValueErrors as lam_tpu's `_packed_geometry` and its packed
    gemv entry points (lam_tpu/ops/gemv.py:394-406, :472-475). With
    padded=True (the fq planes) the buffer may also hold the padded count
    of tiles, as lam_tpu's fq kernels accept (gemv.py:2083, :2173); T is
    the buffer's own tile count."""
    tb = buf_shape[1]
    if tb < _LANES or tb & (tb - 1):
        raise ValueError(f"{what}: packed tile width {tb} must be a "
                         f"power-of-two multiple of {_LANES}")
    if n % tb or buf_shape[0] % tb:
        raise ValueError(f"{what}: n={n} and packed rows "
                         f"{buf_shape[0]} must be multiples of tb={tb}")
    nblk, T = n // tb, buf_shape[0] // tb
    if padded:
        if T not in (tri_tile_count(nblk), padded_tri_tile_count(nblk)):
            raise ValueError(
                f"packed buffer has {T} tiles, triangle of nblk={nblk} "
                f"needs {tri_tile_count(nblk)} "
                f"(or {padded_tri_tile_count(nblk)} padded)")
    elif T != tri_tile_count(nblk):
        raise ValueError(
            f"packed buffer has {T} tiles, triangle of nblk={nblk} "
            f"needs {tri_tile_count(nblk)}")
    return tb, nblk, T
