"""Band-pair sharded symmetric CG: each matrix byte read once per matvec.

The port of lam_tpu/parallel/pcg_symm.py (df64 storage, slab and packed).
The padded n_p x n_p symmetric matrix is cut into 2g bands of m rows; rank
c owns the band pair (c, 2g-1-c), whose lower-triangle tile counts add up
to the same number for every rank, so the walk is balanced by
construction. The rank stores either its two bands as one (2m, n_p) SLAB
of full rows (packed=False; only the walk's tiles are read) or only the
walk's tiles, in walk order, as a (T*tb, tb) buffer (packed=True: half
the memory). Both as the (hi, lo) f32 pair of the f64 matrix.

Vectors are replicated on every rank: the one-device CG loops of
lam_tpu_torch/solver/cg.py run unchanged on them with the local dot, and
the matvec is the one collective: each rank walks its tiles with the slab
kernel (`gemv_f32_symm_slab` for the f32 inner loop of 'ir', the df64
twin for the accurate matvec), places the direct terms yd at its owned
rows on top of the transpose terms yt (`_scatter_bands`) and all-reduces
the n_p-vector. The all-reduce gives every rank the same bits, so every
rank computes the same vectors and takes the same host decisions.
lam_tpu runs XLA's f64 matmul off a TPU for the accurate matvec; the port
runs its df64 slab kernel on the card and the plain version on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lam_tpu_torch import io as lio
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.parallel.mesh import make_mesh
from lam_tpu_torch.precision import join_f64, split_f64, split_f64_host
from lam_tpu_torch.solver import operators as ops

ENGINES = ("pallas_symm", "pallas_symm_packed")


def band_padded_size(n, g, tb):
    """Pad so each of the 2g bands is a whole number of (tb) tile-rows."""
    return layout.padded_size(n, 2 * g * tb)


def _validate_tb(tb):
    """The walk tables are in tb-tile units: tb must be a power-of-two
    multiple of the 128-lane width (lam_tpu/parallel/pcg_symm.py:72)."""
    if tb < 128 or tb & (tb - 1):
        raise ValueError(
            f"tb={tb} is not a power-of-two multiple of 128; use 128, 256, "
            "512, ...")
    return tb


@functools.cache
def _band_tables(g, mt, tb):
    """Per-rank (it, kt, lt) int32 (g, T) walk tables of the band pairs.

    g ranks, mt tile-rows per band (2g bands). Rank c owns global
    tile-rows [c*mt, (c+1)*mt) and [(2g-1-c)*mt, (2g-c)*mt); for each
    owned tile-row i (ascending) the row's lower-triangle tiles are
    k = 0..i. Every rank's table has the same length
    mt^2*(2g-1) + mt*(mt+1): balanced by construction."""
    its, kts, lts = [], [], []
    for c in range(g):
        it_c, kt_c, lt_c = [], [], []
        rows = (list(range(c * mt, (c + 1) * mt)),
                list(range((2 * g - 1 - c) * mt, (2 * g - c) * mt)))
        for half, band in enumerate(rows):
            for local, i in enumerate(band):
                for k in range(i + 1):
                    it_c.append(i)
                    kt_c.append(k)
                    lt_c.append(half * mt + local)
        its.append(it_c)
        kts.append(kt_c)
        lts.append(lt_c)
    if len({len(x) for x in its}) != 1:
        raise AssertionError("band-pair walks must be equal per rank")
    return (np.asarray(its, np.int32), np.asarray(kts, np.int32),
            np.asarray(lts, np.int32))


def _slab_row_ranges(c, g, m):
    """Original-row ranges (start, size) of rank c's two bands."""
    return ((c * m, m), ((2 * g - 1 - c) * m, m))


def _scatter_bands(yd, yt, c, g, m):
    """Full-length y partial: yt (transpose terms over all columns) plus
    the slab's direct terms yd placed at rank c's original rows."""
    y = yt.clone()
    for half, (r0, size) in enumerate(_slab_row_ranges(c, g, m)):
        y[r0:r0 + size] += yd[half * m:(half + 1) * m]
    return y


def _own_rows(p, c, g, m):
    """Rank c's rows of a replicated vector in slab order (band c, then
    band 2g-1-c): the dual of _scatter_bands."""
    return torch.cat([p[r0:r0 + size]
                      for r0, size in _slab_row_ranges(c, g, m)])


def _make_mv32(mesh, m, tb, packed):
    def mv(operand, p):
        hi, _, it, kt, lt = operand
        yd, yt = gemv.gemv_f32_symm_slab(hi, p, it, kt, lt, ms=2 * m,
                                         packed=packed, tb=tb)
        return mesh.all_reduce(
            _scatter_bands(yd, yt, mesh.rank, mesh.size, m))

    return mv


def _make_mv_acc(mesh, m, tb, packed):
    def mv(operand, p):
        hi, lo, it, kt, lt = operand
        ph, pl = split_f64(p)
        ydh, ydl, yth, ytl = gemv.gemv_df64_symm_slab(
            hi, lo, ph, pl, it, kt, lt, ms=2 * m, packed=packed, tb=tb)
        return mesh.all_reduce(_scatter_bands(
            join_f64(ydh, ydl), join_f64(yth, ytl), mesh.rank, mesh.size, m))

    return mv


class SymmShardedOperator(ops.LinearOperator):
    """Band-pair sharded SYMMETRIC df64 matrix over a 1-D mesh: the
    rank's slab or packed walk tiles as the (hi, lo) f32 pair plus its
    walk tables, operand (hi, lo, it, kt, lt); vectors replicated."""

    def __init__(self, operand, n, n_padded, mesh, m, tb, packed,
                 vector_dtype=torch.float64):
        make = _make_mv32 if vector_dtype == torch.float32 else _make_mv_acc
        super().__init__(make(mesh, m, tb, packed), operand, n, n_padded,
                         vector_dtype, mesh.device)
        self.precision = "f32" if vector_dtype == torch.float32 else "df64"
        self.engine = ENGINES[packed]
        self.mesh = mesh
        self.m = m
        self.tb = tb
        self.packed = packed

    @staticmethod
    def from_row_block_fn(row_block_fn, n, mesh=None, tb=None, packed=False,
                          precision="df64", device="cuda"):
        """Build from per-row-block reads of a SYMMETRIC f64 matrix; this
        rank reads and stores only its two bands. packed=True stores only
        the walk's tiles, in walk order (half the memory of the slab)."""
        if precision in ("dfq", "fq"):
            raise NotImplementedError(
                f"precision={precision!r} on the band-pair mesh is not "
                "ported yet: it needs the slab kernels gemv_dfq_symm_slab "
                "(10), gemv_q16_symm_slab (16) and gemv_fq_symm_slab (17) "
                "of ROADMAP Queue 2")
        if precision != "df64":
            raise ValueError(
                f"SymmShardedOperator precision must be 'df64', 'dfq' or "
                f"'fq', got {precision!r}")
        mesh = mesh or make_mesh(device=device)
        tb = _validate_tb(layout.SYMM_TB if tb is None else tb)
        g, c = mesh.size, mesh.rank
        n_p = band_padded_size(n, g, tb)
        m = n_p // (2 * g)
        its, kts, lts = _band_tables(g, m // tb, tb)

        def rows_of(r0, count):
            out = np.zeros((count, n_p))
            src = max(0, min(n - r0, count))
            if src:
                out[:src, :n] = row_block_fn(r0, src)
            return out

        if packed:
            tiles = np.empty((its.shape[1] * tb, tb))
            cur_i, rows = -1, None
            for t, (i, k) in enumerate(zip(its[c], kts[c])):
                if i != cur_i:
                    cur_i, rows = i, rows_of(i * tb, tb)
                tiles[t * tb:(t + 1) * tb] = rows[:, k * tb:(k + 1) * tb]
            block = tiles
        else:
            block = np.concatenate([rows_of(r0, size) for r0, size
                                    in _slab_row_ranges(c, g, m)])
        planes = [ops._upload(x, mesh.device) for x in split_f64_host(block)]
        tables = [ops._upload(x[c], mesh.device) for x in (its, kts, lts)]
        return SymmShardedOperator((*planes, *tables), n, n_p, mesh, m, tb,
                                   packed)

    @staticmethod
    def from_dense(a, mesh=None, tb=None, packed=False, precision="df64",
                   device="cuda"):
        a = np.asarray(a, dtype=np.float64)
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        if not ops._verifies_symmetric(a):
            raise ValueError(
                "SymmShardedOperator requires a symmetric matrix (the "
                "band walk mirrors the lower triangle)")
        return SymmShardedOperator.from_row_block_fn(
            lambda s, rows: a[s:s + rows, :], n, mesh=mesh, tb=tb,
            packed=packed, precision=precision, device=device)

    @staticmethod
    def from_file(path, mesh=None, tb=None, packed=False, precision="df64",
                  device="cuda"):
        """Band-wise file load: this rank reads only its bands' rows.
        Symmetry is trusted (CG's contract), as lam_tpu does."""
        rows, cols = lio.read_header(path)
        if rows != cols:
            raise ValueError(f"{path}: matrix must be square "
                             f"({rows}x{cols})")
        return SymmShardedOperator.from_row_block_fn(
            lambda s, count: lio.read_matrix_rows(path, s, count), rows,
            mesh=mesh, tb=tb, packed=packed, precision=precision,
            device=device)

    def as_f32(self):
        """f32 triangle-walk view sharing this operator's buffers (the hi
        plane): the inner engine of the refinement loop."""
        if self.precision == "f32":
            return self
        return SymmShardedOperator(self.operand, self.n, self.n_padded,
                                   self.mesh, self.m, self.tb, self.packed,
                                   torch.float32)
