"""Band-pair sharded symmetric CG: each matrix byte read once per matvec.

The port of lam_tpu/parallel/pcg_symm.py: the df64 storage (slab and
packed) and the quantized storages dfq and fq (packed only). The padded
n_p x n_p symmetric matrix is cut into 2g bands of m rows; rank c owns
the band pair (c, 2g-1-c), whose lower-triangle tile counts add up to the
same number for every rank, so the walk is balanced by construction. The
rank stores one of three things:

  'df64' its two bands as one (2m, n_p) SLAB of full rows (packed=False;
         only the walk's tiles are read) or only the walk's tiles, in
         walk order, as a (T*tb, tb) buffer (packed=True: half the
         memory), both as the (hi, lo) f32 pair of the f64 matrix;
         operand (hi, lo, it, kt, lt).
  'dfq'  the walk's tiles as the f32 hi plane plus the lo plane quantized
         to int16 against one power-of-two scale per walk position (6 B
         per element); operand (hi, loq, sc, dh, dl, it, kt, lt).
  'fq'   the walk's tiles as the three-int16 cascade against three scale
         tables (6 B per element), whose inner matvec reads only the
         2-byte q1 plane; operand (q1, q2, q3, s1, s2, s3, dh, dl, it, kt,
         lt). The planes hold exactly T tiles: the Q16_P padding of the
         one-device fq planes does not apply to a shard.

The quantized storages take the diagonal out of each i == k tile before
quantizing it (it would set the tile's scale) and keep it exactly as the
(dh, dl) f32 pair over the rank's 2m rows in slab order; the owner adds
its diagonal term to the direct terms before the all-reduce. With a
source file and `pack_cache_src` each rank publishes its pack to
`<src>.shardpack/<storage>.g<g>.s<c>` and later runs on the same mesh
read it back (lam_tpu_torch/solver/pack_cache.py; files byte-equal to
lam_tpu's).

Vectors are replicated on every rank: the one-device CG loops of
lam_tpu_torch/solver/cg.py run unchanged on them with the local dot, and
the matvec is the one collective: each rank walks its tiles with a slab
kernel (`gemv_f32_symm_slab` for the f32 inner loop of 'ir' and 'irq',
`gemv_q16_symm_slab` for that of 'irfq'; the df64, dfq or fq twin for the
accurate matvec), places the direct terms yd at its owned rows on top of
the transpose terms yt (`_scatter_bands`) and all-reduces the n_p-vector.
The all-reduce gives every rank the same bits, so every rank computes the
same vectors and takes the same host decisions. lam_tpu runs XLA's f64
matmul off a TPU for the accurate matvec; the port runs its slab kernels
on the card and their plain versions on the CPU.

Generate mode (`from_gen_tridiagonal`, `from_gen_fq`) builds each rank's
storage on its own device from the rank's own walk tables: the slab, or
the packed hi plane with ONE zero (tb, tb) lo tile (kernel 9's broadcast
mode reads it at every tile), or the packed q1 plane with one zero tile
each for q2 and q3 (kernel 17's). A packed df64 operator whose lo tile
holds only zeros, or an fq one whose q2 and q3 tiles do, counted once when
it is built, multiplies by the kernel that reads hi or q1 alone
(`gemv.gemv_df64_symm_slab_zero`, `gemv.gemv_fq_symm_slab_zero`).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from lam_tpu_torch import generate as gen
from lam_tpu_torch import io as lio
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.parallel.mesh import make_mesh
from lam_tpu_torch.precision import join_f64, split_f64, split_f64_host
from lam_tpu_torch.solver import operators as ops
from lam_tpu_torch.solver import pack_cache as pc

ENGINES = ("pallas_symm", "pallas_symm_packed")
STORAGES = ("slab", "packed", "dfq", "fq")


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


def _make_mv32(mesh, m, tb, storage):
    """The f32 inner matvec of a storage: the slab walk of the hi plane
    ('slab', 'packed', 'dfq') or of the 2-byte q1 plane ('fq'). The
    quantized planes carry a zeroed diagonal: the owner adds dh * p over
    its rows (slab order) before the all-reduce."""
    c, g = mesh.rank, mesh.size

    def mv(operand, p):
        it, kt, lt = operand[-3:]
        if storage == "fq":
            yd, yt = gemv.gemv_q16_symm_slab(operand[0], operand[3], p, it,
                                             kt, lt, ms=2 * m)
        else:
            yd, yt = gemv.gemv_f32_symm_slab(operand[0], p, it, kt, lt,
                                             ms=2 * m,
                                             packed=storage != "slab", tb=tb)
        if storage in ops.QUANT_LAYOUT:
            yd = yd + operand[-5] * _own_rows(p, c, g, m)
        return mesh.all_reduce(_scatter_bands(yd, yt, c, g, m))

    return mv


def _make_mv_acc(mesh, m, tb, storage, zero_tiles):
    """The accurate matvec of a storage, on f64 vectors: the df64, dfq or
    fq slab walk, or where `zero_tiles` (the packed lo tile, or the q2 and
    q3 tiles, of zeros) the walk of the hi or q1 plane alone. For the
    quantized storages the owner adds the exact diagonal term (dh + dl) *
    p over its rows, in native f64 (lam_tpu adds it with df_mul and
    two_sum), before the all-reduce."""
    c, g = mesh.rank, mesh.size

    def mv(operand, p):
        it, kt, lt = operand[-3:]
        ph, pl = split_f64(p)
        if storage == "fq" and zero_tiles:
            parts = gemv.gemv_fq_symm_slab_zero(operand[0], operand[3], ph,
                                                pl, it, kt, lt, ms=2 * m)
        elif storage == "fq":
            parts = gemv.gemv_fq_symm_slab(*operand[:6], ph, pl, it, kt, lt,
                                           ms=2 * m)
        elif storage == "dfq":
            parts = gemv.gemv_dfq_symm_slab(*operand[:3], ph, pl, it, kt, lt,
                                            ms=2 * m)
        elif zero_tiles:
            parts = gemv.gemv_df64_symm_slab_zero(operand[0], ph, pl, it, kt,
                                                  lt, ms=2 * m)
        else:
            parts = gemv.gemv_df64_symm_slab(
                operand[0], operand[1], ph, pl, it, kt, lt, ms=2 * m,
                packed=storage != "slab", tb=tb)
        yd, yt = join_f64(*parts[:2]), join_f64(*parts[2:])
        if storage in ops.QUANT_LAYOUT:
            yd = yd + join_f64(operand[-5], operand[-4]) * _own_rows(p, c, g,
                                                                    m)
        return mesh.all_reduce(_scatter_bands(yd, yt, c, g, m))

    return mv


class SymmShardedOperator(ops.LinearOperator):
    """Band-pair sharded SYMMETRIC matrix over a 1-D mesh, in one of the
    storages 'slab' and 'packed' (the df64 pair: operand (hi, lo, it, kt,
    lt)), 'dfq' ((hi, loq, sc, dh, dl, it, kt, lt)) and 'fq' ((q1, q2, q3,
    s1, s2, s3, dh, dl, it, kt, lt)): this rank's walk tiles, its walk
    tables and, for the quantized storages, its rows' diagonal; vectors
    replicated."""

    def __init__(self, operand, n, n_padded, mesh, m, tb, storage,
                 vector_dtype=torch.float64):
        if storage not in STORAGES:
            raise ValueError(f"unknown band-pair storage {storage!r}")
        if vector_dtype == torch.float32:
            mv = _make_mv32(mesh, m, tb, storage)
        else:
            planes = {"packed": 2, "fq": 3}.get(storage)
            mv = _make_mv_acc(mesh, m, tb, storage, planes is not None
                              and ops.zero_tiles_of(operand[:planes]))
        super().__init__(mv, operand, n, n_padded, vector_dtype,
                         mesh.device)
        self.precision = ("f32" if vector_dtype == torch.float32 else
                          storage if storage in ops.QUANT_LAYOUT else "df64")
        self.engine = ENGINES[storage != "slab"]
        self.mesh = mesh
        self.m = m
        self.tb = tb
        self.storage = storage
        self.packed = storage != "slab"

    @staticmethod
    def from_row_block_fn(row_block_fn, n, mesh=None, tb=None, packed=False,
                          precision="df64", pack_cache_src=None,
                          device="cuda"):
        """Build from per-row-block reads of a SYMMETRIC f64 matrix; this
        rank reads and stores only its two bands. packed=True stores only
        the walk's tiles, in walk order (half the memory of the slab).
        precision 'dfq' or 'fq' quantizes them (6 B per element; implies
        packed storage). pack_cache_src (dfq/fq only): the path of the
        source matrix file, which turns on the per-shard pack cache."""
        if precision not in ("df64", "dfq", "fq"):
            raise ValueError(
                f"SymmShardedOperator precision must be 'df64', 'dfq' or "
                f"'fq', got {precision!r}")
        mesh = mesh or make_mesh(device=device)
        tb = _validate_tb(layout.SYMM_TB if tb is None else tb)
        g, c = mesh.size, mesh.rank
        n_p = band_padded_size(n, g, tb)
        m = n_p // (2 * g)
        its, kts, lts = _band_tables(g, m // tb, tb)
        tables = [ops._upload(x[c], mesh.device) for x in (its, kts, lts)]

        def rows_of(r0, count):
            out = np.zeros((count, n_p))
            src = max(0, min(n - r0, count))
            if src:
                out[:src, :n] = row_block_fn(r0, src)
            return out

        def walk_tiles():
            """(t, the f64 (tb, tb) tile at walk position t): one read of
            each owned tile-row."""
            cur_i, rows = -1, None
            for t, (i, k) in enumerate(zip(its[c], kts[c])):
                if i != cur_i:
                    cur_i, rows = i, rows_of(i * tb, tb)
                yield t, rows[:, k * tb:(k + 1) * tb]

        if precision in ops.QUANT_LAYOUT:
            bufs = SymmShardedOperator._quantized_pack(
                walk_tiles, precision, c, g, n, n_p, m, tb, its, kts, lts,
                pack_cache_src)
            operand = (*(ops._upload(x, mesh.device) for x in bufs), *tables)
            return SymmShardedOperator(operand, n, n_p, mesh, m, tb,
                                       precision)
        if packed:
            block = np.empty((its.shape[1] * tb, tb))
            for t, tile in walk_tiles():
                block[t * tb:(t + 1) * tb] = tile
        else:
            block = np.concatenate([rows_of(r0, size) for r0, size
                                    in _slab_row_ranges(c, g, m)])
        planes = [ops._upload(x, mesh.device) for x in split_f64_host(block)]
        return SymmShardedOperator((*planes, *tables), n, n_p, mesh, m, tb,
                                   STORAGES[packed])

    @staticmethod
    def _gen_geometry(n, mesh, tb, device):
        """(mesh, tb, n_p, m, this rank's tables (it, kt, lt) on its
        device) of generate mode's operator."""
        mesh = mesh or make_mesh(device=device)
        tb = _validate_tb(layout.SYMM_TB if tb is None else tb)
        n_p = band_padded_size(n, mesh.size, tb)
        m = n_p // (2 * mesh.size)
        tables = [ops._upload(x[mesh.rank], mesh.device)
                  for x in _band_tables(mesh.size, m // tb, tb)]
        return mesh, tb, n_p, m, tables

    @staticmethod
    def from_gen_tridiagonal(n, mesh=None, tb=None, packed=False,
                             device="cuda"):
        """Generate mode's tridiagonal built on the rank's device
        (lam_tpu/parallel/pcg_symm.py:686-718): the rank's (2m, n_p) slab of
        the f32 hi plane in band-pair row order and a zero lo slab, or
        (packed=True) its walk's tiles of the hi plane, written from the
        rank's own tables, and ONE zero (tb, tb) lo tile: the entries
        {0, 1, 2} are exact in f32, so the lo plane is zero."""
        mesh, tb, n_p, m, tables = SymmShardedOperator._gen_geometry(
            n, mesh, tb, device)
        dev = mesh.device
        if packed:
            it, kt = (x.long() for x in tables[:2])
            hi = gen._tridiag_hi_packed_impl(n, tb, it, kt, n_p // tb)
            lo = torch.zeros((tb, tb), dtype=torch.float32, device=dev)
        else:
            hi = gen._tridiag_block(
                n, gen._slab_rows(mesh.size, m, mesh.rank, dev), 0, n_p, dev)
            lo = torch.zeros_like(hi)
        return SymmShardedOperator((hi, lo, *tables), n, n_p, mesh, m, tb,
                                   STORAGES[packed])

    @staticmethod
    def from_gen_fq(n, mesh=None, tb=None, device="cuda"):
        """Generate mode's fq operator built on the rank's device
        (lam_tpu/parallel/pcg_symm.py:720-760): the q1 plane of the rank's
        walk, exact against the scale TRIDIAG_Q1_SCALE (s1), ONE zero
        (tb, tb) tile each for q2 and q3 with zero scales, and the diagonal
        as the rank's slab-order pair (dh = 2 on real rows, dl = 0)."""
        mesh, tb, n_p, m, tables = SymmShardedOperator._gen_geometry(
            n, mesh, tb, device)
        dev = mesh.device
        T = tables[0].shape[0]
        it, kt = (x.long() for x in tables[:2])
        q1 = gen._tridiag_q1_packed_impl(n, tb, it, kt, n_p // tb)
        zq = torch.zeros((tb, tb), dtype=torch.int16, device=dev)
        s1 = torch.full((T,), gen.TRIDIAG_Q1_SCALE, dtype=torch.float32,
                        device=dev)
        zs = torch.zeros((T,), dtype=torch.float32, device=dev)
        dh = gen._gen_diag_slab_rank(n, mesh.size, m, mesh.rank, dev)
        operand = (q1, zq, zq, s1, zs, zs, dh, torch.zeros_like(dh),
                   *tables)
        return SymmShardedOperator(operand, n, n_p, mesh, m, tb, "fq")

    @staticmethod
    def _quantized_pack(walk_tiles, storage, c, g, n, n_p, m, tb, its, kts,
                        lts, pack_cache_src):
        """Rank c's quantized pack as host buffers in operand order
        (planes..., scales..., dh, dl): read from the shard cache when
        pack_cache_src names the source file and its cache is usable,
        else packed from the walk's tiles (and published there). The
        diagonal of each i == k tile, systematically the largest entries
        of an SPD matrix, would set the tile's scale: it is taken out
        exactly as the slab-order (dh, dl) pair and the zeroed tile is
        quantized instead. Byte-equal to rank c's part of lam_tpu's
        `_from_row_block_fn_quantized`."""
        T = its.shape[1]
        plane_dtypes, n_scales = ops.QUANT_LAYOUT[storage]
        n_planes = len(plane_dtypes)
        specs = ([(dt, (T * tb, tb)) for dt in plane_dtypes]
                 + [(np.float32, (T,))] * n_scales
                 + [(np.float32, (2 * m,))] * 2)
        src_stat = None
        if pack_cache_src is not None:
            # the source's identity before the pack reads it
            src_stat = os.stat(pack_cache_src)
            hit = pc.load_shard(pack_cache_src, storage, "g", g, c, n, n_p,
                                tb, specs)
            if hit is not None:
                return hit
        planes = [np.empty((T * tb, tb), dt) for dt in plane_dtypes]
        scales = [np.zeros((T,), np.float32) for _ in range(n_scales)]
        dh = np.zeros((2 * m,), np.float32)
        dl = np.zeros((2 * m,), np.float32)
        for t, tile in walk_tiles():
            if its[c, t] == kts[c, t]:
                tile = tile.copy()
                dv = np.diagonal(tile).copy()
                dhi = dv.astype(np.float32)
                own = slice(int(lts[c, t]) * tb, (int(lts[c, t]) + 1) * tb)
                dh[own] = dhi
                dl[own] = (dv - dhi.astype(np.float64)).astype(np.float32)
                np.fill_diagonal(tile, 0.0)
            out = ops.quantize_storage_tiles(storage, tile, tb)
            for plane, val in zip(planes, out[:n_planes]):
                plane[t * tb:(t + 1) * tb] = val
            for sc, val in zip(scales, out[n_planes:]):
                sc[t] = val[0]
        bufs = (*planes, *scales, dh, dl)
        if pack_cache_src is not None:
            pc.save_shard(pack_cache_src, storage, "g", g, c, n, n_p, tb,
                          bufs, src_stat=src_stat)
        return bufs

    @staticmethod
    def from_dense(a, mesh=None, tb=None, packed=False, precision="df64",
                   pack_cache_src=None, device="cuda"):
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
            packed=packed, precision=precision,
            pack_cache_src=pack_cache_src, device=device)

    @staticmethod
    def from_file(path, mesh=None, tb=None, packed=False, precision="df64",
                  pack_cache_src=None, device="cuda"):
        """Build from a symmetric matrix file (the binary format or .npy):
        this rank reads only the rows of its two bands
        (lam_tpu/parallel/pcg_symm.py:779-789). pack_cache_src, the
        facade's addition, names the source of a quantized storage's shard
        cache, as in from_row_block_fn."""
        return SymmShardedOperator.from_row_block_fn(
            lambda s, rows: lio.read_matrix_rows(path, s, rows),
            lio.square_size(path), mesh=mesh, tb=tb, packed=packed,
            precision=precision, pack_cache_src=pack_cache_src,
            device=device)

    def as_f32(self):
        """f32 triangle-walk view sharing this operator's buffers (the hi
        plane; the q1 plane of 'fq'): the inner engine of the refinement
        loop."""
        if self.precision == "f32":
            return self
        return SymmShardedOperator(self.operand, self.n, self.n_padded,
                                   self.mesh, self.m, self.tb, self.storage,
                                   torch.float32)

    def diagonal(self):
        """The matrix diagonal as a padded f64 vector, on every rank (a
        collective; lam_tpu/parallel/pcg_symm.py:837-899): the rank's 2m
        values in slab order, scattered to its owned rows and
        all-reduced. The quantized storages carry them as the (dh, dl)
        pair; the df64 slab holds them at (row, its own column) of each
        band; the packed walk in its diagonal tiles (it == kt), one at
        the end of each owned tile row, so in slab order, with a
        broadcast lo tile's diagonal added to every one of them."""
        c, g, m, tb = self.mesh.rank, self.mesh.size, self.m, self.tb
        if self.storage in ops.QUANT_LAYOUT:
            dv = join_f64(self.operand[-5], self.operand[-4])
        elif self.storage == "slab":
            dv = torch.cat([
                join_f64(*(torch.diagonal(x[h * m:(h + 1) * m,
                                            r0:r0 + size])
                           for x in self.operand[:2]))
                for h, (r0, size) in enumerate(_slab_row_ranges(c, g, m))])
        else:
            it, kt = self.operand[-3:-1]
            pos = torch.nonzero(it == kt).reshape(-1)
            tiles = [x.reshape(-1, tb, tb)[pos if x.shape[0] > tb
                                           else torch.zeros_like(pos)]
                     for x in self.operand[:2]]
            dv = torch.diagonal(join_f64(*tiles), dim1=1,
                                dim2=2).reshape(-1)
        d = torch.zeros(self.n_padded, dtype=torch.float64,
                        device=self.device)
        return self.mesh.all_reduce(_scatter_bands(dv, d, c, g, m))
