"""Symmetric 2-D sharded CG: each element stored once AND O(N/R) exchange.

The port of lam_tpu/parallel/pcg2d_symm.py (`Symm2DOperator`, file mode).
The band-pair operator (parallel/pcg_symm.py) halves the matrix bytes but
all-reduces a whole N-vector per matvec; the dense grid (parallel/pcg2d.py)
exchanges only O(N/R) blocks but stores and streams all N^2 elements. This
is their composition:

  * grid and vectors as parallel/pcg2d.py: rank i * R + j at grid row i,
    grid column j of a `Mesh2D`; vectors split over grid rows, replicated
    over grid columns; dots all-reduced over the grid column.
  * storage: n_p = padded_size(n, 2 R tb), m = n_p / R, c = m / tb. Every
    rank holds (T*tb, tb) buffers, T = c(c+1)/2 tiles:
      - rank (i, i): the walk-order packed lower triangle of block A_ii
        (`layout.pack_tri_host`);
      - rank (i, j), i > j: the TOP m/2 rows of the lower block A_ij;
        rank (j, i): the BOTTOM m/2 rows of the same block. Both as
        row-major rectangles of c/2 x c tiles (`layout.pack_rect_host`)
        plus c/2 trailing zero tiles, so every rank's buffer has T tiles
        and every rank owns ~m^2/2 elements.
    Three storages, as on the band pairs: 'df64' the (hi, lo) f32 pair,
    operand (hi, lo); 'dfq' (hi, loq, sc, dh, dl); 'fq' (q1, q2, q3, s1,
    s2, s3, dh, dl). The planes hold exactly T tiles and each scale table
    one entry per tile of the buffer. A quantized diagonal rank takes the
    matrix diagonal out of its diagonal tiles before quantizing them (it
    would set the tiles' scales) and keeps it as the exact (dh, dl) f32
    pair over its m rows; an off-diagonal rank's pair is zeros. (lam_tpu
    replicates the pair over the grid row; here `diagonal()` all-reduces
    it over the grid row instead, so a rank's shard file is what lam_tpu
    writes for it.)
  * matvec: one transpose exchange delivers p-block j to rank (i, j); a
    diagonal rank runs the one-device symmetric kernel on its triangle
    (plus its diagonal term for the quantized storages); an off-diagonal
    rank computes BOTH products of its half-slab S in one pass (the dual
    kernels of ops/gemv.py): S @ p_j belongs to rows of y_i, S^T @ p_i[half]
    to y_j. The product that belongs to the mirror rank's grid row rides a
    second transpose exchange; an all-reduce over the grid row completes
    y. Per matvec: two exchanges and one all-reduce of (N/R)-vectors.

Every rank runs the one-device CG loops of lam_tpu_torch/solver/cg.py on
its block of the vectors with the grid's dot. The f32 view of the
refinement loop reads the hi plane (df64, dfq) or the 2-byte q1 plane (fq)
of the same buffers. With a source file and `pack_cache_src` a quantized
rank publishes its pack to `<src>.shardpack/<storage>.r<R>.s<i*R+j>`
(lam_tpu_torch/solver/pack_cache.py; byte-equal to lam_tpu's). lam_tpu runs
XLA's f64 matmul off a TPU for the accurate matvec; the port runs its
kernels on the card and their plain versions on the CPU. Generate mode
(`from_gen_tridiagonal`, `from_gen_fq`) builds each rank's triangle or
half-slab on its device, with ONE zero (tb, tb) tile for the lo plane or
for each of q2 and q3 that every tile reads (the broadcast modes of
kernels 2 and 15 on the diagonal ranks, 12 and 19 on the others). A rank
whose tiles hold only zeros, counted once when its operator is built,
runs the accurate matvec's kernel that reads q1 or hi alone: an fq
diagonal rank `gemv.gemv_fq_symm_zero`, an fq off-diagonal rank
`gemv.gemv_fq_dual_zero`, a df64 off-diagonal rank
`gemv.gemv_df64_dual_zero` (a df64 diagonal rank keeps kernel 2's
broadcast mode). `diagonal()` serves the Jacobi preconditioner (`run_pcg`,
and `inv_diag32` of the refinement loop).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lam_tpu_torch import generate as gen
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.parallel.mesh import make_mesh2d
from lam_tpu_torch.parallel.pcg2d import GridOperator, check_active
from lam_tpu_torch.parallel.pcg_symm import _validate_tb
from lam_tpu_torch.precision import join_f64, split_f64, split_f64_host
from lam_tpu_torch.solver import operators as ops
from lam_tpu_torch.solver import pack_cache as pc

ENGINE = "pallas_symm_packed"
STORAGES = ("df64", "dfq", "fq")

# storage -> (f32 view, accurate matvec), each (the diagonal ranks' triangle
# kernel, the off-diagonal ranks' dual kernel, the operand entries both read)
_TILE_MATH = {
    "df64": ((gemv.gemv_f32_symm, gemv.gemv_f32_dual, (0,)),
             (gemv.gemv_df64_symm, gemv.gemv_df64_dual, (0, 1))),
    "dfq": ((gemv.gemv_f32_symm, gemv.gemv_f32_dual, (0,)),
            (gemv.gemv_dfq_symm, gemv.gemv_dfq_dual, (0, 1, 2))),
    "fq": ((gemv.gemv_q16_symm, gemv.gemv_q16_dual, (0, 3)),
           (gemv.gemv_fq_symm, gemv.gemv_fq_dual, (0, 1, 2, 3, 4, 5))),
}

# storage -> the accurate matvec's kernels over broadcast tiles of zeros,
# by rank: {True: the diagonal ranks', False: the off-diagonal ranks'},
# each (the kernel, the operand entries it reads, the planes whose tiles
# are counted); a rank without one keeps _TILE_MATH's
_ZERO_MATH = {
    "fq": {True: (gemv.gemv_fq_symm_zero, (0, 3), 3),
           False: (gemv.gemv_fq_dual_zero, (0, 3), 3)},
    "df64": {False: (gemv.gemv_df64_dual_zero, (0,), 2)},
}


def sym2d_padded_size(n, r, tb):
    """Pad so each (n_p/R, n_p/R) block splits into an EVEN number of
    tb-tile rows (the off-diagonal half-slab boundary is m/2)."""
    return layout.padded_size(n, 2 * r * tb)


def _geometry(n, r, tb):
    """(tb, n_p, m, c, T) of an n x n matrix on an R x R grid."""
    tb = _validate_tb(layout.SYMM_TB if tb is None else tb)
    n_p = sym2d_padded_size(n, r, tb)
    m = n_p // r
    c = m // tb
    return tb, n_p, m, c, layout.tri_tile_count(c)


def _scatter_half(d, m, top):
    """(m/2,) partial -> (m,) with the other half zero."""
    z = torch.zeros(m - d.shape[0], dtype=d.dtype, device=d.device)
    return torch.cat([d, z] if top else [z, d])


def _route_mv_pair(mesh, m, diag_mv, dual_mv, p_own, p_recv):
    """The ONE routing of the three storages: which half-slab product
    joins this rank's grid-row sum and which rides the second exchange,
    and the p_own[:m/2] / p_recv[m/2:] half-vector slicing, are decided
    here and nowhere else. Returns (own partial (m,), payload (m,)).

      diag_mv(p) -> (m,): the diagonal rank's full product (with its
        diagonal term, where the storage has one);
      dual_mv(p_full, q_half) -> (direct (m/2,), transpose (m,)): both
        products of the rank's half-slab S (S @ p_full, S^T @ q_half).

    p_own is the rank's own block i, p_recv block j from the first
    exchange. A lower rank (i > j) holds the top half of A_ij: its direct
    product is the top half of y_i (own), its transpose product belongs to
    y_j (payload). An upper rank (i < j) holds the bottom half of A_ji: its
    transpose product belongs to y_i (own), its direct product is the
    bottom half of y_j (payload)."""
    m2 = m // 2
    if mesh.i == mesh.j:
        return diag_mv(p_own), torch.zeros_like(p_own)
    if mesh.i > mesh.j:
        d, t = dual_mv(p_recv, p_own[:m2])
        return _scatter_half(d, m, top=True), t
    d, t = dual_mv(p_own, p_recv[m2:])
    return t, _scatter_half(d, m, top=False)


def _zero_tiles(mesh, operand, storage, which):
    """True where the rank's accurate matvec has a kernel for its
    broadcast tiles and they hold only zeros: one count on the device,
    when the operator is built (`ops.zero_tiles_of`)."""
    zero = _ZERO_MATH.get(storage, {}).get(mesh.i == mesh.j)
    if which != "acc" or zero is None:
        return False
    return ops.zero_tiles_of(operand[:zero[2]])


def _make_mv_pair(mesh, m, storage, which, zero=False):
    """The rank's matvec (operand, p_own, p_recv) -> (own partial, mirror
    payload): only the tile math of the storage is chosen here, the
    routing is `_route_mv_pair`'s. which='f32' is the inner view on f32
    vectors, 'acc' the accurate matvec on f64 vectors; `zero` puts the
    rank's kernel that reads q1 and s1 (fq) or hi (df64, off-diagonal
    rank) alone in the tile-reading one's place (`_ZERO_MATH`). The
    quantized planes carry a zero diagonal: the
    diagonal rank adds dh * p (f32) or (dh + dl) * p in native f64
    (lam_tpu adds it with df_mul and two_sum)."""
    tri, dual, idx = _TILE_MATH[storage][which == "acc"]
    tri_idx = dual_idx = idx
    if zero:
        kernel, zero_idx, _ = _ZERO_MATH[storage][mesh.i == mesh.j]
        if mesh.i == mesh.j:
            tri, tri_idx = kernel, zero_idx
        else:
            dual, dual_idx = kernel, zero_idx
    quant = storage in ops.QUANT_LAYOUT

    def mv_pair(operand, p_own, p_recv):
        dual_planes = [operand[k] for k in dual_idx]
        tri_planes = [operand[k] for k in tri_idx]
        if which == "f32":
            def diag_mv(p):
                y = tri(*tri_planes, p)
                return y + operand[-2] * p if quant else y

            def dual_mv(pf, qh):
                return dual(*dual_planes, pf, qh)
        else:
            def diag_mv(p):
                y = join_f64(*tri(*tri_planes, *split_f64(p)))
                if quant:
                    y = y + join_f64(operand[-2], operand[-1]) * p
                return y

            def dual_mv(pf, qh):
                out = dual(*dual_planes, *split_f64(pf), *split_f64(qh))
                return join_f64(*out[:2]), join_f64(*out[2:])

        return _route_mv_pair(mesh, m, diag_mv, dual_mv, p_own, p_recv)

    return mv_pair


def _make_apply_sym2d(mv_pair, mesh):
    """The rank's matvec: its block of p -> its block of A p. Every rank,
    a diagonal one too, takes part in the same three collectives in the
    same order."""

    def apply(operand, p_blk):
        # exchange 1: rank (i, j) needs p-block j
        own, payload = mv_pair(operand, p_blk, mesh.transpose(p_blk))
        # exchange 2: hand the mirror rank its half-slab's other product
        return mesh.all_reduce_row(own + mesh.transpose(payload))

    return apply


def _pack_chip_block(block_fn, n, m, tb, i, j):
    """Rank (i, j)'s (T*tb, tb) packed f64 buffer from reads of the
    unpadded matrix (`block_fn(r0, c0, h, w)` -> f64 block), zero-padded."""
    c = m // tb
    m2 = m // 2

    def padded(r0, c0, h, w):
        src_h = max(0, min(n - r0, h))
        src_w = max(0, min(n - c0, w))
        out = np.zeros((h, w), np.float64)
        if src_h > 0 and src_w > 0:
            out[:src_h, :src_w] = block_fn(r0, c0, src_h, src_w)
        return out

    if i == j:
        return layout.pack_tri_host(padded(i * m, i * m, m, m), tb)
    if i > j:                       # top half of lower block A_ij
        s = padded(i * m, j * m, m2, m)
    else:                           # bottom half of lower block A_ji
        s = padded(j * m + m2, i * m, m2, m)
    return layout.pack_rect_host(s, tb, pad_tiles=c // 2)


class Symm2DOperator(GridOperator):
    """Symmetric matrix stored ONCE across an R x R grid (packed triangle
    on the diagonal ranks, half-slabs on the others) in one of the
    storages 'df64' (operand (hi, lo)), 'dfq' ((hi, loq, sc, dh, dl)) and
    'fq' ((q1, q2, q3, s1, s2, s3, dh, dl)); O(N/R) exchange per matvec.
    `mv_pair(operand, p_own, p_recv)` is the rank's part of a matvec
    before the second exchange."""

    def __init__(self, operand, n, n_padded, mesh, tb, storage="df64",
                 vector_dtype=torch.float64):
        if storage not in STORAGES:
            raise ValueError(f"unknown symmetric-grid storage {storage!r}")
        which = "f32" if vector_dtype == torch.float32 else "acc"
        self.mv_pair = _make_mv_pair(
            mesh, n_padded // mesh.r, storage, which,
            _zero_tiles(mesh, operand, storage, which))
        super().__init__(_make_apply_sym2d(self.mv_pair, mesh), operand, n,
                         n_padded, vector_dtype, mesh)
        self.precision = "f32" if which == "f32" else storage
        self.engine = ENGINE
        self.tb = tb
        self.storage = storage

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_block_fn(block_fn, n, mesh=None, tb=None, precision="df64",
                      pack_cache_src=None, device="cuda"):
        """Build from `block_fn(r0, c0, h, w)` -> f64 block of the UNPADDED
        symmetric matrix: this rank reads and packs ONLY its own triangle
        or half-slab (the 2-D analog of the per-rank MPI-IO read).
        precision 'dfq' or 'fq' quantizes it (6 B per element stored once
        across the grid). pack_cache_src (dfq/fq only): the path of the
        source matrix file, which turns on the per-shard pack cache."""
        if precision not in STORAGES:
            raise ValueError(
                f"Symm2DOperator precision must be 'df64', 'dfq' or "
                f"'fq', got {precision!r}")
        mesh = mesh or make_mesh2d(device=device)
        check_active(mesh)
        tb, n_p, m, c, T = _geometry(n, mesh.r, tb)
        if precision in ops.QUANT_LAYOUT:
            bufs = Symm2DOperator._quantized_pack(
                block_fn, precision, mesh, n, n_p, m, c, T, tb,
                pack_cache_src)
        else:
            bufs = split_f64_host(_pack_chip_block(block_fn, n, m, tb,
                                                   mesh.i, mesh.j))
        operand = tuple(ops._upload(x, mesh.device) for x in bufs)
        return Symm2DOperator(operand, n, n_p, mesh, tb, precision)

    @staticmethod
    def _quantized_pack(block_fn, storage, mesh, n, n_p, m, c, T, tb,
                        pack_cache_src):
        """This rank's quantized pack as host buffers in operand order
        (planes..., scales..., dh, dl): read from the shard cache (topology
        code "r", shard index i*R+j) when pack_cache_src names the source
        file and its cache is usable, else packed from the rank's block
        (and published there). On a diagonal rank the matrix diagonal is
        taken out of the diagonal tiles as the exact (dh, dl) pair BEFORE
        quantization, so it cannot set a tile's scale. Byte-equal to rank
        (i, j)'s part of lam_tpu's `_from_block_fn_quantized`."""
        i, j, r = mesh.i, mesh.j, mesh.r
        plane_dtypes, n_scales = ops.QUANT_LAYOUT[storage]
        specs = ([(dt, (T * tb, tb)) for dt in plane_dtypes]
                 + [(np.float32, (T,))] * n_scales
                 + [(np.float32, (m,))] * 2)
        src_stat = None
        if pack_cache_src is not None:
            # the source's identity before the pack reads it
            src_stat = os.stat(pack_cache_src)
            hit = pc.load_shard(pack_cache_src, storage, "r", r, i * r + j,
                                n, n_p, tb, specs)
            if hit is not None:
                return hit
        packed = _pack_chip_block(block_fn, n, m, tb, i, j)
        dh = np.zeros((m,), np.float32)
        dl = np.zeros((m,), np.float32)
        if i == j:
            for li in range(c):
                t = li * (li + 1) // 2 + li
                tile = packed[t * tb:(t + 1) * tb]
                dv = np.diagonal(tile).copy()
                dhi = dv.astype(np.float32)
                dh[li * tb:(li + 1) * tb] = dhi
                dl[li * tb:(li + 1) * tb] = (
                    dv - dhi.astype(np.float64)).astype(np.float32)
                np.fill_diagonal(tile, 0.0)
        bufs = (*ops.quantize_storage_tiles(storage, packed, tb), dh, dl)
        if pack_cache_src is not None:
            pc.save_shard(pack_cache_src, storage, "r", r, i * r + j, n, n_p,
                          tb, bufs, src_stat=src_stat)
        return bufs

    @staticmethod
    def from_dense(a, mesh=None, tb=None, precision="df64", device="cuda"):
        a = np.asarray(a, dtype=np.float64)
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        if not ops._verifies_symmetric(a):
            raise ValueError(
                "Symm2DOperator requires a symmetric matrix (each "
                "element is stored once and mirrored by the dual walk)")
        return Symm2DOperator.from_block_fn(
            lambda r0, c0, h, w: a[r0:r0 + h, c0:c0 + w], n, mesh=mesh,
            tb=tb, precision=precision, device=device)

    @staticmethod
    def _gen_plane(n, mesh, tb, device, diag, band):
        """(mesh, tb, n_p, m, T, this rank's (T*tb, tb) buffer of the
        tridiagonal with `diag` on the diagonal and `band` beside it, in
        band's dtype), lam_tpu's per-rank `local_build`
        (lam_tpu/parallel/pcg2d_symm.py:701-764) written into zeros: the
        diagonal rank (i, i) its c diagonal walk tiles and the corners of
        its tiles at it == kt + 1 (the packed walk over its block's global
        tiles i*c + (it, kt)); rank (i, i-1) the cross-block corner
        A[i*m, i*m - 1] at its rectangle's tile (0, c-1), element (0,
        tb-1); every other rank zeros."""
        mesh = mesh or make_mesh2d(device=device)
        check_active(mesh)
        tb, n_p, m, c, T = _geometry(n, mesh.r, tb)
        i, j, dev = mesh.i, mesh.j, mesh.device
        if i == j:
            it, kt = (torch.as_tensor(x, dtype=torch.long, device=dev) + i * c
                      for x in layout._symm_tables(c))
            buf = gen._tridiag_packed(n, tb, it, kt, n_p // tb,
                                      diag.to(dev), band.to(dev))
        else:
            buf = torch.zeros((T * tb, tb), dtype=band.dtype, device=dev)
            if i == j + 1 and i * m < n:
                buf[(c - 1) * tb, tb - 1] = band.to(dev)
        return mesh, tb, n_p, m, T, buf

    @staticmethod
    def from_gen_tridiagonal(n, mesh=None, tb=None, device="cuda"):
        """Generate mode's tridiagonal built on the rank's device
        (`_gen_plane`): the rank's f32 hi buffer and ONE zero (tb, tb) lo
        tile (the entries {0, 1, 2} are exact in f32), which the diagonal
        rank's triangle kernel and the others' dual kernel read at every
        tile (their broadcast modes)."""
        one = torch.tensor(1.0, dtype=torch.float32)
        mesh, tb, n_p, m, T, hi = Symm2DOperator._gen_plane(
            n, mesh, tb, device, 2 * one, one)
        lo = torch.zeros((tb, tb), dtype=torch.float32, device=mesh.device)
        return Symm2DOperator((hi, lo), n, n_p, mesh, tb)

    @staticmethod
    def from_gen_fq(n, mesh=None, tb=None, device="cuda"):
        """Generate mode's fq operator built on the rank's device
        (lam_tpu/parallel/pcg2d_symm.py:774-862): the rank's q1 buffer with
        the diagonal extracted (`_gen_plane`, exact against the scale
        TRIDIAG_Q1_SCALE), ONE zero (tb, tb) tile each for q2 and q3 with
        zero scales, and the diagonal pair (dh = 2 on real rows, dl = 0) on
        the diagonal rank, zeros on the others (this module's layout; lam_tpu
        replicates the pair over the grid row)."""
        qv = torch.tensor(round(1.0 / gen.TRIDIAG_Q1_SCALE),
                          dtype=torch.int16)
        mesh, tb, n_p, m, T, q1 = Symm2DOperator._gen_plane(
            n, mesh, tb, device, torch.zeros_like(qv), qv)
        dev = mesh.device
        zq = torch.zeros((tb, tb), dtype=torch.int16, device=dev)
        s1 = torch.full((T,), gen.TRIDIAG_Q1_SCALE, dtype=torch.float32,
                        device=dev)
        zs = torch.zeros((T,), dtype=torch.float32, device=dev)
        dh = torch.zeros((m,), dtype=torch.float32, device=dev)
        if mesh.i == mesh.j:
            rows = mesh.i * m + torch.arange(m, device=dev)
            dh = torch.where(rows < n, 2.0, 0.0).to(torch.float32)
        operand = (q1, zq, zq, s1, zs, zs, dh, torch.zeros_like(dh))
        return Symm2DOperator(operand, n, n_p, mesh, tb, "fq")

    # -- solve path --------------------------------------------------------

    def as_f32(self):
        """f32 dual-walk view SHARING this operator's buffers (the hi
        plane; the q1 plane of 'fq'): the inner engine of the refinement
        loop."""
        if self.precision == "f32":
            return self
        return Symm2DOperator(self.operand, self.n, self.n_padded, self.mesh,
                              self.tb, self.storage, torch.float32)

    def diagonal(self):
        """This rank's block (grid row i) of the matrix diagonal in f64 (a
        collective over the grid row). It lives on the diagonal rank: the
        (dh, dl) pair of a quantized storage, or the diagonals of the df64
        triangle's diagonal tiles, at walk positions li(li+1)/2 + li; the
        other ranks of the grid row add zeros."""
        if self.storage in ops.QUANT_LAYOUT:
            d = join_f64(self.operand[-2], self.operand[-1])
        elif self.mesh.i == self.mesh.j:
            c = self.m // self.tb
            dpos = [li * (li + 1) // 2 + li for li in range(c)]
            # a broadcast lo tile (generate mode) is every tile's lo
            tiles = join_f64(*(x.reshape(-1, self.tb, self.tb)[
                dpos if x.shape == self.operand[0].shape else [0] * c]
                for x in self.operand))
            d = torch.diagonal(tiles, dim1=1, dim2=2).reshape(self.m)
        else:
            d = torch.zeros(self.m, dtype=torch.float64, device=self.device)
        return self.mesh.all_reduce_row(d)
