"""2-D sharded dense CG: (n_p/R, n_p/R) blocks over an R x R grid.

The port of lam_tpu/parallel/pcg2d.py (`Sharded2DOperator` and its solve
methods). Every 1-D backend moves O(N) vector entries per rank and
matvec; on the grid the exchange is one transposed block plus one
all-reduce of a block, O(N/R) per rank.

  * grid: the first R^2 ranks of the process group, rank i * R + j at
    grid row i, grid column j (`parallel.mesh.Mesh2D`);
  * A: rank (i, j) holds block A_ij of the zero-padded matrix, as an f32
    block or the (hi, lo) f32 pair of the f64 block;
  * vectors: split over grid rows, REPLICATED over grid columns (rank
    (i, j) holds block i), so all vector algebra is local and a dot is
    the local dot all-reduced over the rank's grid column;
  * matvec: rank (i, j) needs block j of p but holds block i: one
    transpose exchange (i, j) <- (j, i) delivers it; the local dense
    kernel (`gemv_f32` / `gemv_df64`) runs on the block; an all-reduce
    over the rank's grid row sums the row's partial products and leaves
    y split and replicated like p.

lam_tpu runs one shard_map program; here every rank of the grid runs the
one-device CG loops of lam_tpu_torch/solver/cg.py on its block of the
vectors with the grid's dot. The blocks of a symmetric matrix are not
symmetric, so engine 'pallas_symm' folds to the dense engine 'pallas',
as in lam_tpu. Generate mode (`from_gen_tridiagonal`) builds the rank's
block on its device. `diagonal()` serves the Jacobi preconditioner
(`run_pcg`, and `inv_diag32` of the refinement loop). Engine 'xla'
(precision 'f64' forces it) stores the rank's block in f64, f32 or as the
(hi, lo) pair, padded only to a multiple of R, and multiplies by plain
torch products (lam_tpu/parallel/pcg2d.py:113-117). The block matvec of
`cg_solve_block` carries k columns through the same exchange and row
all-reduce (`prepare_b_block`, lam_tpu/parallel/pcg2d.py:368-376). The
symmetric grid, which stores each element once, is
lam_tpu_torch/parallel/pcg2d_symm.py; like lam_tpu's it has no block
matvec.
"""

from __future__ import annotations

import numpy as np
import torch

from lam_tpu_torch import generate as gen
from lam_tpu_torch.ops import layout
from lam_tpu_torch.parallel.mesh import make_mesh2d
from lam_tpu_torch.parallel.pcg import (MATVEC, TILE_K, TILE_M, XLA,
                                        resolve_engine, storage_of)
from lam_tpu_torch.precision import join_f64
from lam_tpu_torch.solver import operators as ops


def _make_apply2d(mv_local, mesh):
    """The rank's matvec: its block of p -> its block of A p."""

    def apply(operand, p_blk):
        return mesh.all_reduce_row(mv_local(operand, mesh.transpose(p_blk)))

    return apply


class GridOperator(ops.LinearOperator):
    """An operator on an R x R grid (`Mesh2D`): this rank holds block i
    (its grid row's, `m` = n_p/R entries) of every vector, replicated over
    the grid columns, and a dot is the grid's (`mesh.dot`)."""

    def __init__(self, matvec_fn, operand, n, n_padded, vector_dtype, mesh):
        super().__init__(matvec_fn, operand, n, n_padded, vector_dtype,
                         mesh.device)
        self.mesh = mesh
        self.dot = mesh.dot
        self.m = n_padded // mesh.r

    def prepare_b(self, b):
        """This rank's block (grid row i) of the zero-padded right-hand
        side."""
        b = torch.as_tensor(b, dtype=self.vector_dtype)
        if b.shape != (self.n,):
            raise ValueError(f"rhs has shape {tuple(b.shape)}, expected "
                             f"({self.n},)")
        b = torch.nn.functional.pad(b, (0, self.n_padded - self.n))
        return self.from_global(b)

    def from_global(self, v_padded):
        """This rank's block (grid row i) of a whole padded vector or
        block of vectors."""
        r0 = self.mesh.i * self.m
        v = torch.as_tensor(v_padded, dtype=self.vector_dtype)
        return v[r0:r0 + self.m].to(self.device)

    def to_global(self, v_blk):
        """The whole padded vector, on every rank of the grid (a
        collective over the grid column)."""
        return self.mesh.all_gather_col(v_blk)

    def extract_x(self, x_blk):
        """The whole solution on every rank of the grid (a collective
        over the grid column)."""
        return self.to_global(x_blk)[:self.n]


def check_active(mesh):
    """Raise for a rank that is outside the grid: it holds no block."""
    if not mesh.active:
        raise RuntimeError(f"rank {mesh.rank} is outside the "
                           f"{mesh.r}x{mesh.r} grid and holds no block")


class Sharded2DOperator(GridOperator):
    """Dense matrix in (n_p/R, n_p/R) blocks over an R x R grid (lam_tpu's
    Sharded2DOperator): f32 or df64 storage of the rank's block with the
    dense kernels (engine 'pallas'), or f64, f32 or df64 with plain torch
    products (engine 'xla'); vectors split over grid rows, dots
    all-reduced over the grid column."""

    def __init__(self, operand, n, n_padded, vector_dtype, precision, mesh,
                 engine=ops.DENSE_ENGINE):
        super().__init__(_make_apply2d(MATVEC[(precision, engine)][0], mesh),
                         operand, n, n_padded, vector_dtype, mesh)
        self.precision = "f32" if precision == "f32@df64" else precision
        self.engine = engine
        mv = ops._MV_BLOCK_SQUARE.get(precision)
        # the block matvec: k columns through the same exchange and row
        # all-reduce (none for an f32 view, as in lam_tpu)
        self._mv_block = None if mv is None else _make_apply2d(mv, mesh)

    # -- construction ------------------------------------------------------

    @staticmethod
    def block_padded_size(n, r, engine=ops.DENSE_ENGINE):
        """Pad so each of the R block sides is a multiple of the dense
        tiles; engine 'xla' only to a multiple of R
        (lam_tpu/parallel/pcg2d.py:203-211)."""
        if engine == XLA:
            return layout.padded_size(n, r)
        return layout.padded_size(n, r * max(TILE_K, TILE_M))

    @staticmethod
    def _geometry(n, mesh, precision, engine, device):
        """(mesh, precision, engine, n_p, m) of a configuration the port
        takes ('auto' precision resolved on the grid's device); raises for
        the others."""
        mesh = mesh or make_mesh2d(device=device)
        if precision == "auto":
            precision = ops.auto_precision(mesh.device)
        engine = resolve_engine(engine, precision)
        if precision not in ("f32", "df64", "f64"):
            raise ValueError(f"unknown precision {precision!r}")
        check_active(mesh)
        n_p = Sharded2DOperator.block_padded_size(n, mesh.r, engine)
        return mesh, precision, engine, n_p, n_p // mesh.r

    @staticmethod
    def from_block_fn(block_fn, n, mesh=None, precision="df64",
                      engine="auto", device="cuda"):
        """Build from block_fn(row_start, col_start, rows, cols) -> that
        f64 block of the UNPADDED matrix: this rank reads and stores only
        its own block (the 2-D analog of the per-rank MPI-IO read),
        zero-padded. precision 'f32' or 'df64' with engine 'auto',
        'pallas' or 'pallas_symm' (blocks are not symmetric: the dense
        kernels), or 'f64', 'f32' or 'df64' with engine 'xla'."""
        mesh, precision, engine, n_p, m = Sharded2DOperator._geometry(
            n, mesh, precision, engine, device)
        r0, c0 = mesh.i * m, mesh.j * m
        block = np.zeros((m, m))
        src_h = max(0, min(n - r0, m))
        src_w = max(0, min(n - c0, m))
        if src_h and src_w:
            block[:src_h, :src_w] = block_fn(r0, c0, src_h, src_w)
        operand, vdtype = storage_of(block, precision, mesh.device)
        return Sharded2DOperator(operand, n, n_p, vdtype, precision, mesh,
                                 engine)

    @staticmethod
    def from_dense(a, mesh=None, precision="df64", engine="auto",
                   device="cuda"):
        a = np.asarray(a, dtype=np.float64)
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        return Sharded2DOperator.from_block_fn(
            lambda r0, c0, h, w: a[r0:r0 + h, c0:c0 + w], n, mesh=mesh,
            precision=precision, engine=engine, device=device)

    @staticmethod
    def from_gen_tridiagonal(n, mesh=None, precision="df64", engine="auto",
                             device="cuda"):
        """Generate mode's tridiagonal built on the rank's device, block by
        block (lam_tpu/parallel/pcg2d.py:294-327): this rank's (m, m) block
        of the f32 square, for 'df64' with a zero lo block (the entries
        {0, 1, 2} are exact in f32), for 'f64' cast to f64."""
        mesh, precision, engine, n_p, m = Sharded2DOperator._geometry(
            n, mesh, precision, engine, device)
        rows = torch.arange(mesh.i * m, (mesh.i + 1) * m, device=mesh.device)
        hi = gen._tridiag_block(n, rows, mesh.j * m, m, mesh.device)
        if precision == "f32":
            return Sharded2DOperator(hi, n, n_p, torch.float32, "f32", mesh,
                                     engine)
        if precision == "f64":
            return Sharded2DOperator(hi.double(), n, n_p, torch.float64,
                                     "f64", mesh, engine)
        return Sharded2DOperator((hi, torch.zeros_like(hi)), n, n_p,
                                 torch.float64, "df64", mesh, engine)

    # -- solve path --------------------------------------------------------

    def as_f32(self):
        """f32 view SHARING this operator's buffers: the hi block of a
        df64 operator (the inner engine of the refinement loop)."""
        if self.precision == "f32":
            return self
        if self.precision != "df64":
            raise NotImplementedError(
                "as_f32 for 2-D f64 operators: rebuild with df64")
        return Sharded2DOperator(self.operand, self.n, self.n_padded,
                                 torch.float32, "f32@df64", self.mesh,
                                 self.engine)

    def diagonal(self):
        """This rank's block (grid row i) of the matrix diagonal (a
        collective over the grid row; lam_tpu/parallel/pcg2d.py:379-405):
        only the diagonal rank (i, i) holds it, the diagonal of its
        block; the other ranks of the grid row add zeros. f64 for df64,
        f32 for f32."""
        pair = self.precision == "df64"
        blocks = self.operand if pair else (self.operand,)
        d = [torch.diagonal(x) for x in blocks]
        d = join_f64(*d) if pair else d[0].to(self.vector_dtype)
        if self.mesh.i != self.mesh.j:
            d = torch.zeros_like(d)
        return self.mesh.all_reduce_row(d)
