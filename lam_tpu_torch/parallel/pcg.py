"""Row-sharded dense CG: the gather and ring backends.

The port of lam_tpu/parallel/pcg.py:57-103 and :365-645. The matrix is
split by rows over the ranks of a 1-D mesh: rank i holds rows
[i*m, (i+1)*m) of the zero-padded n_p x n_p matrix (all columns), as an
f32 row block or the (hi, lo) f32 pair of the f64 rows, and the rows of
every vector. lam_tpu runs one shard_map program; here every rank runs
the one-device CG loops of lam_tpu_torch/solver/cg.py on its rows, with
the mesh's all-reduced dot (`LinearOperator.dot`), and the matvec:

  comm='gather': all_gather(p) over the ranks, then one row-block
    matvec (`gemv_f32` / `gemv_df64`) over the full width.
  comm='ring': g steps; at step s rank i multiplies the block of p that
    rank (i + s) % g owns against that column block of its rows
    (`gemv_f32_cols` / `gemv_df64_cols`, which read the block in place),
    adding onto a zero accumulator in that order, while the block it
    holds moves to rank i - 1. The same bytes cross the mesh as with
    gather. One rank falls back to gather (lam_tpu/parallel/pcg.py:72).
    Here each shift completes before the step's matvec; overlapping the
    two is later work.

Per iteration: one all-gather of p (or g - 1 shifts of a block) and two
scalar all-reduces (p.Ap, r.r), as in lam_tpu; Jacobi-preconditioned CG
(`run_pcg`, and the refinement loop's `inv_diag32`) adds r.z, and scales
by the rank's rows of the inverse diagonal (`diagonal()`, no
communication).

Engine 'xla' (lam_tpu's oracle engine; precision 'f64' forces it) keeps
the same layout, padded only to a multiple of the ranks, and multiplies
by plain torch products: the rank's rows times the gathered p, or a
column block of them times the ringed block (lam_tpu/solver/operators.py:
163-174, :322-331), with the rows stored in f64, f32 or as the (hi, lo)
pair. The block matvec of `cg_solve_block` is the rank's rows times the
gathered block of right-hand sides, whatever the engine and comm.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lam_tpu_torch import generate as gen
from lam_tpu_torch import io as lio
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.ops.layout import TILE_K, TILE_M
from lam_tpu_torch.parallel.mesh import ROWS_AXIS, make_mesh  # noqa: F401
from lam_tpu_torch.precision import join_f64, split_f64, split_f64_host
from lam_tpu_torch.solver import operators as ops


def _cols_f32(a, p_blk, blk):
    return gemv.gemv_f32_cols(a, p_blk, blk)


def _cols_df64(operand, p_blk, blk):
    hi, lo = operand
    ph, pl = split_f64(p_blk)
    return join_f64(*gemv.gemv_df64_cols(hi, lo, ph, pl, blk))


def _cols_f32_of_df64(operand, p_blk, blk):
    return gemv.gemv_f32_cols(operand[0], p_blk, blk)


def _cols_of(a, p_blk, blk):
    nb = p_blk.shape[0]
    return a[:, blk * nb:(blk + 1) * nb]


def _cols_xla(a, p_blk, blk):
    return _cols_of(a, p_blk, blk) @ p_blk


def _cols_df64_xla(operand, p_blk, blk):
    return ops._mv_df64_xla(tuple(_cols_of(x, p_blk, blk) for x in operand),
                            p_blk)


def _cols_f32_of_df64_xla(operand, p_blk, blk):
    return _cols_xla(operand[0], p_blk, blk)


XLA = ops.XLA_ENGINE

# (precision, engine) -> (row-block matvec over the full width,
# column-block matvec)
MATVEC = {
    ("f32", ops.DENSE_ENGINE): (ops._mv_f32_pallas, _cols_f32),
    ("df64", ops.DENSE_ENGINE): (ops._mv_df64_pallas, _cols_df64),
    ("f32@df64", ops.DENSE_ENGINE): (ops._mv_f32_of_df64_pallas,
                                     _cols_f32_of_df64),
    ("f64", XLA): (ops._mv_xla, _cols_xla),
    ("f32", XLA): (ops._mv_xla, _cols_xla),
    ("df64", XLA): (ops._mv_df64_xla, _cols_df64_xla),
    ("f32@df64", XLA): (ops._mv_f32_of_df64_xla, _cols_f32_of_df64_xla),
}


def resolve_engine(engine, precision):
    """The engine of a dense sharded layout: row blocks and grid blocks
    are not symmetric, so 'auto' and 'pallas_symm' take the dense kernels
    ('pallas'); 'xla' stays, and precision 'f64' forces it (no f64
    kernel), as in lam_tpu."""
    if engine not in ("auto", ops.DENSE_ENGINE, "pallas_symm", XLA):
        raise ValueError(f"unknown engine {engine!r}")
    return XLA if engine == XLA or precision == "f64" else ops.DENSE_ENGINE


def storage_of(rows, precision, dev):
    """(operand, vector dtype) of f64 host rows or blocks in a dense
    sharded layout's storage: f64, f32 or the (hi, lo) f32 pair."""
    if precision == "f64":
        return ops._upload(rows, dev), torch.float64
    if precision == "f32":
        return ops._upload(rows.astype(np.float32), dev), torch.float32
    if precision == "df64":
        return (tuple(ops._upload(x, dev) for x in split_f64_host(rows)),
                torch.float64)
    raise ValueError(f"unknown precision {precision!r}")


def _make_apply(mv_local, mv_cols, mesh, comm):
    """The rank's matvec: its rows of p -> its rows of A p."""
    if comm not in ("gather", "ring"):
        raise ValueError(f"unknown comm strategy {comm!r}")
    if comm == "gather" or mesh.size == 1:
        def apply(operand, p_local):
            return mv_local(operand, mesh.all_gather(p_local))

        return apply

    g, rank = mesh.size, mesh.rank

    def apply(operand, p_local):
        acc = torch.zeros_like(p_local)
        blk = p_local
        for s in range(g):
            nxt = mesh.ppermute_prev(blk) if s < g - 1 else None
            acc = acc + mv_cols(operand, blk, (rank + s) % g)
            blk = nxt
        return acc

    return apply


def _block_apply(precision, mesh):
    """The rank's block matvec: its rows of P (m, k) -> its rows of A P,
    the rows times the gathered block (None for an f32 view)."""
    mv = ops._MV_BLOCK_SQUARE.get(precision)
    if mv is None:
        return None

    def apply(operand, p_local):
        return mv(operand, mesh.all_gather(p_local))

    return apply


class ShardedDenseOperator(ops.LinearOperator):
    """Row-sharded dense matrix over a 1-D mesh (lam_tpu's
    ShardedDenseOperator): f32 or df64 storage of the rank's rows with
    the dense kernels (engine 'pallas'), or f64, f32 or df64 with plain
    torch products (engine 'xla'); vectors split by rows, dots
    all-reduced."""

    def __init__(self, operand, n, n_padded, vector_dtype, precision, mesh,
                 comm="gather", engine=ops.DENSE_ENGINE):
        mv_local, mv_cols = MATVEC[(precision, engine)]
        super().__init__(_make_apply(mv_local, mv_cols, mesh, comm),
                         operand, n, n_padded, vector_dtype, mesh.device)
        self.precision = "f32" if precision == "f32@df64" else precision
        self.engine = engine
        self.mesh = mesh
        self.comm = comm
        self.dot = mesh.dot
        self.m = n_padded // mesh.size
        self._mv_block = _block_apply(precision, mesh)

    # -- construction ------------------------------------------------------

    @staticmethod
    def shard_padded_size(n, g, engine=ops.DENSE_ENGINE):
        """Pad so the g row shards are multiples of the dense tile rows
        and the columns of TILE_K; engine 'xla' only to a multiple of g
        (lam_tpu/parallel/pcg.py:399-412)."""
        if engine == XLA:
            return layout.padded_size(n, g)
        return layout.padded_size(n, math.lcm(TILE_K, TILE_M * g))

    @staticmethod
    def _check_config(engine, comm, precision="df64"):
        """The engine the configuration runs; raises for one the row
        shards do not take."""
        engine = resolve_engine(engine, precision)
        if comm not in ("gather", "ring"):
            raise ValueError(f"unknown comm strategy {comm!r}")
        return engine

    @staticmethod
    def from_row_block_fn(row_block_fn, n, mesh=None, precision="df64",
                          engine="auto", comm="gather", device="cuda"):
        """Build from row_block_fn(row_start, num_rows) -> the (num_rows,
        n) f64 source rows: this rank reads and stores only its own rows
        (the per-rank MPI-IO read of the reference), zero-padded.
        precision 'f32' or 'df64' with engine 'auto', 'pallas' or
        'pallas_symm' (row blocks are not symmetric: the dense kernels),
        or 'f64', 'f32' or 'df64' with engine 'xla' ('f64' forces it);
        'auto' is df64 on a card and f64 on the CPU."""
        mesh = mesh or make_mesh(device=device)
        if precision == "auto":
            precision = ops.auto_precision(mesh.device)
        if precision not in ("f32", "df64", "f64"):
            raise ValueError(f"ShardedDenseOperator precision must be "
                             f"'f64', 'f32' or 'df64', got {precision!r}")
        engine = ShardedDenseOperator._check_config(engine, comm, precision)
        n_p = ShardedDenseOperator.shard_padded_size(n, mesh.size, engine)
        m = n_p // mesh.size
        r0 = mesh.rank * m
        rows = np.zeros((m, n_p))
        src = max(0, min(n - r0, m))
        if src:
            rows[:src, :n] = row_block_fn(r0, src)
        operand, vdtype = storage_of(rows, precision, mesh.device)
        return ShardedDenseOperator(operand, n, n_p, vdtype, precision, mesh,
                                    comm, engine)

    @staticmethod
    def from_gen_tridiagonal(n, mesh=None, engine="auto", comm="gather",
                             device="cuda"):
        """Generate mode's tridiagonal built on the rank's device, shard
        by shard (lam_tpu/parallel/pcg.py:476-503): this rank's (m, n_p)
        rows of the f32 hi plane and a zero lo plane of the same shape (the
        entries {0, 1, 2} are exact in f32). engine 'auto', 'pallas' or
        'pallas_symm' all take the dense kernels: row shards are
        rectangular; 'xla' multiplies by plain torch products."""
        engine = ShardedDenseOperator._check_config(engine, comm)
        mesh = mesh or make_mesh(device=device)
        n_p = ShardedDenseOperator.shard_padded_size(n, mesh.size, engine)
        m = n_p // mesh.size
        rows = torch.arange(mesh.rank * m, (mesh.rank + 1) * m,
                            device=mesh.device)
        hi = gen._tridiag_block(n, rows, 0, n_p, mesh.device)
        return ShardedDenseOperator((hi, torch.zeros_like(hi)), n, n_p,
                                    torch.float64, "df64", mesh, comm,
                                    engine)

    @staticmethod
    def from_dense(a, mesh=None, precision="df64", engine="auto",
                   comm="gather", device="cuda"):
        a = np.asarray(a, dtype=np.float64)
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        return ShardedDenseOperator.from_row_block_fn(
            lambda s, m: a[s:s + m, :], n, mesh=mesh, precision=precision,
            engine=engine, comm=comm, device=device)

    @staticmethod
    def from_file(path, mesh=None, precision="df64", engine="auto",
                  comm="gather", device="cuda"):
        """Build from a matrix file (the binary format or .npy): this rank
        reads only its own rows, the reference's per-rank MPI-IO seek and
        read (lam_tpu/parallel/pcg.py:514-526)."""
        return ShardedDenseOperator.from_row_block_fn(
            lambda s, m: lio.read_matrix_rows(path, s, m),
            lio.square_size(path), mesh=mesh, precision=precision,
            engine=engine, comm=comm, device=device)

    # -- solve path --------------------------------------------------------

    def prepare_b(self, b):
        """This rank's rows of the zero-padded right-hand side."""
        b = torch.as_tensor(b, dtype=self.vector_dtype)
        if b.shape != (self.n,):
            raise ValueError(f"rhs has shape {tuple(b.shape)}, expected "
                             f"({self.n},)")
        return self.from_global(
            torch.nn.functional.pad(b, (0, self.n_padded - self.n)))

    def from_global(self, v_padded):
        """This rank's rows of a whole padded vector or block."""
        r0 = self.mesh.rank * self.m
        v = torch.as_tensor(v_padded, dtype=self.vector_dtype)
        return v[r0:r0 + self.m].to(self.device)

    def to_global(self, v_local):
        """The whole padded vector (a collective)."""
        return self.mesh.all_gather(v_local)

    def extract_x(self, x_local):
        """The whole solution on every rank (a collective)."""
        return self.to_global(x_local)[:self.n]

    def diagonal(self):
        """This rank's rows of the matrix diagonal, with no communication
        (lam_tpu/parallel/pcg.py:593-618): rank i holds rows [i*m, (i+1)*m)
        and every column, so its part is the diagonal of its columns
        [i*m, (i+1)*m). f64 for df64, f32 for f32."""
        pair = self.precision == "df64"
        c0 = self.mesh.rank * self.m
        d = [torch.diagonal(x[:, c0:c0 + self.m])
             for x in (self.operand if pair else (self.operand,))]
        return join_f64(*d) if pair else d[0].to(self.vector_dtype)

    def as_f32(self):
        """f32 view SHARING this operator's buffers: the hi plane of a
        df64 operator (the inner engine of the refinement loop). An f64
        operator has none, as in lam_tpu."""
        if self.precision == "f32":
            return self
        if self.precision != "df64":
            raise NotImplementedError(
                "as_f32 for sharded f64 operators: rebuild with df64")
        return ShardedDenseOperator(self.operand, self.n, self.n_padded,
                                    torch.float32, "f32@df64", self.mesh,
                                    self.comm, self.engine)
