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
scalar all-reduces (p.Ap, r.r), as in lam_tpu.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lam_tpu_torch import io as lio
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.parallel.mesh import make_mesh
from lam_tpu_torch.precision import join_f64, split_f64, split_f64_host
from lam_tpu_torch.solver import operators as ops

# lam_tpu's dense tile contract (lam_tpu/ops/gemv.py:46-47), which sets
# the padding of a sharded full-square operator
TILE_M = 256
TILE_K = 1024


def _cols_f32(a, p_blk, blk):
    return gemv.gemv_f32_cols(a, p_blk, blk)


def _cols_df64(operand, p_blk, blk):
    hi, lo = operand
    ph, pl = split_f64(p_blk)
    return join_f64(*gemv.gemv_df64_cols(hi, lo, ph, pl, blk))


def _cols_f32_of_df64(operand, p_blk, blk):
    return gemv.gemv_f32_cols(operand[0], p_blk, blk)


# precision -> (row-block matvec over the full width, column-block matvec)
MATVEC = {
    "f32": (ops._mv_f32_pallas, _cols_f32),
    "df64": (ops._mv_df64_pallas, _cols_df64),
    "f32@df64": (ops._mv_f32_of_df64_pallas, _cols_f32_of_df64),
}


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


class ShardedDenseOperator(ops.LinearOperator):
    """Row-sharded dense matrix over a 1-D mesh (lam_tpu's
    ShardedDenseOperator, engine 'pallas'): f32 or df64 storage of the
    rank's rows, vectors split by rows, dots all-reduced."""

    def __init__(self, operand, n, n_padded, vector_dtype, precision, mesh,
                 comm="gather"):
        mv_local, mv_cols = MATVEC[precision]
        super().__init__(_make_apply(mv_local, mv_cols, mesh, comm),
                         operand, n, n_padded, vector_dtype, mesh.device)
        self.precision = "f32" if precision == "f32@df64" else precision
        self.engine = ops.DENSE_ENGINE
        self.mesh = mesh
        self.comm = comm
        self.dot = mesh.dot
        self.m = n_padded // mesh.size

    # -- construction ------------------------------------------------------

    @staticmethod
    def shard_padded_size(n, g):
        """Pad so the g row shards are multiples of the dense tile rows
        and the columns of TILE_K (lam_tpu/parallel/pcg.py:399-412)."""
        return layout.padded_size(n, math.lcm(TILE_K, TILE_M * g))

    @staticmethod
    def from_row_block_fn(row_block_fn, n, mesh=None, precision="df64",
                          engine="auto", comm="gather", device="cuda"):
        """Build from row_block_fn(row_start, num_rows) -> the (num_rows,
        n) f64 source rows: this rank reads and stores only its own rows
        (the per-rank MPI-IO read of the reference), zero-padded.
        precision 'f32' or 'df64'; engine 'auto', 'pallas' or
        'pallas_symm' (row blocks are not symmetric: the dense kernels)."""
        if engine == "xla":
            raise NotImplementedError("engine='xla' is not ported yet")
        if engine not in ("auto", ops.DENSE_ENGINE, "pallas_symm"):
            raise ValueError(f"unknown engine {engine!r}")
        if precision not in ("f32", "df64"):
            raise ValueError(f"ShardedDenseOperator precision must be "
                             f"'f32' or 'df64', got {precision!r}")
        if comm not in ("gather", "ring"):
            raise ValueError(f"unknown comm strategy {comm!r}")
        mesh = mesh or make_mesh(device=device)
        n_p = ShardedDenseOperator.shard_padded_size(n, mesh.size)
        m = n_p // mesh.size
        r0 = mesh.rank * m
        rows = np.zeros((m, n_p))
        src = max(0, min(n - r0, m))
        if src:
            rows[:src, :n] = row_block_fn(r0, src)
        if precision == "f32":
            operand = ops._upload(rows.astype(np.float32), mesh.device)
            vdtype = torch.float32
        else:
            operand = tuple(ops._upload(x, mesh.device)
                            for x in split_f64_host(rows))
            vdtype = torch.float64
        return ShardedDenseOperator(operand, n, n_p, vdtype, precision, mesh,
                                    comm)

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
        """Shard-wise file load: this rank reads only its row block."""
        rows, cols = lio.read_header(path)
        if rows != cols:
            raise ValueError(f"{path}: matrix must be square "
                             f"({rows}x{cols})")
        return ShardedDenseOperator.from_row_block_fn(
            lambda s, m: lio.read_matrix_rows(path, s, m), rows, mesh=mesh,
            precision=precision, engine=engine, comm=comm, device=device)

    # -- solve path --------------------------------------------------------

    def prepare_b(self, b):
        """This rank's rows of the zero-padded right-hand side."""
        b = torch.as_tensor(b, dtype=self.vector_dtype)
        if b.shape != (self.n,):
            raise ValueError(f"rhs has shape {tuple(b.shape)}, expected "
                             f"({self.n},)")
        b = torch.nn.functional.pad(b, (0, self.n_padded - self.n))
        r0 = self.mesh.rank * self.m
        return b[r0:r0 + self.m].to(self.device)

    def extract_x(self, x_local):
        """The whole solution on every rank (a collective)."""
        return self.mesh.all_gather(x_local)[:self.n]

    def as_f32(self):
        """f32 view SHARING this operator's buffers: the hi plane of a
        df64 operator (the inner engine of the refinement loop)."""
        if self.precision == "f32":
            return self
        return ShardedDenseOperator(self.operand, self.n, self.n_padded,
                                    torch.float32, "f32@df64", self.mesh,
                                    self.comm)
