"""Steady-state heat-equation demo on PyTorch: lam_tpu/apps/heat.py.

The reference app relaxes an nx x ny plate (north boundary 0, south,
west and east 100, interior set to the boundary average) with Jacobi
sweeps until the largest update falls below epsilon. Both of lam_tpu's
solvers are here:

  * `solve_heat_jacobi`: the numerics-parity sweep, loop on the device;
  * `solve_heat_cg`: the steady state as the SPD 5-point-Laplacian system
    A u = b over the interior, solved by the port's CG engine, matrix-
    free: `precision="ir"` runs the f32 inner CG on the hand-written
    stencil kernel (ops/stencil.py, csrc/stencil.cu) on the 2-D padded
    grid with f64 refinement restarts; `precision="f64"` runs plain f64
    CG on the plain PyTorch stencil. `devices=G > 1` splits the padded
    grid's rows over the G ranks of a process group
    (`_ShardedStencilOperator`): every matvec exchanges one edge row with
    each neighbour (`parallel.mesh.Mesh.halo`) and runs the stencil
    kernel on the rank's shard, always with refinement ('ir').
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lam_tpu_torch.solver.cg import (CHUNK, _cg_ir_loop, cg_solve,
                                     cg_solve_ir)
from lam_tpu_torch.solver.operators import (LinearOperator,
                                            MatrixFreeOperator,
                                            resolve_device)

BC_NORTH = 0.0
BC_SOUTH = 100.0
BC_WEST = 100.0
BC_EAST = 100.0


def initial_grid(nx, ny, bc_north=BC_NORTH, bc_south=BC_SOUTH,
                 bc_west=BC_WEST, bc_east=BC_EAST):
    """Boundary conditions + interior average, as lam_tpu's (the
    reference's set_initial_solution). Returns (ny, nx), row y=0 =
    south."""
    grid = np.zeros((ny, nx), dtype=np.float64)
    grid[ny - 1, 1:nx - 1] = bc_north
    grid[0, 1:nx - 1] = bc_south
    grid[1:ny - 1, 0] = bc_west
    grid[1:ny - 1, nx - 1] = bc_east
    grid[0, 0] = (bc_south + bc_west) / 2
    grid[ny - 1, 0] = (bc_north + bc_west) / 2
    # the east corners sit in column nx-1, as in lam_tpu (the reference
    # indexes them with ny-1, right only for square grids)
    grid[0, nx - 1] = (bc_south + bc_east) / 2
    grid[ny - 1, nx - 1] = (bc_north + bc_east) / 2
    initial_val = ((nx - 1) * bc_north + (nx - 1) * bc_south
                   + (ny - 1) * bc_west + (ny - 1) * bc_east) \
        / (2 * nx + 2 * ny - 4)
    grid[1:ny - 1, 1:nx - 1] = initial_val
    return grid


def solve_heat_jacobi(grid, max_iters=1_000_000, epsilon=1e-3,
                      device="cuda"):
    """Parity port of the reference's solve_heat: sweeps until the
    largest interior update is below epsilon, or max_iters sweeps.
    Returns (grid, sweeps, last update) as lam_tpu's.

    lam_tpu runs the loop as one lax.while_loop. Here each sweep tests
    the stopping rule on the device and freezes a finished state with
    torch.where (the grid, the update and the count keep their values),
    and the host reads one flag every CHUNK sweeps, as the CG loop does
    (solver/cg.py): the sweep count and the grid are lam_tpu's."""
    dev = resolve_device(device)
    g = torch.tensor(np.asarray(grid, dtype=np.float64), device=dev)
    inner = g[1:-1, 1:-1]
    eps = torch.as_tensor(epsilon, dtype=torch.float64, device=dev)
    limit = torch.as_tensor(max_iters, device=dev)
    diff = torch.full((), float("inf"), dtype=torch.float64, device=dev)
    k = torch.zeros((), dtype=torch.int64, device=dev)

    def active(diff, k):
        return (k < limit) & (diff >= eps)

    go = active(diff, k)
    while bool(go):
        for _ in range(CHUNK):
            new = (g[2:, 1:-1] + g[:-2, 1:-1] + g[1:-1, :-2]
                   + g[1:-1, 2:]) / 4.0
            d = torch.max(torch.abs(new - inner))
            inner.copy_(torch.where(go, new, inner))
            diff = torch.where(go, d, diff)
            k = k + go
            go = active(diff, k)
    return g.cpu().numpy(), int(k), float(diff)


def _laplace5(u):
    """4u - u_N - u_S - u_W - u_E on a 2-D (nyi, nxi) array with zero
    (Dirichlet-absorbed) neighbours outside it, in lam_tpu's order
    (heat.py:103-107: the row below, the row above, east, west). Each
    term is subtracted in place on the rows or columns it reaches, which
    rounds as lam_tpu's zero-padded shifts do (x - 0 == x)."""
    out = 4.0 * u
    out[:-1, :] -= u[1:, :]
    out[1:, :] -= u[:-1, :]
    out[:, :-1] -= u[:, 1:]
    out[:, 1:] -= u[:, :-1]
    return out


@functools.lru_cache(maxsize=None)
def _laplace_matvec(nyi, nxi):
    """Matrix-free 5-point Laplacian on an (nyi, nxi) interior, flat
    vectors of any float dtype: SPD, so CG applies. The operand is
    unused (the shape is baked in)."""

    def mv(operand, p):
        del operand
        return _laplace5(p.reshape(nyi, nxi)).reshape(-1)

    return mv


@functools.lru_cache(maxsize=None)
def _laplace_matvec_padded(nyi, nxi, H, W):
    """Masked 5-point Laplacian on the padded (H, W) grid, plain PyTorch,
    any float dtype: _laplace_matvec on the leading (nyi, nxi) interior,
    padding kept exactly zero, so it shares a vector space with the
    stencil kernel. The f64 refinement matvec of precision='ir'."""

    def mv(operand, p):
        del operand
        out = _laplace5(p.reshape(H, W)[:nyi, :nxi])
        return torch.nn.functional.pad(
            out, (0, W - nxi, 0, H - nyi)).reshape(-1)

    return mv


@functools.lru_cache(maxsize=None)
def _laplace_matvec_dot_kernel(nyi, nxi, H, W, tbr):
    """Fused (Ap, p.Ap) by the stencil kernel, one read of p and one
    write of y per matvec: the counterpart of lam_tpu's
    _laplace_matvec_dot_pallas (heat.py:130-142). The operand is the
    (1, W) zero row the kernel takes as both edges (laplace5_f32's form,
    without a fresh row per call)."""
    from lam_tpu_torch.ops.stencil import laplace5_f32_halo

    def mvd(operand, p):
        y, d = laplace5_f32_halo(p.reshape(H, W), operand, operand, nyi,
                                 nxi=nxi, tbr=tbr)
        return y.reshape(-1), d

    return mvd


class _StencilOperator(LinearOperator):
    """Operator on the 2-D zero-padded grid vector space.

    The base pads and crops 1-D tails; the stencil pads in 2-D (rows to
    H, columns to W), so prepare_b/extract_x are overridden. Every CG
    vector keeps exact zeros in the padding (masked matvecs), so dot
    products and norms are unaffected."""

    def __init__(self, matvec_fn, matvec_dot_fn, operand, nyi, nxi, H, W,
                 dtype, device):
        super().__init__(matvec_fn, operand, nyi * nxi, H * W, dtype, device,
                         matvec_dot_fn=matvec_dot_fn)
        self._dims = (nyi, nxi, H, W)

    def prepare_b(self, b):
        nyi, nxi, H, W = self._dims
        b = torch.as_tensor(b, dtype=self.vector_dtype, device=self.device)
        if b.shape != (self.n,):
            raise ValueError(f"rhs has shape {tuple(b.shape)}, expected "
                             f"({self.n},)")
        return torch.nn.functional.pad(
            b.reshape(nyi, nxi), (0, W - nxi, 0, H - nyi)).reshape(-1)

    def extract_x(self, x_padded):
        nyi, nxi, H, W = self._dims
        return x_padded.reshape(H, W)[:nyi, :nxi].reshape(-1)


# -- the row-sharded stencil over a 1-D mesh ----------------------------------
#
# Rank c holds rows [c*Hs, (c+1)*Hs) of the padded (H, W) grid, Hs = H / G
# (`padded_hw(..., row_groups=G)`: every shard a whole number of row
# tiles), as every vector's flat (Hs*W,) part. Each matvec exchanges the
# shard's first and last rows with its neighbours and runs the stencil on
# the shard with the received rows as its up/dn edges; the refinement
# loop of solver/cg.py runs on the parts with the mesh's all-reduced dot
# (lam_tpu/apps/heat.py:161-309).


def _sharded_stencil_applies(mesh, nyi, nxi, Hs, W, tbr):
    """(apply32_dot, apply_acc) of this rank's shard: the f32 stencil
    kernel with the f32 halo, returning y and the shard's LOCAL p . y
    (its caller all-reduces it), and the masked f64 stencil with the f64
    halo (an f32 halo would cap the refinement near 1e-7). A rank whose
    rows are all padding (nrows 0) still exchanges its rows and joins
    every collective."""
    from lam_tpu_torch.ops.stencil import laplace5_f32_halo, laplace5_masked
    nrows = min(max(nyi - mesh.rank * Hs, 0), Hs)

    def halo(u):
        up, dn = mesh.halo(u[0], u[-1])
        return up.reshape(1, W), dn.reshape(1, W)

    def apply32_dot(operand, p):
        del operand
        u = p.reshape(Hs, W)
        y, d = laplace5_f32_halo(u, *halo(u), nrows, nxi=nxi, tbr=tbr)
        return y.reshape(-1), d

    def apply_acc(operand, p):
        del operand
        u = p.reshape(Hs, W)
        return laplace5_masked(u, *halo(u), nrows, nxi).reshape(-1)

    return apply32_dot, apply_acc


class _ShardedStencilOperator(LinearOperator):
    """Row-sharded padded-grid operator (the twin of _StencilOperator):
    f64 vectors split by rows over the mesh, the mesh's dot, the f64
    stencil as its matvec and the f32 kernel with its fused p . y,
    all-reduced, as the inner engine of `run_cg_ir`."""

    def __init__(self, nyi, nxi, H, W, tbr, mesh):
        self.mesh = mesh
        self._dims = (nyi, nxi, H, W)
        self._hs = H // mesh.size
        apply32_dot, apply_acc = _sharded_stencil_applies(
            mesh, nyi, nxi, self._hs, W, tbr)
        super().__init__(apply_acc, None, nyi * nxi, H * W, torch.float64,
                         mesh.device)
        self.dot = mesh.dot
        self._apply32_dot = apply32_dot

    def _matvec_dot32(self, p):
        # the kernel's p . y is the shard's: summed over the ranks before
        # alpha, or each rank would take its own step
        y, d = self._apply32_dot(None, p)
        return y, self.mesh.all_reduce(d)

    def prepare_b(self, b):
        """This rank's rows of the padded right-hand side, flat, f64."""
        nyi, nxi, H, W = self._dims
        b = torch.as_tensor(b, dtype=torch.float64)
        if b.shape != (self.n,):
            raise ValueError(f"rhs has shape {tuple(b.shape)}, expected "
                             f"({self.n},)")
        bp = torch.nn.functional.pad(b.reshape(nyi, nxi),
                                     (0, W - nxi, 0, H - nyi))
        r0 = self.mesh.rank * self._hs
        return bp[r0:r0 + self._hs].reshape(-1).to(self.device)

    def extract_x(self, x_local):
        """The whole interior on every rank (a collective)."""
        nyi, nxi, H, W = self._dims
        full = self.mesh.all_gather(x_local).reshape(H, W)
        return full[:nyi, :nxi].reshape(-1)

    def run_cg_ir(self, op32, b_padded, max_iters, rel_error, max_cycles,
                  inner_floor, inv_diag32=None):
        del op32  # the f32 stencil is the shard's kernel, not a view
        if inv_diag32 is not None:
            raise NotImplementedError(
                "the Laplacian stencil has a constant diagonal (4); "
                "Jacobi preconditioning is a no-op — run without it")
        return _cg_ir_loop(self._matvec_dot32, self.matvec_dot, b_padded,
                           max_iters, rel_error, max_cycles, inner_floor,
                           self.dot)


def solve_heat_cg(grid, max_iters=100_000, rel_error=1e-10,
                  precision="auto", devices=None, device="cuda"):
    """Steady state via CG on the 5-point Laplacian system, as lam_tpu's.

    Unknowns are the interior cells; the boundary enters as the rhs
    b[i,j] = sum of adjacent boundary temperatures. Returns (grid,
    iterations, rel_residual); for 'ir' the iterations are the total
    inner f32 iterations.

    precision: 'f64' runs plain f64 CG on the plain PyTorch stencil.
    'ir' runs the inner CG in f32 on the stencil kernel (fused p.Ap) on
    the 2-D padded grid, restarted from the TRUE residual computed with
    the masked f64 stencil on the same vector space, up to 40 refinement
    cycles (the Laplacian's condition number grows as side^2). 'auto' is
    'ir' on a CUDA device and 'f64' on the CPU (lam_tpu's accelerator
    rule).

    devices=G > 1 splits the grid's rows over the G ranks of the process
    group (one process per rank, `parallel.mesh.distributed_init`; the
    group must have G ranks): one edge row exchanged with each neighbour
    per matvec, the stencil kernel on the rank's shard, vectors split end
    to end. It implies 'ir' (an explicit 'f64' raises, as in lam_tpu) and
    returns the whole grid on every rank."""
    grid = np.asarray(grid, dtype=np.float64)
    ny, nx = grid.shape
    nyi, nxi = ny - 2, nx - 2
    b = np.zeros((nyi, nxi), dtype=np.float64)
    b[0, :] += grid[0, 1:nx - 1]           # south boundary row
    b[-1, :] += grid[ny - 1, 1:nx - 1]     # north
    b[:, 0] += grid[1:ny - 1, 0]           # west
    b[:, -1] += grid[1:ny - 1, nx - 1]     # east

    if devices and devices > 1:
        # an explicit f64 is rejected as lam_tpu rejects it (its sharded
        # path implements only the mixed-precision ir solver)
        if precision == "f64":
            raise ValueError(
                "the row-sharded heat path implements only the "
                "mixed-precision ir solver; drop --precision f64 or "
                "--devices")
        if precision not in ("auto", "ir"):
            raise ValueError(f"unknown precision {precision!r} (auto, f64 "
                             "or ir)")
        from lam_tpu_torch.ops.stencil import padded_hw
        from lam_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(devices, device=device)
        H, W, tbr = padded_hw(nyi, nxi, row_groups=mesh.size)
        if mesh.device.type == "cuda":
            from lam_tpu_torch.ops._build import library
            library()
        op = _ShardedStencilOperator(nyi, nxi, H, W, tbr, mesh)
        res = cg_solve_ir(op, op, b.reshape(-1), max_iters=max_iters,
                          rel_error=rel_error, max_cycles=40)
        return _result(grid, res)
    dev = resolve_device(device)
    if precision == "auto":
        precision = "ir" if dev.type == "cuda" else "f64"
    if precision == "ir":
        from lam_tpu_torch.ops.stencil import padded_hw
        H, W, tbr = padded_hw(nyi, nxi)
        if dev.type == "cuda":
            # build (or load) the kernels here rather than in the first
            # matvec, so a warm-up solve with max_iters=0 carries it
            from lam_tpu_torch.ops._build import library
            library()
        # the kernel's zero edge row, shared: op32 is a view of op, as
        # cg_solve_ir requires (the f64 stencil ignores it)
        operand = torch.zeros((1, W), dtype=torch.float32, device=dev)
        op = _StencilOperator(_laplace_matvec_padded(nyi, nxi, H, W), None,
                              operand, nyi, nxi, H, W, torch.float64, dev)
        op32 = _StencilOperator(None,
                                _laplace_matvec_dot_kernel(nyi, nxi, H, W,
                                                           tbr),
                                operand, nyi, nxi, H, W, torch.float32, dev)
        res = cg_solve_ir(op32, op, b.reshape(-1), max_iters=max_iters,
                          rel_error=rel_error, max_cycles=40)
    elif precision == "f64":
        op = MatrixFreeOperator(_laplace_matvec(nyi, nxi),
                                torch.zeros((), device=dev), nyi * nxi,
                                device=dev)
        res = cg_solve(op, b.reshape(-1), max_iters=max_iters,
                       rel_error=rel_error)
    else:
        raise ValueError(f"unknown precision {precision!r} (auto, f64 or ir)")
    return _result(grid, res)


def _result(grid, res):
    """(grid with the solved interior, iterations, rel_residual)."""
    out = grid.copy()
    out[1:-1, 1:-1] = res.x.cpu().numpy().reshape(out[1:-1, 1:-1].shape)
    return out, int(res.num_iters), float(res.rel_residual)
