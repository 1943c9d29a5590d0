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
    CG on the plain PyTorch stencil.

The row-sharded halo-exchange variant of `solve_heat_cg` (lam_tpu's
devices > 1) comes with the sharded backends and raises here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lam_tpu_torch.solver.cg import CHUNK, cg_solve, cg_solve_ir
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
    rule). devices > 1 (lam_tpu's row-sharded halo path) is not ported
    yet and raises."""
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
        raise NotImplementedError(
            f"solve_heat_cg(devices={devices}): the row-sharded halo path "
            "is not ported yet (ROADMAP Queue 1 item 4, the row-sharded "
            "heat path)")
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
    out = grid.copy()
    out[1:ny - 1, 1:nx - 1] = res.x.cpu().numpy().reshape(nyi, nxi)
    return out, int(res.num_iters), float(res.rel_residual)
