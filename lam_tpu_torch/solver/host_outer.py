"""Iterative refinement with host-exact outer residuals (lam_tpu/solver/host_outer.py).

The irfq refinement on the device (solver/cg.py `_cg_ir_loop`) holds the
whole fq cascade, 6 B an element, though only its few outer residuals
read q2 and q3: the inner CG reads the 2-byte q1 plane alone. Where the
host still holds the exact f64 source it packed from (a memory map of
the matrix file), the outer residual r = b - A x can be formed there in
f64 instead, and only q1, its scales and the diagonal pair go to the
card (`DenseOperator.from_file_fq_q1`): a third of the bytes to upload
and to hold, and an outer operator that is exact rather than the ~2^-48
cascade. The trade: each refinement cycle pays one host matvec, N^2 f64
reads (dsymv reads one triangle), so `solve_s` grows while the time to
an answer from cold storage shrinks. Between the host and the card a
cycle moves two n-vectors.

The outer loop is a Python loop over a handful of cycles; each inner
solve is the port's `_cg_loop` on the card.
"""

from __future__ import annotations

import numpy as np

from lam_tpu_torch.solver.cg import CGResult, _cg_loop, default_inner_floor


def host_matvec(a):
    """x -> A @ x on the host, reading one triangle where BLAS dsymv
    applies: `a` (an (n, n) array or memory map, C-ordered and symmetric)
    transposed is F-ordered and equal to itself, so scipy's dsymv takes
    the `a.T` view without a copy. Otherwise `a @ x`."""
    try:
        from scipy.linalg.blas import dsymv
        at = a.T
        if not at.flags.f_contiguous:
            raise ValueError
        return lambda x: dsymv(1.0, at, x, lower=1)
    except (ImportError, ValueError):
        return lambda x: a @ x


def cg_solve_ir_host(a_host, op_q1, b, *, max_iters=10000, rel_error=1e-9,
                     inner_floor=None, max_cycles=20):
    """Mixed-precision CG: inner solves on the card over `op_q1.as_f32()`
    (the q1 plane: `DenseOperator.from_file_fq_q1`, or a full fq
    operator, whose buffers it shares), exact f64 outer residuals on the
    host.

    a_host: the exact operator, an (n, n) f64 array or memory map, or a
        callable x -> A x.
    Each cycle runs the inner CG with the irfq floor schedule
    (`default_inner_floor('irfq')` unless inner_floor is given) and
    tolerance clip(rel_error / rel, floor, 0.99), then forms r = b - A x
    on the host. Returns a host CGResult: x an (n,) f64 numpy vector,
    num_iters the total counted inner iterations, rel_residual the TRUE
    relative residual under a_host (not a recurrence). max_iters=0 is the
    warm-up: one inner matvec builds and launches the kernel, the inner
    loop runs with zero iterations, and the result is (zeros, 0, 1.0,
    False)."""
    op32 = op_q1.as_f32()
    n = op_q1.n
    b = np.asarray(b, dtype=np.float64)
    if b.shape != (n,):
        raise ValueError(f"rhs has shape {b.shape}, expected ({n},)")
    matvec = a_host if callable(a_host) else host_matvec(a_host)
    floors = np.atleast_1d(
        default_inner_floor("irfq") if inner_floor is None
        else inner_floor).astype(np.float64)

    bb = float(b @ b)
    if bb == 0.0:
        return CGResult(x=np.zeros(n), num_iters=0, rel_residual=0.0,
                        converged=True)
    if max_iters == 0:
        zero = op32.prepare_b(np.zeros(n, np.float32))
        float(op32.matvec_dot(zero)[1])
        float(_cg_loop(op32.matvec_dot, zero, 0, 0.5,
                       op32.dot).rel_residual)
        return CGResult(x=np.zeros(n), num_iters=0, rel_residual=1.0,
                        converged=False)
    x = np.zeros(n, dtype=np.float64)
    r = b.copy()
    total = 0
    rel = 1.0
    for cyc in range(max_cycles):
        rel = float(np.sqrt(float(r @ r) / bb))
        if rel < rel_error or total >= max_iters:
            break
        floor = float(floors[min(cyc, len(floors) - 1)])
        tol = float(np.clip(rel_error / rel, floor, 0.99))
        rnorm = float(np.sqrt(float(r @ r)))
        r32 = op32.prepare_b((r / rnorm).astype(np.float32))
        inner = _cg_loop(op32.matvec_dot, r32, max_iters - total, tol,
                         op32.dot)
        d = op32.extract_x(inner.x).detach().cpu().numpy()
        x += d.astype(np.float64) * rnorm
        total += int(inner.num_iters)
        r = b - matvec(x)
    else:
        rel = float(np.sqrt(float(r @ r) / bb))
    return CGResult(x=x, num_iters=total, rel_residual=rel,
                    converged=rel < rel_error)
