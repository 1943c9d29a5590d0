"""The conjugate-gradient engine, on torch tensors.

The main-path subset of lam_tpu/solver/cg.py, with its semantics kept
exactly (lam_tpu/solver/cg.py:14-26):
  * update order: gemv; alpha = rr / p.Ap; x += alpha p; r -= alpha Ap;
    rr_new = r.r; beta = rr_new / rr; convergence test; p = r + beta p.
  * stopping rule: sqrt(rr / bb) < rel_error, bb = b.b computed once.
  * `num_iters` is the number of completed iterations; convergence at
    iteration k reports k, non-convergence reports max_iters.

The JAX package runs the whole loop as one `lax.while_loop` with no host
round trip. Here PyTorch runs eagerly, so the loop never reads a scalar
back per iteration: each iteration tests convergence on the device and
freezes a finished state with `torch.where` (alpha = 0, so x and r stay
bitwise unchanged; p, rr and k keep their values), and the host reads
one flag every CHUNK iterations to stop. A solve therefore runs up to
CHUNK - 1 frozen iterations past convergence, and `num_iters` stays
exact. The refinement loop reads one flag per cycle besides.

Both loops take the reduction `dot` they use for every dot product
(default: the one-device vdot). A row-sharded operator passes its mesh's
dot, which all-reduces the ranks' partial sums, so each rank holds the
same scalars and every host decision (the flag read every CHUNK
iterations, the refinement-cycle test) is taken alike on every rank; a
rank that decided alone would leave the others waiting in a collective.
This replaces lam_tpu's separate per-shard loops (lam_tpu/parallel/
pcg.py:108-156, :238-309), whose update order is the one above.

Jacobi preconditioning (`preconditioner="jacobi"`, lam_tpu/solver/cg.py:
108-160) runs `_pcg_loop`, the same loop with z = inv_diag * r: the
stopping test stays on the UNpreconditioned sqrt(rr / bb). In the
refinement loop it scales the inner f32 loop only (`inv_diag32`); the
outer true-residual recurrence is unchanged. inv_diag is split like the
vectors it scales (a mesh operator's `diagonal()` returns the rank's
part), so it needs no communication.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lam_tpu_torch.solver.operators import vdot

CHUNK = 32  # iterations between host reads of the continue flag


class CGResult(NamedTuple):
    """Solve outcome. Fields are device tensors until read."""

    x: torch.Tensor
    num_iters: torch.Tensor      # int64: completed iterations
    rel_residual: torch.Tensor   # sqrt(rr / bb) at exit
    converged: torch.Tensor      # bool


# Inner tolerance floors of the refinement loop (lam_tpu/solver/cg.py:
# 47-65). An exact-f32 inner operator ('ir', and 'irq', whose inner loop
# reads the dfq storage's f32 hi plane) gets a flat 1e-5: the f32
# recurrence stagnates near kappa*eps_f32 anyway, so a tighter inner
# tolerance burns iterations. The ~2^-16 quantized inner operator
# ('irfq') gets a loose-early/tight-late per-cycle schedule; floors
# below its error cost iterations.
IR_INNER_FLOOR = 1e-5
IRFQ_INNER_FLOOR = (3e-2, 1e-2)


def default_inner_floor(precision):
    """The inner_floor (scalar or per-cycle schedule) of a refinement
    precision mode: 'ir', 'irq' or 'irfq'."""
    if precision == "irfq":
        return IRFQ_INNER_FLOOR
    if precision not in ("ir", "irq"):
        raise ValueError(f"{precision!r} is not a refinement precision "
                         "('ir', 'irq' or 'irfq')")
    return IR_INNER_FLOOR


def _cg_loop(matvec_dot, b, max_iters, rel_error, dot=vdot):
    """CG on (possibly padded) vectors. matvec_dot(p) -> (Ap, p.Ap).
    max_iters and rel_error may be numbers or 0-dim device tensors."""
    dtype, dev = b.dtype, b.device
    bb = dot(b, b)
    eps = torch.as_tensor(rel_error, dtype=dtype, device=dev)
    limit = torch.as_tensor(max_iters, device=dev)
    # x = 0, r = p = b
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    rr = bb
    k = torch.zeros((), dtype=torch.int64, device=dev)

    def active(rr, k):
        return (k < limit) & (torch.sqrt(rr / bb) >= eps)

    go = active(rr, k)
    while bool(go):
        for _ in range(CHUNK):
            ap, p_ap = matvec_dot(p)
            alpha = torch.where(go, rr / p_ap, 0.0)
            x.addcmul_(alpha, p)
            r.addcmul_(alpha, ap, value=-1.0)
            rr_new = dot(r, r)
            beta = rr_new / rr
            p = torch.where(go, r + beta * p, p)
            rr = torch.where(go, rr_new, rr)
            k = k + go
            go = active(rr, k)
    rel = torch.sqrt(rr / bb)
    converged = rel < eps
    num_iters = torch.where(converged, k, limit)
    return CGResult(x=x, num_iters=num_iters, rel_residual=rel,
                    converged=converged)


def _pcg_loop(matvec_dot, b, inv_diag, max_iters, rel_error, dot=vdot):
    """Jacobi-preconditioned CG: lam_tpu's recurrence (alpha = rz / p.Ap,
    z = inv_diag * r, beta = rz_new / rz, p = z + beta p), p.Ap from the
    fused matvec_dot, the stopping test on the UNpreconditioned sqrt(rr /
    bb), finished states frozen and the flag read every CHUNK iterations
    as in _cg_loop."""
    dtype, dev = b.dtype, b.device
    bb = dot(b, b)
    eps = torch.as_tensor(rel_error, dtype=dtype, device=dev)
    limit = torch.as_tensor(max_iters, device=dev)
    x = torch.zeros_like(b)
    r = b.clone()
    p = inv_diag * b
    rz = dot(b, p)
    rr = bb
    k = torch.zeros((), dtype=torch.int64, device=dev)

    def active(rr, k):
        return (k < limit) & (torch.sqrt(rr / bb) >= eps)

    go = active(rr, k)
    while bool(go):
        for _ in range(CHUNK):
            ap, p_ap = matvec_dot(p)
            alpha = torch.where(go, rz / p_ap, 0.0)
            x.addcmul_(alpha, p)
            r.addcmul_(alpha, ap, value=-1.0)
            z = inv_diag * r
            rz_new = dot(r, z)
            rr_new = dot(r, r)
            beta = rz_new / rz
            p = torch.where(go, z + beta * p, p)
            rz = torch.where(go, rz_new, rz)
            rr = torch.where(go, rr_new, rr)
            k = k + go
            go = active(rr, k)
    rel = torch.sqrt(rr / bb)
    converged = rel < eps
    num_iters = torch.where(converged, k, limit)
    return CGResult(x=x, num_iters=num_iters, rel_residual=rel,
                    converged=converged)


def _check_preconditioner(preconditioner):
    if preconditioner not in (None, "jacobi"):
        raise ValueError(f"unknown preconditioner {preconditioner!r}")


def cg_solve(op, b, *, max_iters=1000, rel_error=1e-9,
             preconditioner=None):
    """Solve A x = b with CG for a LinearOperator `op`.

    `b` may be numpy or torch, length op.n; the result's x has length
    op.n (padding and precision are the operator's).
    preconditioner="jacobi" runs diagonal-scaled CG (the operator must
    expose a diagonal)."""
    _check_preconditioner(preconditioner)
    b_dev = op.prepare_b(b)
    if preconditioner is None:
        res = op.run_cg(_cg_loop, b_dev, max_iters, rel_error)
    else:
        res = op.run_pcg(b_dev, max_iters, rel_error)
    return res._replace(x=op.extract_x(res.x))


def _cg_ir_loop(matvec_dot32, matvec_dot_acc, b, max_iters, rel_error,
                max_cycles, inner_floor, dot=vdot, inv_diag32=None):
    """Mixed-precision CG with iterative refinement.

    Outer loop (b's dtype): r = b - A x with the accurate matvec,
    normalized and handed to an inner f32 CG whose tolerance is clipped
    to [floor, 0.99]; x += inner x * |r|. inner_floor may be a scalar or
    a per-cycle schedule (cycle c uses entry min(c, len-1)). inv_diag32
    (f32, optional) Jacobi-preconditions the inner loop (`_pcg_loop`)."""
    dtype, dev = b.dtype, b.device
    bb = dot(b, b)
    eps = torch.as_tensor(rel_error, dtype=dtype, device=dev)
    floors = torch.atleast_1d(torch.as_tensor(inner_floor, dtype=dtype,
                                              device=dev))
    x = torch.zeros_like(b)
    r = b
    k = torch.zeros((), dtype=torch.int64, device=dev)
    cyc = 0

    def rel_of(r):
        return torch.sqrt(dot(r, r) / bb)

    while cyc < max_cycles and bool((k < max_iters) & (rel_of(r) >= eps)):
        rnorm = torch.sqrt(dot(r, r))
        rel = rnorm / torch.sqrt(bb)
        # inner tolerance: enough to land under rel_error this cycle,
        # floored at what the inner operator can deliver
        floor = floors[min(cyc, floors.shape[0] - 1)]
        inner_tol = torch.clamp(torch.maximum(eps / rel, floor), max=0.99)
        r32 = (r / rnorm).to(torch.float32)
        if inv_diag32 is None:
            inner = _cg_loop(matvec_dot32, r32, max_iters - k,
                             inner_tol.to(torch.float32), dot)
        else:
            inner = _pcg_loop(matvec_dot32, r32, inv_diag32, max_iters - k,
                              inner_tol.to(torch.float32), dot)
        x = x + inner.x.to(dtype) * rnorm
        r = b - matvec_dot_acc(x)[0]
        k = k + inner.num_iters
        cyc += 1
    rel = rel_of(r)
    return CGResult(x=x, num_iters=k, rel_residual=rel, converged=rel < eps)


def _inv_diag_f32(op):
    """The f32 inverse diagonal that preconditions an inner loop: 1 where
    d == 0 (the padding, whose residual is 0: any finite inverse works,
    and 1 avoids inf * 0), 1 / d elsewhere, taken from the ACCURATE
    operator's diagonal and split like its vectors."""
    d = op.diagonal()
    return torch.where(d == 0, torch.ones_like(d), 1.0 / d).to(torch.float32)


def cg_solve_ir(op32, op_acc, b, *, max_iters=10000, rel_error=1e-9,
                inner_floor=IR_INNER_FLOOR, max_cycles=6,
                preconditioner=None):
    """Mixed-precision CG with iterative refinement: f32 iterations on
    op32 (half the bytes of the df64 pair), restarted from the TRUE
    residual computed with op_acc. op32 must be op_acc.as_f32(): one
    copy of the matrix serves both. num_iters counts TOTAL inner f32
    iterations; x is on op_acc's dtype. preconditioner="jacobi" scales
    the INNER loop by op_acc's inverse diagonal; the outer recurrence is
    unchanged."""
    _check_preconditioner(preconditioner)
    inv32 = _inv_diag_f32(op_acc) if preconditioner == "jacobi" else None
    b_acc = op_acc.prepare_b(b)
    res = op_acc.run_cg_ir(op32, b_acc, max_iters, rel_error, max_cycles,
                           inner_floor, inv_diag32=inv32)
    return res._replace(x=op_acc.extract_x(res.x))
