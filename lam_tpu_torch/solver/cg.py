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


def _active(limit, eps, bb):
    """The continue test of a CG loop: k < limit and sqrt(rr / bb) >= eps."""
    def active(rr, k):
        return (k < limit) & (torch.sqrt(rr / bb) >= eps)

    return active


def _chunks(k_budget):
    """Iterations between flag reads: CHUNK, or fewer where a segment's
    host-known budget (`k_budget`, the iterations it may still take) ends
    first, so that it stops at its limit with no frozen iterations past
    it."""
    return CHUNK if k_budget is None else max(1, min(CHUNK, k_budget))


def _cg_run(matvec_dot, state, limit, eps, dot, k_budget=None):
    """Continue the CG recurrence from state (x, r, p, rr, bb, k) until
    k == limit or convergence; returns the new state. x is updated in
    place. k_budget (a segment's host-known iteration budget, else None)
    shortens the last chunk to end at the limit."""
    x, r, p, rr, bb, k = state
    active = _active(limit, eps, bb)
    go = active(rr, k)
    while bool(go):
        steps = _chunks(k_budget)
        for _ in range(steps):
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
        if k_budget is not None:
            k_budget -= steps
    return x, r, p, rr, bb, k


def _pcg_run(matvec_dot, state, inv_diag, limit, eps, dot, k_budget=None):
    """Continue the Jacobi-PCG recurrence from state (x, r, p, rz, rr,
    bb, k), as _cg_run does."""
    x, r, p, rz, rr, bb, k = state
    active = _active(limit, eps, bb)
    go = active(rr, k)
    while bool(go):
        steps = _chunks(k_budget)
        for _ in range(steps):
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
        if k_budget is not None:
            k_budget -= steps
    return x, r, p, rz, rr, bb, k


def _result(x, rr, bb, k, eps, limit):
    rel = torch.sqrt(rr / bb)
    converged = rel < eps
    num_iters = torch.where(converged, k, limit)
    return CGResult(x=x, num_iters=num_iters, rel_residual=rel,
                    converged=converged)


def _cg_loop(matvec_dot, b, max_iters, rel_error, dot=vdot):
    """CG on (possibly padded) vectors from x = 0, r = p = b.
    matvec_dot(p) -> (Ap, p.Ap). max_iters and rel_error may be numbers
    or 0-dim device tensors."""
    dtype, dev = b.dtype, b.device
    bb = dot(b, b)
    eps = torch.as_tensor(rel_error, dtype=dtype, device=dev)
    limit = torch.as_tensor(max_iters, device=dev)
    k = torch.zeros((), dtype=torch.int64, device=dev)
    x, _, _, rr, _, k = _cg_run(
        matvec_dot, (torch.zeros_like(b), b.clone(), b.clone(), bb, bb, k),
        limit, eps, dot)
    return _result(x, rr, bb, k, eps, limit)


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
    p = inv_diag * b
    rz = dot(b, p)
    k = torch.zeros((), dtype=torch.int64, device=dev)
    x, _, _, _, rr, _, k = _pcg_run(
        matvec_dot, (torch.zeros_like(b), b.clone(), p, rz, bb, bb, k),
        inv_diag, limit, eps, dot)
    return _result(x, rr, bb, k, eps, limit)


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


def _dot_cols(dot, u, v):
    """Per-column dots of two (n, k) blocks: the operator's `dot` applied
    to each column, so a mesh all-reduces each and every rank holds the
    same (k,) values."""
    return torch.stack([dot(u[:, j], v[:, j]) for j in range(u.shape[1])])


def _cg_block_loop(matvec, b, max_iters, rel_error, dot=vdot):
    """Block CG (lam_tpu/solver/cg.py:163-206): k independent recurrences
    sharing each read of A, matvec(P) -> A P on (n, k) blocks. Columns
    converge independently: a converged column freezes (alpha = beta =
    0) and keeps the iteration count of its last active step, k + 1.
    As in _cg_loop, the host reads one flag every CHUNK iterations, and
    every column freezes once k reaches max_iters."""
    dtype, dev = b.dtype, b.device
    bb = _dot_cols(dot, b, b)
    eps = torch.as_tensor(rel_error, dtype=dtype, device=dev)
    limit = torch.as_tensor(max_iters, device=dev)
    x = torch.zeros_like(b)
    r, p, rr = b, b, bb
    iters = torch.zeros(b.shape[1], dtype=torch.int64, device=dev)
    k = torch.zeros((), dtype=torch.int64, device=dev)

    def active_mask(rr, k):
        return (torch.sqrt(rr / bb) >= eps) & (k < limit)

    active = active_mask(rr, k)
    while bool(active.any()):
        for _ in range(CHUNK):
            ap = matvec(p)
            pap = _dot_cols(dot, p, ap)
            alpha = torch.where(active, rr / pap, 0.0)
            x = x + alpha * p
            r = r - alpha * ap
            rr_new = _dot_cols(dot, r, r)
            beta = torch.where(active, rr_new / rr, 0.0)
            rr = torch.where(active, rr_new, rr)
            p = torch.where(active, r + beta * p, p)
            iters = torch.where(active, k + 1, iters)
            k = k + active.any()
            active = active_mask(rr, k)
    rel = torch.sqrt(rr / bb)
    return CGResult(x=x, num_iters=iters, rel_residual=rel,
                    converged=rel < eps)


def cg_solve_block(op, b_block, *, max_iters=1000, rel_error=1e-9):
    """Solve A X = B for an (n, k) block of right-hand sides
    (lam_tpu/solver/cg.py:209-218): per-column CGResult fields
    (num_iters, rel_residual and converged are (k,) tensors). The
    operator's block matvec is a plain torch product over its storage
    (a matmul, or the packed triangle's walk), as lam_tpu's is an XLA
    product: the single-vector kernels do not apply."""
    b_dev = op.prepare_b_block(b_block)
    res = op.run_cg_block(b_dev, max_iters, rel_error)
    return res._replace(x=op.extract_x(res.x))


def _ir_floors(inner_floor, dtype, dev):
    """inner_floor, a scalar or a per-cycle schedule, as a 1-D tensor:
    cycle c uses entry min(c, len - 1)."""
    return torch.atleast_1d(torch.as_tensor(inner_floor, dtype=dtype,
                                            device=dev))


def _ir_cycle(matvec_dot32, matvec_dot_acc, b, bb, x, r, k_left, eps, floor,
              dot=vdot, inv_diag32=None):
    """One refinement cycle from (x, r) (lam_tpu/solver/checkpoint.py:
    252-278): the inner tolerance from the current relative residual,
    floored at `floor` and capped at 0.99; the normalized residual
    solved in f32 for at most k_left iterations; x += inner x * |r| and
    the TRUE residual r = b - A x with the accurate matvec. Returns (x',
    r', inner iterations). _cg_ir_loop runs it, so a resumed solve
    follows the fused loop's trajectory bit for bit."""
    dtype = b.dtype
    rnorm = torch.sqrt(dot(r, r))
    rel = rnorm / torch.sqrt(bb)
    # inner tolerance: enough to land under rel_error this cycle,
    # floored at what the inner operator can deliver
    inner_tol = torch.clamp(torch.maximum(eps / rel, floor), max=0.99)
    r32 = (r / rnorm).to(torch.float32)
    if inv_diag32 is None:
        inner = _cg_loop(matvec_dot32, r32, k_left,
                         inner_tol.to(torch.float32), dot)
    else:
        inner = _pcg_loop(matvec_dot32, r32, inv_diag32, k_left,
                          inner_tol.to(torch.float32), dot)
    x = x + inner.x.to(dtype) * rnorm
    r = b - matvec_dot_acc(x)[0]
    return x, r, inner.num_iters


def _ir_active(r, bb, eps, dot):
    """The refinement loop's continue test on the residual alone:
    sqrt(r.r / bb) >= eps (the decision every rank takes alike)."""
    return torch.sqrt(dot(r, r) / bb) >= eps


def _cg_ir_loop(matvec_dot32, matvec_dot_acc, b, max_iters, rel_error,
                max_cycles, inner_floor, dot=vdot, inv_diag32=None):
    """Mixed-precision CG with iterative refinement.

    Outer loop (b's dtype): r = b - A x with the accurate matvec,
    normalized and handed to an inner f32 CG whose tolerance is clipped
    to [floor, 0.99]; x += inner x * |r| (`_ir_cycle`). inner_floor may
    be a scalar or a per-cycle schedule (cycle c uses entry min(c,
    len-1)). inv_diag32 (f32, optional) Jacobi-preconditions the inner
    loop (`_pcg_loop`)."""
    dtype, dev = b.dtype, b.device
    bb = dot(b, b)
    eps = torch.as_tensor(rel_error, dtype=dtype, device=dev)
    floors = _ir_floors(inner_floor, dtype, dev)
    x = torch.zeros_like(b)
    r = b
    k = torch.zeros((), dtype=torch.int64, device=dev)
    cyc = 0
    while cyc < max_cycles and bool((k < max_iters)
                                    & _ir_active(r, bb, eps, dot)):
        x, r, inner_iters = _ir_cycle(
            matvec_dot32, matvec_dot_acc, b, bb, x, r, max_iters - k, eps,
            floors[min(cyc, floors.shape[0] - 1)], dot, inv_diag32)
        k = k + inner_iters
        cyc += 1
    rel = torch.sqrt(dot(r, r) / bb)
    return CGResult(x=x, num_iters=k, rel_residual=rel, converged=rel < eps)


def _inv_diag(op):
    """Jacobi's inverse diagonal, split like the operator's vectors: 1
    where d == 0 (the padding, whose residual is 0: any finite inverse
    works, and 1 avoids inf * 0), 1 / d elsewhere."""
    d = op.diagonal()
    return torch.where(d == 0, torch.ones_like(d), 1.0 / d)


def _inv_diag_f32(op):
    """The f32 inverse diagonal that preconditions an inner loop, taken
    from the ACCURATE operator's diagonal."""
    return _inv_diag(op).to(torch.float32)


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
