"""Solver-state checkpoint and resume, and segmented solving.

The port of lam_tpu/solver/checkpoint.py, name for name:

  * the CG state (x, r, p, rr, bb, k), with the carried rz for Jacobi
    PCG, is a restart point: CG continues exactly from it;
  * `cg_solve_resumable` runs the loop in segments of `segment`
    iterations (lam_tpu_torch/solver/cg.py's `_cg_run`/`_pcg_run`, the
    loops of `cg_solve`, so it follows cg_solve's trajectory bit for
    bit), may persist the state after each one and can resume from it;
  * `cg_solve_ir_resumable` checkpoints the refinement loop at cycle
    boundaries (x, r, k, cycle), one cycle being `cg._ir_cycle`, the body
    of the fused loop, so a resumed solve lands on the uninterrupted
    one's bits.

The files are lam_tpu's, byte for byte: each vector in the reference
binary format (lam_tpu_torch/io.py's `write_matrix`: f64, a header of
rows and columns) and a JSON sidecar with the same keys, order and
values (`state.json`: rr, bb, k, n, n_padded, and kind and rz for PCG;
`ir_state.json`: k, cycle, n, n_padded, preconditioner). A checkpoint of
either package resumes in the other for the same operator layout:
`n_padded` is the operator's own, so the sidecar check refuses a
checkpoint written for another padding, mesh or layout.

On a mesh a vector in a file is the whole padded vector in lam_tpu's
order: the operator's `to_global` assembles it (a collective on the
split layouts, the vector itself where it is whole on every rank) and
`from_global` takes a rank's part back. Rank 0 writes the files and a
barrier of the mesh follows, so no rank goes on before they are written;
on resume every rank reads them. Every host decision (the iteration and
cycle limits, the convergence test) reads scalars that the operator's
`dot` has all-reduced, so all ranks leave the loops together.
"""

from __future__ import annotations

import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from lam_tpu_torch import io as lio
from lam_tpu_torch.solver.cg import (IR_INNER_FLOOR, CGResult,
                                     _check_preconditioner, _cg_run,
                                     _inv_diag, _inv_diag_f32, _ir_active,
                                     _ir_cycle, _ir_floors, _pcg_run,
                                     _result)


class CGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rr: torch.Tensor
    bb: torch.Tensor
    k: torch.Tensor  # completed iterations (int64)


class PCGState(NamedTuple):
    """Jacobi-PCG restart point: the CG state plus the carried
    preconditioned product rz = <r, M^-1 r>."""
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    rr: torch.Tensor
    bb: torch.Tensor
    k: torch.Tensor  # completed iterations (int64)


def _k0(dev):
    return torch.zeros((), dtype=torch.int64, device=dev)


def initial_state(op, b_padded):
    """x = 0, r = p = b: the state `cg_solve` starts from (copies of b,
    since the loop updates r in place)."""
    bb = op.dot(b_padded, b_padded)
    return CGState(x=torch.zeros_like(b_padded), r=b_padded.clone(),
                   p=b_padded.clone(), rr=bb, bb=bb, k=_k0(b_padded.device))


def initial_pcg_state(op, b_padded, inv_diag):
    bb = op.dot(b_padded, b_padded)
    z0 = inv_diag * b_padded
    return PCGState(x=torch.zeros_like(b_padded), r=b_padded.clone(), p=z0,
                    rz=op.dot(b_padded, z0), rr=bb, bb=bb,
                    k=_k0(b_padded.device))


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_state(path, state, n):
    """Persist a CGState or PCGState whose vectors are whole (host
    arrays or tensors): vectors in the reference binary format plus a
    JSON sidecar with the scalars (PCG adds "kind" and the carried rz)."""
    os.makedirs(path, exist_ok=True)
    for name in ("x", "r", "p"):
        lio.write_matrix(os.path.join(path, f"{name}.bin"),
                         _host(getattr(state, name)))
    meta = {"rr": float(state.rr), "bb": float(state.bb),
            "k": int(state.k), "n": int(n),
            "n_padded": int(state.x.shape[0])}
    if isinstance(state, PCGState):
        meta["kind"] = "pcg"
        meta["rz"] = float(state.rz)
    with open(os.path.join(path, "state.json"), "w") as f:
        json.dump(meta, f)


def _check_size(meta, op, what):
    if meta["n"] != op.n or meta["n_padded"] != op.n_padded:
        raise ValueError(
            f"{what} is for n={meta['n']}/pad={meta['n_padded']}, "
            f"operator has n={op.n}/pad={op.n_padded}")


def _read_part(path, name, op):
    return op.from_global(lio.read_vector(os.path.join(path, f"{name}.bin")))


def load_state(path, op, kind="cg"):
    """The state of a checkpoint directory, this rank's parts of its
    vectors on op's device in op's vector dtype; refuses a checkpoint of
    another size or padding, or of the other recurrence."""
    with open(os.path.join(path, "state.json")) as f:
        meta = json.load(f)
    _check_size(meta, op, "checkpoint")
    stored = meta.get("kind", "cg")
    if stored != kind:
        raise ValueError(
            f"checkpoint was written by a {stored!r} solve; cannot "
            f"resume it as {kind!r} (the recurrences carry different "
            "state)")
    vecs = {name: _read_part(path, name, op) for name in ("x", "r", "p")}

    def scalar(key):
        return torch.as_tensor(meta[key], dtype=op.vector_dtype,
                               device=op.device)

    k = torch.as_tensor(meta["k"], dtype=torch.int64, device=op.device)
    if kind == "pcg":
        return PCGState(rz=scalar("rz"), rr=scalar("rr"), bb=scalar("bb"),
                        k=k, **vecs)
    return CGState(rr=scalar("rr"), bb=scalar("bb"), k=k, **vecs)


def _is_writer(op):
    """Rank 0 of the operator's mesh, or of the process group where a
    one-device operator has none, writes the files."""
    mesh = getattr(op, "mesh", None)
    if mesh is not None:
        return mesh.rank == 0
    return not dist.is_initialized() or dist.get_rank() == 0


def _written(op):
    """No rank of the mesh goes on before rank 0 has written."""
    mesh = getattr(op, "mesh", None)
    if mesh is not None and mesh.size > 1:
        mesh.barrier()


def cg_solve_resumable(op, b, *, max_iters=1000, rel_error=1e-9,
                       segment=100, checkpoint_path=None, resume=False,
                       on_segment=None, preconditioner=None):
    """Segmented CG with optional checkpointing.

    Runs `segment` iterations a segment; after each segment the state
    may be persisted (`checkpoint_path`) and `on_segment(state,
    seg_seconds)` is called. `resume=True` restarts from the checkpoint.
    preconditioner="jacobi" runs the diagonal-scaled recurrence (the
    sidecar tags the checkpoint, so the two recurrences cannot be
    cross-resumed). Each segment ends in a scalar read, so its time is
    the device's too. Returns (CGResult, [(iterations, seconds), ...]);
    num_iters is max_iters for a solve that has not converged."""
    _check_preconditioner(preconditioner)
    if segment < 1:
        raise ValueError(f"segment must be a positive number of "
                         f"iterations, got {segment}")
    b_padded = op.prepare_b(b)
    dev = b_padded.device
    inv_d = None if preconditioner is None else _inv_diag(op)
    kind = "cg" if inv_d is None else "pcg"
    if resume:
        if not checkpoint_path:
            raise ValueError("resume=True requires checkpoint_path")
        state = load_state(checkpoint_path, op, kind=kind)
    elif inv_d is None:
        state = initial_state(op, b_padded)
    else:
        state = initial_pcg_state(op, b_padded, inv_d)
    eps = torch.as_tensor(rel_error, dtype=b_padded.dtype, device=dev)

    seg_times = []
    while True:
        k_now = int(state.k)
        if k_now >= max_iters:
            break
        # the loop's own test, on the device's dtype
        if not bool(torch.sqrt(state.rr / state.bb) >= eps):
            break
        k_stop = min(k_now + segment, max_iters)
        limit = torch.as_tensor(k_stop, device=dev)
        t0 = time.perf_counter()
        if inv_d is None:
            state = CGState(*_cg_run(op.matvec_dot, state, limit, eps,
                                     op.dot, k_budget=k_stop - k_now))
        else:
            state = PCGState(*_pcg_run(op.matvec_dot, state, inv_d, limit,
                                       eps, op.dot,
                                       k_budget=k_stop - k_now))
        k_new = int(state.k)  # waits for the segment
        dt = time.perf_counter() - t0
        seg_times.append((k_new - k_now, dt))
        if checkpoint_path:
            whole = state._replace(**{name: op.to_global(getattr(state, name))
                                      for name in ("x", "r", "p")})
            if _is_writer(op):
                save_state(checkpoint_path, whole, op.n)
            _written(op)
        if on_segment is not None:
            on_segment(state, dt)

    result = _result(op.extract_x(state.x), state.rr, state.bb, state.k, eps,
                     torch.as_tensor(max_iters, device=dev))
    return result, seg_times


# --- resumable mixed-precision (ir) solving --------------------------------
#
# Refinement-cycle boundaries are natural restart points: the outer state
# is (x, r, k, cycle) in the accurate dtype, and the f64 binary format
# round-trips it exactly, so a resumed solve continues with the same
# per-cycle arithmetic as an uninterrupted one.


def save_ir_state(path, x, r, k, cycle, n, preconditioner=None):
    """Persist the outer state of a refinement solve (whole vectors)."""
    os.makedirs(path, exist_ok=True)
    lio.write_matrix(os.path.join(path, "x.bin"), _host(x))
    lio.write_matrix(os.path.join(path, "r.bin"), _host(r))
    with open(os.path.join(path, "ir_state.json"), "w") as f:
        json.dump({"k": int(k), "cycle": int(cycle), "n": int(n),
                   "n_padded": int(x.shape[0]),
                   "preconditioner": preconditioner}, f)


def load_ir_state(path, op, preconditioner=None):
    """(x, r, k, cycle) of an ir checkpoint, x and r this rank's parts;
    refuses another size or padding, or another preconditioner."""
    with open(os.path.join(path, "ir_state.json")) as f:
        meta = json.load(f)
    _check_size(meta, op, "ir checkpoint")
    # older sidecars (written before the preconditioner) lack the key
    saved = meta.get("preconditioner")
    if saved != preconditioner:
        raise ValueError(
            f"ir checkpoint was written with "
            f"preconditioner={saved!r}; resuming with "
            f"{preconditioner!r} would follow a different trajectory")
    return (_read_part(path, "x", op), _read_part(path, "r", op),
            meta["k"], meta["cycle"])


def cg_solve_ir_resumable(op32, op_acc, b, *, max_iters=10000,
                          rel_error=1e-9, inner_floor=IR_INNER_FLOOR,
                          max_cycles=6, checkpoint_path=None, resume=False,
                          on_cycle=None, preconditioner=None):
    """Mixed-precision refinement with per-cycle checkpointing.

    cg_solve_ir's contract plus: after every refinement cycle the outer
    state persists to `checkpoint_path` and `on_cycle(x, r, k, cycle)`
    is called; `resume=True` continues from the checkpoint bit for bit.
    The floor of a per-cycle schedule is indexed by the restored cycle
    counter. The sidecar records the preconditioner, so a resume with
    another one is refused. Returns (CGResult, [(inner_iters,
    cycle_seconds), ...])."""
    if op32.operand is not op_acc.operand:
        raise ValueError(
            "cg_solve_ir requires the f32 operator to be a VIEW of the "
            "accurate operator (use op_acc.as_f32())")
    _check_preconditioner(preconditioner)
    inv32 = _inv_diag_f32(op_acc) if preconditioner == "jacobi" else None
    b_p = op_acc.prepare_b(b)
    dtype, dev = b_p.dtype, b_p.device
    if resume:
        if not checkpoint_path:
            raise ValueError("resume=True requires checkpoint_path")
        x, r, k, cycle = load_ir_state(checkpoint_path, op_acc,
                                       preconditioner)
    else:
        x, r, k, cycle = torch.zeros_like(b_p), b_p, 0, 0
    dot = op_acc.dot
    bb = dot(b_p, b_p)
    eps = torch.as_tensor(rel_error, dtype=dtype, device=dev)
    floors = _ir_floors(inner_floor, dtype, dev)

    cyc_times = []
    while (cycle < max_cycles and k < max_iters
           and bool(_ir_active(r, bb, eps, dot))):
        t0 = time.perf_counter()
        x, r, inner = _ir_cycle(
            op32.matvec_dot, op_acc.matvec_dot, b_p, bb, x, r,
            max_iters - k, eps, floors[min(cycle, floors.shape[0] - 1)],
            dot, inv32)
        inner = int(inner)  # waits for the cycle
        k += inner
        cycle += 1
        cyc_times.append((inner, time.perf_counter() - t0))
        if checkpoint_path:
            xg, rg = op_acc.to_global(x), op_acc.to_global(r)
            if _is_writer(op_acc):
                save_ir_state(checkpoint_path, xg, rg, k, cycle, op_acc.n,
                              preconditioner=preconditioner)
            _written(op_acc)
        if on_cycle is not None:
            on_cycle(x, r, k, cycle)

    rel = torch.sqrt(dot(r, r) / bb)
    result = CGResult(x=op_acc.extract_x(x),
                      num_iters=torch.as_tensor(k, device=dev),
                      rel_residual=rel, converged=rel < eps)
    return result, cyc_times
