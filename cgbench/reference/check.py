"""The comparison that decides a run's `correct`.

Every solve the run timed is judged after the window, against the
benchmark's own f64 matrix and right-hand sides (never the solver's packed
planes):

  true_rel_residual  the largest |b - A x| / |b| over the solves, in f64;
                     its limit is the configuration's stated guarantee
  unconverged        solves the solver reported as not converged; limit 0

A solve fails when it is unconverged or over the residual limit. The
counted iterations are not compared: the control (control.py) counts as
many as the plain f64 CG does, so no limit on them could separate it from
a sound run.
"""

from __future__ import annotations

import torch

from cgbench.reference.cg import exact_matmul

# columns of X a residual product takes at once
_COLS = 64


def true_rel_residuals(a, rhs, xs):
    """|b - A x| / |b| in f64 for each pair of rhs[i] (host array) and
    xs[i] (a tensor of length n), in blocks of columns; a non-finite
    residual reads as inf."""
    exact_matmul()
    out = []
    for s in range(0, len(xs), _COLS):
        x = torch.stack([v.to(a.device, torch.float64)
                         for v in xs[s:s + _COLS]], dim=1)
        b = torch.as_tensor(rhs[s:s + _COLS], dtype=torch.float64,
                            device=a.device).T
        rel = (torch.linalg.vector_norm(b - a @ x, dim=0)
               / torch.linalg.vector_norm(b, dim=0))
        out.append(torch.nan_to_num(rel, nan=float("inf")).cpu())
    return torch.cat(out).tolist()


def judge(a, pool, solves, cfg):
    """(checks, failed): checks maps each compared number's name to
    (value, limit); failed counts the solves that broke a limit.

    a: the (n, n) f64 matrix on the device the check runs on. pool: the
    (count, n) host rhs pool. solves: (rhs index, x, converged) per timed
    solve."""
    res_limit = float(cfg["true_rel_residual_limit"])
    rel = true_rel_residuals(a, pool[[s[0] for s in solves]],
                             [s[1] for s in solves])
    failed = sum(not s[2] or not r <= res_limit
                 for s, r in zip(solves, rel))
    checks = {
        "true_rel_residual": (max(rel), res_limit),
        "unconverged": (sum(not s[2] for s in solves), 0),
    }
    return checks, failed


def correct(checks):
    """Every compared number within its limit (NaN is not)."""
    return all(value <= limit for value, limit in checks.values())
