"""Numpy float64 reference CG: the port's correctness oracle.

A copy of lam_tpu/solver/oracle.py:17-36 (the port imports no lam_tpu
module). It stays numpy on the host, so it is independent of every torch
path it checks.

Implements exactly the reference algorithm and stopping rule
(ConjugateGradient_CPU_OMP.hpp:50-91): update order, convergence test
before the p-update, iteration counting. Returns (x, iterations, relative
residual, converged).
"""

import numpy as np


def oracle_cg(a, b, max_iters=1000, rel_error=1e-9):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    x = np.zeros_like(b)
    r = b.copy()
    p = b.copy()
    bb = float(b @ b)
    rr = bb
    for k in range(1, max_iters + 1):
        ap = a @ p
        alpha = rr / float(p @ ap)
        x += alpha * p
        r -= alpha * ap
        rr_new = float(r @ r)
        beta = rr_new / rr
        rr = rr_new
        if np.sqrt(rr / bb) < rel_error:
            return x, k, float(np.sqrt(rr / bb)), True
        p = r + beta * p
    return x, max_iters, float(np.sqrt(rr / bb)), False
