"""Plain conjugate gradients in torch: the reference the solver's answers
and iteration counts are judged by, and, in float32, the control that
stands in the solver's place.

The recurrence and stopping rule are the challenge's: from x = 0, r = p =
b; alpha = rr / p.Ap; x += alpha p; r -= alpha Ap; beta = rr_new / rr; p
= r + beta p; stop once sqrt(rr / bb) < rel_error or after max_iters
iterations. Each column of `b` is its own recurrence: a column that has
converged freezes, and its count is the iterations it completed.
"""

from __future__ import annotations

import torch


def exact_matmul():
    """Switch off TF32, so that a float32 product is a float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def cg(a, b, rel_error, max_iters):
    """CG on each column of b (n, k) against a (n, n), in a's dtype.
    Returns (x (n, k), iterations (k,) int64, converged (k,) bool), all on
    a's device."""
    exact_matmul()
    b = b.to(a.dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    bb = (b * b).sum(0)
    rr = bb.clone()
    k = torch.zeros(b.shape[1], dtype=torch.int64, device=b.device)
    eps = torch.as_tensor(rel_error, dtype=a.dtype, device=a.device)

    def active():
        return (torch.sqrt(rr / bb) >= eps) & (k < max_iters)

    go = active()
    while bool(go.any()):
        ap = a @ p
        alpha = torch.where(go, rr / (p * ap).sum(0), 0.0)
        x += alpha * p
        r -= alpha * ap
        rr_new = (r * r).sum(0)
        p = torch.where(go, r + (rr_new / rr) * p, p)
        rr = torch.where(go, rr_new, rr)
        k += go
        go = active()
    return x, k, torch.sqrt(rr / bb) < eps
