"""The LAM challenge's random SPD system class, built in plain torch on the
device from a seed.

A = (Q sqrt(D)) (Q sqrt(D))^T = Q D Q^T with eigenvalues d = exp(scale *
U(-1, 1)) and Q a dense random orthogonal matrix: the Q factor of the QR
factorisation of an (n, n) standard normal matrix (Householder QR, which
orthonormalises the same columns the challenge's Gram-Schmidt does). A is
then averaged with its transpose, so that it is symmetric to the bit: the
lower triangle the solver stores and the full matrix this reference
multiplies by are one matrix. Right-hand sides are U(-1, 1).

The whole system comes from one torch.Generator on the device, seeded with
the run's seed, in a few large calls: the same seed gives the same bits.
"""

from __future__ import annotations

import torch

# rows of A a symmetrisation block holds: 4096 x 4096 f64 is 134 MB
_BLOCK = 4096


def generator(seed, device):
    """The run's random stream: one torch.Generator on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _symmetrize_(a):
    """a <- (a + a^T) / 2, by pairs of row blocks, in place."""
    n = a.shape[0]
    for s in range(0, n, _BLOCK):
        e = min(s + _BLOCK, n)
        for s2 in range(s, n, _BLOCK):
            e2 = min(s2 + _BLOCK, n)
            avg = (a[s:e, s2:e2] + a[s2:e2, s:e].T) * 0.5
            a[s:e, s2:e2] = avg
            a[s2:e2, s:e] = avg.T
    return a


def _on_device_solver(fn, *args):
    """fn(*args) with torch's CUDA linear algebra on cuSOLVER, which runs
    on the device alone, so that one seed gives one set of bits (MAGMA,
    which torch may pick instead, factors its panels on the host)."""
    if args[0].device.type != "cuda":
        return fn(*args)
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return fn(*args)
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


def make_matrix(cfg, gen):
    """The (n, n) f64 system matrix of configuration `cfg` on the
    generator's device: the eigenvalues first, then the normal matrix
    whose Q factor is the similarity, drawn from `gen` in that order.
    Holds two (n, n) f64 matrices at a time."""
    n = int(cfg["n"])
    dev = gen.device
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=dev)
    d = torch.exp(cfg["eigenvalue_scale"] * (2.0 * u - 1.0))
    g = torch.randn((n, n), generator=gen, dtype=torch.float64, device=dev)
    h, tau = _on_device_solver(torch.geqrf, g)
    del g
    q = _on_device_solver(torch.linalg.householder_product, h, tau)
    del h
    q.mul_(torch.sqrt(d))           # the columns of Q sqrt(D)
    a = q @ q.T
    del q
    return _symmetrize_(a)


def make_rhs_pool(cfg, count, gen):
    """`count` right-hand sides U(-1, 1), as a (count, n) host f64 array,
    drawn from `gen` after the matrix."""
    n = int(cfg["n"])
    b = torch.rand((count, n), generator=gen, dtype=torch.float64,
                   device=gen.device)
    return (2.0 * b - 1.0).cpu().numpy()
