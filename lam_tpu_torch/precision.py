"""Float-float ("df64") building blocks on torch tensors.

The port of lam_tpu/precision.py. A df64 value is an unevaluated sum of
two float32s, value = hi + lo with hi = fl32(value): two f32 planes are
exactly the 8 bytes/element of f64. The port keeps the pair as its
storage format, so the packed (hi, lo) planes are the JAX package's
bytes, but the H100 kernel forms hi + lo in native f64 instead of
running the error-free transforms below (see csrc/gemv_symm.cu). The
transforms are kept for parity with the JAX package; they assume IEEE
round-to-nearest f32 adds and multiplies with no FMA contraction, which
PyTorch's eager elementwise ops provide.

`split_f64_host` is the host split of lam_tpu/solver/operators.py:124-134:
the native library's threaded split where it is built, else numpy's, the
same bits.
"""

from __future__ import annotations

import numpy as np
import torch

# Dekker splitter for f32: 2^12 + 1 (f32 has 24 mantissa bits -> split 12/12).
_SPLIT32 = 4097.0


def split_f64(x):
    """Split an f64 tensor into a (hi, lo) pair of f32 tensors, x == hi + lo."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(x.dtype)).to(torch.float32)
    return hi, lo


def join_f64(hi, lo):
    """Recombine a (hi, lo) f32 pair into f64."""
    return hi.to(torch.float64) + lo.to(torch.float64)


def two_sum(a, b):
    """Knuth's branch-free exact addition: a + b == s + e exactly."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def fast_two_sum(a, b):
    """Dekker's exact addition, valid when |a| >= |b|: a + b == s + e."""
    s = a + b
    e = b - (s - a)
    return s, e


def split32(a):
    """Dekker split of an f32 value into high/low 12-bit-mantissa halves."""
    c = _SPLIT32 * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Exact f32 multiplication: a * b == p + e exactly (Dekker/Veltkamp)."""
    p = a * b
    ah, al = split32(a)
    bh, bl = split32(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(x, y):
    """Double-float addition: (xh,xl) + (yh,yl) -> (zh,zl)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return fast_two_sum(s, e)


def df_mul(x, y):
    """Double-float multiplication: (xh,xl) * (yh,yl) -> (zh,zl)."""
    xh, xl = x
    yh, yl = y
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return fast_two_sum(p, e)


def df_neg(x):
    return (-x[0], -x[1])


def split_f64_host(a):
    """Host-side f64 -> (hi, lo) f32 split of a numpy array: threaded C++
    where the native library is built, else numpy."""
    from lam_tpu_torch import _native_io
    if _native_io.available():
        return _native_io.split_f64(a)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo
