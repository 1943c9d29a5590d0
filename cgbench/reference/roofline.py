"""Operations, bytes and the least time of one symmetric matvec, worked out
from n and the storage a traffic file states, never from the solver's
buffers: the number reads the same work whatever kernel does it.

A traffic file's "matvec" describes the operator its CG loop iterates on:
  element_bytes   bytes an element of the stored lower triangle
  diagonal_bytes  0 where the diagonal lies in the triangle; else the
                  bytes an element of the diagonal kept apart (the f32
                  pair of the quantized storages: 8, its hi part: 4), the
                  triangle then being the strictly lower one
  vector_bytes    bytes an element of the vector read and of the one
                  written
  peak            the arithmetic the products run in (a key of PEAK_FLOPS)

Each input byte is counted once and the output once, whatever a kernel
reads again. The operations are 2 n^2: one multiply and one add for each
element of the full symmetric matrix.
"""

from __future__ import annotations

# published rates of one NVIDIA H100 SXM (dense, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12, "bf16": 989e12}


def matvec_bytes(n, mv):
    """Bytes one matvec has to move at least."""
    if mv["diagonal_bytes"]:
        tri = n * (n - 1) // 2
        diag = n * mv["diagonal_bytes"]
    else:
        tri, diag = n * (n + 1) // 2, 0
    return tri * mv["element_bytes"] + diag + 2 * n * mv["vector_bytes"]


def matvec_flops(n):
    return 2 * n * n


def matvec_bound_s(n, mv):
    """The least time of one matvec: the larger of its bytes at the HBM
    rate and its operations at the peak of its arithmetic."""
    return max(matvec_bytes(n, mv) / HBM_BYTES_PER_S,
               matvec_flops(n) / PEAK_FLOPS[mv["peak"]])
