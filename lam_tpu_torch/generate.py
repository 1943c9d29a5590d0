"""Problem generators, bit-identical to lam_tpu.generate.

Generate mode's system (the reference's fixture-free benchmark, `-s N`):
the dense tridiagonal with 2 on the diagonal and 1 beside it, and a
right-hand side of ones. On the host as numpy arrays
(`tridiagonal_rows`, `tridiagonal_matrix`, `tridiagonal_hi_plane`,
`ones_rhs`), and on a torch device as the f32 square
(`tridiagonal_hi_plane_device`), one packed walk-order plane
(`_tridiag_hi_packed_impl`, `_tridiag_q1_packed_impl`, over one device's
or one rank's walk tables), one rank's rows or block of the f32 square
(`_tridiag_block`: a row shard, the band-pair slab, a 2-D grid block) or
one rank's part of the band-pair diagonal (`_gen_diag_slab_rank`): plain
torch programs, not kernels (lam_tpu builds them with jax.jit, outside any
Pallas call, and lets out_shardings cut the global array into its shards;
here each rank writes only its own shard), which write only the nonzero
entries into zeros.

The reference's offline random-SPD-system tool: A = (Q sqrt(D)) (Q sqrt(D))^T
with eigenvalues D = exp(3.5 * U(-1, 1)) and a random U(-1, 1) rhs, plus
the O(k N^2) spectrum-exact Householder variant used for benchmark-scale
systems. The same seed gives the same bytes as lam_tpu.generate
(tests/test_torch_layout.py and tests/test_torch_gen.py hold them equal);
the port keeps its own copy because importing any lam_tpu module imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def tridiagonal_rows(row_start, num_rows, n, dtype=np.float64):
    """Dense row block of the generate-mode tridiagonal: entry (i, j) is 2
    if i == j, 1 if |i - j| == 1, else 0. In f64 the native library fills
    it where it is built (lam_tpu/generate.py:35-36), the same bytes."""
    if dtype == np.float64:
        from lam_tpu_torch import _native_io
        if _native_io.available():
            return _native_io.tridiagonal_rows(row_start, num_rows, n)
    block = np.zeros((num_rows, n), dtype=dtype)
    local = np.arange(num_rows)
    i = row_start + local
    block[local, i] = 2
    sub = i > 0
    block[local[sub], i[sub] - 1] = 1
    sup = i + 1 < n
    block[local[sup], i[sup] + 1] = 1
    return block


def tridiagonal_matrix(n, dtype=np.float64):
    """Full dense generate-mode tridiagonal matrix."""
    return tridiagonal_rows(0, n, n, dtype=dtype)


def tridiagonal_hi_plane(n, n_padded=None):
    """Zero-padded f32 square of the generate-mode tridiagonal: its
    entries {0, 1, 2} are exact in f32, so this is the hi plane of its
    df64 pair and the lo plane is zero."""
    n_padded = n_padded or n
    hi = np.zeros((n_padded, n_padded), dtype=np.float32)
    i = np.arange(n)
    hi[i, i] = 2
    hi[i[1:], i[1:] - 1] = 1
    hi[i[:-1], i[:-1] + 1] = 1
    return hi


def tridiagonal_hi_plane_device(n, n_padded=None, device="cuda"):
    """`tridiagonal_hi_plane` built on `device`: zeros, then the three
    diagonals written in place (no host matrix, no upload)."""
    n_padded = n_padded or n
    hi = torch.zeros((n_padded, n_padded), dtype=torch.float32,
                     device=device)
    i = torch.arange(n, device=device)
    hi[i, i] = 2
    hi[i[1:], i[1:] - 1] = 1
    hi[i[:-1], i[:-1] + 1] = 1
    return hi


def _tridiag_block(n, rows, c0, width, device):
    """The f32 (len(rows), width) block of the tridiagonal's padded square
    whose row k is original row rows[k] (a 1-D long tensor) and whose
    columns are [c0, c0 + width): lam_tpu's per-element
    `_tridiag_hi_device_impl` (lam_tpu/generate.py:88) and
    `_tridiag_hi_slab_impl` (:106) restricted to one rank's shard, written
    as the three bands into zeros, O(len(rows)) work (an index over a
    rank's whole (75k, 150k) shard would take 90 GB at N=150000). Rows
    and columns past n are padding (0)."""
    out = torch.zeros((rows.shape[0], width), dtype=torch.float32,
                      device=device)
    k = torch.arange(rows.shape[0], device=device)
    for off, val in ((0, 2.0), (-1, 1.0), (1, 1.0)):
        col = rows + off
        keep = ((rows < n) & (col >= 0) & (col < n) & (col >= c0)
                & (col < c0 + width))
        out[k[keep], col[keep] - c0] = val
    return out


def _slab_rows(g, m, c, device):
    """Original rows of rank c's band-pair slab, in slab order: band c,
    then band 2g-1-c (lam_tpu/parallel/pcg_symm.py's permutation)."""
    r = torch.arange(m, device=device)
    return torch.cat([c * m + r, (2 * g - 1 - c) * m + r])


def _gen_diag_slab_rank(n, g, m, c, device, value=2.0):
    """Rank c's (2m,) part of lam_tpu's slab-order diagonal
    `_gen_diag_slab_impl` (lam_tpu/generate.py:222): `value` at slab rows
    whose original row is < n, 0 on padding."""
    rows = _slab_rows(g, m, c, device)
    return torch.where(rows < n, value, 0.0).to(torch.float32)


def _tridiag_packed(n, tb, it, kt, nblk, diag, band):
    """The packed walk-order plane ((len(it)*tb, tb), walk position t =
    tile (it[t], kt[t]); it, kt int tensors on the plane's device) of the
    tridiagonal with `diag` on the diagonal and `band` beside it, in
    band's dtype. Only the two kinds of nonzero tile are written into
    zeros: the nblk diagonal tiles and the single top-right corner of the
    nblk - 1 tiles just below them (it == kt + 1), as lam_tpu's scatter
    does (lam_tpu/generate.py:137-145: the per-element form ran out of
    memory). Inert pad entries of padded tables (k > i) match neither."""
    out = torch.zeros((it.shape[0], tb, tb), dtype=band.dtype,
                      device=it.device)
    dpos = torch.nonzero(it == kt).flatten()
    r = torch.arange(tb, device=it.device)
    d = r[:, None] - r[None, :]
    tile = torch.where(d == 0, diag, torch.where(d.abs() == 1, band,
                                                 torch.zeros_like(band)))
    rows_in = (it[dpos, None] * tb + r[None, :]) < n      # (nblk, tb)
    out[dpos] = tile * (rows_in[:, :, None] & rows_in[:, None, :])
    if nblk > 1:
        cpos = torch.nonzero(it == kt + 1).flatten()
        ic = it[cpos]
        out[cpos, 0, tb - 1] = torch.where((ic * tb < n) & (ic > 0), band,
                                           torch.zeros_like(band))
    return out.reshape(-1, tb)


def _tridiag_hi_packed_impl(n, tb, it, kt, nblk):
    """f32 hi plane of the generate-mode tridiagonal in packed walk order
    (lam_tpu/generate.py:130), built on the device of it and kt."""
    one = torch.tensor(1.0, dtype=torch.float32, device=it.device)
    return _tridiag_packed(n, tb, it, kt, nblk, 2 * one, one)


# generate mode's fq quantization: the stored entries are {0, 1} (the
# diagonal extracted), and the smallest power of two >= 1/32767 is 2^-14,
# what quantize_fq_tiles picks for such a tile: the device-built q1 plane
# is exact (q in {0, 16384})
TRIDIAG_Q1_SCALE = 2.0 ** -14


def _tridiag_q1_packed_impl(n, tb, it, kt, nblk):
    """int16 q1 plane of the generate-mode tridiagonal in packed walk
    order with the diagonal extracted (the fq layout of from_gen_fq,
    lam_tpu/generate.py:185): the +-1 band quantized against
    TRIDIAG_Q1_SCALE, built on the device of it and kt."""
    qv = torch.tensor(round(1.0 / TRIDIAG_Q1_SCALE), dtype=torch.int16,
                      device=it.device)
    return _tridiag_packed(n, tb, it, kt, nblk, torch.zeros_like(qv), qv)


def ones_rhs(n, dtype=np.float64):
    """Generate mode's right-hand side: all ones."""
    return np.ones(n, dtype=dtype)


def random_eigenvalues(n, rng):
    """Reference eigenvalue law: exp(3.5 * U(-1, 1)) (condition number up
    to ~e^7)."""
    return np.exp(3.5 * rng.uniform(-1.0, 1.0, size=n))


def random_spd_matrix(n, seed=0, dtype=np.float64):
    """Random SPD matrix: Q orthogonal from the QR of a random U(-1,1)
    matrix, A = (Q sqrt(D)) (Q sqrt(D))^T. O(N^3): for N up to a few
    thousand; see random_spd_matrix_fast for benchmark-scale systems."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1.0, 1.0, size=(n, n))
    q, r = np.linalg.qr(m)
    # Fix the sign ambiguity so Q is Haar-distributed.
    q = q * np.sign(np.diagonal(r))
    d = random_eigenvalues(n, rng)
    qd = q * np.sqrt(d)
    a = qd @ qd.T
    return a.astype(dtype, copy=False)


def random_spd_matrix_fast(n, seed=0, num_reflectors=4, dtype=np.float64):
    """Random SPD matrix with the reference's exact spectrum in O(k N^2):
    A = H diag(D) H^T with H a product of `num_reflectors` Householder
    reflections. CG convergence depends only on the spectrum, so this
    reproduces the reference systems' ~320-360-iteration behavior at any
    N without the O(N^3) orthonormalization."""
    rng = np.random.default_rng(seed)
    d = random_eigenvalues(n, rng).astype(dtype)
    a = np.zeros((n, n), dtype=dtype)
    np.fill_diagonal(a, d)
    block = max(1, (1 << 25) // max(n, 1))  # ~256 MB row blocks
    for _ in range(num_reflectors):
        v = rng.standard_normal(n).astype(dtype)
        v /= np.linalg.norm(v)
        # A <- (I - 2 v v^T) A (I - 2 v v^T), applied in O(N^2),
        # row-blocked in place to avoid N^2-sized temporaries.
        w = a @ v
        for s in range(0, n, block):
            e = min(s + block, n)
            a[s:e] -= 2.0 * np.outer(w[s:e], v)
        w = v @ a
        for s in range(0, n, block):
            e = min(s + block, n)
            a[s:e] -= 2.0 * np.outer(v[s:e], w)
    # Symmetrize away rounding asymmetry, by block pairs, in place.
    for s in range(0, n, block):
        e = min(s + block, n)
        for s2 in range(s, n, block):
            e2 = min(s2 + block, n)
            avg = 0.5 * (a[s:e, s2:e2] + a[s2:e2, s:e].T)
            a[s:e, s2:e2] = avg
            a[s2:e2, s:e] = avg.T
    return a


def random_rhs(n, seed=0, dtype=np.float64):
    """Random U(-1, 1) rhs."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, size=n).astype(dtype)


def random_spd_system(n, seed=0, fast=None, dtype=np.float64):
    """(A, b) pair as produced by the reference tool. `fast=None` picks
    the O(k N^2) construction above N=4096."""
    if fast is None:
        fast = n > 4096
    gen = random_spd_matrix_fast if fast else random_spd_matrix
    return gen(n, seed=seed, dtype=dtype), random_rhs(n, seed=seed + 10,
                                                      dtype=dtype)
