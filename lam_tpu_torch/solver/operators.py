"""Linear operators: storage precision, padding and matvec kernel.

The one-device subset of lam_tpu/solver/operators.py. A `DenseOperator`
holds a matrix on one device and computes A @ p for the CG loop
(lam_tpu_torch/solver/cg.py). With the packed engine
('pallas_symm_packed', the default for a symmetric matrix) it stores
the lower triangle of a symmetric matrix as walk-order tiles:

  'df64' packed lower-triangle (hi, lo) f32 planes, matvec by the df64
         symmetric kernel; vectors are f64. The f64-parity main path.
  'f32'  packed lower-triangle f32 plane, matvec by the f32 symmetric
         kernel; vectors are f32. `as_f32()` of a df64 operator is the
         same matvec on the df64 operator's own hi plane: the inner
         engine of the mixed-precision solver.
  'dfq'  quantized-lo packed storage: the f32 hi plane plus the lo plane
         as int16 tiles against per-tile power-of-two scales (6 B per
         stored element, ~2^-39 tile-relative) plus the diagonal as an
         exact (dh, dl) f32 pair, zeroed in the planes. Matvec by the dfq
         symmetric kernel plus the diagonal term, in f64. `as_f32()` is
         the f32 symmetric kernel on the hi plane plus dh * p: the inner
         engine of 'irq'.
  'fq'   fully-quantized packed storage: three int16 planes against
         per-tile power-of-two scales (6 B per stored element, ~2^-48
         tile-relative) plus the diagonal as an exact (dh, dl) f32 pair,
         zeroed in the planes. Matvec by the fq symmetric kernel plus
         the diagonal term, in f64. `as_f32()` is the q16 kernel on the
         q1 plane alone (2 B per element) plus dh * p in f32: the inner
         engine of 'irfq'.

Engine 'xla' (lam_tpu's oracle engine; what precision 'f64' forces)
stores the unpadded square and multiplies by a plain torch product, not
a kernel: 'f64' the f64 square, 'f32' the f32 square, 'df64' the (hi, lo)
f32 squares cast to f64 at every matvec, as lam_tpu's XLA does.
precision='auto' is df64 on a card and f64 on the CPU (lam_tpu's rule,
the card in the TPU's place).

The full-square engine ('pallas', the only one for a matrix that is not
symmetric, and what engine='auto' picks for one) stores the whole
square: 'f32' as one f32 square, matvec by the dense f32 kernel; 'df64'
as (hi, lo) f32 squares, matvec by the dense df64 kernel, whose
`as_f32()` is the dense f32 kernel on the hi square. The full-square
symmetric engine ('pallas_symm', f32 and df64) stores the same squares
and reads only their lower-triangle tiles, in place (the square walk of
the symmetric kernels): half the bytes of a dense matvec, no capacity
saved.

Generate mode's operators (lam_tpu_torch/solver/api.py) are built on the
device from packed planes: `from_packed_f32`, `from_packed_planes` with
the lo plane as one broadcast (tb, tb) zero tile, `from_gen_fq` with q2
and q3 as one zero tile each, and `from_df64_planes` over squares. An
fq operator whose q2 and q3 tiles hold only zeros, counted once when it is
built (`zero_tiles_of`), never at a matvec, multiplies by the kernel that
reads q1 alone (`gemv.gemv_fq_symm_zero`).

A `MatrixFreeOperator` applies a function instead of a stored matrix
(the heat demo's 5-point Laplacian, lam_tpu_torch/apps/heat.py), and an
operator may take a fused `matvec_dot_fn` whose kernel returns p . A p
from the same pass.

Padding: the matrix and vectors are zero-padded once, at construction,
to the tile grid. Zero padding is exact for CG: padded entries of every
vector stay 0 and no dot product changes.

File mode (`from_file_*`) takes its buffers from the cheapest source, in
lam_tpu's order (lam_tpu/solver/operators.py:970-1018): the pack cache
beside the file, streamed to the device as it is read
(`pack_cache.load_device`); for fq, the native range pack on a worker
thread while the main thread uploads each finished window of the planes
(`_pack_fq_streamed`); the fused native pack (`_native_io.pack_*`); the
streaming numpy pack over a memory map. `from_file_fq_q1` uploads only
the q1 plane, its scales and the diagonal pair: the inner engine of the
host outer loop (solver/host_outer.py), whose accurate matvec refuses.

Every constructor takes an explicit `device`. Asking for CUDA where
there is none raises; nothing falls back to the CPU. The constructors of
pre-built buffers take host arrays or tensors; a tensor already on the
device is used as it is, not copied. Host arrays go to the device
through pinned staging memory (ops/transfer.py).
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from lam_tpu_torch import _native_io
from lam_tpu_torch import io as lio
from lam_tpu_torch.ops import gemv, layout, transfer
from lam_tpu_torch.ops.layout import PAD_MULTIPLE, padded_size  # noqa: F401
from lam_tpu_torch.precision import join_f64, split_f64, split_f64_host
from lam_tpu_torch.solver import pack_cache as pc

ENGINE = "pallas_symm_packed"  # lam_tpu's name for the packed layout
DENSE_ENGINE = "pallas"        # lam_tpu's name for the full-square engine
SQUARE_ENGINE = "pallas_symm"  # the full square, lower triangle read
XLA_ENGINE = "xla"             # the plain torch products: the oracle path
ENGINES = ("auto", ENGINE, DENSE_ENGINE, SQUARE_ENGINE, XLA_ENGINE)

# tiles a call of the cold fq pipeline's range pack fills: fine enough that
# uploads start early, coarse enough that a call's overhead vanishes
PACK_CHUNK_TILES = 512

# quantized-storage layouts: storage -> (per-plane dtypes, n_scales).
# Operand order is (planes..., scales..., dh, dl).
QUANT_LAYOUT = {
    "dfq": ((np.float32, np.int16), 1),
    "fq": ((np.int16, np.int16, np.int16), 3),
}


def resolve_device(device):
    """torch.device for `device`; raises when CUDA is asked for and
    absent (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev


def vdot(a, b):
    """Dot product of two real vectors (PyTorch's own reduction)."""
    return torch.sum(a * b)


# a host array as a new tensor on dev (through pinned staging memory when
# it is large); a tensor moved there, kept as it is when it is there already
_upload = transfer.to_device


_TORCH_DTYPE = {np.float32: torch.float32, np.int16: torch.int16}


def _buffer(x, dtype):
    """A pre-built buffer of numpy dtype `dtype`: a host array as numpy,
    a tensor as a tensor of that dtype where it is."""
    if isinstance(x, torch.Tensor):
        return x.to(_TORCH_DTYPE[dtype])
    return np.asarray(x, dtype)


def _verifies_symmetric(a, tol=1e-12):
    """Whole-matrix symmetry check via two random matvecs: A v vs A^T v.

    ||Av - A^T v|| <= tol * (||Av|| + ||A^T v||) catches any asymmetry
    with probability 1 over the random v, at the cost of two streaming
    passes over A on the host."""
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n)
    av = a @ v
    atv = v @ a
    scale = np.linalg.norm(av) + np.linalg.norm(atv)
    return bool(np.linalg.norm(av - atv) <= tol * max(scale, 1e-300))


def _host_pack_planes(a, precision, tb):
    """Streaming host pack of a symmetric f64 matrix (`a` may be a
    np.memmap) into the packed-triangle f32 plane(s): 'f32' (one plane)
    or 'df64' (hi, lo pair), zero-padded to a multiple of tb. Peak host
    memory is the plane(s) plus one (tb, i*tb) row block. Bit-identical
    to lam_tpu's `DenseOperator._host_pack_planes`."""
    n = a.shape[0]
    n_p = layout.padded_size(n, tb)
    nblk = n_p // tb
    T = layout.tri_tile_count(nblk)
    hi = np.empty((T * tb, tb), np.float32)
    lo = (np.empty((T * tb, tb), np.float32)
          if precision == "df64" else None)
    t = 0
    for i in range(nblk):
        r0, r1 = i * tb, min((i + 1) * tb, n)
        width = (i + 1) * tb
        cw = min(width, n)
        blk = np.zeros((tb, width), np.float64)
        if r1 > r0:
            blk[:r1 - r0, :cw] = a[r0:r1, :cw]
        bh = blk.astype(np.float32)
        bl = ((blk - bh.astype(np.float64)).astype(np.float32)
              if lo is not None else None)
        for k in range(i + 1):
            sl = slice(t * tb, (t + 1) * tb)
            hi[sl] = bh[:, k * tb:(k + 1) * tb]
            if lo is not None:
                lo[sl] = bl[:, k * tb:(k + 1) * tb]
            t += 1
    return (hi,) if lo is None else (hi, lo)


def quantize_storage_tiles(storage, buf, tb):
    """The quantized planes and per-tile scales of a (k*tb, tb) walk-order
    f64 buffer whose diagonal is already extracted and zeroed: 'dfq' ->
    (hi, loq, sc); 'fq' -> (q1, q2, q3, s1, s2, s3)."""
    if storage == "dfq":
        hi, lo = split_f64_host(buf)
        return (hi, *layout.quantize_lo_tiles(lo, tb))
    if storage != "fq":
        raise ValueError(f"unknown quantized storage {storage!r}")
    return layout.quantize_fq_tiles(buf, tb)


def _host_pack_tri(a, storage, tb):
    """Streaming host pack of a symmetric f64 matrix (`a` may be a
    np.memmap) into the quantized packed-triangle buffers, in operand
    order: 'dfq' (hi, loq, sc, dh, dl), 'fq' (q1, q2, q3, s1, s2, s3,
    dh, dl). The diagonal is extracted as an exact (dh, dl) f32 pair and
    zeroed before quantization. The fq planes are padded to
    padded_tri_tile_count tiles with zero pad tiles and zero pad scales;
    the dfq planes hold exactly the T triangle tiles. Peak host memory is
    the buffers plus one (tb, i*tb) row block. Bit-identical to
    lam_tpu's `DenseOperator._host_pack_tri` (its numpy path)."""
    if storage not in QUANT_LAYOUT:
        raise ValueError(f"unknown quantized storage {storage!r}")
    n = a.shape[0]
    n_p = layout.padded_size(n, tb)
    nblk = n_p // tb
    Ts = (layout.padded_tri_tile_count(nblk) if storage == "fq"
          else layout.tri_tile_count(nblk))
    dtypes, n_scales = QUANT_LAYOUT[storage]
    planes = [np.zeros((Ts * tb, tb), dt) for dt in dtypes]
    scales = [np.zeros((Ts,), np.float32) for _ in range(n_scales)]
    dh = np.zeros((n_p,), np.float32)
    dl = np.zeros((n_p,), np.float32)
    t = 0
    for i in range(nblk):
        r0, r1 = i * tb, min((i + 1) * tb, n)
        width = (i + 1) * tb
        cw = min(width, n)
        blk = np.zeros((tb, width), np.float64)
        if r1 > r0:
            blk[:r1 - r0, :cw] = a[r0:r1, :cw]
            rr = np.arange(r1 - r0)
            dvals = blk[rr, r0 + rr].copy()
            dhi = dvals.astype(np.float32)
            dh[r0:r1] = dhi
            dl[r0:r1] = (dvals - dhi.astype(np.float64)).astype(np.float32)
            blk[rr, r0 + rr] = 0.0
        for k in range(i + 1):
            out = quantize_storage_tiles(storage,
                                         blk[:, k * tb:(k + 1) * tb], tb)
            for plane, val in zip(planes, out[:len(planes)]):
                plane[t * tb:(t + 1) * tb] = val
            for sc, val in zip(scales, out[len(planes):]):
                sc[t] = val[0]
            t += 1
    return (*planes, *scales, dh, dl)


def _file_pack(path, a, precision, n_p, tb):
    """The host buffers of a matrix file's pack (`a` its memory map): the
    fused native pack where the library is built, else numpy's, the same
    bytes."""
    if _native_io.has_pack(precision):
        return getattr(_native_io, f"pack_{precision}")(
            path, a.offset, a.shape[0], n_p, tb)
    if precision in QUANT_LAYOUT:
        return _host_pack_tri(a, precision, tb)
    return _host_pack_planes(a, precision, tb)


# matvec implementations: fn(operand, p) -> A @ p

def _no_accurate_matvec(operand, p):
    # the q1-only operator (from_file_fq_q1): lam_tpu's words
    raise NotImplementedError(
        "q1-only fq operator: the accurate cascade matvec is unavailable "
        "(q2/q3 were never loaded). Use .as_f32() as the inner engine of "
        "solver/host_outer.cg_solve_ir_host, or load the full operator "
        "with DenseOperator.from_file_fq")


# engine 'xla' (lam_tpu/solver/operators.py:163-174, :294-302): plain
# torch products, a vector or an (n, k) block alike

def _mv_xla(a, p):
    # the f64 or f32 square, or a rank's rows or block of it
    return a @ p


def _mv_df64_xla(operand, p):
    # both planes cast to p's f64 at every call, as lam_tpu's XLA does
    hi, lo = operand
    return hi.to(p.dtype) @ p + lo.to(p.dtype) @ p


def _mv_f32_of_df64_xla(operand, p):
    return operand[0] @ p


def _mv_f32_of_f64_xla(a32):
    """The f32 view of an f64 square: `a32`, the square cast to f32 ONCE
    per operator (DenseOperator.as_f32 keeps it), as lam_tpu's XLA hoists
    the loop-invariant cast out of its loop, not once a matvec."""
    def mv(_operand, p):
        return a32 @ p

    return mv


# block matvecs of the packed triangle (lam_tpu/solver/operators.py:
# 426-501): plain torch products in the block's dtype (f64 for df64, dfq
# and fq), the index_add_ of the walk tables in place of segment_sum

def _packed_block_walk(buf_hi, buf_lo, p_block):
    """(n, k) block matvec over a walk-order packed triangle buffer:
    direct terms added by row tile, transpose terms (off the diagonal
    only, kt < it) by column tile. A (tb, tb) lo buffer is one broadcast
    tile added to every tile; planes padded past the triangle (fq) are
    cut to its tiles."""
    tb = buf_hi.shape[1]
    T = buf_hi.shape[0] // tb
    n, k = p_block.shape
    nblk = n // tb
    dt, dev = p_block.dtype, p_block.device
    it, kt = (torch.as_tensor(t, dtype=torch.long, device=dev)
              for t in layout._symm_tables(nblk))
    tiles = buf_hi.reshape(T, tb, tb)[:len(it)].to(dt)
    if buf_lo is not None:
        if buf_lo.shape[0] == tb:
            tiles = tiles + buf_lo.to(dt)[None]
        else:
            tiles = tiles + buf_lo.reshape(T, tb, tb)[:len(it)].to(dt)
    pb = p_block.reshape(nblk, tb, k)
    y = torch.zeros((nblk, tb, k), dtype=dt, device=dev)
    y.index_add_(0, it, torch.einsum("tij,tjk->tik", tiles, pb[kt]))
    trans = torch.einsum("tij,tik->tjk", tiles, pb[it])
    trans = trans * (kt < it)[:, None, None]
    y.index_add_(0, kt, trans)
    return y.reshape(n, k)


def _mv_block_packed_f32(a, p):
    return _packed_block_walk(a, None, p)


def _mv_block_packed_df64(operand, p):
    return _packed_block_walk(operand[0], operand[1], p)


def _diag_term(dh, dl, p):
    return (dh.to(p.dtype) + dl.to(p.dtype))[:, None] * p


def _mv_block_packed_dfq(operand, p):
    hi, loq, sc, dh, dl = operand
    tb = hi.shape[1]
    T = hi.shape[0] // tb
    lo = (loq.reshape(T, tb, tb).to(torch.float32)
          * sc[:, None, None]).reshape(T * tb, tb)
    return _packed_block_walk(hi, lo, p) + _diag_term(dh, dl, p)


def _mv_block_packed_fq(operand, p):
    # the planes summed in p's f64 (an f32 sum would round q2 and q3
    # away); a (tb, tb) plane is one broadcast zero tile: skipped
    q1, q2, q3, s1, s2, s3, dh, dl = operand
    tb = q1.shape[1]
    T = q1.shape[0] // tb
    rec = sum((q.reshape(T, tb, tb).to(p.dtype)
               * s.to(p.dtype)[:, None, None]).reshape(T * tb, tb)
              for q, s in ((q1, s1), (q2, s2), (q3, s3))
              if q.shape == q1.shape)
    return _packed_block_walk(rec, None, p) + _diag_term(dh, dl, p)


_MV_BLOCK_PACKED = {
    "f32": _mv_block_packed_f32,
    "df64": _mv_block_packed_df64,
    "dfq": _mv_block_packed_dfq,
    "fq": _mv_block_packed_fq,
}
# the block matvec of a square (engine 'xla', 'pallas', 'pallas_symm')
_MV_BLOCK_SQUARE = {"f64": _mv_xla, "f32": _mv_xla, "df64": _mv_df64_xla}


# the symmetric kernels route by the operand's shape: the packed
# triangle, the full square (the square walk) or a broadcast lo tile

def _mv_f32_symm(a, p):
    return gemv.gemv_f32_symm(a, p)


def _mv_df64_symm(operand, p):
    hi, lo = operand
    ph, pl = split_f64(p)
    yh, yl = gemv.gemv_df64_symm(hi, lo, ph, pl)
    return join_f64(yh, yl)


def _mv_f32_of_df64_symm(operand, p):
    # the hi plane of a symmetric matrix's df64 pair is symmetric too
    return gemv.gemv_f32_symm(operand[0], p)


def _mv_dfq_packed(operand, p):
    # the planes carry a zero diagonal: add (dh + dl) * p in f64
    hi, loq, sc, dh, dl = operand
    ph, pl = split_f64(p)
    yh, yl = gemv.gemv_dfq_symm(hi, loq, sc, ph, pl)
    return join_f64(yh, yl) + join_f64(dh, dl) * p


def _mv_f32_of_dfq_packed(operand, p):
    # inner view: the f32 triangle kernel on the hi plane plus the f32
    # diagonal term the planes no longer carry
    return gemv.gemv_f32_symm(operand[0], p) + operand[3] * p


def _mv_fq_packed(operand, p):
    # the planes carry a zero diagonal: add (dh + dl) * p in f64
    q1, q2, q3, s1, s2, s3, dh, dl = operand
    ph, pl = split_f64(p)
    yh, yl = gemv.gemv_fq_symm(q1, q2, q3, s1, s2, s3, ph, pl)
    return join_f64(yh, yl) + join_f64(dh, dl) * p


def _mv_fq_zero(operand, p):
    # q2 and q3 are tiles of zeros: q1 alone, then the diagonal term
    q1, _, _, s1, _, _, dh, dl = operand
    ph, pl = split_f64(p)
    yh, yl = gemv.gemv_fq_symm_zero(q1, s1, ph, pl)
    return join_f64(yh, yl) + join_f64(dh, dl) * p


def _mv_f32_of_fq_packed(operand, p):
    # inner view: the 2-byte q1 plane plus the f32 diagonal term
    return gemv.gemv_q16_symm(operand[0], operand[3], p) + operand[6] * p


def _mv_f32_pallas(a, p):
    return gemv.gemv_f32(a, p)


def _mv_df64_pallas(operand, p):
    hi, lo = operand
    ph, pl = split_f64(p)
    yh, yl = gemv.gemv_df64(hi, lo, ph, pl)
    return join_f64(yh, yl)


def _mv_f32_of_df64_pallas(operand, p):
    return gemv.gemv_f32(operand[0], p)


# accurate packed matvec of each quantized storage, and the f32 inner
# view over each (precision, engine) operand
_MV_QUANT = {"dfq": _mv_dfq_packed, "fq": _mv_fq_packed}
_MV_F32_OF = {
    ("df64", ENGINE): _mv_f32_of_df64_symm,
    ("dfq", ENGINE): _mv_f32_of_dfq_packed,
    ("fq", ENGINE): _mv_f32_of_fq_packed,
    ("df64", DENSE_ENGINE): _mv_f32_of_df64_pallas,
    ("df64", SQUARE_ENGINE): _mv_f32_of_df64_symm,
    ("df64", XLA_ENGINE): _mv_f32_of_df64_xla,
}


class LinearOperator:
    """Anything with a matvec usable by the CG loop.

    `matvec_fn(operand, p) -> A p`; or, for a kernel that takes the dot
    in the same pass (lam_tpu's base takes only this form,
    lam_tpu/solver/operators.py:521), `matvec_dot_fn(operand, p) ->
    (A p, p . A p)`. Either may be None, not both. `dot` is the
    reduction of the operator's vectors: vdot here, the mesh's
    all-reduced dot for vectors split across ranks."""

    dot = staticmethod(vdot)
    # block matvec fn(operand, P) -> A P on (n_p, k) blocks, where the
    # storage has one (lam_tpu's `_mv_block`); None: run_cg_block raises
    _mv_block = None

    def __init__(self, matvec_fn, operand, n, n_padded, vector_dtype,
                 device, matvec_dot_fn=None):
        if matvec_fn is None and matvec_dot_fn is None:
            raise ValueError("a LinearOperator needs matvec_fn or "
                             "matvec_dot_fn")
        self._matvec_fn = matvec_fn
        self._matvec_dot_fn = matvec_dot_fn
        self.operand = operand
        self.n = n
        self.n_padded = n_padded
        self.vector_dtype = vector_dtype
        self.device = device

    def matvec(self, p_padded):
        if self._matvec_fn is None:
            return self._matvec_dot_fn(self.operand, p_padded)[0]
        return self._matvec_fn(self.operand, p_padded)

    def matvec_dot(self, p_padded):
        """(A p, p . A p): the CG loop's matvec step."""
        if self._matvec_dot_fn is not None:
            return self._matvec_dot_fn(self.operand, p_padded)
        ap = self._matvec_fn(self.operand, p_padded)
        return ap, self.dot(p_padded, ap)

    def prepare_b(self, b):
        """Unpadded host/device vector -> padded vector on the device."""
        b = torch.as_tensor(b, dtype=self.vector_dtype, device=self.device)
        if b.shape != (self.n,):
            raise ValueError(f"rhs has shape {tuple(b.shape)}, expected "
                             f"({self.n},)")
        if self.n_padded != self.n:
            b = torch.nn.functional.pad(b, (0, self.n_padded - self.n))
        return b

    def extract_x(self, x_padded):
        return x_padded[: self.n]

    def to_global(self, v):
        """The whole padded vector of this operator's vector `v`, in
        lam_tpu's order, on every rank: a checkpoint's vector. A
        collective on a mesh whose vectors are split; here v itself."""
        return v

    def from_global(self, v_padded):
        """This rank's part of a whole padded vector (or (n_p, k) block),
        on the device in the vector dtype: the inverse of to_global."""
        return torch.as_tensor(v_padded, dtype=self.vector_dtype).to(
            self.device)

    def prepare_b_block(self, b_block):
        """(n, k) block of right-hand sides -> this rank's part of the
        padded block on the device (lam_tpu/solver/operators.py:
        567-575)."""
        b = torch.as_tensor(b_block, dtype=self.vector_dtype)
        if b.ndim != 2 or b.shape[0] != self.n:
            raise ValueError(f"rhs block must be ({self.n}, k), "
                             f"got {tuple(b.shape)}")
        b = torch.nn.functional.pad(b, (0, 0, 0, self.n_padded - self.n))
        return self.from_global(b)

    def run_cg_block(self, b_block_padded, max_iters, rel_error):
        from lam_tpu_torch.solver.cg import _cg_block_loop
        mv = self._mv_block
        if mv is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no block matvec")
        return _cg_block_loop(lambda p: mv(self.operand, p), b_block_padded,
                              max_iters, rel_error, self.dot)

    def matvec_chain(self, p_padded, repeats):
        """`repeats` back-to-back matvecs, normalized each step to stay
        bounded: for timing the matvec."""
        v = p_padded
        for _ in range(repeats):
            w = self.matvec(v)
            v = w / torch.sqrt(self.dot(w, w))
        return v

    def run_cg(self, loop_fn, b_padded, max_iters, rel_error):
        return loop_fn(self.matvec_dot, b_padded, max_iters, rel_error,
                       self.dot)

    def run_cg_ir(self, op32, b_padded, max_iters, rel_error, max_cycles,
                  inner_floor, inv_diag32=None):
        from lam_tpu_torch.solver.cg import _cg_ir_loop
        if op32.operand is not self.operand:
            raise ValueError(
                "cg_solve_ir requires the f32 operator to be a VIEW of "
                "the accurate operator (use op_acc.as_f32()); separate "
                "buffers would double the matrix footprint on the device")
        return _cg_ir_loop(op32.matvec_dot, self.matvec_dot, b_padded,
                           max_iters, rel_error, max_cycles, inner_floor,
                           self.dot, inv_diag32)

    def diagonal(self):
        """The matrix diagonal in the vector dtype, split like the
        vectors (for preconditioning). Operators that cannot provide one
        raise, as lam_tpu's base does."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a diagonal")

    def run_pcg(self, b_padded, max_iters, rel_error):
        """Jacobi-preconditioned CG (lam_tpu/solver/operators.py:594-601):
        the padding's d == 0 takes an inverse of 1, never inf."""
        from lam_tpu_torch.solver.cg import _inv_diag, _pcg_loop
        return _pcg_loop(self.matvec_dot, b_padded, _inv_diag(self),
                         max_iters, rel_error, self.dot)


class MatrixFreeOperator(LinearOperator):
    """Operator from an arbitrary matvec function (e.g. a stencil), as
    lam_tpu's (lam_tpu/solver/operators.py:604-616): the heat demo's f64
    5-point Laplacian, with no matrix stored and no padding."""

    def __init__(self, matvec_fn, operand, n, vector_dtype=torch.float64,
                 device="cuda"):
        super().__init__(matvec_fn, operand, n, n, vector_dtype,
                         resolve_device(device))


def _packed_diagonal(buf, nblk):
    """The diagonal of a walk-order packed triangle buffer of nblk row
    tiles (lam_tpu/solver/operators.py:403-425): row tile i's diagonal
    tile sits at walk position i(i+1)/2 + i, its diagonal at buf[t*tb + s,
    s]. A broadcast (tb, tb) buffer (generate mode's zero lo tile) adds
    its own diagonal to every row tile."""
    tb = buf.shape[1]
    if buf.shape[0] == tb and nblk > 1:
        return torch.diagonal(buf).repeat(nblk)
    i = torch.arange(nblk, device=buf.device)
    tiles = buf.reshape(-1, tb, tb)[i * (i + 1) // 2 + i]
    return torch.diagonal(tiles, dim1=1, dim2=2).reshape(-1)


def zero_tiles_of(planes):
    """True where every plane after the first (the df64 lo plane, or the
    fq q2 and q3 planes) is a broadcast tile, not of the first plane's
    shape, holding only zeros (-0.0 counts: its terms never change a sum's
    bits, csrc/strip_walk.cuh). One count on the device, read when an
    operator is built."""
    tiles = planes[1:]
    return all(t.shape != planes[0].shape for t in tiles) and all(
        int(torch.count_nonzero(t)) == 0 for t in tiles)


class DenseOperator(LinearOperator):
    """Device-resident dense matrix with a precision and an engine."""

    def __init__(self, matvec_fn, operand, n, n_padded, vector_dtype,
                 precision, engine, device, mv_block=None):
        super().__init__(matvec_fn, operand, n, n_padded, vector_dtype,
                         device)
        self.precision = precision
        self.engine = engine
        self._mv_block = mv_block
        self._a32 = None  # an f64 square's f32 cast, made by as_f32()

    @staticmethod
    def from_dense(a, precision="df64", engine="auto", device="cuda"):
        """Build from an (n, n) numpy array (f64 source of truth).

        'f32'/'df64' store the packed lower triangle (engine
        'pallas_symm_packed', which 'auto' picks after checking that A
        is symmetric) or the full square (engine 'pallas', which 'auto'
        picks for a matrix that is not symmetric; engine 'pallas_symm',
        for a symmetric one, reads only its lower-triangle tiles); 'dfq'/
        'fq' store the packed triangle only. Engine 'xla' stores the
        unpadded square for a plain torch product (f64, f32, df64); 'f64'
        forces it. precision='auto' is df64 on a card, f64 on the CPU."""
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        if precision == "auto":
            precision = auto_precision(device)
        if precision not in ("f32", "df64", "dfq", "fq", "f64"):
            raise ValueError(f"unknown precision {precision!r}")
        check_engine(engine)
        if precision in QUANT_LAYOUT:
            if engine not in ("auto", ENGINE):
                raise ValueError(
                    f"precision={precision!r} implies the packed symmetric "
                    f"engine; engine={engine!r} is not combinable")
            return DenseOperator._from_dense_quantized(a, precision, True,
                                                       device)
        dev = resolve_device(device)
        a = np.asarray(a, dtype=np.float64)
        if precision == "f64" or engine == XLA_ENGINE:
            # no f64 kernel: f64 is the xla answer, as in lam_tpu
            return DenseOperator._xla_operator(a, precision, dev)
        if engine == "auto":
            engine = ENGINE if _verifies_symmetric(a) else DENSE_ENGINE
        elif engine in (ENGINE, SQUARE_ENGINE) and not _verifies_symmetric(a):
            raise ValueError(
                f"engine={engine!r} requires a symmetric matrix (the "
                "lower-triangle kernel mirrors A's lower half); the "
                "random-vector check found A v != A^T v; use "
                f"engine={DENSE_ENGINE!r}")
        pad = layout.padded_size(n)
        if pad != n:
            a_p = np.zeros((pad, pad), dtype=np.float64)
            a_p[:n, :n] = a
            a = a_p
        if engine in (DENSE_ENGINE, SQUARE_ENGINE):
            if precision == "f32":
                return DenseOperator(
                    _mv_f32_pallas if engine == DENSE_ENGINE
                    else _mv_f32_symm, _upload(a.astype(np.float32), dev),
                    n, pad, torch.float32, "f32", engine, dev, _mv_xla)
            return DenseOperator._square_df64(*split_f64_host(a), n, dev,
                                              engine)
        bufs = _host_pack_planes(a, precision, layout.SYMM_TB)
        return DenseOperator._plane_operator(precision, bufs, n, pad, dev)

    @staticmethod
    def _xla_operator(a, precision, dev):
        """Engine 'xla' over the unpadded (n, n) f64 array `a`: the f64
        square, the f32 square or the (hi, lo) f32 squares."""
        n = a.shape[0]
        if precision == "df64":
            operand = tuple(_upload(x, dev) for x in split_f64_host(a))
            mv, vdtype = _mv_df64_xla, torch.float64
        else:
            np_dtype = np.float64 if precision == "f64" else np.float32
            operand = _upload(a.astype(np_dtype), dev)
            mv = _mv_xla
            vdtype = torch.float64 if precision == "f64" else torch.float32
        return DenseOperator(mv, operand, n, n, vdtype, precision,
                             XLA_ENGINE, dev, _MV_BLOCK_SQUARE[precision])

    @staticmethod
    def _square_df64(hi, lo, n, dev, engine=DENSE_ENGINE):
        """Full-square df64 operator over (n_p, n_p) (hi, lo) planes, host
        arrays or tensors: the dense kernel ('pallas'), the square walk
        of the symmetric one ('pallas_symm') or plain torch products
        ('xla')."""
        n_p = hi.shape[0]
        if tuple(hi.shape) != (n_p, n_p) or tuple(lo.shape) != (n_p, n_p):
            raise ValueError("planes must be square and equal-shaped")
        operand = (_upload(hi, dev), _upload(lo, dev))
        mv = {DENSE_ENGINE: _mv_df64_pallas, SQUARE_ENGINE: _mv_df64_symm,
              XLA_ENGINE: _mv_df64_xla}[engine]
        return DenseOperator(mv, operand, n, n_p, torch.float64, "df64",
                             engine, dev, _mv_df64_xla)

    @staticmethod
    def _plane_operator(precision, bufs, n, n_padded, dev):
        """DenseOperator over packed-triangle plane(s), host arrays or
        tensors; a df64 lo plane may be one broadcast (tb, tb) tile."""
        tb = layout.packed_geometry(bufs[0].shape, n_padded,
                                    "DenseOperator")[0]
        if precision == "f32":
            return DenseOperator(_mv_f32_symm, _upload(bufs[0], dev), n,
                                 n_padded, torch.float32, "f32", ENGINE, dev,
                                 _mv_block_packed_f32)
        shape, lo_shape = tuple(bufs[0].shape), tuple(bufs[1].shape)
        if lo_shape not in (shape, (tb, tb)):
            raise ValueError(
                f"lo plane must match the hi plane {shape} or be a single "
                f"({tb}, {tb}) broadcast tile, got {lo_shape}")
        operand = (_upload(bufs[0], dev), _upload(bufs[1], dev))
        return DenseOperator(_mv_df64_symm, operand, n, n_padded,
                             torch.float64, "df64", ENGINE, dev,
                             _mv_block_packed_df64)

    @staticmethod
    def _packed_operator(storage, bufs, n, n_padded, dev):
        """DenseOperator over quantized packed-triangle buffers in operand
        order (`_host_pack_tri`, `pack_cache.load`, `from_gen_fq`), host
        arrays or tensors; the fq q2 and q3 planes may each be one
        broadcast (tb, tb) tile. Where both are tiles of zeros, the matvec
        reads q1 alone."""
        if storage not in QUANT_LAYOUT:
            raise ValueError(f"not a quantized storage: {storage!r}")
        n_planes = len(QUANT_LAYOUT[storage][0])
        planes, scales = bufs[:n_planes], bufs[n_planes:-2]
        tb, _, T = layout.packed_geometry(planes[0].shape, n_padded,
                                          "DenseOperator",
                                          padded=storage == "fq")
        shape = tuple(planes[0].shape)
        for name, plane in zip(("q2", "q3"), planes[1:]):
            if tuple(plane.shape) == shape:
                continue
            if storage == "fq":
                if tuple(plane.shape) == (tb, tb):
                    continue
                raise ValueError(f"{name} plane shape {tuple(plane.shape)} "
                                 f"!= q1 plane {shape} (or one broadcast "
                                 f"({tb}, {tb}) tile)")
            raise ValueError(f"quantized lo plane shape "
                             f"{tuple(plane.shape)} != hi plane {shape}")
        for sc in scales:
            if tuple(sc.shape) != (T,):
                raise ValueError(f"scale table shape {tuple(sc.shape)} != "
                                 f"({T},)")
        operand = tuple(_upload(b, dev) for b in bufs)
        matvec = (_mv_fq_zero if storage == "fq"
                  and zero_tiles_of(operand[:3]) else _MV_QUANT[storage])
        return DenseOperator(matvec, operand, n, n_padded, torch.float64,
                             storage, ENGINE, dev, _MV_BLOCK_PACKED[storage])

    @staticmethod
    def _from_dense_quantized(a, storage, check_symmetric, device):
        """Quantized packed operator of an (n, n) array, built streaming
        by row tile (`a` may be a np.memmap), padded to a multiple of the
        512-wide tile."""
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        dev = resolve_device(device)
        if check_symmetric and not _verifies_symmetric(a):
            raise ValueError(
                f"precision={storage!r} requires a symmetric matrix (the "
                "lower-triangle kernel mirrors A's lower half); the "
                "random-vector check found A v != A^T v")
        tb = layout.SYMM_TB
        bufs = _host_pack_tri(a, storage, tb)
        return DenseOperator._packed_operator(storage, bufs, n,
                                              layout.padded_size(n, tb), dev)

    @staticmethod
    def from_dense_dfq(a, check_symmetric=True, device="cuda"):
        """Quantized-lo packed operator ("dfq") from an (n, n) array: the
        f32 hi plane of the lower triangle, the lo plane as int16 tiles
        against per-tile power-of-two scales (|A_stored - A| <= ~2^-39
        of the tile's max) and the diagonal as an exact (dh, dl) pair,
        padded to a multiple of the 512-wide tile."""
        return DenseOperator._from_dense_quantized(a, "dfq", check_symmetric,
                                                   device)

    @staticmethod
    def from_dense_fq(a, check_symmetric=True, device="cuda"):
        """Fully-quantized packed operator ("fq") from an (n, n) array:
        the three-plane int16 cascade of the lower triangle plus the
        diagonal as an exact (dh, dl) pair, padded to a multiple of the
        512-wide tile."""
        return DenseOperator._from_dense_quantized(a, "fq", check_symmetric,
                                                   device)

    @staticmethod
    def _pack_fq_streamed(path, data_off, n, n_p, tb, dev):
        """The cold fq pipeline (lam_tpu/solver/operators.py:876-950): a
        worker thread runs the native range pack over tile rows, about
        PACK_CHUNK_TILES tiles a call (ctypes drops the GIL), while the
        main thread advances one transfer.Folder a q plane over the rows
        already final, so reading, quantizing and uploading overlap. Rows [0,
        avail) of a plane are final once every tile row below them is
        packed; the pad tiles are zeroed up front, so the last window
        takes the whole padded plane. A worker's exception is raised
        here. Returns (host buffers, for pack_cache.save; device buffers
        in operand order)."""
        nblk = n_p // tb
        bufs = _native_io.alloc_fq_buffers(n_p, tb)
        bounds, acc = [0], 0
        for i in range(nblk):
            acc += i + 1
            if acc >= PACK_CHUNK_TILES:
                bounds.append(i + 1)
                acc = 0
        if bounds[-1] != nblk:
            bounds.append(nblk)
        progress = {"rows": 0, "err": None}
        cv = threading.Condition()

        def worker():
            try:
                for r0, r1 in zip(bounds, bounds[1:]):
                    _native_io.pack_fq_range(path, data_off, n, n_p, tb, r0,
                                             r1, bufs)
                    with cv:
                        progress["rows"] = r1
                        cv.notify()
            except BaseException as e:  # raised by the main thread
                with cv:
                    progress["err"] = e
                    cv.notify()

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            planes = bufs[:3]
            folders = [transfer.Folder(q.shape, q.dtype, dev) for q in planes]
            done = 0
            while done < nblk:
                with cv:
                    while (progress["rows"] == done
                           and progress["err"] is None):
                        cv.wait()
                    if progress["err"] is not None:
                        raise progress["err"]
                    done = progress["rows"]
                avail = (planes[0].shape[0] if done == nblk
                         else layout.tri_tile_count(done) * tb)
                for f, q in zip(folders, planes):
                    f.advance(q, avail)
        finally:
            t.join()
        dev_bufs = (tuple(f.result() for f in folders)
                    + tuple(transfer.to_device(b, dev) for b in bufs[3:]))
        return bufs, dev_bufs

    @staticmethod
    def _from_file_packed(path, precision, check_symmetric, pack_cache,
                          device):
        """Shared body of the from_file_* constructors: the buffers come,
        in lam_tpu's order, from the pack cache beside the file streamed
        to the device (pack_cache=True and a usable cache); for fq from
        the streamed native range pack; from the fused native pack; else
        from the streaming numpy pack over a memory map. A fresh pack is
        published to the cache from its host buffers (pack_cache=True;
        atomic, best-effort). Symmetry is trusted by default (CG's
        contract)."""
        dev = resolve_device(device)
        path = str(path)
        # the source's identity before the memory map binds to it: a
        # replace during the pack makes pack_cache.save refuse to publish
        src_stat = os.stat(path)
        a = lio.open_matrix_memmap(path)
        if check_symmetric and not _verifies_symmetric(a):
            raise ValueError(
                f"precision='{precision}' requires a symmetric matrix "
                "(the lower-triangle kernel mirrors A's lower half); "
                "the random-vector check found A v != A^T v")
        n = a.shape[0]
        tb = layout.SYMM_TB
        n_p = layout.padded_size(n, tb)
        quantized = precision in QUANT_LAYOUT
        mk = (DenseOperator._packed_operator if quantized
              else DenseOperator._plane_operator)
        if pack_cache:
            hit = pc.load_device(path, precision, dev)
            if hit is not None and hit[:3] == (n, n_p, tb):
                return mk(precision, hit[3], n, n_p, dev)
        if _native_io.has_range_pack(precision):
            bufs, dev_bufs = DenseOperator._pack_fq_streamed(
                path, a.offset, n, n_p, tb, dev)
        else:
            bufs = dev_bufs = _file_pack(path, a, precision, n_p, tb)
        del a
        if pack_cache:
            pc.save(path, precision, n, n_p, tb, bufs, src_stat=src_stat)
        return mk(precision, dev_bufs, n, n_p, dev)

    @staticmethod
    def from_file_f32(path, check_symmetric=False, pack_cache=False,
                      device="cuda"):
        """f32 packed-triangle operator straight from a matrix file
        (binary format or .npy), by the fused native pack (the streaming
        numpy pack where the library is not built) or, with
        pack_cache=True, from `<file>.f32pack` (published after a fresh
        pack). Symmetry is trusted by default (CG's contract)."""
        return DenseOperator._from_file_packed(path, "f32", check_symmetric,
                                               pack_cache, device)

    @staticmethod
    def from_file_df64(path, check_symmetric=False, pack_cache=False,
                       device="cuda"):
        """df64 (hi, lo) packed-triangle operator straight from a matrix
        file, as from_file_f32 (cache `<file>.df64pack`)."""
        return DenseOperator._from_file_packed(path, "df64",
                                               check_symmetric, pack_cache,
                                               device)

    @staticmethod
    def from_file_dfq(path, check_symmetric=False, pack_cache=False,
                      device="cuda"):
        """Quantized-lo packed operator straight from a matrix file, as
        from_file_f32 (cache `<file>.dfqpack`, which lam_tpu reads and
        writes too)."""
        return DenseOperator._from_file_packed(path, "dfq", check_symmetric,
                                               pack_cache, device)

    @staticmethod
    def from_file_fq(path, check_symmetric=False, pack_cache=False,
                     device="cuda"):
        """Fully-quantized packed operator straight from a matrix file,
        as from_file_f32 (cache `<file>.fqpack`, which lam_tpu reads and
        writes too)."""
        return DenseOperator._from_file_packed(path, "fq", check_symmetric,
                                               pack_cache, device)

    @staticmethod
    def from_file_fq_q1(path, pack_cache=True, device="cuda"):
        """The q1-only fq operator of the host outer loop
        (lam_tpu/solver/operators.py:1076-1146): only the buffers the irfq
        inner matvec reads go to the device, the 2-byte q1 plane, its
        scales and the diagonal pair (a third of the cascade's bytes), q2
        and q3 riding as one zero tile each (`from_gen_fq`'s layout). The
        host computes the outer residuals against the f64 source
        (solver/host_outer.cg_solve_ir_host).

        Only its `as_f32()` view serves (kernel 14, gemv_q16_symm or its
        bf16 body); its accurate matvec raises, since over zero q2/q3 it
        would apply the coarse q1 reconstruction as if it were the
        cascade.

        Warm (pack_cache=True and a usable cache): the partial read of
        `<file>.fqpack` (pack_cache.load_device_fq_q1). Cold: the full
        pack (native where built), published to the cache when
        pack_cache, then the four buffers uploaded."""
        dev = resolve_device(device)
        path = str(path)
        src_stat = os.stat(path)
        if pack_cache:
            hit = pc.load_device_fq_q1(path, dev)
            if hit is not None:
                n, n_p, _, (q1, s1, dh, dl) = hit
                return DenseOperator._q1_only_operator(q1, s1, dh, dl, n,
                                                       n_p, dev)
        a = lio.open_matrix_memmap(path)
        n = a.shape[0]
        tb = layout.SYMM_TB
        n_p = layout.padded_size(n, tb)
        bufs = _file_pack(path, a, "fq", n_p, tb)
        del a
        if pack_cache:
            pc.save(path, "fq", n, n_p, tb, bufs, src_stat=src_stat)
        q1, s1, dh, dl = (transfer.to_device(bufs[i], dev)
                          for i in (0, 3, 6, 7))
        return DenseOperator._q1_only_operator(q1, s1, dh, dl, n, n_p, dev)

    @staticmethod
    def _q1_only_operator(q1, s1, dh, dl, n, n_p, dev):
        """fq operator over device q1, s1, dh and dl, with q2 and q3 one
        zero tile each and zero s2, s3, whose accurate matvec raises. It
        is built here, not by _packed_operator, which would route zero
        q2/q3 tiles to gemv_fq_symm_zero."""
        tb, _, T = layout.packed_geometry(tuple(q1.shape), n_p,
                                          "DenseOperator", padded=True)
        if tuple(s1.shape) != (T,):
            raise ValueError(f"scale table shape {tuple(s1.shape)} != "
                             f"({T},)")
        zero_tile = torch.zeros((tb, tb), dtype=torch.int16, device=dev)
        zero_sc = torch.zeros_like(s1)
        operand = (q1, zero_tile, zero_tile, s1, zero_sc, zero_sc, dh, dl)
        return DenseOperator(_no_accurate_matvec, operand, n, n_p,
                             torch.float64, "fq", ENGINE, dev)

    @staticmethod
    def from_packed_f32(a_packed, n, n_padded, device="cuda"):
        """f32 operator from a pre-packed walk-order (T*tb, tb) triangle
        plane (lam_tpu/solver/operators.py:1174): generate mode's f32
        operator, whose entries {0, 1, 2} are exact in f32, so the hi
        plane is the matrix."""
        return DenseOperator._plane_operator(
            "f32", (_buffer(a_packed, np.float32),), n, n_padded,
            resolve_device(device))

    @staticmethod
    def from_gen_fq(q1, n, n_padded, diag_value=2.0, device="cuda"):
        """fq operator from a pre-packed walk-order int16 q1 plane whose
        quantization is exact (generate mode's tridiagonal: entries {0, 1}
        against TRIDIAG_Q1_SCALE, the diagonal extracted;
        generate._tridiag_q1_packed_impl), as lam_tpu's
        (lam_tpu/solver/operators.py:1186): q2 and q3 are exactly zero and
        stored as ONE broadcast (tb, tb) zero tile each, so the storage is
        2 B per element; s1 is TRIDIAG_Q1_SCALE, s2 and s3 zero; the
        diagonal rides as the exact pair dh = diag_value on the first n
        entries, dl = 0."""
        from lam_tpu_torch.generate import TRIDIAG_Q1_SCALE
        tb = layout.SYMM_TB
        T = q1.shape[0] // tb
        dv = np.float32(diag_value)
        if float(dv) != float(diag_value):
            raise ValueError(f"diag_value {diag_value} is not exact "
                             "in f32 (the gen pair carries dl == 0)")
        dev = resolve_device(device)
        dh = torch.zeros((n_padded,), dtype=torch.float32, device=dev)
        dh[:n] = float(dv)
        zero_tile = torch.zeros((tb, tb), dtype=torch.int16, device=dev)
        zero_sc = torch.zeros((T,), dtype=torch.float32, device=dev)
        s1 = torch.full((T,), TRIDIAG_Q1_SCALE, dtype=torch.float32,
                        device=dev)
        bufs = (_buffer(q1, np.int16), zero_tile, zero_tile, s1, zero_sc,
                zero_sc, dh, torch.zeros_like(dh))
        return DenseOperator._packed_operator("fq", bufs, n, n_padded, dev)

    @staticmethod
    def from_packed_planes(hi, lo, n, n_padded, device="cuda"):
        """df64 operator from pre-packed walk-order (T*tb, tb) planes,
        host arrays (e.g. `np.asarray` of a lam_tpu operator's `operand`:
        the state carried across from the JAX package) or tensors. `lo`
        may be one (tb, tb) broadcast tile: generate mode's zero lo plane
        of a matrix whose entries are exact in f32, a quarter of the
        full-square pair's memory (lam_tpu/solver/operators.py:1219). The
        caller asserts the planes represent a symmetric f64 matrix."""
        bufs = (_buffer(hi, np.float32), _buffer(lo, np.float32))
        return DenseOperator._plane_operator("df64", bufs, n, n_padded,
                                             resolve_device(device))

    @staticmethod
    def from_df64_planes(hi, lo, n, engine=DENSE_ENGINE, device="cuda"):
        """Full-square df64 operator from pre-split, pre-padded (n_p, n_p)
        f32 planes, host arrays (e.g. `np.asarray` of a lam_tpu engine=
        'pallas' or 'pallas_symm' operator's `operand`: the state carried
        across from the JAX package) or tensors (generate mode's planes):
        engine 'pallas' (the dense kernel), 'pallas_symm' (the square walk
        of the symmetric kernel) or 'xla' (plain torch products). The
        caller asserts they represent the intended f64 matrix and, for
        'pallas_symm', that it is symmetric."""
        if engine not in (DENSE_ENGINE, SQUARE_ENGINE, XLA_ENGINE):
            check_engine(engine)
            raise ValueError(f"from_df64_planes takes engine "
                             f"{DENSE_ENGINE!r}, {SQUARE_ENGINE!r} or "
                             f"{XLA_ENGINE!r}, got {engine!r}")
        return DenseOperator._square_df64(
            _buffer(hi, np.float32), _buffer(lo, np.float32), n,
            resolve_device(device), engine)

    @staticmethod
    def from_dfq_planes(hi, loq, sc, dh, dl, n, n_padded, device="cuda"):
        """dfq operator from pre-packed buffers given as host arrays in
        operand order, e.g. `np.asarray` of each entry of a lam_tpu dfq
        operator's `operand`: the state carried across from the JAX
        package. The caller asserts they represent a symmetric matrix."""
        dtypes = (np.float32, np.int16, np.float32, np.float32, np.float32)
        bufs = tuple(_buffer(b, dt) for b, dt in
                     zip((hi, loq, sc, dh, dl), dtypes))
        return DenseOperator._packed_operator("dfq", bufs, n, n_padded,
                                              resolve_device(device))

    @staticmethod
    def from_fq_planes(q1, q2, q3, s1, s2, s3, dh, dl, n, n_padded,
                       device="cuda"):
        """fq operator from pre-packed buffers given as host arrays in
        operand order, e.g. `np.asarray` of each entry of a lam_tpu fq
        operator's `operand`: the state carried across from the JAX
        package. q2 and q3 may each be one broadcast (tb, tb) tile (a
        lam_tpu `from_gen_fq` operator). The caller asserts they represent
        a symmetric matrix."""
        dtypes = (np.int16,) * 3 + (np.float32,) * 5
        bufs = tuple(_buffer(b, dt) for b, dt in
                     zip((q1, q2, q3, s1, s2, s3, dh, dl), dtypes))
        return DenseOperator._packed_operator("fq", bufs, n, n_padded,
                                              resolve_device(device))

    def diagonal(self):
        """The matrix diagonal as a padded vector (lam_tpu/solver/
        operators.py:1255-1270): f64 for the quantized storages (the exact
        (dh, dl) pair the planes no longer carry), for df64 (hi + lo, a
        broadcast lo tile counted at every row tile) and for the f64
        oracle square, f32 for f32. The packed planes give theirs at the
        diagonal tiles, the full squares theirs."""
        if self.precision in QUANT_LAYOUT:
            return join_f64(self.operand[-2], self.operand[-1])
        if self.engine == ENGINE:
            planes = (self.operand if self.precision == "df64"
                      else (self.operand,))
            nblk = self.n_padded // planes[0].shape[1]
            d = [_packed_diagonal(x, nblk) for x in planes]
            return d[0] if self.precision == "f32" else join_f64(*d)
        if self.precision in ("f32", "f64"):
            return torch.diagonal(self.operand)
        return join_f64(*(torch.diagonal(x) for x in self.operand))

    def as_f32(self):
        """Sibling f32 operator SHARING this operator's device buffers
        (the same operand object): the inner engine of cg_solve_ir, which
        holds one copy of the matrix. The f32 view of an f64 square is
        the one exception: it multiplies by the square cast to f32, made
        at the first call and kept by this operator (lam_tpu's XLA
        materializes the same cast once per loop)."""
        if self.precision == "f32":
            return self
        if self.precision == "f64":
            if self._a32 is None:
                self._a32 = self.operand.to(torch.float32)
            mv = _mv_f32_of_f64_xla(self._a32)
        else:
            mv = _MV_F32_OF[(self.precision, self.engine)]
        return DenseOperator(mv, self.operand, self.n, self.n_padded,
                             torch.float32, "f32", self.engine, self.device)


def check_engine(engine):
    """Raise ValueError for an engine neither package knows."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (one of {ENGINES})")


def auto_precision(device):
    """precision='auto' (lam_tpu/solver/operators.py:670-671, the card in
    the TPU's place): 'df64' on a CUDA device, 'f64' on the CPU."""
    return "df64" if torch.device(device).type == "cuda" else "f64"
