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
  'f64'  the full square in float64 with a plain torch matvec: the
         oracle path (lam_tpu's engine='xla'), not a kernel path.

The full-square engine ('pallas', the only one for a matrix that is not
symmetric, and what engine='auto' picks for one) stores the whole
square: 'f32' as one f32 square, matvec by the dense f32 kernel; 'df64'
as (hi, lo) f32 squares, matvec by the dense df64 kernel, whose
`as_f32()` is the dense f32 kernel on the hi square.

A `MatrixFreeOperator` applies a function instead of a stored matrix
(the heat demo's 5-point Laplacian, lam_tpu_torch/apps/heat.py), and an
operator may take a fused `matvec_dot_fn` whose kernel returns p . A p
from the same pass.

Padding: the matrix and vectors are zero-padded once, at construction,
to the tile grid. Zero padding is exact for CG: padded entries of every
vector stay 0 and no dot product changes.

Every constructor takes an explicit `device`. Asking for CUDA where
there is none raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lam_tpu_torch import io as lio
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.precision import join_f64, split_f64, split_f64_host
from lam_tpu_torch.solver import pack_cache as pc

ENGINE = "pallas_symm_packed"  # lam_tpu's name for the packed layout
DENSE_ENGINE = "pallas"        # lam_tpu's name for the full-square engine
ENGINES = ("auto", ENGINE, DENSE_ENGINE)
UNPORTED_ENGINES = ("pallas_symm", "xla")

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


def _upload(x, dev):
    return torch.tensor(np.asarray(x), device=dev)


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


# matvec implementations: fn(operand, p) -> A @ p

def _mv_f64_plain(a, p):
    # the oracle path: plain torch on the full f64 square
    return a @ p


def _mv_f32_packed(a, p):
    return gemv.gemv_f32_symm(a, p)


def _mv_df64_packed(operand, p):
    hi, lo = operand
    ph, pl = split_f64(p)
    yh, yl = gemv.gemv_df64_symm(hi, lo, ph, pl)
    return join_f64(yh, yl)


def _mv_f32_of_df64_packed(operand, p):
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
    ("df64", ENGINE): _mv_f32_of_df64_packed,
    ("dfq", ENGINE): _mv_f32_of_dfq_packed,
    ("fq", ENGINE): _mv_f32_of_fq_packed,
    ("df64", DENSE_ENGINE): _mv_f32_of_df64_pallas,
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
                  inner_floor):
        from lam_tpu_torch.solver.cg import _cg_ir_loop
        if op32.operand is not self.operand:
            raise ValueError(
                "cg_solve_ir requires the f32 operator to be a VIEW of "
                "the accurate operator (use op_acc.as_f32()); separate "
                "buffers would double the matrix footprint on the device")
        return _cg_ir_loop(op32.matvec_dot, self.matvec_dot, b_padded,
                           max_iters, rel_error, max_cycles, inner_floor,
                           self.dot)


class MatrixFreeOperator(LinearOperator):
    """Operator from an arbitrary matvec function (e.g. a stencil), as
    lam_tpu's (lam_tpu/solver/operators.py:604-616): the heat demo's f64
    5-point Laplacian, with no matrix stored and no padding."""

    def __init__(self, matvec_fn, operand, n, vector_dtype=torch.float64,
                 device="cuda"):
        super().__init__(matvec_fn, operand, n, n, vector_dtype,
                         resolve_device(device))


class DenseOperator(LinearOperator):
    """Device-resident dense matrix with a precision and an engine."""

    def __init__(self, matvec_fn, operand, n, n_padded, vector_dtype,
                 precision, engine, device):
        super().__init__(matvec_fn, operand, n, n_padded, vector_dtype,
                         device)
        self.precision = precision
        self.engine = engine

    @staticmethod
    def from_dense(a, precision="df64", engine="auto", device="cuda"):
        """Build from an (n, n) numpy array (f64 source of truth).

        'f32'/'df64' store the packed lower triangle (engine
        'pallas_symm_packed', which 'auto' picks after checking that A
        is symmetric) or the full square (engine 'pallas', which 'auto'
        picks for a matrix that is not symmetric); 'dfq'/'fq' store the
        packed triangle only; 'f64' is the plain oracle path."""
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        if precision not in ("f32", "df64", "dfq", "fq", "f64"):
            if precision == "auto":
                raise NotImplementedError(
                    f"precision={precision!r} is not ported yet")
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
        if precision == "f64":
            return DenseOperator(_mv_f64_plain, _upload(a, dev), n, n,
                                 torch.float64, "f64", "plain", dev)
        if engine == "auto":
            engine = ENGINE if _verifies_symmetric(a) else DENSE_ENGINE
        elif engine == ENGINE and not _verifies_symmetric(a):
            raise ValueError(
                f"engine={ENGINE!r} requires a symmetric matrix (the "
                "lower-triangle kernel mirrors A's lower half); the "
                "random-vector check found A v != A^T v; use "
                f"engine={DENSE_ENGINE!r}")
        pad = layout.padded_size(n)
        if pad != n:
            a_p = np.zeros((pad, pad), dtype=np.float64)
            a_p[:n, :n] = a
            a = a_p
        if engine == DENSE_ENGINE:
            if precision == "f32":
                return DenseOperator(_mv_f32_pallas,
                                     _upload(a.astype(np.float32), dev), n,
                                     pad, torch.float32, "f32",
                                     DENSE_ENGINE, dev)
            return DenseOperator._square_df64(*split_f64_host(a), n, dev)
        bufs = _host_pack_planes(a, precision, layout.SYMM_TB)
        return DenseOperator._plane_operator(precision, bufs, n, pad, dev)

    @staticmethod
    def _square_df64(hi, lo, n, dev):
        """Full-square df64 operator over (n_p, n_p) host (hi, lo)
        planes."""
        n_p = hi.shape[0]
        if hi.shape != (n_p, n_p) or lo.shape != (n_p, n_p):
            raise ValueError("planes must be square and equal-shaped")
        operand = (_upload(hi, dev), _upload(lo, dev))
        return DenseOperator(_mv_df64_pallas, operand, n, n_p,
                             torch.float64, "df64", DENSE_ENGINE, dev)

    @staticmethod
    def _plane_operator(precision, bufs, n, n_padded, dev):
        """DenseOperator over host packed-triangle plane(s)."""
        layout.packed_geometry(bufs[0].shape, n_padded, "DenseOperator")
        if precision == "f32":
            return DenseOperator(_mv_f32_packed, _upload(bufs[0], dev), n,
                                 n_padded, torch.float32, "f32", ENGINE, dev)
        if bufs[1].shape != bufs[0].shape:
            raise NotImplementedError(
                "a broadcast (tb, tb) lo tile is not ported yet; pass a lo "
                "plane of the hi plane's shape")
        operand = (_upload(bufs[0], dev), _upload(bufs[1], dev))
        return DenseOperator(_mv_df64_packed, operand, n, n_padded,
                             torch.float64, "df64", ENGINE, dev)

    @staticmethod
    def _packed_operator(storage, bufs, n, n_padded, dev):
        """DenseOperator over host quantized packed-triangle buffers in
        operand order (`_host_pack_tri`, `pack_cache.load`)."""
        if storage not in QUANT_LAYOUT:
            raise ValueError(f"not a quantized storage: {storage!r}")
        n_planes = len(QUANT_LAYOUT[storage][0])
        planes, scales = bufs[:n_planes], bufs[n_planes:-2]
        _, _, T = layout.packed_geometry(planes[0].shape, n_padded,
                                         "DenseOperator",
                                         padded=storage == "fq")
        for plane in planes[1:]:
            if plane.shape == planes[0].shape:
                continue
            if storage == "fq":
                raise NotImplementedError(
                    "broadcast (tb, tb) q2/q3 tiles are not ported yet; "
                    "pass planes of the q1 plane's shape")
            raise ValueError(f"quantized lo plane shape {plane.shape} != "
                             f"hi plane {planes[0].shape}")
        for sc in scales:
            if sc.shape != (T,):
                raise ValueError(f"scale table shape {sc.shape} != ({T},)")
        operand = tuple(_upload(b, dev) for b in bufs)
        return DenseOperator(_MV_QUANT[storage], operand, n, n_padded,
                             torch.float64, storage, ENGINE, dev)

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
    def _from_file_packed(path, precision, check_symmetric, pack_cache,
                          device):
        """Shared body of the from_file_* constructors: the buffers come
        from the pack cache beside the file (pack_cache=True and a usable
        cache), else from the streaming numpy pack over a memory map,
        which is then published to the cache (pack_cache=True; atomic,
        best-effort). Symmetry is trusted by default (CG's contract)."""
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
            hit = pc.load(path, precision)
            if hit is not None and hit[:3] == (n, n_p, tb):
                return mk(precision, hit[3], n, n_p, dev)
        if quantized:
            bufs = _host_pack_tri(a, precision, tb)
        else:
            bufs = _host_pack_planes(a, precision, tb)
        del a
        if pack_cache:
            pc.save(path, precision, n, n_p, tb, bufs, src_stat=src_stat)
        return mk(precision, bufs, n, n_p, dev)

    @staticmethod
    def from_file_f32(path, check_symmetric=False, pack_cache=False,
                      device="cuda"):
        """f32 packed-triangle operator straight from a matrix file
        (binary format or .npy), by the streaming numpy pack or, with
        pack_cache=True, from `<file>.f32pack` (published after a
        fresh pack). Symmetry is trusted by default (CG's contract)."""
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
    def from_packed_planes(hi, lo, n, n_padded, device="cuda"):
        """df64 operator from pre-packed walk-order (T*tb, tb) planes
        given as host arrays, e.g. `np.asarray` of a lam_tpu operator's
        `operand`: the state carried across from the JAX package. The
        caller asserts the planes represent a symmetric f64 matrix."""
        bufs = (np.asarray(hi, np.float32), np.asarray(lo, np.float32))
        return DenseOperator._plane_operator("df64", bufs, n, n_padded,
                                             resolve_device(device))

    @staticmethod
    def from_df64_planes(hi, lo, n, engine=DENSE_ENGINE, device="cuda"):
        """Full-square df64 operator from pre-split, pre-padded (n_p, n_p)
        f32 planes given as host arrays, e.g. `np.asarray` of a lam_tpu
        engine='pallas' operator's `operand`: the state carried across
        from the JAX package. The caller asserts they represent the
        intended f64 matrix."""
        if engine != DENSE_ENGINE:
            check_engine(engine)
            raise NotImplementedError(
                f"from_df64_planes(engine={engine!r}) is not ported yet "
                f"(only {DENSE_ENGINE!r})")
        return DenseOperator._square_df64(np.asarray(hi, np.float32),
                                          np.asarray(lo, np.float32), n,
                                          resolve_device(device))

    @staticmethod
    def from_dfq_planes(hi, loq, sc, dh, dl, n, n_padded, device="cuda"):
        """dfq operator from pre-packed buffers given as host arrays in
        operand order, e.g. `np.asarray` of each entry of a lam_tpu dfq
        operator's `operand`: the state carried across from the JAX
        package. The caller asserts they represent a symmetric matrix."""
        dtypes = (np.float32, np.int16, np.float32, np.float32, np.float32)
        bufs = tuple(np.asarray(b, dt) for b, dt in
                     zip((hi, loq, sc, dh, dl), dtypes))
        return DenseOperator._packed_operator("dfq", bufs, n, n_padded,
                                              resolve_device(device))

    @staticmethod
    def from_fq_planes(q1, q2, q3, s1, s2, s3, dh, dl, n, n_padded,
                       device="cuda"):
        """fq operator from pre-packed buffers given as host arrays in
        operand order, e.g. `np.asarray` of each entry of a lam_tpu fq
        operator's `operand`: the state carried across from the JAX
        package. The caller asserts they represent a symmetric matrix."""
        dtypes = (np.int16,) * 3 + (np.float32,) * 5
        bufs = tuple(np.asarray(b, dt) for b, dt in
                     zip((q1, q2, q3, s1, s2, s3, dh, dl), dtypes))
        return DenseOperator._packed_operator("fq", bufs, n, n_padded,
                                              resolve_device(device))

    def diagonal(self):
        """The matrix diagonal as a padded vector: f64 for the quantized
        storages (the exact (dh, dl) pair the planes no longer carry) and
        a full-square df64 operator, f32 for a full-square f32 one."""
        if self.precision in QUANT_LAYOUT:
            return join_f64(self.operand[-2], self.operand[-1])
        if self.engine == DENSE_ENGINE:
            if self.precision == "f32":
                return torch.diagonal(self.operand)
            return join_f64(*(torch.diagonal(x) for x in self.operand))
        raise NotImplementedError(
            f"diagonal() of a {self.precision!r} {self.engine!r} operator "
            "is not ported yet")

    def as_f32(self):
        """Sibling f32 operator SHARING this operator's device buffers
        (the same operand object, not a cast copy): the inner engine of
        cg_solve_ir, which holds one copy of the matrix."""
        if self.precision == "f32":
            return self
        key = (self.precision, self.engine)
        if key not in _MV_F32_OF:
            raise NotImplementedError(
                f"as_f32() of a {self.precision!r} {self.engine!r} "
                "operator is not ported yet")
        return DenseOperator(_MV_F32_OF[key], self.operand, self.n,
                             self.n_padded, torch.float32, "f32",
                             self.engine, self.device)


def check_engine(engine):
    """Raise for an engine the port does not take: NotImplementedError
    for lam_tpu's engines still to port, ValueError for an unknown one."""
    if engine in UNPORTED_ENGINES:
        raise NotImplementedError(f"engine={engine!r} is not ported yet")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (one of "
                         f"{ENGINES + UNPORTED_ENGINES})")
