"""ctypes bindings of the port's native host library (lam_tpu/_native_io.py).

`lam_tpu_torch/native/lam_native.cpp` (the JAX package's
`native/lam_native.cpp`, copied) holds threaded host routines: row reads
of the binary matrix format, the f64 -> (hi, lo) f32 split, the
tridiagonal fill, and the fused packs of a symmetric matrix file into
the packed-triangle layouts (f32, df64, dfq, fq; the fq pack also by
ranges of tile rows, so a worker thread can pack while the main thread
uploads). Each result is byte-equal to the numpy branch that stays
beside its call site (`io.read_matrix_rows`, `generate.tridiagonal_rows`,
`precision.split_f64_host`, `solver/operators.py`'s `_host_pack_tri` and
`_host_pack_planes`).

At first use one g++ (the flags of native/Makefile) builds the library
into `lam_tpu_torch/_build/` under a name that carries a hash of the
source and the flags, written under a temporary name and moved into
place, so several processes may build at once. Where no g++ is found
and no library was built, `available()` is False and every caller takes
its numpy branch. A build or load that fails with g++ present raises
with the compiler's output: a broken source never hides behind the
numpy path. `calls()` counts the bindings' calls by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

from lam_tpu_torch.ops.layout import padded_tri_tile_count, tri_tile_count

SOURCE = pathlib.Path(__file__).resolve().parent / "native" / "lam_native.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_LIB = None
_TRIED = False
_LOCK = threading.Lock()
_CALLS: dict = {}


def library_path():
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblam_native_{h.hexdigest()[:16]}.so"


def build():
    """The library's path, compiling it first unless it exists. None
    where it does not exist and no g++ is found; raises with g++'s
    output when the compile fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _register(lib):
    u64 = ctypes.c_uint64
    f64p = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)
    i16p = ctypes.POINTER(ctypes.c_int16)
    sigs = {
        "ln_read_rows": ([ctypes.c_char_p, u64, u64, u64, f64p],
                         ctypes.c_int),
        "ln_read_rows_split": ([ctypes.c_char_p, u64, u64, u64, f32p, f32p],
                               ctypes.c_int),
        "ln_split_f64": ([f64p, u64, f32p, f32p], None),
        "ln_write_matrix": ([ctypes.c_char_p, u64, u64, f64p], ctypes.c_int),
        "ln_tridiagonal_rows": ([u64, u64, u64, f64p], None),
        "ln_tridiagonal_rows_split": ([u64, u64, u64, f32p, f32p], None),
        "ln_pack_dfq": ([ctypes.c_char_p, u64, u64, u64, u64, f32p, i16p,
                         f32p, f32p, f32p], ctypes.c_int),
        "ln_pack_fq": ([ctypes.c_char_p, u64, u64, u64, u64, i16p, i16p,
                        i16p, f32p, f32p, f32p, f32p, f32p], ctypes.c_int),
        "ln_pack_fq_range": ([ctypes.c_char_p, u64, u64, u64, u64, u64, u64,
                              i16p, i16p, i16p, f32p, f32p, f32p, f32p,
                              f32p], ctypes.c_int),
        "ln_pack_planes": ([ctypes.c_char_p, u64, u64, u64, u64, f32p, f32p],
                           ctypes.c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            path = build()
            if path is not None:
                lib = ctypes.CDLL(str(path))
                _register(lib)
                _LIB = lib
            _TRIED = True
    return _LIB


def available():
    """True where the library is built (or g++ can build it now)."""
    return _load() is not None


def calls():
    """{binding name: calls} since the last reset_calls()."""
    return dict(_CALLS)


def reset_calls():
    _CALLS.clear()


def _lib(name):
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is not available (no g++ "
                           "found): take the numpy branch")
    _CALLS[name] = _CALLS.get(name, 0) + 1
    return lib


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i16p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def read_rows(path, row_start, num_rows, cols):
    """Rows [row_start, row_start + num_rows) of a binary-format (16-byte
    header) f64 matrix file, read by threads."""
    lib = _lib("read_rows")
    out = np.empty((num_rows, cols), dtype=np.float64)
    rc = lib.ln_read_rows(str(path).encode(), row_start, num_rows, cols,
                          _f64p(out))
    if rc != 0:
        raise IOError(f"native read of {path} failed (rc={rc})")
    return out


def read_rows_split(path, row_start, num_rows, cols):
    """The row block as (hi, lo) f32 planes, split during the read."""
    lib = _lib("read_rows_split")
    hi = np.empty((num_rows, cols), dtype=np.float32)
    lo = np.empty((num_rows, cols), dtype=np.float32)
    rc = lib.ln_read_rows_split(str(path).encode(), row_start, num_rows,
                                cols, _f32p(hi), _f32p(lo))
    if rc != 0:
        raise IOError(f"native split-read of {path} failed (rc={rc})")
    return hi, lo


def split_f64(a):
    """(hi, lo) f32 planes of an f64 array, hi = f32(a), lo = f32(a -
    hi): numpy's split bit for bit."""
    lib = _lib("split_f64")
    a = np.ascontiguousarray(a, dtype=np.float64)
    hi = np.empty(a.shape, dtype=np.float32)
    lo = np.empty(a.shape, dtype=np.float32)
    lib.ln_split_f64(_f64p(a), a.size, _f32p(hi), _f32p(lo))
    return hi, lo


def write_matrix(path, a):
    """A 2-D f64 array in the binary format."""
    lib = _lib("write_matrix")
    a = np.ascontiguousarray(a, dtype=np.float64)
    rc = lib.ln_write_matrix(str(path).encode(), a.shape[0], a.shape[1],
                             _f64p(a))
    if rc != 0:
        raise IOError(f"native write of {path} failed (rc={rc})")


def tridiagonal_rows(row_start, num_rows, n):
    """Rows of generate mode's tridiagonal in f64 (2 on the diagonal, 1
    beside it)."""
    lib = _lib("tridiagonal_rows")
    out = np.empty((num_rows, n), dtype=np.float64)
    lib.ln_tridiagonal_rows(row_start, num_rows, n, _f64p(out))
    return out


def tridiagonal_rows_split(row_start, num_rows, n):
    lib = _lib("tridiagonal_rows_split")
    hi = np.empty((num_rows, n), dtype=np.float32)
    lo = np.empty((num_rows, n), dtype=np.float32)
    lib.ln_tridiagonal_rows_split(row_start, num_rows, n, _f32p(hi),
                                  _f32p(lo))
    return hi, lo


def pack_dfq(path, data_off, n, n_pad, tb):
    """Fused read, split and quantize of a symmetric f64 matrix file (raw
    data at byte data_off) into the dfq buffers (hi, loq, sc, dh, dl),
    reading only the lower-triangle bytes."""
    lib = _lib("pack_dfq")
    T = tri_tile_count(n_pad // tb)
    hi = np.empty((T * tb, tb), dtype=np.float32)
    loq = np.empty((T * tb, tb), dtype=np.int16)
    sc = np.empty((T,), dtype=np.float32)
    dh = np.empty((n_pad,), dtype=np.float32)
    dl = np.empty((n_pad,), dtype=np.float32)
    rc = lib.ln_pack_dfq(str(path).encode(), data_off, n, n_pad, tb,
                         _f32p(hi), _i16p(loq), _f32p(sc), _f32p(dh),
                         _f32p(dl))
    if rc != 0:
        raise IOError(f"native dfq pack of {path} failed (rc={rc})")
    return hi, loq, sc, dh, dl


def has_range_pack(storage):
    """True where the library packs this storage by ranges of tile rows
    (fq only): the gate of the streamed cold path."""
    return storage == "fq" and available()


def has_pack(storage):
    """True where the library has the fused pack of this storage."""
    return storage in ("dfq", "fq", "f32", "df64") and available()


def alloc_fq_buffers(n_pad, tb):
    """Host fq buffers in operand order (q1, q2, q3, s1, s2, s3, dh, dl),
    the planes padded to padded_tri_tile_count tiles, pad tiles, scales
    and the diagonal pair zeroed: the allocation shared by pack_fq and
    the streamed range pack."""
    nblk = n_pad // tb
    T = tri_tile_count(nblk)
    Ts = padded_tri_tile_count(nblk)
    planes = [np.empty((Ts * tb, tb), dtype=np.int16) for _ in range(3)]
    for q in planes:
        q[T * tb:] = 0
    scales = [np.zeros((Ts,), dtype=np.float32) for _ in range(3)]
    dh = np.zeros((n_pad,), dtype=np.float32)
    dl = np.zeros((n_pad,), dtype=np.float32)
    return (*planes, *scales, dh, dl)


def pack_fq_range(path, data_off, n, n_pad, tb, row0, row1, bufs):
    """Fill tile rows [row0, row1) of the fq layout into `bufs` (the
    alloc_fq_buffers tuple). The ctypes call releases the GIL, so a
    worker thread can pack while the main thread uploads finished rows
    (ops/transfer.py Folder)."""
    lib = _lib("pack_fq_range")
    q1, q2, q3, s1, s2, s3, dh, dl = bufs
    rc = lib.ln_pack_fq_range(
        str(path).encode(), data_off, n, n_pad, tb, row0, row1, _i16p(q1),
        _i16p(q2), _i16p(q3), _f32p(s1), _f32p(s2), _f32p(s3), _f32p(dh),
        _f32p(dl))
    if rc != 0:
        raise IOError(f"native fq range pack of {path} failed (rc={rc}, "
                      f"rows [{row0}, {row1}))")


def pack_fq(path, data_off, n, n_pad, tb):
    """Fused read and three-plane quantize of a symmetric f64 matrix file
    into the fq buffers, in operand order, padded as alloc_fq_buffers
    (the pass fills the real triangle only)."""
    lib = _lib("pack_fq")
    bufs = alloc_fq_buffers(n_pad, tb)
    q1, q2, q3, s1, s2, s3, dh, dl = bufs
    rc = lib.ln_pack_fq(str(path).encode(), data_off, n, n_pad, tb,
                        _i16p(q1), _i16p(q2), _i16p(q3), _f32p(s1),
                        _f32p(s2), _f32p(s3), _f32p(dh), _f32p(dl))
    if rc != 0:
        raise IOError(f"native fq pack of {path} failed (rc={rc})")
    return bufs


def _pack_planes(name, path, data_off, n, n_pad, tb, want_lo):
    lib = _lib(name)
    T = tri_tile_count(n_pad // tb)
    hi = np.empty((T * tb, tb), dtype=np.float32)
    lo = np.empty((T * tb, tb), dtype=np.float32) if want_lo else None
    rc = lib.ln_pack_planes(str(path).encode(), data_off, n, n_pad, tb,
                            _f32p(hi), _f32p(lo) if want_lo else None)
    if rc != 0:
        raise IOError(f"native plane pack of {path} failed (rc={rc})")
    return (hi,) if lo is None else (hi, lo)


def pack_f32(path, data_off, n, n_pad, tb):
    """Fused read and convert of a symmetric f64 matrix file into the f32
    packed-triangle plane: `_host_pack_planes(a, 'f32', tb)` bit for
    bit."""
    return _pack_planes("pack_f32", path, data_off, n, n_pad, tb, False)


def pack_df64(path, data_off, n, n_pad, tb):
    """Fused read and split into the (hi, lo) packed-triangle planes:
    `_host_pack_planes(a, 'df64', tb)` bit for bit."""
    return _pack_planes("pack_df64", path, data_off, n, n_pad, tb, True)
