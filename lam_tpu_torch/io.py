"""Binary matrix/vector files (numpy only), byte-compatible with lam_tpu.io.

Format (the reference generator's, read and written by lam_tpu.io):

    uint64 num_rows   (little-endian)
    uint64 num_cols
    float64 data[num_rows * num_cols]   (row-major)

Vectors are (N, 1) columns. `.npy` float64 files are accepted wherever
the binary format is. A row block of a binary file is read by the
native library's threads where it is built (lam_tpu_torch/_native_io.py),
else by numpy, the same bytes.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_HEADER = struct.Struct("<QQ")


def _is_npy(path):
    return str(path).endswith(".npy")


def _open_npy(path):
    """Memory-map a .npy as a 2-D f64 array ((n,) vectors view as
    (n, 1) columns, matching how the binary format stores them)."""
    a = np.load(path, mmap_mode="r")
    if a.dtype != np.float64:
        raise ValueError(f"{path}: expected float64 .npy, got {a.dtype}")
    if a.ndim == 1:
        a = a.reshape(-1, 1)
    if a.ndim != 2:
        raise ValueError(f"{path}: expected a 1-D/2-D .npy, got "
                         f"{a.ndim}-D")
    return a


def read_header(path):
    """Return (num_rows, num_cols) of a binary file (or a .npy's shape).

    Raises IOError with a one-line message on a short or implausible
    header."""
    if _is_npy(path):
        return _open_npy(path).shape
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
    if len(head) != _HEADER.size:
        raise IOError(f"{path}: not a LAM binary file (header is "
                      f"{len(head)} bytes, need {_HEADER.size})")
    rows, cols = _HEADER.unpack(head)
    if rows == 0 or cols == 0 or rows * cols > (1 << 48):
        raise IOError(f"{path}: implausible header ({rows}x{cols}) — "
                      f"corrupt or not a LAM binary file")
    return rows, cols


def square_size(path):
    """n of the n x n matrix in a file (its header, or a .npy's shape);
    ValueError, in lam_tpu's words (lam_tpu/parallel/pcg.py:519-522), for
    one that is not square."""
    rows, cols = read_header(path)
    if rows != cols:
        raise ValueError(f"{path}: matrix must be square ({rows}x{cols})")
    return rows


def read_matrix(path, dtype=np.float64):
    """Read a full matrix (or column vector) as a (rows, cols) array."""
    rows, cols = read_header(path)
    if _is_npy(path):
        return np.ascontiguousarray(
            np.asarray(_open_npy(path)).astype(dtype, copy=False))
    data = np.fromfile(path, dtype=np.float64, count=rows * cols,
                       offset=_HEADER.size)
    if data.size != rows * cols:
        raise IOError(f"{path}: truncated payload "
                      f"({data.size} of {rows * cols} elements)")
    return np.ascontiguousarray(data.reshape(rows, cols).astype(dtype, copy=False))


def read_vector(path, dtype=np.float64):
    """Read an (N, 1) file as a 1-D vector, validating cols == 1."""
    rows, cols = read_header(path)
    if cols != 1:
        raise ValueError(f"{path}: not a vector (cols={cols})")
    return read_matrix(path, dtype=dtype).reshape(rows)


def read_matrix_rows(path, row_start, num_rows, dtype=np.float64):
    """Read the row block [row_start, row_start+num_rows) of a matrix file
    (lam_tpu/io.py:112): each rank of a sharded solve reads only its own
    rows, the analog of the reference's per-rank MPI-IO seek and read."""
    rows, cols = read_header(path)
    # Python ints: a numpy int32 row index (a walk table's) would overflow
    # the byte offset of a file over 2 GiB
    row_start, num_rows = int(row_start), int(num_rows)
    if row_start + num_rows > rows:
        raise ValueError(f"row block [{row_start}, {row_start + num_rows}) "
                         f"out of range for {rows}-row matrix")
    if _is_npy(path):
        mm = _open_npy(path)
        return np.ascontiguousarray(
            np.array(mm[row_start:row_start + num_rows]).astype(
                dtype, copy=False))
    offset = _HEADER.size + row_start * cols * 8
    count = num_rows * cols

    def truncated(present):
        return IOError(f"{path}: truncated payload ({present} of {count} "
                       f"elements in row block [{row_start}, "
                       f"{row_start + num_rows}))")
    if dtype == np.float64:
        from lam_tpu_torch import _native_io
        if _native_io.available():
            # the numpy branch's error, from the file's size
            present = (os.path.getsize(path) - offset) // 8
            if present < count:
                raise truncated(max(0, present))
            return _native_io.read_rows(path, row_start, num_rows, cols)
    data = np.fromfile(path, dtype=np.float64, count=count, offset=offset)
    if data.size != count:
        raise truncated(data.size)
    return np.ascontiguousarray(
        data.reshape(num_rows, cols).astype(dtype, copy=False))


def read_matrix_block(path, row_start, col_start, num_rows, num_cols,
                      dtype=np.float64):
    """Read the (num_rows, num_cols) block at (row_start, col_start) of a
    matrix file (lam_tpu/io.py:142): the column-windowed 2-D analog of
    `read_matrix_rows` for the 2-D grid. Only the block's bytes are read
    (a per-row window of a memory map); full-row reads would amplify the
    I/O R times on an R x R grid."""
    rows, cols = read_header(path)
    if row_start + num_rows > rows or col_start + num_cols > cols:
        raise ValueError(
            f"block [{row_start}:{row_start + num_rows}, "
            f"{col_start}:{col_start + num_cols}) out of range for "
            f"{rows}x{cols} matrix")
    mm = (_open_npy(path) if _is_npy(path) else
          np.memmap(path, dtype=np.float64, mode="r", offset=_HEADER.size,
                    shape=(rows, cols)))
    block = np.array(mm[row_start:row_start + num_rows,
                        col_start:col_start + num_cols])
    del mm
    return np.ascontiguousarray(block.astype(dtype, copy=False))


def open_matrix_memmap(path):
    """Memory-map a square f64 matrix file (.npy or the binary format)
    without reading it (lam_tpu/solver/operators.py:71-99). The map's
    `offset` is the byte where the row-major data starts (16, or the
    .npy header's length): the native packs read the file from there. It
    is C-ordered, so its transpose is the F-ordered view that BLAS's
    dsymv takes without a copy (solver/host_outer.py)."""
    path = str(path)
    if _is_npy(path):
        a = np.load(path, mmap_mode="r")
        if a.dtype != np.float64:
            raise ValueError(f"{path}: expected float64, got {a.dtype}")
    else:
        # the header checked before mapping: an overstated size would
        # otherwise fail as a raw mmap error
        n = square_size(path)
        a = np.memmap(path, dtype=np.float64, mode="r",
                      offset=_HEADER.size, shape=(n, n))
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"{path}: matrix must be square, got {a.shape}")
    return a


def write_matrix(path, array):
    """Write a matrix/vector in the binary format; 1-D arrays are written
    as (N, 1) column vectors."""
    a = np.asarray(array, dtype=np.float64)
    if a.ndim == 1:
        a = a.reshape(-1, 1)
    if a.ndim != 2:
        raise ValueError(f"expected 1-D or 2-D array, got shape {a.shape}")
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(a.shape[0], a.shape[1]))
        np.ascontiguousarray(a).tofile(f)
