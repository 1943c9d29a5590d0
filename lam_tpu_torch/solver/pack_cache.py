"""On-disk cache of packed triangle planes, beside the matrix file.

The whole-matrix cache of lam_tpu/solver/pack_cache.py (`MAGIC`,
`_PREC_CODE`, `cache_path`, `_buffer_specs`, `save`, `_validate`,
`load`, pack_cache.py:59-192), byte for byte, for the precisions the
port packs: 'dfq', 'fq', 'f32' and 'df64'. Either package reads a cache the
other wrote. `load_device` (pack_cache.py:195-220) streams each buffer
to the device through pinned staging slots while the next chunk is read
(ops/transfer.py), and `load_device_fq_q1` (:223-285) streams only the
buffers the irfq inner matvec reads, q1, s1, dh and dl, seeking past the
rest: the q1-only operator of the host outer loop
(`DenseOperator.from_file_fq_q1`, solver/host_outer.py).

File format (version 2, little-endian):
    8 bytes   magic b"LAMPACK2"
    6 x u64   precision code (1=dfq, 2=fq, 3=f32, 4=df64), n,
              n_padded, tb, source file size, source file mtime_ns
    raw buffers in operand order
      dfq:  hi (T*tb, tb) f32 | loq (T*tb, tb) i16 | sc (T,) f32
            | dh, dl (n_p,) f32
      fq:   q1, q2, q3 (Tq*tb, tb) i16 | s1, s2, s3 (Tq,) f32
            | dh, dl (n_p,) f32
      f32:  hi (T*tb, tb) f32
      df64: hi (T*tb, tb) f32 | lo (T*tb, tb) f32
with T = tri_tile_count(n_padded/tb) and Tq = padded_tri_tile_count.
The source (size, mtime_ns) pair makes the cache self-invalidating. A
load never raises on a bad cache: any mismatch or truncation returns
None and the caller repacks (and overwrites). Any change to the bytes a
pack produces for the same source must bump the magic.

The per-shard cache of the sharded quantized builds
(`shard_cache_path`, `save_shard`, `load_shard`, pack_cache.py:288-398),
byte for byte as well: each rank packs its own share in a layout that
depends on the mesh, so each shard has a file of its own,
`<src>.shardpack/<precision>.<topo><size>.s<idx>` (topo 'g': the 1-D
band-pair mesh), keyed on the whole placement and the source's (size,
mtime_ns): a rank touches only its own file, and a run on another mesh
misses and repacks.

Shard file format (version 1, little-endian):
    8 bytes  magic b"LAMSHRD1"
    9 x u64  precision code, n, n_padded, tb, topo code (1 = 'g', 2 =
             'r', the R x R grid), topo size, shard index, source file
             size, source file mtime_ns
    u64      number of buffers
    per buffer: u64 dtype code (1=f32, 2=i16, 3=f64), u64 ndim,
                ndim x u64 dims
    raw buffers, in operand order
Buffer shapes are explicit here: the caller passes the (dtype, shape)
list its topology demands and any difference is a miss.
"""

from __future__ import annotations

import os

import numpy as np

from lam_tpu_torch.ops import layout

MAGIC = b"LAMPACK2"
_PREC_CODE = {"dfq": 1, "fq": 2, "f32": 3, "df64": 4}
_HEADER_WORDS = 6
SHARD_MAGIC = b"LAMSHRD1"
_SHARD_HEADER_WORDS = 9
_TOPO_CODE = {"g": 1, "r": 2}
_DTYPE_CODE = {np.dtype(np.float32): 1, np.dtype(np.int16): 2,
               np.dtype(np.float64): 3}


def cache_path(src_path, precision):
    """Cache file published beside the source matrix file."""
    return f"{src_path}.{precision}pack"


def _buffer_specs(precision, n_padded, tb):
    """(dtype, shape) per buffer, in operand order."""
    nblk = n_padded // tb
    T = layout.tri_tile_count(nblk)
    plane = (T * tb, tb)
    diag = (n_padded,)
    if precision == "dfq":
        return [(np.float32, plane), (np.int16, plane), (np.float32, (T,)),
                (np.float32, diag), (np.float32, diag)]
    if precision == "fq":
        tq = layout.padded_tri_tile_count(nblk)
        return ([(np.int16, (tq * tb, tb))] * 3
                + [(np.float32, (tq,))] * 3
                + [(np.float32, diag)] * 2)
    if precision == "f32":
        return [(np.float32, plane)]
    if precision == "df64":
        return [(np.float32, plane)] * 2
    raise ValueError(f"unknown packed precision {precision!r}")


def save(src_path, precision, n, n_padded, tb, bufs, src_stat=None):
    """Atomically publish the packed buffers beside `src_path`.

    Best-effort: an OSError (full disk, read-only directory) removes the
    temporary file and returns False. `src_stat` is the os.stat of the
    source taken before the pack ran; if the source changed since, the
    save is refused (the planes may mix old and new content)."""
    dst = cache_path(src_path, precision)
    tmp = dst + ".tmp"
    try:
        st = os.stat(src_path)
        if src_stat is not None:
            if (st.st_size != src_stat.st_size
                    or st.st_mtime_ns != src_stat.st_mtime_ns):
                return False  # source rewritten mid-pack
            st = src_stat
        header = np.array(
            [_PREC_CODE[precision], n, n_padded, tb, st.st_size,
             st.st_mtime_ns], dtype="<u8")
        with open(tmp, "wb") as fh:
            fh.write(MAGIC)
            header.tofile(fh)
            for buf in bufs:
                np.ascontiguousarray(buf).tofile(fh)
        os.replace(tmp, dst)
        return True
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _validate(fh, src_path, precision):
    """(n, n_padded, tb, specs) with the stream at the first buffer byte,
    or None on any header, source-identity or payload-size mismatch."""
    src_st = os.stat(src_path)
    if fh.read(len(MAGIC)) != MAGIC:
        return None
    header = np.fromfile(fh, dtype="<u8", count=_HEADER_WORDS)
    if header.size != _HEADER_WORDS:
        return None
    code, n, n_padded, tb, src_size, src_mtime = (int(v) for v in header)
    if (code != _PREC_CODE[precision] or tb == 0
            or n_padded % tb != 0 or n > n_padded
            or src_size != src_st.st_size
            or src_mtime != src_st.st_mtime_ns):
        return None
    specs = _buffer_specs(precision, n_padded, tb)
    # size check before any fromfile: a corrupt header could otherwise
    # demand an absurd allocation
    expect = sum(int(np.prod(s)) * np.dtype(d).itemsize for d, s in specs)
    payload = os.fstat(fh.fileno()).st_size - fh.tell()
    if payload != expect:
        return None
    return n, n_padded, tb, specs


def _read_bufs(fh, specs):
    """The buffers of `specs` read in order from the stream, or None when
    one comes up short."""
    bufs = []
    for dtype, shape in specs:
        count = int(np.prod(shape))
        buf = np.fromfile(fh, dtype=dtype, count=count)
        if buf.size != count:
            return None
        bufs.append(buf.reshape(shape))
    return tuple(bufs)


def load(src_path, precision):
    """(n, n_padded, tb, host buffers) from the cache beside `src_path`,
    or None when there is no usable cache (missing, stale against the
    source's (size, mtime_ns), truncated, wrong precision or format)."""
    path = cache_path(src_path, precision)
    try:
        with open(path, "rb") as fh:
            v = _validate(fh, src_path, precision)
            if v is None:
                return None
            n, n_padded, tb, specs = v
            bufs = _read_bufs(fh, specs)
        return None if bufs is None else (n, n_padded, tb, bufs)
    except (OSError, ValueError):
        return None


def _offsets(fh, src_path, precision):
    """(n, n_padded, tb, specs, byte offset of each buffer), or None as
    `_validate`."""
    v = _validate(fh, src_path, precision)
    if v is None:
        return None
    n, n_padded, tb, specs = v
    pos, offs = fh.tell(), []
    for dtype, shape in specs:
        offs.append(pos)
        pos += int(np.prod(shape)) * np.dtype(dtype).itemsize
    return n, n_padded, tb, specs, offs


def load_device(src_path, precision, device, which=None):
    """`load`, each buffer streamed to `device` as it is read
    (transfer.stream_file_to_device): (n, n_padded, tb, device buffers),
    or None with `load`'s no-usable-cache rules. `which` picks buffers by
    operand index (default: all of them); the others are skipped."""
    from lam_tpu_torch.ops import transfer
    path = cache_path(src_path, precision)
    try:
        with open(path, "rb") as fh:
            v = _offsets(fh, src_path, precision)
        if v is None:
            return None
        n, n_padded, tb, specs, offs = v
        idx = range(len(specs)) if which is None else which
        bufs = tuple(transfer.stream_file_to_device(path, offs[i], *specs[i],
                                                    device) for i in idx)
        return n, n_padded, tb, bufs
    except (OSError, ValueError):
        return None


def load_device_fq_q1(src_path, device):
    """The partial fq load of the host outer loop: only q1, s1, dh and dl
    (operand indices 0, 3, 6 and 7) streamed to `device`, q2, q3, s2 and
    s3 skipped. (n, n_padded, tb, (q1, s1, dh, dl)) or None with `load`'s
    rules."""
    return load_device(src_path, "fq", device, which=(0, 3, 6, 7))


def shard_cache_path(src_path, precision, topo, topo_size, shard_idx):
    """One shard's cache file, in `<src>.shardpack/` beside the source."""
    return os.path.join(f"{src_path}.shardpack",
                        f"{precision}.{topo}{topo_size}.s{shard_idx}")


def save_shard(src_path, precision, topo, topo_size, shard_idx, n, n_padded,
               tb, bufs, src_stat=None):
    """Atomically publish one shard's packed buffers. Best-effort (False
    on any OSError); refused when the source's stat no longer matches
    the pre-pack `src_stat`, as `save`."""
    dst = shard_cache_path(src_path, precision, topo, topo_size, shard_idx)
    tmp = dst + ".tmp"
    try:
        st = os.stat(src_path)
        if src_stat is not None:
            if (st.st_size != src_stat.st_size
                    or st.st_mtime_ns != src_stat.st_mtime_ns):
                return False
            st = src_stat
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        header = np.array(
            [_PREC_CODE[precision], n, n_padded, tb, _TOPO_CODE[topo],
             topo_size, shard_idx, st.st_size, st.st_mtime_ns], dtype="<u8")
        arrs = [np.ascontiguousarray(buf) for buf in bufs]
        with open(tmp, "wb") as fh:
            fh.write(SHARD_MAGIC)
            header.tofile(fh)
            np.array([len(arrs)], dtype="<u8").tofile(fh)
            for arr in arrs:
                np.array([_DTYPE_CODE[arr.dtype], arr.ndim, *arr.shape],
                         dtype="<u8").tofile(fh)
            for arr in arrs:
                arr.tofile(fh)
        os.replace(tmp, dst)
        return True
    except (OSError, KeyError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _read_shard_specs(fh, count):
    """The `count` recorded (dtype, shape) pairs, or None when short or
    implausible."""
    rev_dtype = {v: k for k, v in _DTYPE_CODE.items()}
    specs = []
    for _ in range(count):
        meta = np.fromfile(fh, dtype="<u8", count=2)
        if meta.size != 2:
            return None
        dcode, ndim = int(meta[0]), int(meta[1])
        if dcode not in rev_dtype or ndim > 4:
            return None
        dims = np.fromfile(fh, dtype="<u8", count=ndim)
        if dims.size != ndim:
            return None
        specs.append((rev_dtype[dcode], tuple(int(d) for d in dims)))
    return specs


def load_shard(src_path, precision, topo, topo_size, shard_idx, n, n_padded,
               tb, expected_specs):
    """One shard's host buffers, or None: missing, stale, truncated, or
    any difference in identity or in the recorded buffers against
    `expected_specs`, the (dtype, shape) list the caller's topology
    demands. Never raises on a bad cache."""
    path = shard_cache_path(src_path, precision, topo, topo_size, shard_idx)
    want = [_PREC_CODE[precision], n, n_padded, tb, _TOPO_CODE[topo],
            topo_size, shard_idx]
    try:
        src_st = os.stat(src_path)
        with open(path, "rb") as fh:
            if fh.read(len(SHARD_MAGIC)) != SHARD_MAGIC:
                return None
            header = np.fromfile(fh, dtype="<u8", count=_SHARD_HEADER_WORDS)
            if header.size != _SHARD_HEADER_WORDS:
                return None
            if [int(v) for v in header] != want + [src_st.st_size,
                                                   src_st.st_mtime_ns]:
                return None
            nb = np.fromfile(fh, dtype="<u8", count=1)
            if nb.size != 1 or int(nb[0]) != len(expected_specs):
                return None
            specs = _read_shard_specs(fh, len(expected_specs))
            if specs is None or specs != [(np.dtype(d), tuple(s))
                                          for d, s in expected_specs]:
                return None
            # size check before any payload fromfile (as `_validate`)
            expect = sum(int(np.prod(s)) * d.itemsize for d, s in specs)
            if os.fstat(fh.fileno()).st_size - fh.tell() != expect:
                return None
            return _read_bufs(fh, specs)
    except (OSError, ValueError):
        return None
