"""The port's staged uploads (lam_tpu_torch/ops/transfer.py) on the CPU.

On the CPU the staging slots are plain memory and each copy is
synchronous, but the chunking, the slot ring, the reader thread and the
windows are the card's: `to_device`, `stream_file_to_device` and `Folder`
against a plain read, bit for bit, across chunk boundaries (rows that do
not fill the last chunk, a file offset, a plane of many slots); a short
read raises; the pack cache's device loads against `load`; the streamed
cold fq build against the plain pack, over several range-pack calls, and
a worker's failure raised in the caller.
"""

import numpy as np
import pytest
import torch

from lam_tpu_torch import DenseOperator, _native_io
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import transfer
from lam_tpu_torch.solver import operators as tops
from lam_tpu_torch.solver import pack_cache as pc

DTYPES = [np.float32, np.int16, np.float64]


def _plane(dtype, rows=1003, cols=24, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.int16:
        return rng.integers(-32767, 32768, (rows, cols)).astype(np.int16)
    return rng.standard_normal((rows, cols)).astype(dtype)


def _same(t, ref):
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    x = t.numpy()
    assert x.dtype == ref.dtype and x.shape == ref.shape
    assert x.tobytes() == np.ascontiguousarray(ref).tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_to_device_in_chunks_is_the_plain_copy(dtype):
    host = _plane(dtype)
    # 7 rows a slot: 144 chunks through a ring of 3 slots, the last short
    _same(transfer.to_device(host, "cpu", chunk_bytes=7 * 24 * host.itemsize),
          host)
    view = host[::2, 3:]                    # not contiguous
    _same(transfer.to_device(view, "cpu", chunk_bytes=512), view)
    # slots of MIN_STAGED and more are filled by COPY_THREADS threads
    big = _plane(dtype, rows=5003, cols=1024, seed=5)
    _same(transfer.to_device(big, "cpu",
                             chunk_bytes=transfer.MIN_STAGED * 2), big)
    _same(transfer.to_device(big, "cpu"), big)


def test_stream_file_of_one_slot(tmp_path):
    """A plane of one chunk and MIN_STAGED bytes or more takes one slot,
    read by COPY_THREADS threads."""
    host = _plane(np.float32, rows=2 * 1024 + 5, cols=1024, seed=6)
    path = tmp_path / "one.bin"
    host.tofile(path)
    assert transfer.MIN_STAGED <= host.nbytes < transfer.CHUNK_BYTES
    _same(transfer.stream_file_to_device(str(path), 0, np.float32,
                                         host.shape, "cpu"), host)


def test_to_device_small_tensors_and_copies():
    host = np.arange(10, dtype=np.float32)
    out = transfer.to_device(host, "cpu")
    _same(out, host)
    host[0] = 99.0                          # a copy, not a view
    assert out[0] == 0.0
    t = torch.ones(3)
    assert transfer.to_device(t, "cpu") is t
    _same(transfer.to_device(np.float64(2.5), "cpu"),
          np.asarray(2.5))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk_rows", [2, 5, 64, 1003])
def test_stream_file_to_device_is_the_plain_read(tmp_path, dtype, chunk_rows):
    host = _plane(dtype, seed=1)
    path = tmp_path / "plane.bin"
    with open(path, "wb") as fh:
        fh.write(b"x" * 40)                 # the plane starts at byte 40
        host.tofile(fh)
        fh.write(b"tail")
    out = transfer.stream_file_to_device(
        str(path), 40, dtype, host.shape, "cpu",
        chunk_bytes=chunk_rows * 24 * host.itemsize)
    _same(out, host)
    flat = transfer.stream_file_to_device(str(path), 40, dtype,
                                          (host.size,), "cpu",
                                          chunk_bytes=4096)
    _same(flat, host.reshape(-1))


@pytest.mark.parametrize("chunk_bytes", [None, 480])
def test_stream_file_to_device_short_read_raises(tmp_path, chunk_bytes):
    host = _plane(np.float32, rows=100, cols=5)
    path = tmp_path / "short.bin"
    host[:-1].tofile(path)                  # one row short
    with pytest.raises(IOError, match="short read"):
        transfer.stream_file_to_device(str(path), 0, np.float32, host.shape,
                                       "cpu", chunk_bytes=chunk_bytes)


@pytest.mark.parametrize("dtype", DTYPES)
def test_folder_windows_are_the_plain_copy(dtype):
    host = _plane(dtype, seed=2)
    fill = np.zeros_like(host)
    f = transfer.Folder(host.shape, dtype, "cpu",
                        chunk_bytes=10 * 24 * host.itemsize)
    for avail in (0, 7, 10, 10, 333, 990, 1002):
        fill[:avail] = host[:avail]         # rows [0, avail) are final
        f.advance(fill, avail)
        assert f.done <= avail
        with pytest.raises(RuntimeError, match="not finished"):
            f.result()
    fill[:] = host
    f.advance(fill, host.shape[0])
    _same(f.result(), host)


def test_folder_of_a_plane_below_one_chunk():
    host = _plane(np.int16, rows=9, cols=4)
    f = transfer.Folder(host.shape, np.int16, "cpu")
    f.advance(host, 5)
    assert f.done == 0
    f.advance(host, 9)
    _same(f.result(), host)


@pytest.fixture()
def src(tmp_path):
    rng = np.random.default_rng(3)
    m = rng.standard_normal((700, 700))
    a = m + m.T + 700 * np.eye(700)
    path = str(tmp_path / "A.bin")
    tio.write_matrix(path, a)
    return path, a


@pytest.mark.parametrize("precision", ["fq", "dfq", "f32", "df64"])
def test_pack_cache_load_device_is_load(src, monkeypatch, precision):
    path, _ = src
    getattr(DenseOperator, f"from_file_{precision}")(path, pack_cache=True,
                                                     device="cpu")
    ref = pc.load(path, precision)
    monkeypatch.setattr(transfer, "CHUNK_BYTES", 1 << 16)  # many slots
    hit = pc.load_device(path, precision, "cpu")
    assert hit[:3] == ref[:3] == (700, 1024, 512)
    for t, x in zip(hit[3], ref[3]):
        _same(t, x)
    if precision == "fq":
        q1 = pc.load_device_fq_q1(path, "cpu")
        assert q1[:3] == ref[:3]
        for t, i in zip(q1[3], (0, 3, 6, 7)):
            _same(t, ref[3][i])
    with open(pc.cache_path(path, precision), "r+b") as fh:
        fh.truncate(fh.seek(0, 2) - 1)
    assert pc.load_device(path, precision, "cpu") is None
    assert pc.load_device_fq_q1(path, "cpu") is None


@pytest.mark.parametrize("chunk_tiles", [1, 2, 512])
def test_streamed_cold_fq_build_is_the_plain_pack(tmp_path, monkeypatch,
                                                  chunk_tiles):
    rng = np.random.default_rng(4)
    m = rng.standard_normal((1100, 1100))
    a = m + m.T
    path = str(tmp_path / "A.npy")
    np.save(path, a)
    ref = tops._host_pack_tri(a, "fq", 512)
    monkeypatch.setattr(tops, "PACK_CHUNK_TILES", chunk_tiles)
    monkeypatch.setattr(transfer, "CHUNK_BYTES", 64 * 1024)  # 64 rows
    calls = []
    orig = _native_io.pack_fq_range

    def counted(*args):
        calls.append(args[5:7])
        return orig(*args)

    monkeypatch.setattr(_native_io, "pack_fq_range", counted)
    op = DenseOperator.from_file_fq(path, pack_cache=True, device="cpu")
    assert calls == {1: [(0, 1), (1, 2), (2, 3)], 2: [(0, 2), (2, 3)],
                     512: [(0, 3)]}[chunk_tiles]
    for t, x in zip(op.operand, ref):
        _same(t, x)
    for x, y in zip(pc.load(path, "fq")[3], ref):
        assert x.tobytes() == y.tobytes()


def test_a_range_pack_failure_reaches_the_caller(tmp_path, monkeypatch):
    path = str(tmp_path / "A.bin")
    tio.write_matrix(path, np.eye(1100))
    monkeypatch.setattr(tops, "PACK_CHUNK_TILES", 1)
    orig = _native_io.pack_fq_range

    def fail_second(*args):
        if args[5] == 1:
            raise IOError("disk gone")
        return orig(*args)

    monkeypatch.setattr(_native_io, "pack_fq_range", fail_second)
    with pytest.raises(IOError, match="disk gone"):
        DenseOperator.from_file_fq(path, pack_cache=True, device="cpu")
    assert pc.load(path, "fq") is None     # nothing published
