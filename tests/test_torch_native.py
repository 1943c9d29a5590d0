"""The port's native host library (lam_tpu_torch/_native_io.py) on the CPU.

Every binding against the port's numpy branch that stays beside its call
site and against lam_tpu's numpy branch (`DenseOperator._host_pack_tri` /
`_host_pack_planes`, `io.read_matrix_rows`, `generate.tridiagonal_rows`,
the host split), bit for bit, at n below one 512-wide tile, not a
multiple of it and a multiple of it, from both file formats; the fq range
pack over several splittings against the whole pack; the cache files of
a native cold pack against lam_tpu's; the build (one library when two
processes build at once, a failed compile raised with g++'s output, no
g++: the numpy branch).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from lam_tpu import _native_io as j_native
from lam_tpu import generate as jgen
from lam_tpu import io as jio
from lam_tpu.solver import operators as jops
from lam_tpu.solver import pack_cache as jpc
from lam_tpu_torch import DenseOperator, _native_io
from lam_tpu_torch import generate as tgen
from lam_tpu_torch import io as tio
from lam_tpu_torch.precision import split_f64_host
from lam_tpu_torch.solver import operators as tops
from lam_tpu_torch.solver import pack_cache as pc

ROOT = pathlib.Path(__file__).resolve().parent.parent
TB = 512
SIZES = [300, 700, 1024]      # below a tile, ragged, a multiple
FORMATS = ["bin", "npy"]


@pytest.fixture(autouse=True)
def _lam_tpu_numpy(monkeypatch):
    """lam_tpu's numpy branches: its own native library switched off."""
    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setattr(jio, "_native", lambda: None)


def _matrix(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)) * np.exp(rng.uniform(-8, 8, (n, n)))
    a = m + m.T
    a[np.diag_indices(n)] += n
    a[0, :] = a[:, 0] = 0.0          # a zero row: zero-scale tiles
    a[0, 0] = 1.0
    return a


def _file(tmp_path, a, fmt):
    path = str(tmp_path / f"A.{fmt}")
    if fmt == "npy":
        np.save(path, a)
    else:
        tio.write_matrix(path, a)
    return path


def _numpy(monkeypatch):
    monkeypatch.setattr(_native_io, "available", lambda: False)


def _equal(mine, ref):
    assert len(mine) == len(ref)
    for x, y in zip(mine, ref):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == np.ascontiguousarray(y).tobytes()


def test_library_builds_and_counts():
    assert _native_io.available()
    assert _native_io.library_path().exists()
    _native_io.reset_calls()
    _native_io.split_f64(np.ones(3))
    _native_io.split_f64(np.ones(3))
    assert _native_io.calls() == {"split_f64": 2}
    _native_io.reset_calls()
    assert _native_io.calls() == {}


def test_source_is_the_packages_copy():
    """Below its header block the port's source is native/lam_native.cpp."""
    mine = _native_io.SOURCE.read_text()
    ref = (ROOT / "native" / "lam_native.cpp").read_text()
    head = mine.index("// lam_native: threaded binary IO")
    assert mine[head:] == ref
    assert "lam_tpu_torch/_build" in mine[:head]


@pytest.mark.parametrize("storage", ["fq", "dfq"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n", SIZES)
def test_quantized_packs_byte_equal(tmp_path, monkeypatch, n, fmt, storage):
    a = _matrix(n, seed=n)
    path = _file(tmp_path, a, fmt)
    mm = tio.open_matrix_memmap(path)
    n_p = -(-n // TB) * TB
    mine = getattr(_native_io, f"pack_{storage}")(path, mm.offset, n, n_p, TB)
    ref_j = jops.DenseOperator._host_pack_tri(a, storage, TB)
    _equal(mine, ref_j)
    _numpy(monkeypatch)
    _equal(mine, tops._host_pack_tri(mm, storage, TB))


@pytest.mark.parametrize("precision", ["f32", "df64"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n", SIZES)
def test_plane_packs_byte_equal(tmp_path, monkeypatch, n, fmt, precision):
    a = _matrix(n, seed=n + 1)
    path = _file(tmp_path, a, fmt)
    mm = tio.open_matrix_memmap(path)
    n_p = -(-n // TB) * TB
    mine = getattr(_native_io, f"pack_{precision}")(path, mm.offset, n, n_p,
                                                    TB)
    _equal(mine, jops.DenseOperator._host_pack_planes(a, precision, TB))
    _numpy(monkeypatch)
    _equal(mine, tops._host_pack_planes(mm, precision, TB))


@pytest.mark.parametrize("splits", [[], [1], [2], [1, 2]], ids=str)
def test_fq_range_pack_equals_the_whole_pack(tmp_path, splits):
    n = 1100                          # 3 tile rows, 6 tiles padded to 8
    a = _matrix(n, seed=11)
    path = _file(tmp_path, a, "bin")
    n_p = 1536
    whole = _native_io.pack_fq(path, 16, n, n_p, TB)
    bufs = _native_io.alloc_fq_buffers(n_p, TB)
    bounds = [0, *splits, 3]
    for r0, r1 in zip(bounds, bounds[1:]):
        _native_io.pack_fq_range(path, 16, n, n_p, TB, r0, r1, bufs)
    _equal(bufs, whole)


@pytest.mark.parametrize("fmt", FORMATS)
def test_read_rows_call_site(tmp_path, monkeypatch, fmt):
    a = _matrix(700, seed=3)
    path = _file(tmp_path, a, fmt)
    _native_io.reset_calls()
    mine = tio.read_matrix_rows(path, 129, 300)
    # the native reader takes the binary format; a .npy stays numpy
    assert _native_io.calls().get("read_rows", 0) == (fmt == "bin")
    _equal((mine,), (jio.read_matrix_rows(path, 129, 300),))
    _equal((mine,), (a[129:429],))
    if fmt == "bin":
        _equal((_native_io.read_rows(path, 0, 700, 700),), (a,))
        hi, lo = _native_io.read_rows_split(path, 5, 10, 700)
        _equal((hi, lo), split_f64_host(a[5:15]))
    _numpy(monkeypatch)
    _equal((tio.read_matrix_rows(path, 129, 300),), (mine,))


def test_native_row_reads_past_2_gib(tmp_path):
    """At N=20000 row 15360 starts 2.46e9 bytes in: the native reader's
    uint64 offset reaches it (a sparse file, two rows written there),
    from the int32 row index a walk table gives."""
    n, r0 = 20000, 15360
    rows = np.arange(2 * n, dtype=np.float64).reshape(2, n) - 7.5
    path = str(tmp_path / "A.bin")
    with open(path, "wb") as f:
        f.write(tio._HEADER.pack(n, n))
        f.seek(16 + r0 * n * 8)
        rows.tofile(f)
        f.truncate(16 + n * n * 8)
    _native_io.reset_calls()
    got = tio.read_matrix_rows(path, np.int32(30) * 512, np.int32(2))
    assert _native_io.calls() == {"read_rows": 1}
    _equal((got,), (rows,))
    _equal((tio.read_matrix_rows(path, r0 + 2, 1),), (np.zeros((1, n)),))


def test_split_and_tridiagonal_call_sites(monkeypatch):
    x = _matrix(300, seed=4)[:, :77]              # a strided view
    _native_io.reset_calls()
    mine = split_f64_host(x)
    rows = tgen.tridiagonal_rows(37, 50, 300)
    assert _native_io.calls() == {"split_f64": 1, "tridiagonal_rows": 1}
    hi = x.astype(np.float32)
    _equal(mine, (hi, (x - hi.astype(np.float64)).astype(np.float32)))
    _equal((rows,), (jgen.tridiagonal_rows(37, 50, 300),))
    _equal(_native_io.tridiagonal_rows_split(0, 300, 300),
           split_f64_host(jgen.tridiagonal_rows(0, 300, 300)))
    _numpy(monkeypatch)
    _native_io.reset_calls()
    _equal(split_f64_host(x), mine)
    _equal((tgen.tridiagonal_rows(37, 50, 300),), (rows,))
    assert _native_io.calls() == {}


def test_write_matrix_matches_the_python_writer(tmp_path):
    a = _matrix(200, seed=5)
    _native_io.write_matrix(str(tmp_path / "n.bin"), a)
    tio.write_matrix(str(tmp_path / "p.bin"), a)
    assert ((tmp_path / "n.bin").read_bytes()
            == (tmp_path / "p.bin").read_bytes())


@pytest.mark.parametrize("storage", ["fq", "dfq", "f32", "df64"])
def test_cold_pack_cache_file_equals_lam_tpus(tmp_path, storage):
    """A native cold pack publishes the very bytes lam_tpu writes, and
    each package reads the other's file."""
    a = _matrix(700, seed=6)
    src = _file(tmp_path, a, "bin")
    _native_io.reset_calls()
    op = getattr(DenseOperator, f"from_file_{storage}")(src, pack_cache=True,
                                                        device="cpu")
    assert sum(_native_io.calls().values()) > 0
    mine = pathlib.Path(pc.cache_path(src, storage)).read_bytes()
    os.remove(pc.cache_path(src, storage))
    ref = (jops.DenseOperator._host_pack_tri(a, storage, TB)
           if storage in ("fq", "dfq")
           else jops.DenseOperator._host_pack_planes(a, storage, TB))
    assert jpc.save(src, storage, 700, 1024, TB, ref)
    assert pathlib.Path(jpc.cache_path(src, storage)).read_bytes() == mine
    warm = getattr(DenseOperator, f"from_file_{storage}")(
        src, pack_cache=True, device="cpu")
    operands = ((op.operand,), (warm.operand,)) if storage == "f32" else (
        op.operand, warm.operand)
    _equal(operands[1], tuple(x.numpy() for x in operands[0]))


def test_from_file_takes_the_native_pack_and_the_numpy_fallback(
        tmp_path, monkeypatch):
    a = _matrix(700, seed=7)
    src = _file(tmp_path, a, "npy")
    _native_io.reset_calls()
    nat = DenseOperator.from_file_dfq(src, device="cpu")
    assert _native_io.calls() == {"pack_dfq": 1}
    _numpy(monkeypatch)
    _native_io.reset_calls()
    ref = DenseOperator.from_file_dfq(src, device="cpu")
    assert _native_io.calls() == {}
    _equal(nat.operand, tuple(x.numpy() for x in ref.operand))


_BUILD = """
import pathlib, sys
from lam_tpu_torch import _native_io as m
m.BUILD_DIR = pathlib.Path(sys.argv[1])
assert m.available()
rows = m.tridiagonal_rows(0, 4, 4)
assert rows.tolist() == [[2, 1, 0, 0], [1, 2, 1, 0], [0, 1, 2, 1], [0, 0, 1, 2]]
print(m.library_path())
"""


def test_two_processes_build_one_library(tmp_path):
    cmd = [sys.executable, "-c", _BUILD, str(tmp_path / "build")]
    procs = [subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert outs[0][0] == outs[1][0]
    built = sorted(os.listdir(tmp_path / "build"))
    assert built == [pathlib.Path(outs[0][0].strip()).name]


def _fresh(monkeypatch, tmp_path):
    monkeypatch.setattr(_native_io, "_LIB", None)
    monkeypatch.setattr(_native_io, "_TRIED", False)
    monkeypatch.setattr(_native_io, "BUILD_DIR", tmp_path / "build")


def test_a_failed_compile_raises_with_gpps_output(tmp_path, monkeypatch):
    broken = tmp_path / "lam_native.cpp"
    broken.write_text("int ln_read_rows( {\n")
    _fresh(monkeypatch, tmp_path)
    monkeypatch.setattr(_native_io, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        _native_io.available()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_no_gpp_takes_the_numpy_branch(tmp_path, monkeypatch):
    _fresh(monkeypatch, tmp_path)
    monkeypatch.setattr(_native_io.shutil, "which", lambda name: None)
    assert not _native_io.available()
    assert not _native_io.has_pack("fq") and not _native_io.has_range_pack(
        "fq")
    a = _matrix(700, seed=8)
    src = _file(tmp_path, a, "bin")
    _native_io.reset_calls()
    op = DenseOperator.from_file_fq(src, device="cpu")
    assert _native_io.calls() == {}
    _equal(op.operand, jops.DenseOperator._host_pack_tri(a, "fq", TB))
