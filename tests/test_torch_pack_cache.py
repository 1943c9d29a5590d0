"""The port's pack cache (`<matrix file>.<precision>pack`) against lam_tpu's,
on the CPU: the same bytes on disk, each package reading what the other
wrote, the same refusals of a stale or damaged cache, and the same operand
from a cold pack and a warm cache read.
"""

import os

import numpy as np
import pytest
import torch

from lam_tpu import generate as jgen
from lam_tpu.solver import operators as jops
from lam_tpu.solver import pack_cache as jpc
from lam_tpu_torch import DenseOperator
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import layout
from lam_tpu_torch.solver import operators as tops
from lam_tpu_torch.solver import pack_cache as pc

N, TB = 700, 512  # n_p = 1024: nblk=2, T=3 tiles, fq planes padded to 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def matrix():
    return jgen.random_spd_system(N, seed=50)[0]


@pytest.fixture
def src(tmp_path, matrix):
    path = str(tmp_path / "A.bin")
    tio.write_matrix(path, matrix)
    return path


def _jax_bufs(a, precision):
    if precision == "fq":
        return jops.DenseOperator._host_pack_tri(a, "fq", TB)
    return jops.DenseOperator._host_pack_planes(a, precision, TB)


def _same(bufs, ref):
    assert len(bufs) == len(ref)
    for x, y in zip(bufs, ref):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


@pytest.mark.parametrize("precision", ["fq", "f32", "df64"])
def test_cache_files_are_byte_identical_and_interchangeable(src, matrix,
                                                            precision):
    n_p = layout.padded_size(N, TB)
    bufs = _jax_bufs(matrix, precision)
    st = os.stat(src)
    assert jpc.save(src, precision, N, n_p, TB, bufs, src_stat=st)
    theirs = open(pc.cache_path(src, precision), "rb").read()
    hit = pc.load(src, precision)  # lam_tpu wrote, the port reads
    assert hit is not None and hit[:3] == (N, n_p, TB)
    _same(hit[3], bufs)
    os.remove(pc.cache_path(src, precision))
    assert pc.save(src, precision, N, n_p, TB, bufs, src_stat=st)
    assert open(pc.cache_path(src, precision), "rb").read() == theirs
    hit = jpc.load(src, precision)  # the port wrote, lam_tpu reads
    assert hit is not None and hit[:3] == (N, n_p, TB)
    _same(hit[3], bufs)


def _stale_size(src, cache):
    with open(src, "ab") as fh:
        fh.write(b"\0" * 8)


def _stale_mtime(src, cache):
    st = os.stat(src)
    os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))


def _truncated(src, cache):
    os.truncate(cache, os.path.getsize(cache) - 2)


def _wrong_magic(src, cache):
    with open(cache, "r+b") as fh:
        fh.write(b"LAMPACK1")


def _wrong_precision(src, cache):
    with open(cache, "r+b") as fh:  # header word 0: the precision code
        fh.seek(8)
        fh.write(np.array([3], "<u8").tobytes())


@pytest.mark.parametrize("damage", [_stale_size, _stale_mtime, _truncated,
                                    _wrong_magic, _wrong_precision],
                         ids=lambda f: f.__name__.strip("_"))
def test_bad_cache_is_refused_then_repacked(src, matrix, damage):
    cold = DenseOperator.from_file_fq(src, pack_cache=True, device="cpu")
    cache = pc.cache_path(src, "fq")
    assert pc.load(src, "fq") is not None
    damage(src, cache)
    assert pc.load(src, "fq") is None
    assert jpc.load(src, "fq") is None  # lam_tpu refuses it too
    again = DenseOperator.from_file_fq(src, pack_cache=True, device="cpu")
    for x, y in zip(again.operand, cold.operand):
        assert torch.equal(x, y)
    assert pc.load(src, "fq") is not None  # the repack was published


def test_from_file_fq_cold_then_warm(src, matrix, monkeypatch):
    cold = DenseOperator.from_file_fq(src, pack_cache=True, device="cpu")
    ref = tops._host_pack_tri(matrix, "fq", TB)
    for x, y in zip(cold.operand, ref):
        assert np.array_equal(x.numpy(), y)

    def no_pack(*args):
        raise AssertionError("a warm load must not pack")

    monkeypatch.setattr(tops, "_host_pack_tri", no_pack)
    warm = DenseOperator.from_file_fq(src, pack_cache=True, device="cpu")
    assert (warm.n, warm.n_padded, warm.precision) == (N, 1024, "fq")
    for x, y in zip(warm.operand, cold.operand):
        assert x.dtype == y.dtype and torch.equal(x, y)
    p = warm.prepare_b(np.random.default_rng(51).uniform(-1, 1, N))
    assert torch.equal(warm.matvec(p), cold.matvec(p))


def test_plane_precisions_use_the_cache(src, matrix):
    for precision in ("f32", "df64"):
        ctor = getattr(DenseOperator, f"from_file_{precision}")
        cold = ctor(src, pack_cache=True, device="cpu")
        hit = pc.load(src, precision)
        assert hit is not None
        _same(hit[3], _jax_bufs(matrix, precision))
        warm = ctor(src, pack_cache=True, device="cpu")
        ops = (cold.operand, warm.operand)
        if precision == "f32":
            ops = ((cold.operand,), (warm.operand,))
        for x, y in zip(*ops):
            assert torch.equal(x, y)
    assert not os.path.exists(pc.cache_path(src, "fq"))
    assert DenseOperator.from_file_fq(src, device="cpu").precision == "fq"
    assert not os.path.exists(pc.cache_path(src, "fq"))  # off by default
