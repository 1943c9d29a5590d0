"""The port's pack cache (`<matrix file>.<precision>pack`) against lam_tpu's,
on the CPU: the same bytes on disk, each package reading what the other
wrote, the same refusals of a stale or damaged cache, and the same operand
from a cold pack and a warm cache read. The per-shard cache of the
band-pair quantized storages (`<matrix file>.shardpack/<storage>.g<g>.s<c>`)
likewise: lam_tpu's files and the port's are the same bytes, each package
loads the other's, and another mesh size, a touched source or a truncated
file is a miss.
"""

import os

import numpy as np
import pytest
import torch

from lam_tpu import generate as jgen
from lam_tpu.solver import operators as jops
from lam_tpu.parallel import pcg_symm as jpcg_symm
from lam_tpu.parallel.mesh import make_mesh as jmake_mesh
from lam_tpu.solver import pack_cache as jpc
from lam_tpu_torch import DenseOperator
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import layout
from lam_tpu_torch.parallel import mesh as pmesh
from lam_tpu_torch.parallel import pcg_symm
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


# -- the per-shard cache of the band-pair quantized storages ----------------

SHARD_TB = 128


def _shard_op(src, c, g, storage, pack_cache=True, packed=False):
    """Rank c's operator read from the file, as the facade reads it: only
    its bands' rows, with the shard cache where pack_cache is set."""
    return pcg_symm.SymmShardedOperator.from_row_block_fn(
        lambda s, count: tio.read_matrix_rows(src, s, count),
        tio.read_header(src)[0], mesh=pmesh.Mesh(c, g, "cpu"), tb=SHARD_TB,
        packed=packed, precision=storage,
        pack_cache_src=src if pack_cache else None, device="cpu")


def _shard_specs(op, storage):
    T = op.operand[-1].shape[0]
    dtypes, n_scales = tops.QUANT_LAYOUT[storage]
    return ([(dt, (T * SHARD_TB, SHARD_TB)) for dt in dtypes]
            + [(np.float32, (T,))] * n_scales
            + [(np.float32, (2 * op.m,))] * 2)


def _no_quantize(*args):
    raise AssertionError("a warm shard load must not quantize")


@pytest.mark.parametrize("storage", ["dfq", "fq"])
@pytest.mark.parametrize("g", [1, 2])
def test_shard_files_are_byte_identical_and_interchangeable(src, matrix, g,
                                                            storage,
                                                            monkeypatch):
    """lam_tpu's band-pair build with pack_cache_src writes one file per
    shard; the port's ranks read them (no quantization runs), write the
    same bytes themselves, and lam_tpu reads those."""
    ref = jpcg_symm.SymmShardedOperator.from_row_block_fn(
        lambda s, rows: matrix[s:s + rows], N, mesh=jmake_mesh(g),
        tb=SHARD_TB, precision=storage, pack_cache_src=src)
    paths = [pc.shard_cache_path(src, storage, "g", g, c) for c in range(g)]
    assert paths == [jpc.shard_cache_path(src, storage, "g", g, c)
                     for c in range(g)]
    assert paths[0] == f"{src}.shardpack/{storage}.g{g}.s0"
    theirs = [open(path, "rb").read() for path in paths]
    cold = [_shard_op(src, c, g, storage, pack_cache=False)
            for c in range(g)]
    with monkeypatch.context() as mp:  # lam_tpu wrote, the port reads
        mp.setattr(tops, "quantize_storage_tiles", _no_quantize)
        warm = [_shard_op(src, c, g, storage) for c in range(g)]
    for w, c_ in zip(warm, cold):
        assert w.n_padded == ref.n_padded
        for x, y in zip(w.operand, c_.operand):
            assert x.dtype == y.dtype and torch.equal(x, y)
    for path in paths:
        os.remove(path)
    for c in range(g):  # the port writes, lam_tpu reads
        op = _shard_op(src, c, g, storage)
        assert open(paths[c], "rb").read() == theirs[c]
        hit = jpc.load_shard(src, storage, "g", g, c, N, op.n_padded,
                             SHARD_TB, _shard_specs(op, storage))
        assert hit is not None
        n_bufs = len(hit)
        _same(hit, [x.numpy() for x in op.operand[:n_bufs]])


def _other_mesh(src, cache):
    os.rename(cache, cache.replace(".g2.", ".g3."))


@pytest.mark.parametrize("damage", [_stale_size, _stale_mtime, _truncated,
                                    _wrong_magic, _other_mesh],
                         ids=lambda f: f.__name__.strip("_"))
def test_bad_shard_cache_is_a_miss_then_repacked(src, matrix, damage):
    g, c, storage = 2, 1, "fq"
    cold = _shard_op(src, c, g, storage)
    cache = pc.shard_cache_path(src, storage, "g", g, c)
    args = (src, storage, "g", g, c, N, cold.n_padded, SHARD_TB,
            _shard_specs(cold, storage))
    assert pc.load_shard(*args) is not None
    # another placement of the same file is a miss
    assert pc.load_shard(src, storage, "g", g, 0, *args[5:]) is None
    assert pc.load_shard(src, "dfq", "g", g, c, *args[5:]) is None
    assert pc.load_shard(*args[:8], args[8][:-1]) is None
    damage(src, cache)
    assert pc.load_shard(*args) is None
    assert jpc.load_shard(*args) is None  # lam_tpu refuses it too
    again = _shard_op(src, c, g, storage)
    for x, y in zip(again.operand, cold.operand):
        assert torch.equal(x, y)
    assert pc.load_shard(*args) is not None  # the repack was published


def test_shard_cache_is_off_by_default_and_refuses_a_changed_source(src,
                                                                     matrix):
    op = _shard_op(src, 0, 2, "dfq", pack_cache=False)
    assert not os.path.exists(f"{src}.shardpack")
    bufs = [x.numpy() for x in op.operand[:5]]
    st = os.stat(src)
    _stale_mtime(src, None)  # the source changed while the pack ran
    assert not pc.save_shard(src, "dfq", "g", 2, 0, N, op.n_padded,
                             SHARD_TB, bufs, src_stat=st)
    assert not os.path.exists(pc.shard_cache_path(src, "dfq", "g", 2, 0))
    assert pc.save_shard(src, "dfq", "g", 2, 0, N, op.n_padded, SHARD_TB,
                         bufs)
    # the df64 pair has no shard cache: pack_cache is ignored for it
    _shard_op(src, 0, 2, "df64", packed=True)
    assert os.listdir(f"{src}.shardpack") == ["dfq.g2.s0"]
