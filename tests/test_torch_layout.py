"""The port's host layer is byte-equal to lam_tpu's.

Walk tables, triangle packing, padding, the f64 -> (hi, lo) split, the
streaming plane pack, the binary file format and the random SPD
generators of lam_tpu_torch are numpy copies of lam_tpu's (the port may
not import a lam_tpu module, which imports JAX). Both packages get the
same numpy inputs here and must return identical bytes.
"""

import numpy as np
import pytest

import lam_tpu.generate as jgen
import lam_tpu.io as jio
from lam_tpu.ops import gemv as jgemv
from lam_tpu.solver import operators as jops
from lam_tpu_torch import generate as tgen
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import layout
from lam_tpu_torch.precision import split_f64_host
from lam_tpu_torch.solver import operators as tops


def _same(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize("tb", [128, 512])
@pytest.mark.parametrize("n", [700, 1024, 2100])
def test_host_layer_byte_equal(n, tb, tmp_path):
    # padding and walk tables
    assert layout.padded_size(n) == jops.padded_size(n)
    assert layout.padded_size(n, tb) == jops.padded_size(n, tb)
    nblk = layout.padded_size(n, tb) // tb
    assert layout.tri_tile_count(nblk) == jgemv.tri_tile_count(nblk)
    for mine, ref in zip(layout._symm_tables(nblk),
                         jgemv._symm_tables(nblk)):
        assert _same(mine, ref)

    # generators (the O(N^3) QR one at a size where it is cheap)
    a_fast = tgen.random_spd_matrix_fast(n, seed=n + tb)
    assert _same(a_fast, jgen.random_spd_matrix_fast(n, seed=n + tb))
    assert _same(tgen.random_rhs(n, seed=3), jgen.random_rhs(n, seed=3))
    rng_t, rng_j = (np.random.default_rng(5) for _ in range(2))
    assert _same(tgen.random_eigenvalues(n, rng_t),
                 jgen.random_eigenvalues(n, rng_j))
    for mine, ref in zip(tgen.random_spd_system(64, seed=n + tb),
                         jgen.random_spd_system(64, seed=n + tb)):
        assert _same(mine, ref)

    # split and triangle pack of the zero-padded square
    n_p = layout.padded_size(n, tb)
    a_p = np.zeros((n_p, n_p))
    a_p[:n, :n] = a_fast
    hi, lo = split_f64_host(a_p)
    for mine, ref in zip((hi, lo), jops.split_f64_host(a_p)):
        assert _same(mine, ref)
    for plane in (hi, lo):
        assert _same(layout.pack_tri_host(plane, tb),
                     jgemv.pack_tri_host(plane, tb))

    # streaming pack over a memory map of the binary file, and the
    # file format both ways
    path = tmp_path / "a.bin"
    tio.write_matrix(path, a_fast)
    jpath = tmp_path / "a_jax.bin"
    jio.write_matrix(jpath, a_fast)
    assert path.read_bytes() == jpath.read_bytes()
    assert tio.read_header(path) == jio.read_header(path) == (n, n)
    assert _same(tio.read_matrix(jpath), jio.read_matrix(path))
    memmap = tio.open_matrix_memmap(path)
    jmemmap, _ = jops._open_matrix_memmap(str(path))
    assert _same(memmap, jmemmap)
    for precision in ("f32", "df64"):
        mine = tops._host_pack_planes(memmap, precision, tb)
        ref = jops.DenseOperator._host_pack_planes(memmap, precision, tb)
        assert len(mine) == len(ref)
        for x, y in zip(mine, ref):
            assert _same(x, y)

    # vectors and .npy input
    b = tgen.random_rhs(n, seed=n)
    tio.write_matrix(tmp_path / "b.bin", b)
    assert _same(jio.read_vector(tmp_path / "b.bin"), b)
    np.save(tmp_path / "b.npy", b)
    assert _same(tio.read_vector(tmp_path / "b.npy"),
                 jio.read_vector(tmp_path / "b.npy"))


@pytest.mark.parametrize("bad", [b"\x01" * 7, b"\x00" * 16])
def test_bad_headers_raise_like_lam_tpu(tmp_path, bad):
    path = tmp_path / "bad.bin"
    path.write_bytes(bad)
    with pytest.raises(IOError) as ref:
        jio.read_header(path)
    with pytest.raises(IOError) as mine:
        tio.read_header(path)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("suffix", [".bin", ".npy"])
@pytest.mark.parametrize("start,rows", [(0, 7), (5, 30), (64, 64), (127, 1)])
def test_read_matrix_rows_byte_equal(tmp_path, suffix, start, rows):
    """Each rank's row block, read alone (the MPI-IO analog)."""
    a = tgen.random_spd_matrix_fast(128, seed=start + rows)
    path = tmp_path / f"a{suffix}"
    if suffix == ".npy":
        np.save(path, a)
    else:
        tio.write_matrix(path, a)
    mine = tio.read_matrix_rows(path, start, rows)
    assert _same(mine, jio.read_matrix_rows(path, start, rows))
    assert _same(mine, a[start:start + rows])
    assert _same(tio.read_matrix_rows(path, start, rows, dtype=np.float32),
                 jio.read_matrix_rows(path, start, rows, dtype=np.float32))


def test_read_matrix_rows_raises_like_lam_tpu(tmp_path):
    path = tmp_path / "a.bin"
    tio.write_matrix(path, np.ones((16, 16)))
    with pytest.raises(ValueError) as ref:
        jio.read_matrix_rows(path, 10, 7)
    with pytest.raises(ValueError) as mine:
        tio.read_matrix_rows(path, 10, 7)
    assert str(mine.value) == str(ref.value)
    path.write_bytes(path.read_bytes()[:-8])  # cut the payload
    with pytest.raises(IOError, match="truncated"):
        tio.read_matrix_rows(path, 8, 8)
