"""The port's dfq storage (f32 hi plane + int16 lo plane, the dfq matvec, the
dfq and irq solves) against lam_tpu, on the CPU.

Host layer: the lo quantizer, the streaming pack (exactly T tiles, no
padding) and the `.dfqpack` cache are byte-equal to lam_tpu's. Kernel: the
plain dfq walk against an f64 oracle of the stored hi + loq * sc tiles, and
against lam_tpu's `gemv_dfq_symm` in interpret mode to 1e-6, since XLA:CPU
breaks the in-kernel compensation of lam_tpu's df64 walk. Solves:
random_spd_system(1000, seed=25), n_p=1024, tb=512, T=3 triangle tiles.
"""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lam_tpu
from lam_tpu import generate as jgen
from lam_tpu.ops import gemv as jgemv
from lam_tpu.solver import cg as jcg
from lam_tpu.solver import operators as jops
from lam_tpu.solver import pack_cache as jpc
from lam_tpu_torch import DenseOperator, cg_solve, cg_solve_ir
from lam_tpu_torch import cli as tcli
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.solver import operators as tops
from lam_tpu_torch.solver import pack_cache as pc
from lam_tpu_torch.solver.cg import IR_INNER_FLOOR, default_inner_floor

N, SEED, TB = 1000, 25, 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test processes on shared cores: torch's own
    # thread pool would oversubscribe them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def system():
    return jgen.random_spd_system(N, seed=SEED)


@pytest.fixture(scope="module")
def jax_dfq(system):
    """lam_tpu's dfq operator of the system (its numpy pack here)."""
    return lam_tpu.DenseOperator.from_dense(system[0], precision="dfq")


@pytest.fixture(scope="module")
def op(system):
    return DenseOperator.from_dense_dfq(system[0], device="cpu")


@pytest.fixture(scope="module")
def jax_f64(system):
    a, b = system
    jop = lam_tpu.DenseOperator.from_dense(a, precision="f64")
    res = lam_tpu.cg_solve(jop, b, max_iters=10000, rel_error=1e-9)
    assert bool(res.converged)
    return np.asarray(res.x), int(res.num_iters)


def _sym(n, seed, zero_diag=True):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, size=(n, n))
    a = m + m.T
    if zero_diag:
        np.fill_diagonal(a, 0.0)
    return a


def _rel(y, ref):
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _true_rel(a, b, x):
    return np.linalg.norm(b - a @ x) / np.linalg.norm(b)


def _dequantize(bufs, n_p, tb):
    """f64 oracle: the full symmetric n_p x n_p matrix of dfq buffers
    (hi, loq, sc, dh, dl), with the (dh, dl) diagonal added back."""
    hi, loq, sc, dh, dl = (np.asarray(x) for x in bufs)
    nblk = n_p // tb
    out = np.zeros((n_p, n_p))
    for t, (i, k) in enumerate(zip(*layout._symm_tables(nblk))):
        rows = slice(t * tb, (t + 1) * tb)
        tile = (hi[rows].astype(np.float64)
                + loq[rows].astype(np.float64) * float(sc[t]))
        out[i * tb:(i + 1) * tb, k * tb:(k + 1) * tb] = tile
        if k < i:
            out[k * tb:(k + 1) * tb, i * tb:(i + 1) * tb] = tile.T
    idx = np.arange(n_p)
    out[idx, idx] += dh.astype(np.float64) + dl
    return out


# -- host layer: byte equality ----------------------------------------------

def test_quantize_lo_tiles_byte_equal():
    a = _sym(3 * TB, 60) * 10.0 ** np.random.default_rng(61).uniform(-8, 8)
    hi = a.astype(np.float32)
    lo = layout.pack_tri_host((a - hi).astype(np.float32), TB)
    lo[TB:2 * TB] = 0.0  # an all-zero tile keeps a zero scale
    mine = layout.quantize_lo_tiles(lo, TB)
    ref = jgemv.quantize_lo_tiles(lo, TB)
    for x, y in zip(mine, ref):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)
    assert mine[1][1] == 0 and not mine[0][TB:2 * TB].any()
    # half a quantization step per element, exact power-of-two scales
    step = np.repeat(mine[1], TB)[:, None].astype(np.float64)
    assert (np.abs(mine[0] * step - lo) <= step / 2).all()


@pytest.mark.parametrize("n,T", [(700, 3), (1024, 3), (2100, 15)])
def test_host_pack_tri_dfq_byte_equal(n, T):
    a, _ = jgen.random_spd_system(n, seed=n)
    mine = tops._host_pack_tri(a, "dfq", TB)
    ref = jops.DenseOperator._host_pack_tri(a, "dfq", TB)
    assert len(mine) == len(ref) == 5
    for x, y in zip(mine, ref):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)
    n_p = layout.padded_size(n, TB)
    # exactly the T triangle tiles: the dfq planes are not padded to Ts
    assert layout.tri_tile_count(n_p // TB) == T
    assert mine[0].shape == mine[1].shape == (T * TB, TB)
    assert mine[2].shape == (T,) and mine[3].shape == (n_p,)
    assert (mine[0].dtype, mine[1].dtype) == (np.float32, np.int16)
    # the (dh, dl) pair keeps 48 bits of the diagonal; the planes hold 0
    np.testing.assert_allclose(mine[3][:n].astype(np.float64) + mine[4][:n],
                               np.diagonal(a), rtol=2.0 ** -47, atol=0)
    assert _rel(_dequantize(mine, n_p, TB)[:n, :n], a) <= 1e-11


def test_from_dense_dfq_operand_matches_lam_tpu(jax_dfq, op):
    assert (op.n, op.n_padded, op.precision, op.engine) == (
        N, 1024, "dfq", "pallas_symm_packed")
    assert len(op.operand) == len(jax_dfq.operand) == 5
    for mine, theirs in zip(op.operand, jax_dfq.operand):
        theirs = np.asarray(theirs)
        assert mine.numpy().dtype == theirs.dtype
        assert np.array_equal(mine.numpy(), theirs)


def test_dfqpack_files_are_byte_identical_and_interchangeable(tmp_path):
    a, _ = jgen.random_spd_system(700, seed=62)
    src = str(tmp_path / "A.bin")
    tio.write_matrix(src, a)
    n_p = layout.padded_size(700, TB)
    bufs = jops.DenseOperator._host_pack_tri(a, "dfq", TB)
    st = os.stat(src)
    assert jpc.save(src, "dfq", 700, n_p, TB, bufs, src_stat=st)
    path = pc.cache_path(src, "dfq")
    assert path.endswith(".dfqpack")
    theirs = open(path, "rb").read()
    hit = pc.load(src, "dfq")  # lam_tpu wrote, the port reads
    assert hit is not None and hit[:3] == (700, n_p, TB)
    for x, y in zip(hit[3], bufs):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    os.remove(path)
    assert pc.save(src, "dfq", 700, n_p, TB, bufs, src_stat=st)
    assert open(path, "rb").read() == theirs
    hit = jpc.load(src, "dfq")  # the port wrote, lam_tpu reads
    assert hit is not None and hit[:3] == (700, n_p, TB)
    for x, y in zip(hit[3], bufs):
        assert np.array_equal(np.asarray(x), y)


def test_from_file_dfq_cold_then_warm(tmp_path, monkeypatch):
    a, _ = jgen.random_spd_system(700, seed=63)
    src = str(tmp_path / "A.bin")
    tio.write_matrix(src, a)
    cold = DenseOperator.from_file_dfq(src, pack_cache=True, device="cpu")
    ref = jops.DenseOperator._host_pack_tri(a, "dfq", TB)
    for x, y in zip(cold.operand, ref):
        assert np.array_equal(x.numpy(), y)

    def no_pack(*args):
        raise AssertionError("a warm load must not pack")

    monkeypatch.setattr(tops, "_host_pack_tri", no_pack)
    warm = DenseOperator.from_file_dfq(src, pack_cache=True, device="cpu")
    assert (warm.n, warm.n_padded, warm.precision) == (700, 1024, "dfq")
    for x, y in zip(warm.operand, cold.operand):
        assert x.dtype == y.dtype and torch.equal(x, y)


# -- kernel: plain version against the oracle and lam_tpu -------------------

def _dfq_system(seed, n=N + 24):
    a = _sym(n, seed)  # zero diagonal: the planes of a dfq pack
    bufs = tops._host_pack_tri(a, "dfq", TB)
    rng = np.random.default_rng(seed + 1)
    ph = rng.uniform(-1, 1, 1024).astype(np.float32)
    pl = (rng.uniform(-1, 1, 1024) * 2.0 ** -26).astype(np.float32)
    return a, bufs, ph, pl


def test_gemv_dfq_symm_plain_matches_oracle():
    a, bufs, ph, pl = _dfq_system(64)
    gemv.reset_counters()
    yh, yl = gemv.gemv_dfq_symm(*map(torch.from_numpy, (*bufs[:3], ph, pl)))
    assert yh.dtype == yl.dtype == torch.float32 and yh.shape == (1024,)
    counts = gemv.counters()
    assert counts["gemv_dfq_symm_plain"] == 1 and counts["gemv_dfq_symm"] == 0
    y = yh.numpy().astype(np.float64) + yl.numpy()
    pp = ph.astype(np.float64) + pl
    deq = _dequantize(bufs, 1024, TB)
    # f64 walk of the exactly formed hi + loq * sc, returned as an f32 split
    assert _rel(y, deq @ pp) <= 1e-13
    a_p = np.zeros((1024, 1024))
    a_p[:N + 24, :N + 24] = a
    assert _rel(y, a_p @ pp) <= 1e-11  # the ~2^-39 storage bound
    assert not y[N + 24:].any()


@pytest.mark.parametrize("comp", [None, "nolow", "full"])
def test_gemv_dfq_symm_plain_matches_lam_tpu(comp):
    _, bufs, ph, pl = _dfq_system(65)
    yh, yl = gemv.gemv_dfq_symm(*map(torch.from_numpy, (*bufs[:3], ph, pl)),
                                comp=comp)
    y = yh.numpy().astype(np.float64) + yl.numpy()
    jh, jl = jgemv.gemv_dfq_symm(*map(jnp.asarray, (*bufs[:3], ph, pl)),
                                 comp=comp)
    yj = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    # XLA:CPU breaks lam_tpu's in-kernel compensation
    # (tests/test_torch_gemv.py), hence 1e-6 and not 1e-13
    assert _rel(y, yj) <= 1e-6


def test_gemv_dfq_symm_shape_checks():
    _, bufs, ph, pl = _dfq_system(66)
    hi, loq, sc = map(torch.from_numpy, bufs[:3])
    p, q = torch.from_numpy(ph), torch.from_numpy(pl)
    # the messages of lam_tpu's checks (gemv.py:1180-1189)
    with pytest.raises(ValueError) as ref:
        jgemv.gemv_dfq_symm(bufs[0], bufs[1][:TB], bufs[2], ph, pl)
    with pytest.raises(ValueError) as mine:
        gemv.gemv_dfq_symm(hi, loq[:TB], sc, p, q)
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match=r"sc table shape \(2,\) != \(3,\)"):
        gemv.gemv_dfq_symm(hi, loq, sc[:2].contiguous(), p, q)
    padded = torch.zeros(8 * TB, TB)  # a padded tile count is an fq layout
    with pytest.raises(ValueError, match="needs 3$"):
        gemv.gemv_dfq_symm(padded, padded.to(torch.int16), torch.zeros(8),
                           p, q)
    with pytest.raises(ValueError, match="int16"):
        gemv.gemv_dfq_symm(hi, loq.float(), sc, p, q)
    with pytest.raises(ValueError, match="comp"):
        gemv.gemv_dfq_symm(hi, loq, sc, p, q, comp="defer")
    with pytest.raises(ValueError, match="scale table"):
        DenseOperator.from_dfq_planes(*bufs[:2], bufs[2][:2], *bufs[3:],
                                      N + 24, 1024, device="cpu")


# -- the dfq operator -------------------------------------------------------

def test_from_dfq_planes_carries_lam_tpu_operand(system, jax_dfq, op):
    a = system[0]
    carried = DenseOperator.from_dfq_planes(
        *(np.asarray(x) for x in jax_dfq.operand), jax_dfq.n,
        jax_dfq.n_padded, device="cpu")
    assert (carried.n, carried.n_padded, carried.precision) == (N, 1024,
                                                               "dfq")
    for mine, theirs in zip(carried.operand, op.operand):
        assert mine.dtype == theirs.dtype and torch.equal(mine, theirs)
    p = op.prepare_b(np.random.default_rng(67).uniform(-1, 1, N))
    y = carried.matvec(p)
    assert torch.equal(op.matvec(p), y)
    # lam_tpu's own matvec of the same operand (XLA:CPU: 1e-6)
    yj = np.asarray(jax_dfq.matvec(jnp.asarray(p.numpy())))
    assert _rel(y.numpy(), yj) <= 1e-6
    assert _rel(y.numpy()[:N], a @ p.numpy()[:N]) <= 1e-11
    op32 = op.as_f32()
    assert op32.operand is op.operand and op32.vector_dtype == torch.float32
    y32 = op32.matvec(p.float()).double().numpy()[:N]
    # the inner view reads the f32 hi plane plus dh * p
    assert _rel(y32, a @ p.numpy()[:N]) <= 1e-6
    d = op.diagonal().numpy()
    np.testing.assert_allclose(d[:N], np.diagonal(a), rtol=1e-13, atol=0)
    assert not d[N:].any()


def test_dfq_operator_needs_symmetry_and_packed_engine(system):
    a = system[0].copy()
    a[3, 700] += 1.0
    with pytest.raises(ValueError, match="symmetric"):
        DenseOperator.from_dense(a, precision="dfq", device="cpu")
    with pytest.raises(ValueError, match="not combinable"):
        DenseOperator.from_dense(system[0], precision="dfq", engine="pallas",
                                 device="cpu")
    assert DenseOperator.from_dense(system[0], precision="dfq",
                                    device="cpu").precision == "dfq"


# -- solves -----------------------------------------------------------------

def test_dfq_solve_matches_lam_tpu_f64(system, jax_f64, op):
    a, b = system
    gemv.reset_counters()
    res = cg_solve(op, b, max_iters=10000, rel_error=1e-9)
    x = res.x.numpy()
    assert bool(res.converged) and res.x.dtype == torch.float64
    # the stored operator differs from A by ~1e-12
    assert abs(int(res.num_iters) - jax_f64[1]) <= 2
    assert _true_rel(a, b, x) <= 1e-9
    assert _rel(x, jax_f64[0]) <= 1e-8
    assert gemv.counters()["gemv_dfq_symm_plain"] >= int(res.num_iters)


def test_irq_solve_matches_lam_tpu(system, jax_dfq, op):
    a, b = system
    assert default_inner_floor("irq") == IR_INNER_FLOOR == (
        jcg.default_inner_floor("irq"))
    gemv.reset_counters()
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=10000, rel_error=1e-9,
                      inner_floor=default_inner_floor("irq"))
    x = res.x.numpy()
    assert bool(res.converged) and res.x.dtype == torch.float64
    assert _true_rel(a, b, x) <= 1e-9
    counts = gemv.counters()
    assert counts["gemv_f32_symm_plain"] >= int(res.num_iters)
    assert 0 < counts["gemv_dfq_symm_plain"] <= 6

    # the JAX reference: lam_tpu's refinement loop with its own inner view
    # (the f32 Pallas kernel in interpret mode plus dh * p) and, as the
    # accurate matvec, an f64 dequantization of the same operand
    a_deq = jnp.asarray(_dequantize(jax_dfq.operand, 1024, TB))

    def acc_matvec_dot(operand, p):
        ap = a_deq @ p
        return ap, jnp.vdot(p, ap)

    ref = jcg._cg_ir_loop(
        jops._MATVEC_DOT[("f32@dfq", "pallas_symm_packed")], acc_matvec_dot,
        jax_dfq.operand, jax_dfq.prepare_b(b), jnp.int32(10000), 1e-9, 6,
        jcg.default_inner_floor("irq"))
    assert bool(ref.converged)
    # f32 sums in another order: within 2% of the inner iterations
    assert abs(int(res.num_iters) - int(ref.num_iters)) <= (
        0.02 * int(ref.num_iters))


def test_cli_irq_writes_then_reuses_the_cache(tmp_path, monkeypatch):
    a, b = jgen.random_spd_system(600, seed=9)
    tio.write_matrix(tmp_path / "A.bin", a)
    tio.write_matrix(tmp_path / "b.bin", b)
    argv = ["-A", str(tmp_path / "A.bin"), "-b", str(tmp_path / "b.bin"),
            "--precision", "irq", "--device", "cpu", "--pack-cache"]

    def run(x_name):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tcli.main(argv + ["-o", str(tmp_path / x_name)])
        assert rc == 0
        return out.getvalue().strip().splitlines()[-1].split(",")

    cold = run("x_cold.bin")
    # N,procs,threads,load_s,avg_gemv_s,avg_iter_s,num_iter,err,total_cg_s
    assert len(cold) == 9 and cold[:3] == ["600", "1", "1"]
    assert float(cold[7]) < 1e-9 and int(cold[6]) < 10000
    x = tio.read_vector(tmp_path / "x_cold.bin")
    assert _true_rel(a, b, x) <= 1e-9
    assert (tmp_path / "A.bin.dfqpack").exists()

    def no_pack(*args):
        raise AssertionError("a warm load must not pack")

    monkeypatch.setattr(tops, "_host_pack_tri", no_pack)
    warm = run("x_warm.bin")
    assert warm[6] == cold[6]
    assert np.array_equal(tio.read_vector(tmp_path / "x_warm.bin"), x)
