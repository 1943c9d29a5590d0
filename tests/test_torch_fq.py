"""The port's irfq slice (fq storage, q16 and fq matvecs, fq and irfq solves)
against lam_tpu, on the CPU.

Host layer: the padded fq geometry, the power-of-two scale, the
three-plane quantizer and the streaming pack are byte-equal to lam_tpu's.
Kernels: the plain q16 walk against lam_tpu's `gemv_q16_symm` in interpret
mode (its one-tile grid on an exact plane, its blocked grid on a padded
one); the plain fq walk against an f64 dequantization oracle, since
XLA:CPU breaks the in-kernel two_sum of lam_tpu's `gemv_fq_symm`
(tests/test_fq.py:170-172). Solves: random_spd_system(1000, seed=25),
n_p=1024, tb=512, T=3 triangle tiles stored padded to 8.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lam_tpu
from lam_tpu import generate as jgen
from lam_tpu.ops import gemv as jgemv
from lam_tpu.solver import cg as jcg
from lam_tpu.solver import operators as jops
from lam_tpu_torch import DenseOperator, cg_solve, cg_solve_ir
from lam_tpu_torch import cli as tcli
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.solver import operators as tops
from lam_tpu_torch.solver.cg import IRFQ_INNER_FLOOR, default_inner_floor

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
def jax_fq(system):
    """lam_tpu's fq operator of the system (its numpy pack here)."""
    return lam_tpu.DenseOperator.from_dense(system[0], precision="fq")


@pytest.fixture(scope="module")
def op(system):
    return DenseOperator.from_dense_fq(system[0], device="cpu")


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


def _dequantize(bufs, n_p, tb, planes=3):
    """f64 oracle: the full symmetric n_p x n_p matrix of fq buffers
    (q1, q2, q3, s1, s2, s3, dh, dl), from its first `planes` planes,
    with the (dh, dl) diagonal added back."""
    q, s, (dh, dl) = bufs[:3], bufs[3:6], bufs[6:]
    nblk = n_p // tb
    out = np.zeros((n_p, n_p))
    for t, (i, k) in enumerate(zip(*layout._symm_tables(nblk))):
        tile = sum(np.asarray(q[j][t * tb:(t + 1) * tb], np.float64)
                   * float(s[j][t]) for j in range(planes))
        out[i * tb:(i + 1) * tb, k * tb:(k + 1) * tb] = tile
        if k < i:
            out[k * tb:(k + 1) * tb, i * tb:(i + 1) * tb] = tile.T
    idx = np.arange(n_p)
    out[idx, idx] += np.asarray(dh, np.float64) + np.asarray(dl, np.float64)
    return out


# -- host layer: byte equality ----------------------------------------------

@pytest.mark.parametrize("nblk", [1, 2, 3, 4, 5, 20])
def test_padded_geometry_matches_lam_tpu(nblk):
    assert (layout.padded_tri_tile_count(nblk)
            == jgemv.padded_tri_tile_count(nblk))
    assert layout.Q16_P == jgemv.Q16_P
    if nblk < 2:
        with pytest.raises(ValueError) as ref:
            jgemv._symm_tables_padded(nblk)
        with pytest.raises(ValueError) as mine:
            layout._symm_tables_padded(nblk)
        assert str(mine.value) == str(ref.value)
        return
    for x, y in zip(layout._symm_tables_padded(nblk),
                    jgemv._symm_tables_padded(nblk)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_pow2_scale_matches_lam_tpu_at_boundaries():
    ms = []
    for k in range(-70, 12):
        m = 32767.0 * 2.0 ** k
        ms += [m, np.nextafter(m, 0), np.nextafter(m, np.inf)]
    ms += list(np.random.default_rng(40).uniform(1e-30, 1e3, 200))
    for m in ms:
        assert layout._pow2_scale(m) == jgemv._pow2_scale(m)
        scale = layout._pow2_scale(m)
        assert m / scale <= 32767 < 2 * m / scale  # the smallest such power


def test_quantize_fq_tiles_byte_equal():
    a = _sym(3 * TB, 41, zero_diag=False) * 10.0 ** np.random.default_rng(
        42).uniform(-8, 8)
    packed = layout.pack_tri_host(a, TB)
    packed[TB:2 * TB] = 0.0  # an all-zero tile keeps zero scales
    mine = layout.quantize_fq_tiles(packed, TB)
    ref = jgemv.quantize_fq_tiles(packed, TB)
    for x, y in zip(mine, ref):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert mine[3][1] == 0 and not mine[0][TB:2 * TB].any()


@pytest.mark.parametrize("n,nblk,T,Ts", [(700, 2, 3, 8), (1000, 2, 3, 8)])
def test_host_pack_tri_byte_equal(n, nblk, T, Ts):
    a, _ = jgen.random_spd_system(n, seed=n)
    mine = tops._host_pack_tri(a, "fq", TB)
    ref = jops.DenseOperator._host_pack_tri(a, "fq", TB)
    assert len(mine) == len(ref) == 8
    for x, y in zip(mine, ref):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)
    assert mine[0].shape == (Ts * TB, TB) and mine[3].shape == (Ts,)
    assert layout.tri_tile_count(nblk) == T
    # pad tiles and pad scales are zero; the planes' diagonal is zeroed
    assert not any(q[T * TB:].any() for q in mine[:3])
    assert not any(s[T:].any() for s in mine[3:6])
    # the (dh, dl) pair keeps 48 bits of the diagonal
    np.testing.assert_allclose(mine[6][:n].astype(np.float64) + mine[7][:n],
                               np.diagonal(a), rtol=2.0 ** -47, atol=0)


# -- kernels: plain versions against lam_tpu and the oracle ----------------

def _q1_system(seed):
    a = _sym(N + 24, seed)  # n_p = 1024: nblk=2, T=3, Ts=8
    bufs = tops._host_pack_tri(a, "fq", TB)
    p = np.random.default_rng(seed + 1).uniform(-1, 1, 1024).astype(
        np.float32)
    return a, bufs, p


@pytest.mark.parametrize("padded", [False, True])
def test_gemv_q16_symm_plain_matches_lam_tpu(padded):
    a, bufs, p = _q1_system(43)
    q1, s1 = bufs[0], bufs[3]
    if not padded:  # the exact-count plane: lam_tpu's one-tile grid
        q1, s1 = q1[:3 * TB], s1[:3]
    gemv.reset_counters()
    y = gemv.gemv_q16_symm(torch.from_numpy(q1), torch.from_numpy(s1),
                           torch.from_numpy(p))
    assert y.dtype == torch.float32 and y.shape == (1024,)
    assert gemv.counters()["gemv_q16_symm_plain"] == 1
    assert gemv.counters()["gemv_q16_symm"] == 0
    ref = np.asarray(jgemv.gemv_q16_symm(q1, s1, p))
    # exact f32 products summed in f32 in different orders
    assert _rel(y.numpy().astype(np.float64), ref.astype(np.float64)) <= 1e-6
    oracle = _dequantize(bufs, 1024, TB, planes=1) @ p.astype(np.float64)
    assert _rel(y.numpy().astype(np.float64), oracle) <= 1e-6


@pytest.mark.parametrize("padded", [False, True])
def test_gemv_q16_symm_plain_is_bitwise_on_exact_data(padded):
    # small-integer tiles, a power-of-two scale and small-integer p make
    # every product and sum exact in f32 (the data of
    # tests/test_fq.py:107-133): any order gives the same bits
    T, Ts = 3, 8
    rng = np.random.default_rng(44)
    q1 = rng.integers(-3, 4, (T * TB, TB)).astype(np.int16)
    s1 = np.full((T,), 0.5, np.float32)
    p = rng.integers(-3, 4, 1024).astype(np.float32)
    if padded:
        q1 = np.concatenate([q1, np.zeros(((Ts - T) * TB, TB), np.int16)])
        s1 = np.concatenate([s1, np.zeros(Ts - T, np.float32)])
    y = gemv.gemv_q16_symm(*map(torch.from_numpy, (q1, s1, p)))
    ref = np.asarray(jgemv.gemv_q16_symm(q1, s1, p))
    assert np.array_equal(y.numpy(), ref)


def test_gemv_fq_symm_plain_matches_oracle_and_lam_tpu():
    a, bufs, p = _q1_system(45)
    rng = np.random.default_rng(46)
    ph = p
    pl = (rng.uniform(-1, 1, 1024) * 2.0 ** -26).astype(np.float32)
    gemv.reset_counters()
    yh, yl = gemv.gemv_fq_symm(*map(torch.from_numpy, (*bufs[:6], ph, pl)))
    assert yh.dtype == yl.dtype == torch.float32
    assert gemv.counters()["gemv_fq_symm_plain"] == 1
    y = yh.numpy().astype(np.float64) + yl.numpy()
    pp = ph.astype(np.float64) + pl
    deq = _dequantize(bufs, 1024, TB)
    idx = np.arange(1024)
    deq[idx, idx] = 0.0  # the planes carry a zero diagonal
    # f64 walk of the exactly-rebuilt cascade, returned as an f32 split
    assert _rel(y, deq @ pp) <= 1e-13
    a_p = np.zeros((1024, 1024))
    a_p[:N + 24, :N + 24] = a
    assert _rel(y, a_p @ pp) <= 1e-12  # the ~2^-48 storage bound
    jh, jl = jgemv.gemv_fq_symm(*bufs[:6], ph, pl)
    yj = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    # XLA:CPU breaks lam_tpu's in-kernel two_sum (tests/test_fq.py:170-172)
    assert _rel(y, yj) <= 1e-6


def test_tile_count_and_broadcast_checks():
    _, bufs, p = _q1_system(47)
    q = [torch.from_numpy(x) for x in bufs[:6]]
    pt = torch.from_numpy(p)
    # a plane with neither T=3 nor Ts=8 tiles: the same message as lam_tpu
    bad = torch.zeros(5 * TB, TB, dtype=torch.int16)
    with pytest.raises(ValueError) as ref:
        jgemv.gemv_q16_symm(bad.numpy(), np.zeros(5, np.float32), p)
    with pytest.raises(ValueError) as mine:
        gemv.gemv_q16_symm(bad, torch.zeros(5), pt)
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="or 8 padded"):
        gemv.gemv_fq_symm(bad, bad, bad, *[torch.zeros(5)] * 3, pt, pt)
    with pytest.raises(ValueError, match=r"s1 table shape \(3,\) != \(8,\)"):
        gemv.gemv_q16_symm(q[0], q[3][:3].contiguous(), pt)
    with pytest.raises(ValueError, match="s3 table shape"):
        gemv.gemv_fq_symm(*q[:5], q[5][:3].contiguous(), pt, pt)
    # a (tb, tb) q2 is the broadcast mode; any other shape is refused with
    # lam_tpu's message (lam_tpu/ops/gemv.py:2185-2188)
    gemv.reset_counters()
    gemv.gemv_fq_symm(q[0], q[1][:TB].contiguous(), q[2], *q[3:6], pt, pt)
    assert gemv.counters()["gemv_fq_symm_bcast_plain"] == 1
    with pytest.raises(ValueError, match="or one broadcast"):
        gemv.gemv_fq_symm(q[0], q[1][:2 * TB].contiguous(), q[2], *q[3:6],
                          pt, pt)
    with pytest.raises(ValueError, match="int16"):
        gemv.gemv_q16_symm(q[0].float(), q[3], pt)
    # the f32/df64 planes keep the exact-count check
    with pytest.raises(ValueError, match="needs 3$"):
        gemv.gemv_f32_symm(torch.zeros(8 * TB, TB), pt)
    carried = tops.DenseOperator.from_fq_planes(
        bufs[0], bufs[1][:TB], *bufs[2:], 1000, 1024, device="cpu")
    assert tuple(carried.operand[1].shape) == (TB, TB)
    with pytest.raises(ValueError, match="or one broadcast"):
        tops.DenseOperator.from_fq_planes(
            bufs[0], bufs[1][:2 * TB], *bufs[2:], 1000, 1024, device="cpu")


# -- the fq operator --------------------------------------------------------

def test_from_fq_planes_carries_lam_tpu_operand(system, jax_fq, op):
    a = system[0]
    carried = DenseOperator.from_fq_planes(
        *(np.asarray(x) for x in jax_fq.operand), jax_fq.n, jax_fq.n_padded,
        device="cpu")
    assert (carried.n, carried.n_padded, carried.precision) == (N, 1024, "fq")
    for mine, theirs in zip(carried.operand, op.operand):
        assert mine.dtype == theirs.dtype and torch.equal(mine, theirs)
    p = op.prepare_b(np.random.default_rng(48).uniform(-1, 1, N))
    y = op.matvec(p)
    assert torch.equal(carried.matvec(p), y)
    assert _rel(y.numpy()[:N], a @ p.numpy()[:N]) <= 1e-13
    op32 = op.as_f32()
    assert op32.operand is op.operand and op32.vector_dtype == torch.float32
    y32 = op32.matvec(p.float()).double().numpy()[:N]
    # the inner view reads only the ~2^-16 tile-relative q1 plane
    assert _rel(y32, a @ p.numpy()[:N]) <= 1e-3
    d = op.diagonal().numpy()
    np.testing.assert_allclose(d[:N], np.diagonal(a), rtol=1e-13, atol=0)
    assert not d[N:].any()


def test_fq_operator_needs_symmetry_and_packed_engine(system):
    a = system[0].copy()
    a[3, 700] += 1.0
    with pytest.raises(ValueError, match="symmetric"):
        DenseOperator.from_dense(a, precision="fq", device="cpu")
    with pytest.raises(ValueError, match="not combinable"):
        DenseOperator.from_dense(system[0], precision="fq", engine="pallas",
                                 device="cpu")


# -- solves -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_f64(system):
    a, b = system
    jop = lam_tpu.DenseOperator.from_dense(a, precision="f64")
    res = lam_tpu.cg_solve(jop, b, max_iters=10000, rel_error=1e-9)
    assert bool(res.converged)
    return np.asarray(res.x), int(res.num_iters)


def test_irfq_solve_matches_lam_tpu(system, jax_fq, jax_f64, op):
    a, b = system
    assert default_inner_floor("irfq") == IRFQ_INNER_FLOOR == (
        jcg.IRFQ_INNER_FLOOR)
    gemv.reset_counters()
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=10000, rel_error=1e-9,
                      inner_floor=IRFQ_INNER_FLOOR)
    x = res.x.numpy()
    assert bool(res.converged) and res.x.dtype == torch.float64
    assert _true_rel(a, b, x) <= 1e-9
    assert _rel(x, jax_f64[0]) <= 1e-8
    counts = gemv.counters()
    assert counts["gemv_q16_symm_plain"] >= int(res.num_iters)
    assert 0 < counts["gemv_fq_symm_plain"] <= 6

    # the JAX reference: lam_tpu's refinement loop with its own inner view
    # (the q16 Pallas kernel in interpret mode) and, as the accurate
    # matvec, an f64 dequantization of the same operand
    a_deq = jnp.asarray(_dequantize([np.asarray(x) for x in jax_fq.operand],
                                    1024, TB))

    def acc_matvec_dot(operand, p):
        ap = a_deq @ p
        return ap, jnp.vdot(p, ap)

    ref = jcg._cg_ir_loop(
        jops._MATVEC_DOT[("f32@fq", "pallas_symm_packed")], acc_matvec_dot,
        jax_fq.operand, jax_fq.prepare_b(b), jnp.int32(10000), 1e-9, 6,
        jcg.IRFQ_INNER_FLOOR)
    assert bool(ref.converged)
    # f32 sums in another order: a few iterations either way
    assert abs(int(res.num_iters) - int(ref.num_iters)) <= 5


def test_fq_solve_matches_lam_tpu_f64(system, jax_f64, op):
    a, b = system
    res = cg_solve(op, b, max_iters=10000, rel_error=1e-9)
    x = res.x.numpy()
    assert bool(res.converged)
    assert abs(int(res.num_iters) - jax_f64[1]) <= 5
    assert _true_rel(a, b, x) <= 1e-9
    assert _rel(x, jax_f64[0]) <= 1e-8


def test_cli_irfq_on_cpu(tmp_path):
    a, b = jgen.random_spd_system(600, seed=9)
    tio.write_matrix(tmp_path / "A.bin", a)
    tio.write_matrix(tmp_path / "b.bin", b)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(["-A", str(tmp_path / "A.bin"), "-b",
                        str(tmp_path / "b.bin"), "-o", str(tmp_path / "x.bin"),
                        "--precision", "irfq", "--device", "cpu",
                        "--pack-cache"])
    assert rc == 0
    fields = out.getvalue().strip().splitlines()[-1].split(",")
    # N,procs,threads,load_s,avg_gemv_s,avg_iter_s,num_iter,err,total_cg_s
    assert len(fields) == 9 and fields[:3] == ["600", "1", "1"]
    assert float(fields[7]) < 1e-9 and int(fields[6]) < 10000
    assert _true_rel(a, b, tio.read_vector(tmp_path / "x.bin")) <= 1e-9
    assert (tmp_path / "A.bin.fqpack").exists()
