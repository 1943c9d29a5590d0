"""The xla engine, f64/auto precision, auto backend and block CG (CPU).

The port's engine 'xla' operators (f64, f32 and df64 squares), their f32
views and the block matvecs of every storage lam_tpu gives one (the
squares' products; the packed triangle's walk over f32, df64 with a
plane or a broadcast lo tile, dfq and fq with planes or broadcast zero
tiles) against lam_tpu's `MATVEC` and `_mv_block` on the same numpy
inputs; cg_solve_block's per-column counts against lam_tpu's; and the
'auto' choices of precision and backend.
"""

import numpy as np
import pytest
import torch

import lam_tpu
from lam_tpu import generate as gen
from lam_tpu_torch import ConjugateGradient, DenseOperator, cg_solve_block
from lam_tpu_torch.ops import layout
from lam_tpu_torch.parallel import mesh as pmesh
from lam_tpu_torch.parallel.pcg2d_symm import Symm2DOperator
from lam_tpu_torch.parallel.pcg_symm import SymmShardedOperator
from lam_tpu_torch.solver import api
from lam_tpu_torch.solver import operators as tops

N, K = 700, 3


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
    # eigenvalues exp(2.5 U(-1, 1)), condition ~150: the residual falls
    # steeply through 1e-9, so f64 recurrences that sum in other orders
    # stop on the same iteration (the benchmark's exp(3.5 U) spectrum
    # lets them part by up to ~7 near its 1e-9 floor)
    rng = np.random.default_rng(63)
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    a = (q * np.exp(2.5 * rng.uniform(-1, 1, N))) @ q.T
    bb = np.random.default_rng(64).uniform(-1, 1, (N, K))
    return (a + a.T) / 2, bb


def _rel(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


# -- engine xla and precision f64 -------------------------------------------


@pytest.mark.parametrize("precision,tol", [("f64", 1e-14), ("df64", 1e-14),
                                           ("f32", 1e-6)])
def test_xla_matvec_matches_lam_tpu(system, precision, tol):
    a = system[0]
    op = DenseOperator.from_dense(a, precision=precision, engine="xla",
                                  device="cpu")
    jop = lam_tpu.DenseOperator.from_dense(a, precision=precision,
                                           engine="xla")
    assert (op.engine, op.n_padded) == ("xla", N) == (jop.engine,
                                                     jop.n_padded)
    operand = op.operand if isinstance(op.operand, tuple) else (op.operand,)
    joperand = (jop.operand if isinstance(jop.operand, tuple)
                else (jop.operand,))
    for mine, theirs in zip(operand, joperand):  # the same stored bytes
        assert np.array_equal(mine.numpy(), np.asarray(theirs))
    p = np.random.default_rng(3).standard_normal(N)
    y = op.matvec(op.prepare_b(p)).numpy()
    jy = np.asarray(jop.matvec(jop.prepare_b(p)))
    assert _rel(y, jy) <= tol and _rel(y, a @ p) <= max(tol, 1e-15) * 10
    assert np.array_equal(op.diagonal().numpy(), np.asarray(jop.diagonal()))


@pytest.mark.parametrize("precision", ["f64", "df64"])
def test_xla_as_f32_matches_lam_tpu(system, precision):
    a = system[0]
    op = DenseOperator.from_dense(a, precision=precision, engine="xla",
                                  device="cpu")
    jop = lam_tpu.DenseOperator.from_dense(a, precision=precision,
                                           engine="xla")
    v, jv = op.as_f32(), jop.as_f32()
    assert v.operand is op.operand and v.vector_dtype == torch.float32
    p = np.random.default_rng(4).standard_normal(N).astype(np.float32)
    y = v.matvec(v.prepare_b(p)).numpy()
    assert _rel(y, np.asarray(jv.matvec(jv.prepare_b(p)))) <= 1e-6
    if precision == "f64":
        # the f32 cast is made once and kept by the accurate operator
        cast = op._a32
        op.as_f32()
        assert cast is not None and op._a32 is cast


def test_precision_f64_forces_xla_and_auto_follows_the_device(system):
    a = system[0]
    for engine in ("auto", "pallas", "pallas_symm_packed", "xla"):
        op = DenseOperator.from_dense(a, precision="f64", engine=engine,
                                      device="cpu")
        assert (op.precision, op.engine, op.n_padded) == ("f64", "xla", N)
    op = DenseOperator.from_dense(a, precision="auto", device="cpu")
    assert (op.precision, op.engine) == ("f64", "xla")
    assert tops.auto_precision("cpu") == "f64"
    assert tops.auto_precision("cuda") == "df64"  # the card: df64
    assert tops.auto_precision(torch.device("cuda", 0)) == "df64"
    # engine auto keeps the kernel engines on the CPU (lam_tpu picks xla
    # off a TPU): their plain versions
    op = DenseOperator.from_dense(a, precision="df64", device="cpu")
    assert op.engine == "pallas_symm_packed"


def test_facade_auto_choices():
    cg = ConjugateGradient(device="cpu")  # lam_tpu's defaults
    assert (cg.backend, cg.precision, cg.engine) == ("local", "f64", "auto")
    assert ConjugateGradient(precision="auto", backend="auto",
                             device="cpu").used_devices() == 1
    assert api.auto_backend() == "local"
    assert api.auto_backend(1) == "local"
    assert api.auto_backend(2) == "sharded"
    with pytest.raises(ValueError, match="unknown precision"):
        ConjugateGradient(precision="f16", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        ConjugateGradient(backend="pod", device="cpu")


@pytest.mark.parametrize("precision", ["f64", "ir"])
def test_facade_xla_solves_match_lam_tpu(system, tmp_path, precision):
    a = system[0]
    b = system[1][:, 0]
    from lam_tpu_torch import io as tio
    tio.write_matrix(tmp_path / "A.bin", a)
    tio.write_matrix(tmp_path / "b.bin", b)
    cg = ConjugateGradient(precision=precision, engine="xla", device="cpu")
    cg.load_matrix_from_file(str(tmp_path / "A.bin"))
    cg.load_rhs_from_file(str(tmp_path / "b.bin"))
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    assert cg.op.engine == "xla" and cg.op.n_padded == N
    jop = lam_tpu.DenseOperator.from_dense(
        a, precision="df64" if precision == "ir" else "f64", engine="xla")
    ref = (lam_tpu.cg_solve_ir(jop.as_f32(), jop, b, max_iters=10000,
                               rel_error=1e-9) if precision == "ir"
           else lam_tpu.cg_solve(jop, b, max_iters=10000, rel_error=1e-9))
    slack = 2 if precision == "f64" else int(0.02 * int(ref.num_iters)) + 1
    assert abs(cg.timings["num_iters"] - int(ref.num_iters)) <= slack
    assert np.linalg.norm(b - a @ cg.x) / np.linalg.norm(b) <= 1e-8
    assert cg.measure_gemv(repeats=2) > 0


# -- block matvecs ----------------------------------------------------------


def _pairs(a):
    """(label, port operator, lam_tpu operator) for every storage that
    has a block matvec, built from the same bytes."""
    tb = layout.SYMM_TB
    out = []
    for precision in ("f64", "f32", "df64"):
        out.append((f"xla-{precision}",
                    DenseOperator.from_dense(a, precision=precision,
                                             engine="xla", device="cpu"),
                    lam_tpu.DenseOperator.from_dense(a, precision=precision,
                                                     engine="xla")))
    for precision in ("f32", "df64"):
        for engine in ("pallas", "pallas_symm", "pallas_symm_packed"):
            out.append((f"{engine}-{precision}",
                        DenseOperator.from_dense(a, precision=precision,
                                                 engine=engine,
                                                 device="cpu"),
                        lam_tpu.DenseOperator.from_dense(
                            a, precision=precision, engine=engine)))
    for storage in ("dfq", "fq"):
        jop = getattr(lam_tpu.DenseOperator, f"from_dense_{storage}")(a)
        out.append((f"packed-{storage}",
                    getattr(DenseOperator, f"from_dense_{storage}")(
                        a, device="cpu"), jop))
    # a broadcast (tb, tb) lo tile, and fq's zero q2/q3 tiles
    packed = lam_tpu.DenseOperator.from_dense(a, precision="df64",
                                              engine="pallas_symm_packed")
    hi = np.asarray(packed.operand[0])
    lo = np.random.default_rng(7).uniform(-1e-8, 1e-8, (tb, tb)).astype(
        np.float32)
    out.append(("bcast-df64",
                DenseOperator.from_packed_planes(hi, lo, N, packed.n_padded,
                                                 device="cpu"),
                lam_tpu.DenseOperator.from_packed_planes(hi, lo, N,
                                                         packed.n_padded)))
    fq = lam_tpu.DenseOperator.from_dense_fq(a)
    gen_fq = lam_tpu.DenseOperator.from_gen_fq(np.asarray(fq.operand[0]), N,
                                               fq.n_padded)
    out.append(("bcast-fq",
                DenseOperator.from_fq_planes(
                    *(np.asarray(x) for x in gen_fq.operand), N,
                    fq.n_padded, device="cpu"), gen_fq))
    return out


def test_block_matvecs_match_lam_tpu(system):
    a, bb = system
    for label, op, jop in _pairs(a):
        dt = np.float32 if op.vector_dtype == torch.float32 else np.float64
        p = bb.astype(dt)
        y = op._mv_block(op.operand, op.prepare_b_block(p)).numpy()[:N]
        jy = np.asarray(jop._mv_block(jop.operand,
                                      jop.prepare_b_block(p)))[:N]
        tol = 1e-6 if dt == np.float32 else 1e-13
        assert y.shape == (N, K), label
        assert _rel(y, jy) <= tol, (label, _rel(y, jy))
        # each column is the operator's own matvec of that column
        y0 = op.matvec(op.prepare_b(p[:, 0])).numpy()[:N]
        assert _rel(y[:, 0], y0) <= 10 * tol, (label, _rel(y[:, 0], y0))


def test_packed_block_walk_counts_each_tile_once():
    """Three row tiles of 128: the diagonal tiles' direct terms only, the
    others' transpose terms too, and the padded fq planes cut to the
    triangle's tiles."""
    tb, nblk = 128, 3
    rng = np.random.default_rng(9)
    m = rng.standard_normal((tb * nblk, tb * nblk))
    a = m + m.T
    buf = layout.pack_tri_host(a, tb)
    p = rng.standard_normal((tb * nblk, 2))
    y = tops._packed_block_walk(torch.from_numpy(buf), None,
                                torch.from_numpy(p)).numpy()
    assert _rel(y, a @ p) <= 1e-14
    padded = np.concatenate([buf, rng.standard_normal((2 * tb, tb))])
    y2 = tops._packed_block_walk(torch.from_numpy(padded), None,
                                 torch.from_numpy(p)).numpy()
    assert np.array_equal(y, y2)


@pytest.mark.parametrize("label", ["xla-f64", "pallas_symm_packed-df64",
                                   "packed-fq"])
def test_cg_solve_block_counts_match_lam_tpu(system, label):
    a, bb = system
    op, jop = next((o, j) for lab, o, j in _pairs(a) if lab == label)
    res = cg_solve_block(op, bb, max_iters=10000, rel_error=1e-9)
    ref = lam_tpu.cg_solve_block(jop, bb, max_iters=10000, rel_error=1e-9)
    assert res.x.shape == (N, K)
    assert res.num_iters.shape == res.converged.shape == (K,)
    assert bool(res.converged.all())
    for j in range(K):
        assert abs(int(res.num_iters[j]) - int(ref.num_iters[j])) <= 2
        x = res.x[:, j].numpy()
        assert np.linalg.norm(bb[:, j] - a @ x) / np.linalg.norm(
            bb[:, j]) <= 1e-8


def test_cg_solve_block_freezes_converged_columns(system):
    """A column that converges keeps its count; max_iters stops every
    column at its limit, unconverged."""
    a, bb = system
    op = DenseOperator.from_dense(a, precision="f64", device="cpu")
    block = np.stack([bb[:, 0], a @ np.ones(N), bb[:, 0]], axis=1)
    res = cg_solve_block(op, block, max_iters=10000, rel_error=1e-9)
    n = res.num_iters.tolist()
    assert n[0] == n[2] and n[1] != n[0]
    one = tops.DenseOperator.from_dense(a, precision="f64", device="cpu")
    from lam_tpu_torch import cg_solve
    assert n[0] == int(cg_solve(one, bb[:, 0], max_iters=10000,
                                rel_error=1e-9).num_iters)
    cut = cg_solve_block(op, block, max_iters=5, rel_error=1e-9)
    assert cut.num_iters.tolist() == [5, 5, 5]
    assert not bool(cut.converged.any())


def test_block_matvec_refusals(system):
    a, bb = system
    op = DenseOperator.from_dense(a, precision="df64", device="cpu")
    with pytest.raises(NotImplementedError,
                       match="DenseOperator has no block matvec"):
        cg_solve_block(op.as_f32(), bb)  # lam_tpu's f32 views have none
    with pytest.raises(ValueError, match="rhs block must be"):
        op.prepare_b_block(bb[:10])
    small = gen.random_spd_matrix_fast(256, seed=3)
    for mesh_op in (SymmShardedOperator.from_dense(
                        small, mesh=pmesh.Mesh(0, 1, "cpu"), tb=128,
                        device="cpu"),
                    Symm2DOperator.from_dense(small,
                                              mesh=pmesh.Mesh2D(0, 1, "cpu"),
                                              tb=128, device="cpu")):
        with pytest.raises(NotImplementedError,
                           match=f"{type(mesh_op).__name__} has no block "
                           "matvec"):
            cg_solve_block(mesh_op, np.ones((256, 2)))
