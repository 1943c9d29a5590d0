"""Jacobi-preconditioned CG in the port (solver/cg.py `_pcg_loop`,
`_inv_diag_f32`, the operators' `diagonal()`), its facade and CLI flags,
against lam_tpu on the CPU, on one device. The mesh operators' diagonals
and Jacobi solves are held in their gloo clusters (test_torch_sharded.py,
test_torch_sharded2d.py, test_torch_sharded2d_symm.py).

The system: lam_tpu's random SPD matrix at n=600 (n_p=1024, 3 packed tiles
of 512) scaled by s = exp(linspace(0, 1, n)) on both sides, so Jacobi cuts
the iterations. Solve-level references as in test_torch_cg.py: lam_tpu's
float64 path (engine 'xla') for the f64-class storages and ir/irq, and
lam_tpu's refinement loop with its own inner view (the q16 Pallas kernel
in interpret mode) for irfq.
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lam_tpu
from lam_tpu import cli as jcli
from lam_tpu import generate as jgen
from lam_tpu.solver import cg as jcg
from lam_tpu.solver import operators as jops
from lam_tpu_torch import ConjugateGradient, DenseOperator, cg_solve, cg_solve_ir
from lam_tpu_torch import cli as tcli
from lam_tpu_torch import generate as tgen
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.solver import cg as tcg
from lam_tpu_torch.solver import operators as tops

N, TB = 600, 512
# the solves stop at half the TRUE-residual gate of 1e-9: the quantized
# storages' own error (dfq ~2^-39 of a tile's largest entry) can lift the
# TRUE residual a few percent above the recurrence's
REL = 5e-10
# lo tile of the broadcast operator: eps * I on every packed tile
LO_EPS = 2.0 ** -20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scaled(n, span, seed=6):
    a = np.asarray(jgen.random_spd_matrix(n, seed=seed))
    s = np.exp(np.linspace(0, span, n))
    return a * np.outer(s, s)


@pytest.fixture(scope="module")
def system():
    return _scaled(N, 1.0), np.asarray(jgen.random_rhs(N, seed=16))


def _bcast_planes(eps):
    """(hi plane, lo tile, the f64 matrix they stand for) of generate
    mode's df64 operator at N: the tridiagonal's packed f32 plane and the
    broadcast lo tile eps * I that the walk adds to every stored tile
    (generate mode's is a zero tile; a nonzero one shows that its
    diagonal counts at every row tile)."""
    (hi,) = tops._host_pack_planes(tgen.tridiagonal_matrix(N), "f32", TB)
    lo = (eps * np.eye(TB)).astype(np.float32)
    n_p = layout.padded_size(N, TB)
    nblk = n_p // TB
    it, kt = layout._symm_tables(nblk)
    dense = np.zeros((n_p, n_p))
    for t, (i, k) in enumerate(zip(it, kt)):
        blk = hi[t * TB:(t + 1) * TB].astype(np.float64) + lo
        dense[i * TB:(i + 1) * TB, k * TB:(k + 1) * TB] = blk
        dense[k * TB:(k + 1) * TB, i * TB:(i + 1) * TB] = blk.T
    return hi, lo, dense[:N, :N]


def _ops(system, storage, eps=0.0):
    """(the port's operator, lam_tpu's of the same storage, the f64 matrix
    it stands for, the right-hand side); eps: the diagonal of generate
    mode's broadcast lo tile ('bcast': the tridiagonal against ones)."""
    a, b = system
    if storage == "bcast":
        hi, lo, dense = _bcast_planes(eps)
        n_p = layout.padded_size(N, TB)
        return (DenseOperator.from_packed_planes(hi, lo, N, n_p,
                                                 device="cpu"),
                lam_tpu.DenseOperator.from_packed_planes(
                    jnp.asarray(hi), jnp.asarray(lo), N, n_p), dense,
                tgen.ones_rhs(N))
    if storage in ("dfq", "fq"):
        mine = getattr(DenseOperator, f"from_dense_{storage}")(a,
                                                              device="cpu")
        return (mine, lam_tpu.DenseOperator.from_dense(a, precision=storage),
                a, b)
    engine = "pallas_symm_packed"
    if storage.endswith("-square"):
        storage, engine = storage.split("-")[0], "pallas"
    return (DenseOperator.from_dense(a, precision=storage, engine=engine,
                                     device="cpu"),
            lam_tpu.DenseOperator.from_dense(a, precision=storage,
                                             engine=engine), a, b)


def _true_rel(a, b, x):
    return np.linalg.norm(b - a @ x) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def lam_f64(system):
    """lam_tpu's float64 Jacobi PCG and ir PCG iteration counts, and its
    plain CG count, of a matrix."""
    cache = {}

    def counts(a, b):
        key = id(a)
        if key not in cache:
            f64 = lam_tpu.DenseOperator.from_dense(a, precision="f64",
                                                   engine="xla")
            df64 = lam_tpu.DenseOperator.from_dense(a, precision="df64",
                                                    engine="xla")
            runs = (lam_tpu.cg_solve(f64, b, max_iters=20000, rel_error=REL,
                                     preconditioner="jacobi"),
                    lam_tpu.cg_solve_ir(df64.as_f32(), df64, b,
                                        max_iters=20000, rel_error=REL,
                                        preconditioner="jacobi"),
                    lam_tpu.cg_solve(f64, b, max_iters=20000,
                                     rel_error=REL))
            assert all(bool(r.converged) for r in runs)
            cache[key] = tuple(int(r.num_iters) for r in runs)
        return cache[key]

    return counts


# -- the diagonals ---------------------------------------------------------


@pytest.mark.parametrize("storage", ["f32", "df64", "dfq", "fq", "bcast",
                                     "f32-square", "df64-square"])
def test_diagonal_matches_lam_tpu(system, storage):
    mine, theirs, dense, _ = _ops(system, storage, LO_EPS)
    d, ref = mine.diagonal(), np.asarray(theirs.diagonal())
    assert d.numpy().dtype == ref.dtype
    np.testing.assert_array_equal(d.numpy(), ref)
    if storage == "bcast":  # the lo tile's diagonal at every row tile
        np.testing.assert_array_equal(d[:N].numpy(), np.diag(dense))
    # the inner loop's f32 inverse, bit for bit
    inv = tcg._inv_diag_f32(mine)
    assert inv.dtype == torch.float32
    np.testing.assert_array_equal(inv.numpy(),
                                  np.asarray(jcg._inv_diag_f32(theirs)))
    # a zero (the padding's) takes 1, never inf
    d = d.to(torch.float64)
    assert torch.all(torch.isfinite(inv))
    assert torch.equal(inv[d == 0], torch.ones_like(inv[d == 0]))
    assert bool((d[N:] == 0).all()) == (storage != "bcast")


def test_packed_diagonal_reads_the_diagonal_tiles():
    a = _scaled(1100, 0.5, seed=3)  # 3 row tiles, 6 packed tiles
    (hi,) = tops._host_pack_planes(a, "f32", TB)
    d = tops._packed_diagonal(torch.from_numpy(hi), 3)
    np.testing.assert_array_equal(d[:1100].numpy(),
                                  np.diag(a).astype(np.float32))
    assert not d[1100:].any()
    tile = torch.arange(TB * TB, dtype=torch.float32).reshape(TB, TB)
    np.testing.assert_array_equal(
        tops._packed_diagonal(tile, 3).numpy(),
        np.tile(np.diag(tile.numpy()), 3))


def test_base_and_matrix_free_operators_have_no_diagonal():
    op = tops.MatrixFreeOperator(lambda _, p: 2 * p, None, 5, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="MatrixFreeOperator does not expose a diagonal"):
        cg_solve(op, np.ones(5), preconditioner="jacobi")
    jop = jops.MatrixFreeOperator(lambda _, p: 2 * p, jnp.zeros(()), 5)
    with pytest.raises(NotImplementedError,
                       match="MatrixFreeOperator does not expose a diagonal"):
        lam_tpu.cg_solve(jop, np.ones(5), preconditioner="jacobi")


# -- the solves ------------------------------------------------------------


@pytest.mark.parametrize("storage", ["df64", "dfq", "fq", "bcast",
                                     "df64-square"])
def test_jacobi_cg_matches_lam_tpu(system, lam_f64, storage):
    mine, _, a, b = _ops(system, storage)
    gemv.reset_counters()
    res = cg_solve(mine, b, max_iters=20000, rel_error=REL,
                   preconditioner="jacobi")
    x = res.x.numpy()
    assert bool(res.converged) and res.x.dtype == torch.float64
    assert _true_rel(a, b, x) < 1e-9
    pcg, _, plain = lam_f64(a, b)
    assert abs(int(res.num_iters) - pcg) <= 2, (int(res.num_iters), pcg)
    if storage == "bcast":  # the tridiagonal's constant diagonal: n/2
        assert int(res.num_iters) == plain == N // 2
    else:
        assert int(res.num_iters) < plain  # Jacobi pays off here
    assert sum(gemv.counters().values()) >= int(res.num_iters)


@pytest.mark.parametrize("precision", ["ir", "irq"])
def test_jacobi_ir_matches_lam_tpu(system, lam_f64, precision):
    storage = {"ir": "df64", "irq": "dfq"}[precision]
    mine, _, a, b = _ops(system, storage)
    res = cg_solve_ir(mine.as_f32(), mine, b, max_iters=20000, rel_error=REL,
                      inner_floor=tcg.default_inner_floor(precision),
                      preconditioner="jacobi")
    x = res.x.numpy()
    assert bool(res.converged)
    assert _true_rel(a, b, x) < 1e-9
    ref = lam_f64(a, b)[1]
    # f32 inner sums in another order: within 2% of lam_tpu's count
    assert abs(int(res.num_iters) - ref) <= 0.02 * ref, (
        int(res.num_iters), ref)


def test_jacobi_irfq_matches_lam_tpu(system):
    a, b = system
    mine, theirs, _, _ = _ops(system, "fq")
    res = cg_solve_ir(mine.as_f32(), mine, b, max_iters=20000, rel_error=REL,
                      inner_floor=tcg.IRFQ_INNER_FLOOR,
                      preconditioner="jacobi")
    x = res.x.numpy()
    assert bool(res.converged)
    assert _true_rel(a, b, x) < 1e-9
    plain = cg_solve_ir(mine.as_f32(), mine, b, max_iters=20000,
                        rel_error=REL, inner_floor=tcg.IRFQ_INNER_FLOOR)
    assert int(res.num_iters) < int(plain.num_iters)
    # lam_tpu's refinement loop with its own inner view and inverse
    # diagonal, the accurate matvec in f64 on the source
    a64 = jnp.asarray(a)
    n_p = mine.n_padded

    def acc_matvec_dot(operand, p):
        ap = jnp.pad(a64 @ p[:N], (0, n_p - N))
        return ap, jnp.vdot(p, ap)

    ref = jcg._cg_ir_loop(
        jops._MATVEC_DOT[("f32@fq", "pallas_symm_packed")], acc_matvec_dot,
        theirs.operand, theirs.prepare_b(b), jnp.int32(20000), REL, 6,
        jcg.IRFQ_INNER_FLOOR, jcg._inv_diag_f32(theirs))
    assert bool(ref.converged)
    assert abs(int(res.num_iters) - int(ref.num_iters)) <= (
        0.02 * int(ref.num_iters)), (int(res.num_iters), int(ref.num_iters))


def test_jacobi_f32_matches_lam_tpu(system):
    a, b = system
    mine, theirs, _, _ = _ops(system, "f32")
    res = cg_solve(mine, b, max_iters=20000, rel_error=1e-5,
                   preconditioner="jacobi")
    ref = lam_tpu.cg_solve(theirs, b, max_iters=20000, rel_error=1e-5,
                           preconditioner="jacobi")
    assert bool(res.converged) and res.x.dtype == torch.float32
    assert abs(int(res.num_iters) - int(ref.num_iters)) <= (
        0.02 * int(ref.num_iters))
    assert _true_rel(a, b, res.x.double().numpy()) <= 1e-4


def _pcg_every_iteration(a, b, inv, max_iters, rel_error):
    """lam_tpu's PCG recurrence (lam_tpu/solver/cg.py:108-160) with the
    port's reductions, its stopping test read after every iteration."""
    bb = tops.vdot(b, b)
    x, r = torch.zeros_like(b), b.clone()
    p = inv * b
    rz, rr, k = tops.vdot(b, p), bb, 0
    while k < max_iters and float(torch.sqrt(rr / bb)) >= rel_error:
        ap = a @ p
        alpha = rz / tops.vdot(p, ap)
        x.addcmul_(alpha, p)
        r.addcmul_(alpha, ap, value=-1.0)
        z = inv * r
        rz_new, rr = tops.vdot(r, z), tops.vdot(r, r)
        p = z + rz_new / rz * p
        rz, k = rz_new, k + 1
    return x, k


@pytest.mark.parametrize("max_iters", [1, 31, 33, 20000])
def test_pcg_loop_freezes_and_counts_as_lam_tpu(max_iters):
    """The loop reads its flag every CHUNK iterations: the frozen
    iterations past convergence (or the cap) change no bit of x, and the
    count is lam_tpu's."""
    a = torch.from_numpy(_scaled(120, 3.0, seed=11))
    b = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, 120))
    inv = 1.0 / torch.diagonal(a)
    res = tcg._pcg_loop(lambda p: (a @ p, tops.vdot(p, a @ p)), b, inv,
                        max_iters, 1e-10)
    x, k = _pcg_every_iteration(a, b, inv, max_iters, 1e-10)
    assert bool(res.converged) == (k < max_iters)
    assert int(res.num_iters) == (k if k < max_iters else max_iters)
    assert torch.equal(res.x, x)
    if max_iters == 20000:
        assert bool(res.converged) and float(res.rel_residual) < 1e-10


# -- lam_tpu's contract tests, in the port's form --------------------------


def _diag_spread(seed=19, n=200):
    """tests/test_cg.py:157-194's system: a wildly varying diagonal."""
    rng = np.random.default_rng(seed)
    d = np.exp(rng.uniform(0, 8, n))
    a = np.diag(d) + rng.uniform(-0.5, 0.5, (n, n))
    a = 0.5 * (a + a.T)
    a += n * 0.01 * np.eye(n)
    return a, rng.uniform(-1, 1, n)


def test_jacobi_preconditioned_cg():
    a, b = _diag_spread()
    op = DenseOperator.from_dense(a, precision="df64", device="cpu")
    plain = cg_solve(op, b, max_iters=5000, rel_error=1e-9)
    pre = cg_solve(op, b, max_iters=5000, rel_error=1e-9,
                   preconditioner="jacobi")
    assert bool(pre.converged)
    assert _true_rel(a, b, pre.x.numpy()) < 1e-8
    assert int(pre.num_iters) < int(plain.num_iters)
    ref = lam_tpu.cg_solve(
        lam_tpu.DenseOperator.from_dense(a, precision="f64", engine="xla"),
        b, max_iters=5000, rel_error=1e-9, preconditioner="jacobi")
    assert abs(int(pre.num_iters) - int(ref.num_iters)) <= 2


def test_ir_jacobi_preconditioned():
    a, b = _diag_spread()
    op = DenseOperator.from_dense(a, precision="df64", device="cpu")
    plain = cg_solve_ir(op.as_f32(), op, b, max_iters=20000, rel_error=1e-9)
    pre = cg_solve_ir(op.as_f32(), op, b, max_iters=20000, rel_error=1e-9,
                      preconditioner="jacobi")
    assert bool(pre.converged)
    assert _true_rel(a, b, pre.x.numpy()) < 1e-9
    assert int(pre.num_iters) < int(plain.num_iters)


def test_unknown_preconditioner_in_lam_tpus_words(system):
    op = DenseOperator.from_dense(system[0][:8, :8] + 8 * np.eye(8),
                                  device="cpu")
    jop = lam_tpu.DenseOperator.from_dense(system[0][:8, :8] + 8 * np.eye(8),
                                           precision="f64", engine="xla")
    for mine, theirs in (
            (lambda: cg_solve(op, np.ones(8), preconditioner="ilu"),
             lambda: lam_tpu.cg_solve(jop, np.ones(8),
                                      preconditioner="ilu")),
            (lambda: cg_solve_ir(op.as_f32(), op, np.ones(8),
                                 preconditioner="ilu"),
             lambda: lam_tpu.cg_solve_ir(jop.as_f32(), jop, np.ones(8),
                                         preconditioner="ilu"))):
        with pytest.raises(ValueError) as e_mine:
            mine()
        with pytest.raises(ValueError) as e_ref:
            theirs()
        assert str(e_mine.value) == str(e_ref.value)


# -- the facade and the CLI ------------------------------------------------


@pytest.fixture(scope="module")
def files(system, tmp_path_factory):
    d = tmp_path_factory.mktemp("pcg_files")
    a, b = system
    tio.write_matrix(d / "A.bin", a)
    tio.write_matrix(d / "b.bin", b)
    bad = a.copy()
    bad[0, 5] += 1.0
    tio.write_matrix(d / "bad.bin", bad)
    return str(d / "A.bin"), str(d / "b.bin"), str(d / "bad.bin")


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().strip()


@pytest.mark.parametrize("precision", ["df64", "irfq"])
def test_facade_solve_with_jacobi(system, files, precision):
    a, b = system
    cg = ConjugateGradient(precision=precision, device="cpu")
    cg.load_matrix_from_file(files[0])
    cg.load_rhs_from_file(files[1])
    assert cg.solve(max_iters=20000, rel_error=REL, preconditioner="jacobi")
    assert _true_rel(a, b, cg.x) < 1e-9
    assert "init_s" in cg.timings
    plain = ConjugateGradient(precision=precision, device="cpu")
    plain.load_matrix_from_file(files[0])
    plain.load_rhs_from_file(files[1])
    assert plain.solve(max_iters=20000, rel_error=REL, warmup=False)
    assert "init_s" not in plain.timings
    assert cg.timings["num_iters"] < plain.timings["num_iters"]


def test_facade_check_symmetric_and_host_outer(files):
    cg = ConjugateGradient(precision="df64", device="cpu",
                           check_symmetric=True)
    assert cg.load_matrix_from_file(files[0])
    bad = ConjugateGradient(precision="df64", device="cpu",
                            check_symmetric=True)
    with pytest.raises(ValueError, match="is not symmetric") as mine:
        bad.load_matrix_from_file(files[2])
    jbad = lam_tpu.ConjugateGradient(backend="local", precision="df64",
                                     check_symmetric=True)
    with pytest.raises(ValueError, match="is not symmetric") as ref:
        jbad.load_matrix_from_file(files[2])
    assert str(mine.value) == str(ref.value)
    host = ConjugateGradient(precision="irfq", outer="host", device="cpu")
    host.load_matrix_from_file(files[0])
    host.load_rhs_from_file(files[1])
    with pytest.raises(ValueError, match="does not compose with a "
                       "preconditioner"):
        host.solve(max_iters=100, preconditioner="jacobi")


def test_cli_jacobi_preconditioner(tmp_path, capsys):
    """tests/test_cli.py:244-270 in the port's form (df64 for lam_tpu's
    f64; the sharded part runs in test_torch_sharded.py's cluster)."""
    a = np.asarray(jgen.random_spd_matrix(96, seed=6))
    s = np.exp(np.linspace(0, 4, 96))
    a = a * np.outer(s, s)          # bad scaling: jacobi should win
    b = np.asarray(jgen.random_rhs(96, seed=16))
    m, r, o = (str(tmp_path / f) for f in ("m.bin", "r.bin", "s.bin"))
    tio.write_matrix(m, a)
    tio.write_matrix(r, b)
    base = ["-A", m, "-b", r, "-o", o, "-i", "3000", "--precision", "df64",
            "--device", "cpu"]
    rc, out = _run(tcli.main, base)
    plain = out.split(",")
    rc2, out = _run(tcli.main, base + ["--preconditioner", "jacobi"])
    pcg = out.split(",")
    assert rc == rc2 == 0
    assert float(pcg[7]) < 1e-9
    assert int(pcg[6]) < int(plain[6])   # fewer iterations than plain CG
    x = tio.read_vector(o)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8
    rc, out = _run(tcli.main, base + ["--preconditioner", "jacobi",
                                      "--precision", "ir"])
    assert rc == 0 and float(out.split(",")[7]) < 1e-9
    x = tio.read_vector(o)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8
    # lam_tpu's count on its f64 path, within 2
    with contextlib.redirect_stdout(io.StringIO()) as ref:
        assert jcli.main(["-A", m, "-b", r, "-o", str(tmp_path / "j.bin"),
                          "-i", "3000", "--precision", "f64", "--backend",
                          "local", "--preconditioner", "jacobi"]) == 0
    assert abs(int(pcg[6]) - int(ref.getvalue().split(",")[6])) <= 2
    capsys.readouterr()


def test_cli_positional_form(files, tmp_path):
    a_path, b_path, _ = files
    sol = str(tmp_path / "pos.bin")
    rc, out = _run(tcli.main, [a_path, b_path, sol, "--device", "cpu"])
    fields = out.split(",")
    assert rc == 0 and float(fields[7]) < 1e-9
    assert os.path.exists(sol)
    # -i defaults to 1000 in positional form: an unconverged cap prints 1001
    rc, out = _run(tcli.main, [a_path, b_path, sol, "5", "1e-12",
                               "--device", "cpu"])
    assert rc == 0 and out.split(",")[6] == "6"
    rc, out = _run(tcli.main, [a_path, b_path, sol, "5", "--device", "cpu",
                               "-i", "7"])   # explicit flags win
    assert out.split(",")[6] == "8"
    rc, out = _run(tcli.main, [a_path, b_path, sol, "100000", "1e-30",
                               "--device", "cpu", "-i", "3"])
    assert out.split(",")[6] == "4"


def test_cli_positional_defaults_and_refusals(files, tmp_path, capsys):
    a_path, b_path, _ = files
    sol = str(tmp_path / "pos.bin")
    rc, out = _run(tcli.main, [a_path, b_path, sol, "0", "1e-12",
                               "--device", "cpu"])
    assert rc == 0 and out.split(",")[6] == "1"
    rc, _ = _run(tcli.main, ["a", "b", "c", "1", "1e-9", "extra",
                             "--device", "cpu"])
    assert rc == 1
    assert "Too many positional arguments." in capsys.readouterr().err
    rc, _ = _run(tcli.main, [a_path, b_path, "-s", "10", "--device", "cpu"])
    assert rc == 1
    assert "cannot be used with -s" in capsys.readouterr().err


def test_cli_check_symmetric(files, tmp_path, capsys):
    a_path, b_path, bad = files
    out_path = str(tmp_path / "x.bin")
    rc, _ = _run(tcli.main, ["-A", bad, "-b", b_path, "-o", out_path,
                             "--check-symmetric", "--device", "cpu"])
    err = capsys.readouterr().err
    with contextlib.redirect_stdout(io.StringIO()):
        assert jcli.main(["-A", bad, "-b", b_path, "-o", out_path,
                          "--check-symmetric", "--backend", "local"]) == 1
    assert rc == 1 and err == capsys.readouterr().err
    assert "is not symmetric" in err and len(err.strip().splitlines()) == 1
    rc, out = _run(tcli.main, ["-A", a_path, "-b", b_path, "-o", out_path,
                               "--check-symmetric", "--device", "cpu"])
    assert rc == 0 and float(out.split(",")[7]) < 1e-9


def test_cli_no_warmup_and_profile(files, tmp_path):
    a_path, b_path, _ = files
    common = ["-A", a_path, "-b", b_path, "-o", str(tmp_path / "x.bin"),
              "--device", "cpu", "--init-col"]
    rc, out = _run(tcli.main, common + ["--no-warmup"])
    assert rc == 0 and out.split(",")[4] == "0"   # no init_s
    rc, out = _run(tcli.main, common)
    assert rc == 0 and float(out.split(",")[4]) > 0
    prof = tmp_path / "prof"
    rc, out = _run(tcli.main, common + ["--profile", str(prof)])
    assert rc == 0 and float(out.split(",")[8]) < 1e-9
    assert sorted(os.listdir(prof)) == ["lam-cg.rank0.json"]
    with open(prof / "lam-cg.rank0.json") as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("argv,words", [
    (["--checkpoint", "ck", "--precision", "irfq", "--outer", "host"],
     "--outer host"),
    (["--checkpoint", "ck", "--checkpoint-every", "0"],
     "segment must be a positive"),
    (["--resume"], "--resume needs --checkpoint"),
    (["--platform", "cpu"], "--device")])
def test_cli_still_refused_flags(files, argv, words, capsys):
    a_path, b_path, _ = files
    rc, out = _run(tcli.main, ["-A", a_path, "-b", b_path, "--device", "cpu",
                               *argv])
    err = capsys.readouterr().err
    assert rc == 1 and out == ""
    assert err.startswith("lam-cg: ") and words in err
    assert len(err.strip().splitlines()) == 1
