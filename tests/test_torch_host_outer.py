"""Refinement with host-exact outer residuals (lam_tpu_torch/solver/host_outer.py)
and the q1-only operator, on the CPU, against lam_tpu.

The port's form of each of tests/test_host_outer.py's nine tests, and:
`cg_solve_ir_host` against lam_tpu's on the same file (inner iterations
within 5, as tests/test_torch_fq.py holds irfq); the q1-only buffers
byte-equal to lam_tpu's operand[0, 3, 6, 7], from lam_tpu's cache file
too; the accurate matvec refused with every launch counter unchanged;
the warm-up contract; the facade and the CLI with `--outer host --device
cpu`; each refusal, in lam_tpu's words where it has them.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import lam_tpu
from lam_tpu.solver import operators as jops
from lam_tpu.solver import pack_cache as jpc
from lam_tpu_torch import (ConjugateGradient, DenseOperator, cg_solve_ir,
                           cg_solve_ir_host)
from lam_tpu_torch import cli as tcli
from lam_tpu_torch import io as tio
from lam_tpu_torch import ops
from lam_tpu_torch.solver import pack_cache as pc
from lam_tpu_torch.solver.host_outer import host_matvec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spd_file(tmp_path, n, seed, fmt="npy"):
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    a = (q * np.exp(3.5 * rng.uniform(-1, 1, n))) @ q.T
    a = 0.5 * (a + a.T)
    b = rng.uniform(-1, 1, n)
    path = str(tmp_path / f"A.{fmt}")
    if fmt == "npy":
        np.save(path, a)
    else:
        tio.write_matrix(path, a)
    return path, a, b


def _true_rel(a, b, x):
    return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


def _exact_rel(a, b, x):
    """|b - A x| / |b| in extended precision: a reference whose own
    rounding is far below that of the f64 products compared with it."""
    ld = np.longdouble
    r = b.astype(ld) - a.astype(ld) @ x.astype(ld)
    return float(np.sqrt(np.sum(r * r)) / ld(np.linalg.norm(b)))


def test_host_outer_converges_true_1e9(tmp_path):
    path, a, b = _spd_file(tmp_path, 700, 5)
    op_q1 = DenseOperator.from_file_fq_q1(path, pack_cache=True, device="cpu")
    res = cg_solve_ir_host(a, op_q1, b, max_iters=10000, rel_error=1e-9)
    assert bool(res.converged) and isinstance(res.x, np.ndarray)
    assert _true_rel(a, b, res.x) < 1e-9
    # rel_residual IS the true residual (formed on the host)
    true_rel = _exact_rel(a, b, res.x)
    assert abs(res.rel_residual - true_rel) / true_rel < 1e-6
    assert 200 < res.num_iters < 1000


def test_iterations_match_lam_tpus_host_outer(tmp_path):
    path, a, b = _spd_file(tmp_path, 700, 5)
    mine = cg_solve_ir_host(
        a, DenseOperator.from_file_fq_q1(path, pack_cache=False,
                                         device="cpu"), b)
    ref = lam_tpu.cg_solve_ir_host(
        a, jops.DenseOperator.from_file_fq_q1(path, pack_cache=False), b)
    assert bool(mine.converged) and bool(ref.converged)
    # f32 sums in another order: a few inner iterations either way
    assert abs(mine.num_iters - int(ref.num_iters)) <= 5
    assert np.linalg.norm(mine.x - ref.x) / np.linalg.norm(ref.x) < 1e-8


@pytest.mark.parametrize("fmt", ["npy", "bin"])
def test_q1_buffers_are_lam_tpus(tmp_path, fmt):
    path, a, b = _spd_file(tmp_path, 600, 7, fmt)
    ref = jops.DenseOperator.from_file_fq_q1(path, pack_cache=True)
    cold = DenseOperator.from_file_fq_q1(path, pack_cache=False, device="cpu")
    warm = DenseOperator.from_file_fq_q1(path, pack_cache=True, device="cpu")
    for i in (0, 3, 6, 7):          # q1, s1, dh, dl; lam_tpu's cache read
        want = np.asarray(ref.operand[i])
        for op in (cold, warm):
            assert op.operand[i].numpy().tobytes() == want.tobytes()
    assert jpc.load(path, "fq") is not None and pc.load(path, "fq") is not None
    # q2/q3: one zero tile each, zero s2/s3, as lam_tpu holds them
    for i in (1, 2, 4, 5):
        assert cold.operand[i].shape == np.asarray(ref.operand[i]).shape
        assert not cold.operand[i].any()


def test_q1_partial_cache_load_matches_cold_upload(tmp_path, monkeypatch):
    path, a, b = _spd_file(tmp_path, 600, 7)
    cold = DenseOperator.from_file_fq_q1(path, pack_cache=True, device="cpu")
    assert pc.load(path, "fq") is not None   # the cold path published

    def no_pack(*args):
        raise AssertionError("a warm load must not pack")

    from lam_tpu_torch import _native_io
    from lam_tpu_torch.solver import operators as tops
    monkeypatch.setattr(_native_io, "pack_fq", no_pack)
    monkeypatch.setattr(tops, "_host_pack_tri", no_pack)
    warm = DenseOperator.from_file_fq_q1(path, pack_cache=True, device="cpu")
    for i in (0, 3, 6, 7):
        assert torch.equal(cold.operand[i], warm.operand[i])
    # and both equal the full fq operator's buffers (one layout)
    full = DenseOperator.from_file_fq(path, pack_cache=True, device="cpu")
    for i in (0, 3, 6, 7):
        assert torch.equal(warm.operand[i], full.operand[i])
    # the full operator's inner view gives the q1-only one's products
    p = warm.prepare_b(np.random.default_rng(1).uniform(-1, 1, 600))
    p32 = p.to(torch.float32)
    assert torch.equal(warm.as_f32().matvec(p32), full.as_f32().matvec(p32))


def test_q1_only_accurate_matvec_refuses(tmp_path):
    path, a, b = _spd_file(tmp_path, 600, 7)
    op_q1 = DenseOperator.from_file_fq_q1(path, pack_cache=False,
                                          device="cpu")
    ops.reset_counters()
    p = op_q1.prepare_b(np.ones(600))
    for mv in (op_q1.matvec, op_q1.matvec_dot):
        with pytest.raises(NotImplementedError, match="q1-only"):
            mv(p)
    # no walk ran, gemv_fq_symm_zero's least of all
    assert not any(ops.counters().values())
    with pytest.raises(NotImplementedError, match="q1-only"):
        cg_solve_ir(op_q1.as_f32(), op_q1, b)   # the device outer loop
    # the inner view works
    res = cg_solve_ir_host(a, op_q1, b, rel_error=1e-9)
    assert bool(res.converged)
    counts = ops.counters()
    assert counts["gemv_q16_symm_plain"] > 0
    assert {k for k, v in counts.items() if v} == {"gemv_q16_symm_plain"}


def test_host_outer_callable_operator(tmp_path):
    """Matrix-free or file-streaming callers pass a callable outer."""
    path, a, b = _spd_file(tmp_path, 600, 7)
    op_q1 = DenseOperator.from_file_fq_q1(path, pack_cache=True, device="cpu")
    calls = []

    def outer(x):
        calls.append(1)
        return a @ x

    res = cg_solve_ir_host(outer, op_q1, b, rel_error=1e-9)
    assert bool(res.converged)
    assert calls  # one call a refinement cycle
    assert len(calls) < 15


@pytest.mark.parametrize("fmt", ["npy", "bin"])
def test_host_matvec_symv_matches_gemv(tmp_path, fmt, monkeypatch):
    """dsymv over the memory map's a.T view (one triangle read, no copy)
    agrees with a @ x to f64 rounding, in both file formats."""
    path, a, b = _spd_file(tmp_path, 300, 11, fmt)
    am = tio.open_matrix_memmap(path)
    assert am.T.flags.f_contiguous       # dsymv takes it as it is
    from scipy.linalg import blas
    seen = []
    orig = blas.dsymv

    def dsymv(alpha, at, x, lower):
        seen.append(np.shares_memory(at, am))
        return orig(alpha, at, x, lower=lower)

    monkeypatch.setattr(blas, "dsymv", dsymv)
    mv = host_matvec(am)
    x = np.random.default_rng(0).uniform(-1, 1, 300)
    np.testing.assert_allclose(mv(x), a @ x, rtol=1e-13, atol=1e-13)
    assert seen == [True]
    # a view that is not F-ordered when transposed takes a @ x
    mv2 = host_matvec(np.asfortranarray(a))
    np.testing.assert_allclose(mv2(x), a @ x, rtol=1e-13, atol=1e-13)
    assert seen == [True]


def test_host_outer_zero_rhs(tmp_path):
    path, a, b = _spd_file(tmp_path, 600, 7)
    op_q1 = DenseOperator.from_file_fq_q1(path, pack_cache=True, device="cpu")
    res = cg_solve_ir_host(a, op_q1, np.zeros(600), rel_error=1e-9)
    assert bool(res.converged) and res.num_iters == 0
    assert np.all(res.x == 0)
    with pytest.raises(ValueError, match="rhs has shape"):
        cg_solve_ir_host(a, op_q1, np.zeros(599))


def test_host_outer_warm_up_contract(tmp_path):
    path, a, b = _spd_file(tmp_path, 600, 7)
    op_q1 = DenseOperator.from_file_fq_q1(path, pack_cache=False,
                                          device="cpu")
    calls = []
    ops.reset_counters()
    res = cg_solve_ir_host(lambda x: calls.append(1) or a @ x, op_q1, b,
                           max_iters=0)
    assert (res.num_iters, res.rel_residual, bool(res.converged)) == (
        0, 1.0, False)
    assert np.all(res.x == 0) and not calls      # no cycle, no host matvec
    assert ops.counters()["gemv_q16_symm_plain"] == 1   # the kernel ran


def test_api_outer_host(tmp_path):
    """ConjugateGradient(outer='host'): a file-mode irfq solve with
    host-exact outer residuals through the facade."""
    path, a, b = _spd_file(tmp_path, 700, 5)
    rhs = tmp_path / "b.bin"
    tio.write_matrix(str(rhs), b.reshape(-1, 1))
    cg = ConjugateGradient(backend="local", precision="irfq", outer="host",
                           pack_cache=True, device="cpu")
    assert cg.load_matrix_from_file(path)
    assert cg.load_rhs_from_file(str(rhs))
    assert tuple(cg.op.operand[1].shape) == (512, 512)   # q1 alone
    ops.reset_counters()
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    assert _true_rel(a, b, cg.x) < 1e-9
    assert cg.timings["num_iters"] > 200
    assert cg.timings["rel_residual"] == cg.result.rel_residual
    cg.measure_gemv(repeats=2)
    assert cg.timings["avg_gemv_s"] > 0 and "avg_gemv_acc_s" not in cg.timings
    assert {k for k, v in ops.counters().items() if v} == {
        "gemv_q16_symm_plain"}


def test_api_outer_host_validation(tmp_path):
    with pytest.raises(ValueError, match="outer='host' requires"):
        ConjugateGradient(backend="local", precision="df64", outer="host",
                          device="cpu")
    with pytest.raises(ValueError, match="outer='host' requires"):
        ConjugateGradient(backend="sharded", precision="irfq", outer="host",
                          device="cpu")
    with pytest.raises(ValueError, match="outer must be"):
        ConjugateGradient(outer="remote", device="cpu")
    for mod in (lam_tpu.ConjugateGradient, ConjugateGradient):  # same words
        with pytest.raises(ValueError) as e:
            mod(backend="local", precision="irq", outer="host")
        assert "requires precision='irfq' and backend='local'" in str(e.value)
    # generate mode refuses at once, before anything is built
    cg = ConjugateGradient(precision="irfq", outer="host", device="cpu")
    with pytest.raises(ValueError, match="generate mode has no file"):
        cg.generate_matrix(600)
    assert cg.op is None and cg.n is None


@pytest.mark.parametrize("engine", ["pallas", "pallas_symm"])
@pytest.mark.parametrize("precision", ["fq", "irfq", "dfq", "irq"])
def test_quantized_precisions_refuse_the_square_engines(precision, engine):
    with pytest.raises(ValueError, match="implies packed storage"):
        ConjugateGradient(precision=precision, engine=engine, device="cpu")


def test_cli_outer_host(tmp_path):
    """`--precision irfq --outer host` end to end: the CSV contract, the
    solution written, converged; a second run reads q1 from the cache."""
    path, a, b = _spd_file(tmp_path, 700, 5, "bin")
    rhs = tmp_path / "b.bin"
    tio.write_matrix(str(rhs), b.reshape(-1, 1))
    rows = []
    for k in range(2):
        out = io.StringIO()
        x_path = tmp_path / f"x{k}.bin"
        with contextlib.redirect_stdout(out):
            rc = tcli.main(["-A", path, "-b", str(rhs), "-o", str(x_path),
                            "-e", "1e-9", "-i", "10000", "--precision",
                            "irfq", "--outer", "host", "--pack-cache",
                            "--device", "cpu"])
        assert rc == 0
        fields = out.getvalue().strip().splitlines()[-1].split(",")
        # N,procs,threads,load_s,avg_gemv_s,avg_iter_s,num_iter,err,...
        assert len(fields) == 9 and fields[:3] == ["700", "1", "1"]
        assert float(fields[7]) < 1e-9       # the converged residual
        rows.append(fields)
        assert _true_rel(a, b, tio.read_vector(str(x_path))) < 1e-9
    assert rows[0][6] == rows[1][6]          # cold and warm: one count
    assert np.array_equal(tio.read_vector(str(tmp_path / "x0.bin")),
                          tio.read_vector(str(tmp_path / "x1.bin")))


def test_cli_refuses_outer_host_in_generate_mode(capsys):
    assert tcli.main(["-s", "200", "--precision", "irfq", "--outer", "host",
                      "--device", "cpu"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "--outer host" in err[0]
    assert tcli.main(["-A", "m.bin", "-b", "b.bin", "--precision", "df64",
                      "--outer", "host", "--device", "cpu"]) == 1
    assert "outer='host' requires" in capsys.readouterr().err
