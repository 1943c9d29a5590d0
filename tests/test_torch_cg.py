"""The port's main path (df64 and ir CG on packed triangle storage) against
lam_tpu, on the CPU.

The solve-level reference is lam_tpu's float64 oracle path
(`DenseOperator.from_dense(a, precision="f64")`): on the CPU, lam_tpu's
packed df64 Pallas engine runs under XLA:CPU excess precision, which
breaks its compensated arithmetic (per-matvec error ~2e-8), so its
iteration counts are not a usable reference here. The system is
random_spd_system(1000, seed=25): n_p=1024, tb=512, 3 packed tiles.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lam_tpu
from lam_tpu import cli as jcli
from lam_tpu import generate as jgen
from lam_tpu_torch import ConjugateGradient, DenseOperator, cg_solve, cg_solve_ir
from lam_tpu_torch import cli as tcli
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import gemv

N, SEED = 1000, 25
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def jax_ref(system):
    """lam_tpu's f64 oracle solves: (cg x, cg iters, ir x, ir iters)."""
    a, b = system
    op = lam_tpu.DenseOperator.from_dense(a, precision="f64")
    cg = lam_tpu.cg_solve(op, b, max_iters=10000, rel_error=1e-9)
    ir = lam_tpu.cg_solve_ir(op.as_f32(), op, b, max_iters=10000,
                             rel_error=1e-9)
    assert bool(cg.converged) and bool(ir.converged)
    return (np.asarray(cg.x), int(cg.num_iters), np.asarray(ir.x),
            int(ir.num_iters))


@pytest.fixture(scope="module")
def op(system):
    return DenseOperator.from_dense(system[0], precision="df64",
                                    engine="pallas_symm_packed", device="cpu")


@pytest.fixture(scope="module")
def df64_res(system, op):
    return cg_solve(op, system[1], max_iters=10000, rel_error=1e-9)


def _true_rel(a, b, x):
    return np.linalg.norm(b - a @ x) / np.linalg.norm(b)


def _rel(x, y):
    return np.linalg.norm(x - y) / np.linalg.norm(y)


def test_operator_layout(op):
    assert (op.n, op.n_padded, op.precision, op.engine) == (
        N, 1024, "df64", "pallas_symm_packed")
    assert [tuple(x.shape) for x in op.operand] == [(3 * 512, 512)] * 2
    assert all(x.dtype == torch.float32 for x in op.operand)


def test_f64_oracle_path_matches_lam_tpu(system, jax_ref):
    a, b = system
    op64 = DenseOperator.from_dense(a, precision="f64", device="cpu")
    assert (op64.n_padded, op64.engine) == (N, "xla")
    res = cg_solve(op64, b, max_iters=10000, rel_error=1e-9)
    # two f64 CGs that sum in different orders: the count near the 1e-9
    # threshold moves by a few (torch's BLAS matvec gave 332-334 against
    # lam_tpu's 335, depending on the CPU threads it was given)
    assert abs(int(res.num_iters) - jax_ref[1]) <= 5
    assert _rel(res.x.numpy(), jax_ref[0]) <= 1e-8


def test_df64_solve_matches_lam_tpu(system, jax_ref, df64_res):
    a, b = system
    res = df64_res
    x = res.x.numpy()
    assert bool(res.converged) and x.shape == (N,)
    assert abs(int(res.num_iters) - jax_ref[1]) <= 1
    assert _true_rel(a, b, x) <= 1e-9
    assert _rel(x, jax_ref[0]) <= 1e-8


def test_ir_solve_matches_lam_tpu(system, jax_ref, op):
    a, b = system
    gemv.reset_counters()
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=10000, rel_error=1e-9)
    x = res.x.numpy()
    assert bool(res.converged) and res.x.dtype == torch.float64
    # another f32 summation order (packed walk vs lam_tpu's dense cast)
    assert abs(int(res.num_iters) - jax_ref[3]) <= 0.05 * jax_ref[3]
    assert _true_rel(a, b, x) <= 1e-9
    assert _rel(x, jax_ref[2]) <= 1e-8
    counts = gemv.counters()
    assert counts["gemv_f32_symm_plain"] >= int(res.num_iters)
    assert 0 < counts["gemv_df64_symm_plain"] <= 6


def test_from_packed_planes_carries_lam_tpu_operand(system, op, df64_res):
    a, b = system
    jop = lam_tpu.DenseOperator.from_dense(a, precision="df64",
                                           engine="pallas_symm_packed")
    hi, lo = (np.asarray(x) for x in jop.operand)
    carried = DenseOperator.from_packed_planes(hi, lo, jop.n, jop.n_padded,
                                               device="cpu")
    assert carried.n_padded == op.n_padded
    for mine, theirs in zip(carried.operand, op.operand):
        assert torch.equal(mine, theirs)
    r1 = cg_solve(carried, b, max_iters=10000, rel_error=1e-9)
    assert int(r1.num_iters) == int(df64_res.num_iters)
    assert torch.equal(r1.x, df64_res.x)


def test_as_f32_shares_storage_and_copy_is_rejected(system, op):
    op32 = op.as_f32()
    assert op32.operand is op.operand
    assert op32.operand[0].data_ptr() == op.operand[0].data_ptr()
    assert op32.vector_dtype == torch.float32
    copy = DenseOperator(op32._matvec_fn, tuple(x.clone() for x in op.operand),
                         op.n, op.n_padded, torch.float32, "f32", op.engine,
                         op.device)
    with pytest.raises(ValueError, match="VIEW"):
        cg_solve_ir(copy, op, system[1], max_iters=10)


@pytest.mark.parametrize("max_iters", [0, 37, 64])
def test_num_iters_is_max_iters_when_unconverged(system, op, max_iters):
    b = system[1]
    res = cg_solve(op, b, max_iters=max_iters, rel_error=1e-9)
    assert int(res.num_iters) == max_iters and not bool(res.converged)
    ir = cg_solve_ir(op.as_f32(), op, b, max_iters=max_iters,
                     rel_error=1e-9)
    assert int(ir.num_iters) == max_iters and not bool(ir.converged)


def test_frozen_iterations_leave_the_state_unchanged(system, op, df64_res):
    # convergence inside a chunk: the frozen tail must not move x
    k = int(df64_res.num_iters)
    assert k % 32 != 0  # the solve did run frozen iterations
    exact = cg_solve(op, system[1], max_iters=k, rel_error=0.0)
    assert torch.equal(df64_res.x, exact.x)


def test_exact_convergence_keeps_frozen_state_finite(system):
    # A = 2I in f32: one iteration gives r == 0 exactly, so the frozen
    # tail sees 0/0 in alpha and beta; the frozen state must stay finite
    b = system[1].astype(np.float32)
    op2 = DenseOperator.from_dense(2.0 * np.eye(N), precision="f32",
                                   device="cpu")
    res = cg_solve(op2, b, max_iters=100, rel_error=1e-9)
    assert int(res.num_iters) == 1 and bool(res.converged)
    assert float(res.rel_residual) == 0.0
    assert torch.equal(res.x, torch.from_numpy(b / 2))


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    assert rc == 0
    return out.getvalue().strip().splitlines()[-1].split(",")


@pytest.mark.parametrize("precision,tol,x_tol", [("df64", 1e-9, 1e-8),
                                                 ("ir", 1e-9, 1e-8),
                                                 ("f32", 1e-5, 1e-3)])
def test_cli_csv_fields_match_lam_tpu(tmp_path, precision, tol, x_tol):
    a, b = jgen.random_spd_system(200, seed=3)
    tio.write_matrix(tmp_path / "A.bin", a)
    tio.write_matrix(tmp_path / "b.bin", b)
    common = ["-A", str(tmp_path / "A.bin"), "-b", str(tmp_path / "b.bin"),
              "--precision", precision, "-e", str(tol)]
    mine = _run(tcli.main, common + ["-o", str(tmp_path / "x.bin"),
                                     "--device", "cpu"])
    theirs = _run(jcli.main, common + ["-o", str(tmp_path / "xj.bin"),
                                       "--backend", "local"])
    # N,procs,threads,load_s,avg_gemv_s,avg_iter_s,num_iter,err,total_cg_s
    assert len(mine) == len(theirs) == 9
    assert mine[:3] == theirs[:3] == ["200", "1", "1"]
    assert abs(int(mine[6]) - int(theirs[6])) <= 0.05 * int(theirs[6])
    assert float(mine[7]) < tol and float(theirs[7]) < tol
    x, xj = (tio.read_vector(tmp_path / f) for f in ("x.bin", "xj.bin"))
    assert _rel(x, xj) <= x_tol
    unconverged = _run(tcli.main, common + ["-o", str(tmp_path / "y.bin"),
                                            "--device", "cpu", "-i", "5"])
    assert unconverged[6] == "6"  # the reference's loop-exit value


def test_facade_solves_and_records(tmp_path, system):
    a, b = system
    tio.write_matrix(tmp_path / "A.bin", a)
    tio.write_matrix(tmp_path / "b.bin", b)
    cg = ConjugateGradient(precision="ir", device="cpu")
    cg.load_matrix_from_file(tmp_path / "A.bin")
    cg.load_rhs_from_file(tmp_path / "b.bin")
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    assert {"load_s", "init_s", "solve_s", "num_iters",
            "csv_num_iters"} <= set(cg.timings)
    assert cg.measure_gemv(repeats=2) > 0
    assert "avg_gemv_acc_s" in cg.timings
    cg.save_result_to_file(tmp_path / "x.bin")
    assert np.array_equal(tio.read_vector(tmp_path / "x.bin"), cg.x)
    assert _true_rel(a, b, cg.x) <= 1e-9


def test_unported_options_raise(system, capsys):
    # the symmetric 2-D grid is routed, not refused
    cg = ConjugateGradient(backend="sharded2d", precision="irq", device="cpu")
    assert cg._sharded_engine == "pallas_symm_packed"
    cg = ConjugateGradient(backend="sharded2d", engine="pallas_symm_packed",
                           precision="df64", device="cpu")
    assert cg._sharded_engine == "pallas_symm_packed"
    with pytest.raises(ValueError, match="supports precision df64/ir"):
        ConjugateGradient(backend="sharded2d", engine="pallas_symm_packed",
                          precision="f32", device="cpu")
    # backend and precision 'auto' (the defaults) and engine 'xla' route:
    # one process is one device, and the CPU's auto precision is f64
    cg = ConjugateGradient(backend="auto", device="cpu")
    assert (cg.backend, cg.precision) == ("local", "f64")
    engine = "xla"
    assert ConjugateGradient(engine=engine, device="cpu").engine == engine
    op = DenseOperator.from_dense(system[0], engine=engine, device="cpu")
    assert (op.engine, op.precision, op.n_padded) == (engine, "df64", N)
    fields = _run(tcli.main, ["-s", "100", "--device", "cpu", "-i", "15",
                              "--engine", engine, "-o", os.devnull])
    assert fields[0] == "100" and fields[6] == "16"
    # an engine neither package knows: one stderr line, rc 1
    with pytest.raises(ValueError, match="unknown engine"):
        DenseOperator.from_dense(system[0], engine="mosaic", device="cpu")
    # the full-square symmetric engine and generate mode now route on one
    # device (tests/test_torch_gen.py holds them against lam_tpu)
    assert ConjugateGradient(engine="pallas_symm", precision="df64",
                             device="cpu").engine == "pallas_symm"
    op = DenseOperator.from_dense(system[0], engine="pallas_symm",
                                  device="cpu")
    assert op.engine == "pallas_symm" and op.operand[0].shape == (1024, 1024)
    fields = _run(tcli.main, ["-s", "100", "--device", "cpu", "-i", "15",
                              "-o", os.devnull])
    assert fields[0] == "100" and fields[6] == "16"


def test_cuda_request_raises_without_fallback(system):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ConjugateGradient(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        DenseOperator.from_dense(system[0], precision="df64", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["-A", "m.bin", "-b", "b.bin"])  # --device defaults to cuda


def test_import_leaves_jax_out():
    code = ("import sys, lam_tpu_torch, lam_tpu_torch.cli, "
            "lam_tpu_torch.generate, lam_tpu_torch.ops._build, "
            "lam_tpu_torch.ops.gemv, lam_tpu_torch.ops.layout, "
            "lam_tpu_torch.solver.api, lam_tpu_torch.solver.cg, "
            "lam_tpu_torch.solver.operators, "
            "lam_tpu_torch.solver.pack_cache, lam_tpu_torch.parallel.mesh, "
            "lam_tpu_torch.parallel.pcg, lam_tpu_torch.parallel.pcg_symm, "
            "lam_tpu_torch._native_io, lam_tpu_torch.ops.transfer, "
            "lam_tpu_torch.solver.host_outer, lam_tpu_torch.apps.heat, "
            "lam_tpu_torch.apps.heat_cli, lam_tpu_torch.parallel.pcg2d, "
            "lam_tpu_torch.parallel.pcg2d_symm; "
            "lam_tpu_torch._native_io.available(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lam_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
