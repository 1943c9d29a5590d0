"""The port's full-square engine (engine="pallas": the dense f32 and df64
matvecs, the operator, the df64 and ir solves, the CLI) against lam_tpu, on
the CPU.

Kernels: the plain dense matvecs against lam_tpu's `gemv_f32` (both impls)
and `gemv_df64` in interpret mode, as tests/test_kernels.py runs them, and
against the f64 oracle a @ p, on a square and on a row block (m != n).
lam_tpu's df64 kernel is held to 1e-6 only: XLA:CPU breaks its in-kernel
compensation. Solves: random_spd_system(1000, seed=25), padded to 1024.
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
from lam_tpu_torch import ConjugateGradient, DenseOperator, cg_solve, cg_solve_ir
from lam_tpu_torch import cli as tcli
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import gemv
from lam_tpu_torch.precision import split_f64_host

N, SEED = 1000, 25
SHAPES = [(1024, 1024), (256, 1024)]  # a square and a row block


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
    """lam_tpu's f64 oracle solves: (cg x, cg iters, ir iters)."""
    a, b = system
    op = lam_tpu.DenseOperator.from_dense(a, precision="f64")
    cg = lam_tpu.cg_solve(op, b, max_iters=10000, rel_error=1e-9)
    ir = lam_tpu.cg_solve_ir(op.as_f32(), op, b, max_iters=10000,
                             rel_error=1e-9)
    assert bool(cg.converged) and bool(ir.converged)
    return np.asarray(cg.x), int(cg.num_iters), int(ir.num_iters)


@pytest.fixture(scope="module")
def op(system):
    return DenseOperator.from_dense(system[0], precision="df64",
                                    engine="pallas", device="cpu")


def _rel(y, ref):
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _true_rel(a, b, x):
    return np.linalg.norm(b - a @ x) / np.linalg.norm(b)


def _nonsymmetric(n, seed):
    """A well-conditioned matrix that is far from symmetric."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(n, n)) + n * np.eye(n) * 0.1 + np.triu(
        rng.uniform(0, 2, size=(n, n)), 1)


# -- kernels: plain versions against lam_tpu and the oracle ----------------

@pytest.mark.parametrize("impl", ["dot", "vpu"])
@pytest.mark.parametrize("m,n", SHAPES)
def test_gemv_f32_plain_matches_lam_tpu(m, n, impl):
    rng = np.random.default_rng(m + n)
    a = rng.uniform(-1, 1, size=(m, n)).astype(np.float32)
    p = rng.uniform(-1, 1, size=n).astype(np.float32)
    gemv.reset_counters()
    y = gemv.gemv_f32(torch.from_numpy(a), torch.from_numpy(p))
    assert y.dtype == torch.float32 and y.shape == (m,)
    counts = gemv.counters()
    assert counts.pop("gemv_f32_plain") == 1
    assert set(counts.values()) == {0}  # a CPU tensor launches nothing
    ref = np.asarray(jgemv.gemv_f32(jnp.asarray(a), jnp.asarray(p),
                                    impl=impl))
    # exact f32 products summed in f32, in different orders
    assert _rel(y.numpy().astype(np.float64), ref.astype(np.float64)) <= 1e-5
    oracle = a.astype(np.float64) @ p.astype(np.float64)
    assert _rel(y.numpy().astype(np.float64), oracle) <= 1e-5


@pytest.mark.parametrize("m,n", SHAPES)
def test_gemv_df64_plain_matches_oracle_and_lam_tpu(m, n):
    rng = np.random.default_rng(m + n + 1)
    a = rng.uniform(-1, 1, size=(m, n))
    p = rng.uniform(-1, 1, size=n)
    (ah, al), (ph, pl) = split_f64_host(a), split_f64_host(p)
    gemv.reset_counters()
    yh, yl = gemv.gemv_df64(*map(torch.from_numpy, (ah, al, ph, pl)))
    assert yh.dtype == yl.dtype == torch.float32 and yh.shape == (m,)
    assert gemv.counters()["gemv_df64_plain"] == 1
    y = yh.numpy().astype(np.float64) + yl.numpy()
    # f64 accumulation of the exact (hi + lo) values, as an f32 split
    oracle = ((ah.astype(np.float64) + al) @ (ph.astype(np.float64) + pl))
    assert _rel(y, oracle) <= 1e-13
    jh, jl = jgemv.gemv_df64(*map(jnp.asarray, (ah, al, ph, pl)))
    yj = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    # XLA:CPU excess precision weakens lam_tpu's compensation on the CPU
    assert _rel(y, yj) <= 1e-6


def test_dense_shape_rejections():
    a = torch.zeros(256, 1024)
    p = torch.zeros(1024)
    with pytest.raises(ValueError) as ref:
        jgemv.gemv_f32(jnp.zeros((256, 1000), jnp.float32),
                       jnp.zeros(1000, jnp.float32))
    with pytest.raises(ValueError) as mine:
        gemv.gemv_f32(torch.zeros(256, 1000), torch.zeros(1000))
    # lam_tpu's message, pointing at the port's own padding
    assert str(mine.value).split(";")[0] == str(ref.value).split(";")[0]
    with pytest.raises(ValueError, match="rows=100 "):
        gemv.gemv_f32(torch.zeros(100, 1024), p)
    with pytest.raises(ValueError, match="1000 entries"):
        gemv.gemv_f32(a, torch.zeros(1000))
    with pytest.raises(ValueError, match="float32"):
        gemv.gemv_f32(a.double(), p)
    with pytest.raises(ValueError, match="contiguous"):
        gemv.gemv_f32(torch.zeros(1024, 256).T, p)
    with pytest.raises(ValueError, match="a_lo"):
        gemv.gemv_df64(a, a[:128], p, p)
    with pytest.raises(ValueError, match="comp"):
        gemv.gemv_df64(a, a, p, p, comp="defer")


# -- the full-square operator -----------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "df64"])
def test_nonsymmetric_matrix_gives_a_p(precision):
    n = 700
    a = _nonsymmetric(n, 70)
    op = DenseOperator.from_dense(a, precision=precision, engine="pallas",
                                  device="cpu")
    assert (op.n, op.n_padded, op.engine) == (n, 1024, "pallas")
    p = op.prepare_b(np.random.default_rng(71).uniform(-1, 1, n))
    y = op.matvec(p).double().numpy()
    ref = a @ p.double().numpy()[:n]
    mirrored = np.tril(a) + np.tril(a, -1).T  # what a triangle walk gives
    tol = 1e-6 if precision == "f32" else 1e-13
    assert _rel(y[:n], ref) <= tol
    assert _rel(y[:n], mirrored @ p.double().numpy()[:n]) > 1e-2
    assert not y[n:].any()
    # 'auto' picks the full square for it; the packed engine refuses it
    auto = DenseOperator.from_dense(a, precision=precision, device="cpu")
    assert auto.engine == "pallas"
    assert torch.equal(auto.matvec(p), op.matvec(p))
    with pytest.raises(ValueError, match="engine='pallas'"):
        DenseOperator.from_dense(a, precision=precision,
                                 engine="pallas_symm_packed", device="cpu")


def test_auto_keeps_the_packed_engine_for_symmetric_input(system):
    op = DenseOperator.from_dense(system[0], precision="df64", device="cpu")
    assert op.engine == "pallas_symm_packed"


def test_full_square_operator_views(system, op):
    a = system[0]
    assert [tuple(x.shape) for x in op.operand] == [(1024, 1024)] * 2
    op32 = op.as_f32()
    assert op32.operand is op.operand and op32.vector_dtype == torch.float32
    p = op.prepare_b(np.random.default_rng(72).uniform(-1, 1, N))
    y32 = op32.matvec(p.float()).double().numpy()
    assert _rel(y32[:N], a @ p.numpy()[:N]) <= 1e-6
    d = op.diagonal()
    assert d.dtype == torch.float64
    np.testing.assert_allclose(d.numpy()[:N], np.diagonal(a), rtol=2.0 ** -47,
                               atol=0)
    assert not d[N:].any()
    f32 = DenseOperator.from_dense(a, precision="f32", engine="pallas",
                                   device="cpu")
    assert torch.equal(f32.diagonal()[:N],
                       torch.from_numpy(np.diagonal(a).astype(np.float32)))


def test_from_df64_planes_carries_lam_tpu_operand(system, op):
    a = system[0]
    jop = lam_tpu.DenseOperator.from_dense(a, precision="df64",
                                           engine="pallas")
    hi, lo = (np.asarray(x) for x in jop.operand)
    carried = DenseOperator.from_df64_planes(hi, lo, jop.n, device="cpu")
    assert (carried.n, carried.n_padded, carried.engine) == (N, 1024,
                                                             "pallas")
    for mine, theirs in zip(carried.operand, op.operand):
        assert torch.equal(mine, theirs)
    p = op.prepare_b(np.random.default_rng(73).uniform(-1, 1, N))
    y = carried.matvec(p).numpy()
    yj = np.asarray(jop.matvec(jnp.asarray(p.numpy())))
    assert _rel(y, yj) <= 1e-6  # XLA:CPU's compensation, as above
    assert _rel(y[:N], a @ p.numpy()[:N]) <= 1e-13
    with pytest.raises(NotImplementedError, match="pallas_symm"):
        DenseOperator.from_df64_planes(hi, lo, N, engine="pallas_symm",
                                       device="cpu")
    with pytest.raises(ValueError, match="square"):
        DenseOperator.from_df64_planes(hi[:512], lo[:512], N, device="cpu")


# -- solves -----------------------------------------------------------------

def test_df64_pallas_solve_matches_lam_tpu_f64(system, jax_ref, op):
    a, b = system
    gemv.reset_counters()
    res = cg_solve(op, b, max_iters=10000, rel_error=1e-9)
    x = res.x.numpy()
    assert bool(res.converged)
    assert abs(int(res.num_iters) - jax_ref[1]) <= 1
    assert _true_rel(a, b, x) <= 1e-9
    assert _rel(x, jax_ref[0]) <= 1e-8
    counts = gemv.counters()
    assert counts["gemv_df64_plain"] >= int(res.num_iters)
    assert counts["gemv_df64_symm_plain"] == 0


def test_ir_pallas_solve_matches_lam_tpu(system, jax_ref, op):
    a, b = system
    gemv.reset_counters()
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=10000, rel_error=1e-9)
    x = res.x.numpy()
    assert bool(res.converged) and res.x.dtype == torch.float64
    # f32 sums in another order than lam_tpu's (362 inner iterations):
    # torch.mv's order gives 360 on one thread, the packed walk 362-364
    assert abs(int(res.num_iters) - jax_ref[2]) <= 0.02 * jax_ref[2]
    assert _true_rel(a, b, x) <= 1e-9
    counts = gemv.counters()
    assert counts["gemv_f32_plain"] >= int(res.num_iters)
    assert 0 < counts["gemv_df64_plain"] <= 6
    assert counts["gemv_f32_symm_plain"] == counts["gemv_df64_symm_plain"] == 0


# -- the facade and the CLI --------------------------------------------------

def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(argv)
    assert rc == 0
    return out.getvalue().strip().splitlines()


@pytest.mark.parametrize("precision", ["df64", "ir"])
def test_cli_engine_pallas(tmp_path, capsys, precision):
    a, b = jgen.random_spd_system(600, seed=9)
    tio.write_matrix(tmp_path / "A.bin", a)
    tio.write_matrix(tmp_path / "b.bin", b)
    gemv.reset_counters()
    lines = _run(["-A", str(tmp_path / "A.bin"), "-b",
                  str(tmp_path / "b.bin"), "-o", str(tmp_path / "x.bin"),
                  "--precision", precision, "--engine", "pallas",
                  "--device", "cpu", "--pack-cache"])
    fields = lines[-1].split(",")
    assert len(fields) == 9 and fields[:3] == ["600", "1", "1"]
    assert float(fields[7]) < 1e-9 and int(fields[6]) < 10000
    assert _true_rel(a, b, tio.read_vector(tmp_path / "x.bin")) <= 1e-9
    counts = gemv.counters()
    assert counts["gemv_df64_plain"] > 0
    assert counts["gemv_f32_symm_plain"] == counts["gemv_df64_symm_plain"] == 0
    # the full square reads the file whole: the cache is ignored, said so
    assert "ignored for --engine pallas" in capsys.readouterr().err
    assert not list(tmp_path.glob("A.bin.*pack"))


def test_cli_verbose_prints_the_engine(tmp_path):
    a, b = jgen.random_spd_system(300, seed=10)
    tio.write_matrix(tmp_path / "A.bin", a)
    tio.write_matrix(tmp_path / "b.bin", b)
    lines = _run(["-A", str(tmp_path / "A.bin"), "-b",
                  str(tmp_path / "b.bin"), "-o", str(tmp_path / "x.bin"),
                  "--engine", "pallas", "--device", "cpu", "-v"])
    assert "  precision=df64 engine=pallas" in lines


def test_engine_options_that_raise(tmp_path, system):
    for precision in ("dfq", "irq", "fq", "irfq"):
        with pytest.raises(ValueError, match="packed"):
            ConjugateGradient(precision=precision, engine="pallas",
                              device="cpu")
    for engine in ("pallas_symm", "xla"):
        with pytest.raises(NotImplementedError, match=engine):
            ConjugateGradient(engine=engine, device="cpu")
        with pytest.raises(NotImplementedError, match=engine):
            DenseOperator.from_dense(system[0], engine=engine, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        ConjugateGradient(engine="mosaic", device="cpu")
    assert tcli.main(["--precision", "irq", "--engine", "pallas",
                      "--device", "cpu"]) == 1
