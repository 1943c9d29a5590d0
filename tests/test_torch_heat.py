"""The port's heat-equation demo (lam_tpu_torch.apps, ops.stencil) against
lam_tpu's on the CPU: the plain stencil against lam_tpu's Pallas kernel in
interpret mode (as tests/test_heat.py runs it), the Jacobi sweep, the f64
and ir CG solves, the CLIs and the BMP bytes. Small grids; inputs made
with numpy from a seed.
"""

import contextlib
import io
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_tpu import io as jio
from lam_tpu.apps import bmp as jbmp
from lam_tpu.apps import bmp_cli as jbmp_cli
from lam_tpu.apps import heat as jheat
from lam_tpu.ops import stencil as jst
from lam_tpu_torch import io as tio
from lam_tpu_torch import ops
from lam_tpu_torch.apps import bmp, bmp_cli, heat, heat_cli
from lam_tpu_torch.ops import gemv, stencil
from lam_tpu_torch.solver.cg import cg_solve
from lam_tpu_torch.solver.operators import LinearOperator, MatrixFreeOperator

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test processes on shared cores: torch's own
    # thread pool would oversubscribe them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_jacobi(grid, max_iters, eps):
    """Literal numpy port of the reference's solve_heat (as
    tests/test_heat.py:8-19)."""
    g = grid.copy()
    for k in range(1, max_iters + 1):
        new = g.copy()
        new[1:-1, 1:-1] = (g[2:, 1:-1] + g[:-2, 1:-1]
                           + g[1:-1, :-2] + g[1:-1, 2:]) / 4.0
        diff = np.max(np.abs(new[1:-1, 1:-1] - g[1:-1, 1:-1]))
        g = new
        if diff < eps:
            return g, k, diff
    return g, max_iters, diff


# -- the stencil ---------------------------------------------------------------


@pytest.mark.parametrize("nyi,nxi,row_groups", [
    (998, 1198, 1), (98, 118, 1), (7, 5, 1), (300, 250, 1), (256, 128, 1),
    (4000, 4000, 1), (34, 38, 2), (36, 40, 8), (998, 1198, 4), (1, 1, 3)])
def test_padded_hw_matches_lam_tpu(nyi, nxi, row_groups):
    assert stencil.padded_hw(nyi, nxi, row_groups=row_groups) == \
        jst.padded_hw(nyi, nxi, row_groups=row_groups)
    assert stencil.padded_hw(nyi, nxi, 64, row_groups) == \
        jst.padded_hw(nyi, nxi, 64, row_groups)


def _check_stencil(p, up, dn, nrows, nxi, tbr):
    """The port's plain stencil against lam_tpu's Pallas kernel and an
    f64 oracle on the same inputs; returns the port's y."""
    ops.reset_counters()
    y, d = stencil.laplace5_f32_halo(*map(torch.from_numpy, (p, up, dn)),
                                     nrows, nxi=nxi, tbr=tbr)
    counts = ops.counters()
    assert counts.pop("laplace5_f32_halo_plain") == 1
    assert set(counts.values()) == {0}  # a CPU tensor launches nothing
    assert y.dtype == d.dtype == torch.float32 and d.dim() == 0
    yj, dj = jst.laplace5_f32_halo(*map(jnp.asarray, (p, up, dn)), nrows,
                                   nxi=nxi, tbr=tbr)
    y = y.numpy()
    # the same f32 roundings in the same order: bitwise expected
    np.testing.assert_allclose(y, np.asarray(yj), rtol=0, atol=1e-6)
    H, W = p.shape
    assert not y[nrows:].any() and not y[:, nxi:].any()
    # the dot: f32 sums in two orders, and the f64 oracle
    g = p.astype(np.float64)
    full = 4 * g
    full[1:] -= g[:-1]
    full[0] -= up[0]
    full[:-1] -= g[1:]
    full[-1] -= dn[0]
    full[:, 1:] -= g[:, :-1]
    full[:, :-1] -= g[:, 1:]
    ref = np.zeros_like(full)
    ref[:nrows, :nxi] = full[:nrows, :nxi]
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-5)
    dref = float((g * ref).sum())
    assert abs(float(d) - float(dj)) <= 1e-6 * abs(float(dj))
    assert abs(float(d) - dref) <= 1e-6 * abs(dref)
    return y


@pytest.mark.parametrize("nyi,nxi", [(98, 118), (7, 5), (300, 250),
                                     (256, 128)])
def test_laplace5_plain_matches_lam_tpu(nyi, nxi):
    H, W, tbr = stencil.padded_hw(nyi, nxi)
    rng = np.random.default_rng(nyi * 1000 + nxi)
    p = np.zeros((H, W), np.float32)
    p[:nyi, :nxi] = rng.standard_normal((nyi, nxi)).astype(np.float32)
    zero = np.zeros((1, W), np.float32)
    y = _check_stencil(p, zero, zero, nyi, nxi, tbr)
    # the zero-edge form is the same function
    y2, _ = stencil.laplace5_f32(torch.from_numpy(p), nyi=nyi, nxi=nxi,
                                 tbr=tbr)
    assert np.array_equal(y2.numpy(), y)


@pytest.mark.parametrize("nrows,nxi", [(500, 250), (512, 256)])
def test_laplace5_plain_halo_matches_lam_tpu(nrows, nxi):
    """Non-zero edge rows, as a row-sharded grid's neighbours give them,
    four row tiles, and a row limit below H (up_edge live) or at H
    (dn_edge live); p is non-zero everywhere."""
    H, W, tbr = 512, 256, 128
    rng = np.random.default_rng(nrows + nxi)
    p, up, dn = (rng.standard_normal(s).astype(np.float32)
                 for s in ((H, W), (1, W), (1, W)))
    _check_stencil(p, up, dn, nrows, nxi, tbr)


@pytest.mark.parametrize("shape,tbr", [((100, 128), 64), ((64, 130), 64)])
def test_laplace5_rejects_ragged_grid_as_lam_tpu(shape, tbr):
    p = np.zeros(shape, np.float32)
    e = np.zeros((1, shape[1]), np.float32)
    with pytest.raises(ValueError) as ref:
        jst.laplace5_f32_halo(*map(jnp.asarray, (p, e, e)), 1, nxi=1,
                              tbr=tbr)
    with pytest.raises(ValueError) as mine:
        stencil.laplace5_f32_halo(*map(torch.from_numpy, (p, e, e)), 1,
                                  nxi=1, tbr=tbr)
    assert str(mine.value) == str(ref.value)


def test_laplace5_validates_inputs():
    p = torch.zeros(64, 128)
    e = torch.zeros(1, 128)
    with pytest.raises(ValueError, match="float32"):
        stencil.laplace5_f32_halo(p.double(), e, e, 64, nxi=128, tbr=64)
    with pytest.raises(ValueError, match="float32"):
        stencil.laplace5_f32_halo(p, e, e.double(), 64, nxi=128, tbr=64)
    with pytest.raises(ValueError, match="contiguous"):
        stencil.laplace5_f32_halo(torch.zeros(128, 64).t(), e, e, 64,
                                  nxi=128, tbr=64)
    with pytest.raises(ValueError, match="shape"):
        stencil.laplace5_f32_halo(p, torch.zeros(2, 128), e, 64, nxi=128,
                                  tbr=64)
    with pytest.raises(ValueError, match="device"):
        stencil.laplace5_f32_halo(p.to("meta"), e.to("meta"), e.to("meta"),
                                  64, nxi=128, tbr=64)


def test_counter_registry_covers_every_kernel_module():
    names = {fn.__name__ for fn in ops.KERNELS}
    assert names == {fn.__name__ for fn in gemv.KERNELS} | {
        "laplace5_f32_halo"}
    assert {fn.__name__ for fn in ops.PLAIN} >= {"laplace5_f32_halo_plain",
                                                 "gemv_f32_symm_plain"}
    stencil.laplace5_f32(torch.zeros(8, 128), nyi=8, nxi=128, tbr=8)
    assert gemv.counters() == ops.counters()
    assert ops.counters()["laplace5_f32_halo_plain"] >= 1
    gemv.reset_counters()  # the older entry point resets every module
    assert set(ops.counters().values()) == {0}


# -- the demo ------------------------------------------------------------------


@pytest.mark.parametrize("nx,ny", [(6, 6), (12, 10), (1200, 1000)])
def test_initial_grid_byte_equal(nx, ny):
    mine, ref = heat.initial_grid(nx, ny), jheat.initial_grid(nx, ny)
    assert mine.dtype == ref.dtype and mine.tobytes() == ref.tobytes()


@pytest.mark.parametrize("nx,ny,eps", [(12, 10, 1e-3), (40, 30, 1e-4)])
def test_jacobi_matches_lam_tpu(nx, ny, eps):
    g0 = heat.initial_grid(nx, ny)
    mine, k, diff = heat.solve_heat_jacobi(g0, max_iters=50000, epsilon=eps,
                                           device="cpu")
    ref, k_ref, diff_ref = jheat.solve_heat_jacobi(g0, max_iters=50000,
                                                   epsilon=eps)
    assert k == k_ref and diff < eps
    np.testing.assert_allclose(mine, ref, rtol=1e-12)
    np.testing.assert_allclose(diff, diff_ref, rtol=1e-12)
    g_np, k_np, _ = _reference_jacobi(g0, 50000, eps)
    assert k == k_np
    np.testing.assert_allclose(mine, g_np, rtol=1e-12)


def test_jacobi_stops_at_max_iters():
    g0 = heat.initial_grid(12, 10)
    mine, k, diff = heat.solve_heat_jacobi(g0, max_iters=37, device="cpu")
    ref, k_ref, diff_ref = jheat.solve_heat_jacobi(g0, max_iters=37)
    assert k == k_ref == 37 and diff == pytest.approx(diff_ref, rel=1e-12)
    np.testing.assert_allclose(mine, ref, rtol=1e-12)
    _, k0, d0 = heat.solve_heat_jacobi(g0, max_iters=0, device="cpu")
    assert k0 == 0 and d0 == float("inf")


@pytest.mark.parametrize("nx,ny", [(30, 26), (40, 36)])
def test_cg_f64_matches_lam_tpu(nx, ny):
    g0 = heat.initial_grid(nx, ny)
    mine, k, rel = heat.solve_heat_cg(g0, precision="f64", device="cpu")
    ref, k_ref, rel_ref = jheat.solve_heat_cg(g0, precision="f64")
    assert rel < 1e-10 and rel_ref < 1e-10
    assert abs(k - k_ref) <= 1
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-9)
    # 'auto' is f64 on the CPU
    auto = heat.solve_heat_cg(g0, device="cpu")
    assert auto[1] == k and np.array_equal(auto[0], mine)


@pytest.mark.parametrize("nx,ny", [(30, 26), (40, 36)])
def test_cg_ir_matches_lam_tpu(nx, ny):
    """The ir path on the CPU (the plain stencil) against lam_tpu's (the
    Pallas kernel in interpret mode): the f32 dot is summed in another
    order, so the inner iteration counts may differ by a few."""
    g0 = heat.initial_grid(nx, ny)
    ops.reset_counters()
    mine, k, rel = heat.solve_heat_cg(g0, precision="ir", device="cpu")
    counts = ops.counters()
    ref, k_ref, rel_ref = jheat.solve_heat_cg(g0, precision="ir")
    assert rel < 1e-10 and rel_ref < 1e-10
    assert abs(k - k_ref) <= max(0.02 * k_ref, 3)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-6)
    f64, _, _ = jheat.solve_heat_cg(g0, precision="f64")
    np.testing.assert_allclose(mine, f64, rtol=0, atol=1e-6)
    assert counts["laplace5_f32_halo_plain"] >= k
    assert counts["laplace5_f32_halo"] == 0


def test_cg_solves_exact_laplace_system():
    """MatrixFreeOperator CG on the 5-point stencil of a 7 x 6 interior
    against numpy's dense solve."""
    nyi, nxi = 7, 6
    n = nyi * nxi
    a = np.zeros((n, n))
    for i in range(nyi):
        for j in range(nxi):
            a[i * nxi + j, i * nxi + j] = 4.0
            for ii, jj in ((i + 1, j), (i - 1, j), (i, j + 1), (i, j - 1)):
                if 0 <= ii < nyi and 0 <= jj < nxi:
                    a[i * nxi + j, ii * nxi + jj] = -1.0
    b = np.random.default_rng(5).uniform(0, 100, n)
    op = MatrixFreeOperator(heat._laplace_matvec(nyi, nxi), torch.zeros(()),
                            n, device="cpu")
    assert (op.n, op.n_padded, op.vector_dtype) == (n, n, torch.float64)
    res = cg_solve(op, b, max_iters=1000, rel_error=1e-13)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(a, b),
                               rtol=1e-9)
    # the dense product sums the same terms in another order
    np.testing.assert_allclose(op.matvec(torch.from_numpy(b)).numpy(),
                               a @ b, rtol=1e-13)


def test_operator_takes_a_fused_matvec_dot():
    calls = []

    def mvd(operand, p):
        calls.append(p)
        return 2.0 * p, torch.tensor(-1.0)

    op = LinearOperator(None, None, 4, 4, torch.float64, "cpu",
                        matvec_dot_fn=mvd)
    p = torch.ones(4, dtype=torch.float64)
    ap, d = op.matvec_dot(p)
    # the kernel's own dot is kept, not recomputed
    assert float(d) == -1.0 and torch.equal(ap, 2.0 * p)
    assert torch.equal(op.matvec(p), 2.0 * p) and len(calls) == 2
    with pytest.raises(ValueError, match="matvec"):
        LinearOperator(None, None, 4, 4, torch.float64, "cpu")


def test_stencil_operator_pads_in_two_dimensions():
    nyi, nxi = 5, 3
    H, W, _ = stencil.padded_hw(nyi, nxi)
    op = heat._StencilOperator(heat._laplace_matvec_padded(nyi, nxi, H, W),
                               None, torch.zeros(()), nyi, nxi, H, W,
                               torch.float64, torch.device("cpu"))
    b = np.arange(1.0, nyi * nxi + 1)
    bp = op.prepare_b(b)
    assert bp.shape == (H * W,)
    grid = bp.reshape(H, W).numpy()
    assert np.array_equal(grid[:nyi, :nxi].reshape(-1), b)
    assert not grid[nyi:].any() and not grid[:, nxi:].any()
    assert np.array_equal(op.extract_x(bp).numpy(), b)
    y = op.matvec(bp).reshape(H, W).numpy()
    assert not y[nyi:].any() and not y[:, nxi:].any()
    jy = jheat._laplace_matvec(nyi, nxi)(None, jnp.asarray(b))
    np.testing.assert_array_equal(y[:nyi, :nxi].reshape(-1), np.asarray(jy))
    with pytest.raises(ValueError, match="rhs"):
        op.prepare_b(b[:-1])


def test_sharded_heat_path_raises():
    # the row-sharded path runs (tests/test_torch_heat_sharded.py); here
    # it needs a process group of as many ranks as devices
    g0 = heat.initial_grid(10, 10)
    with pytest.raises(ValueError, match="requested 2 devices"):
        heat.solve_heat_cg(g0, devices=2, device="cpu")
    with pytest.raises(ValueError, match="requested 2 devices"):
        heat.solve_heat_cg(g0, devices=2, precision="ir", device="cpu")
    with pytest.raises(ValueError, match="ir solver") as mine:
        heat.solve_heat_cg(g0, devices=2, precision="f64", device="cpu")
    with pytest.raises(ValueError, match="ir solver") as ref:
        jheat.solve_heat_cg(g0, devices=2, precision="f64")
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="precision"):
        heat.solve_heat_cg(g0, precision="df64", device="cpu")


def test_cuda_request_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g0 = heat.initial_grid(10, 10)
    with pytest.raises(RuntimeError, match="cuda"):
        heat.solve_heat_cg(g0)  # device defaults to cuda
    with pytest.raises(RuntimeError, match="cuda"):
        heat.solve_heat_jacobi(g0)
    with pytest.raises(RuntimeError, match="cuda"):
        with contextlib.redirect_stdout(io.StringIO()):
            heat_cli.main(["10", "10", str(tmp_path / "h.bin")])


# -- the CLIs and the image ------------------------------------------------


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("precision", ["auto", "ir"])
def test_heat_cli_and_bmp_end_to_end(tmp_path, precision):
    heat_bin, bmp_path = tmp_path / "heat.bin", tmp_path / "heat.bmp"
    rc, out = _run(heat_cli.main, ["40", "30", str(heat_bin), "100000",
                                   "--precision", precision,
                                   "--device", "cpu"])
    assert rc == 0
    # lam_tpu's lines: one parser reads both CLIs
    k = int(re.search(r"Iterations converged in (\d+) iterations with "
                      r"rel_residual=(\S+)", out).group(1))
    assert re.search(r"Time elapsed: [0-9.]+ s", out)
    assert re.search(r"Warm-up \(compile \+ construction\) time: [0-9.]+ s",
                     out)
    grid = jio.read_matrix(heat_bin)  # lam_tpu reads the port's file
    assert grid.shape == (30, 40)
    ref_bin = tmp_path / "ref.bin"
    from lam_tpu.apps import heat_cli as jheat_cli
    with contextlib.redirect_stdout(io.StringIO()):
        assert jheat_cli.main(["40", "30", str(ref_bin), "100000",
                               "--precision", precision]) == 0
    np.testing.assert_allclose(grid, jio.read_matrix(ref_bin), rtol=0,
                               atol=1e-6)
    if precision == "auto":  # f64 on the CPU, both packages
        ref = jheat.solve_heat_cg(heat.initial_grid(40, 30))
        assert abs(k - ref[1]) <= 1
    rc, _ = _run(bmp_cli.main, [str(heat_bin), str(bmp_path)])
    assert rc == 0
    assert bmp.read_bmp(bmp_path).shape == (30, 40, 3)
    ref_bmp = tmp_path / "ref.bmp"
    with contextlib.redirect_stdout(io.StringIO()):
        assert jbmp_cli.main([str(heat_bin), str(ref_bmp)]) == 0
    assert bmp_path.read_bytes() == ref_bmp.read_bytes()


def test_heat_cli_jacobi(tmp_path):
    heat_bin = tmp_path / "jac.bin"
    rc, out = _run(heat_cli.main, ["24", "20", str(heat_bin), "1000000",
                                   "--solver", "jacobi", "--device", "cpu"])
    assert rc == 0
    g, k, _ = _reference_jacobi(heat.initial_grid(24, 20), 1000000, 1e-3)
    assert f"Iterations converged in {k} iterations with max_diff=" in out
    np.testing.assert_allclose(tio.read_matrix(heat_bin), g, rtol=1e-12)


def test_heat_cli_errors(tmp_path, capsys):
    assert heat_cli.main(["0", "10", str(tmp_path / "h.bin"),
                          "--device", "cpu"]) == 1
    assert "Wrong argument value" in capsys.readouterr().err
    with contextlib.redirect_stdout(io.StringIO()):
        assert heat_cli.main(["10", "10", str(tmp_path / "h.bin"),
                              "--devices", "2", "--precision", "f64",
                              "--device", "cpu"]) == 1
        assert "ir solver" in capsys.readouterr().err
        # --devices 2 runs as two rank processes
        # (tests/test_torch_heat_sharded.py); one process alone is refused
        assert heat_cli.main(["10", "10", str(tmp_path / "h.bin"),
                              "--devices", "2", "--device", "cpu"]) == 1
    assert "requested 2 devices" in capsys.readouterr().err
    assert bmp_cli.main([str(tmp_path / "missing.bin"),
                         str(tmp_path / "x.bmp")]) == 1
    assert "lam-heat-to-bmp" in capsys.readouterr().err


def test_bmp_bytes_match_lam_tpu(tmp_path):
    rng = np.random.default_rng(11)
    for shape in ((5, 3), (30, 40), (7, 8)):
        vals = rng.uniform(-10, 110, shape)
        rgb = bmp.colormap(vals)
        assert np.array_equal(rgb, jbmp.colormap(vals))
        bmp.write_bmp(tmp_path / "mine.bmp", rgb)
        jbmp.write_bmp(tmp_path / "ref.bmp", rgb)
        assert ((tmp_path / "mine.bmp").read_bytes()
                == (tmp_path / "ref.bmp").read_bytes())
        assert np.array_equal(bmp.read_bmp(tmp_path / "ref.bmp"), rgb)
    flat = np.full((3, 3), 42.0)
    assert np.array_equal(bmp.colormap(flat, 42.0, 42.0),
                          jbmp.colormap(flat, 42.0, 42.0))


def test_heat_modules_leave_jax_out():
    code = ("import sys, lam_tpu_torch.apps.heat, "
            "lam_tpu_torch.apps.heat_cli, lam_tpu_torch.apps.bmp, "
            "lam_tpu_torch.apps.bmp_cli, lam_tpu_torch.ops.stencil; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lam_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
