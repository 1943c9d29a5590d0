"""The port's row-sharded heat path (lam_tpu_torch.apps.heat with
devices=G, parallel.mesh.Mesh.halo) against lam_tpu's on the CPU.

Per shard, with no process group: each rank's f32 stencil kernel (the
plain version here) and f64 stencil on its rows of the padded grid, given
the neighbour rows the halo exchange delivers, concatenate to the
one-device stencil bit for bit, for G = 2, 3 and 4 and grids whose last
ranks hold partly or only padding. In gloo clusters of 2 and 4 rank
processes (tests/torch_sharded_worker.py): the halo exchange, the sharded
solve of the 40 x 36 plate against lam_tpu's `solve_heat_cg(devices=G)` on
the virtual mesh (tests/test_heat.py:93-105), and the heat CLI as rank
processes.
"""

import contextlib
import io
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lam_tpu.apps import heat as jheat
from lam_tpu_torch import io as tio
from lam_tpu_torch.apps import heat, heat_cli
from lam_tpu_torch.ops import stencil
from torch_sharded_worker import launch_cluster

RANKS = (2, 4)
NX, NY = 40, 36
CLUSTER_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the shards, one at a time ---------------------------------------------


def _shard_mesh(c, grids, Hs):
    """A stand-in for rank c's Mesh: its rank, and the rows the exchange
    delivers (rank c-1's last row, rank c+1's first, zeros past the
    edges) of the grid of the rows' dtype, checked against what the rank
    sends."""
    g = grids[0].shape[0] // Hs

    def halo(first, last):
        p = next(x for x in grids if x.dtype == first.dtype)
        assert torch.equal(first, p[c * Hs]) and torch.equal(
            last, p[(c + 1) * Hs - 1])
        up = p[c * Hs - 1] if c > 0 else torch.zeros_like(first)
        dn = p[(c + 1) * Hs] if c < g - 1 else torch.zeros_like(last)
        return up.clone(), dn.clone()

    return SimpleNamespace(rank=c, size=g, halo=halo)


@pytest.mark.parametrize("g,nyi,nxi", [
    (2, 30, 100),   # the last rank partly padding
    (3, 50, 100),   # 2 valid rows of 24 on the last rank
    (4, 34, 120),   # the last rank only padding
    (4, 3, 100),    # three ranks only padding
    (2, 64, 128)])  # no padding rows
def test_shards_concatenate_to_the_one_device_stencil(g, nyi, nxi):
    H, W, tbr = stencil.padded_hw(nyi, nxi, row_groups=g)
    Hs = H // g
    rng = np.random.default_rng(g * 100 + nyi)
    p64 = torch.zeros((H, W), dtype=torch.float64)
    p64[:nyi, :nxi] = torch.from_numpy(rng.standard_normal((nyi, nxi)))
    p = p64.to(torch.float32)
    zero = torch.zeros((1, W))
    y1, d1 = stencil.laplace5_f32_halo_plain(p, zero, zero, nyi, nxi=nxi)
    y64 = stencil.laplace5_masked(p64, zero.double(), zero.double(), nyi,
                                  nxi)
    ys, ds, accs = [], [], []
    for c in range(g):
        apply32_dot, apply_acc = heat._sharded_stencil_applies(
            _shard_mesh(c, (p, p64), Hs), nyi, nxi, Hs, W, tbr)
        y, d = apply32_dot(None, p[c * Hs:(c + 1) * Hs].reshape(-1))
        ys.append(y.reshape(Hs, W))
        ds.append(float(d))
        accs.append(apply_acc(None, p64[c * Hs:(c + 1) * Hs].reshape(-1))
                    .reshape(Hs, W))
    assert torch.equal(torch.cat(ys), y1)
    assert torch.equal(torch.cat(accs), y64)
    # the partials sum, in another order, to the one-device p . y
    exact = float(torch.sum(p.double() * y1.double()))
    assert abs(sum(ds) - exact) <= 1e-6 * abs(exact)
    assert abs(float(d1) - exact) <= 1e-6 * abs(exact)


def test_sharded_operator_places_and_gathers_rows():
    nyi, nxi, g = 34, 120, 4
    H, W, tbr = stencil.padded_hw(nyi, nxi, row_groups=g)
    b = np.random.default_rng(3).standard_normal(nyi * nxi)
    full = np.zeros((H, W))
    full[:nyi, :nxi] = b.reshape(nyi, nxi)
    parts = []
    for c in range(g):
        mesh = SimpleNamespace(rank=c, size=g, device=torch.device("cpu"),
                               dot=None)
        op = heat._ShardedStencilOperator(nyi, nxi, H, W, tbr, mesh)
        bp = op.prepare_b(b)
        assert bp.dtype == torch.float64 and bp.shape == (H // g * W,)
        parts.append(bp)
        np.testing.assert_array_equal(
            bp.numpy(), full[c * H // g:(c + 1) * H // g].reshape(-1))
        with pytest.raises(ValueError, match="rhs has shape"):
            op.prepare_b(b[:-1])
    mesh = SimpleNamespace(rank=0, size=g, device=torch.device("cpu"),
                           dot=None, all_gather=torch.cat)
    op = heat._ShardedStencilOperator(nyi, nxi, H, W, tbr, mesh)
    np.testing.assert_array_equal(op.extract_x(parts).numpy(), b)


def test_sharded_operator_refuses_jacobi_in_lam_tpus_words():
    nyi, nxi = 34, 38
    H, W, tbr = stencil.padded_hw(nyi, nxi, row_groups=2)
    mesh = SimpleNamespace(rank=0, size=2, device=torch.device("cpu"),
                           dot=None)
    op = heat._ShardedStencilOperator(nyi, nxi, H, W, tbr, mesh)
    with pytest.raises(NotImplementedError, match="constant diagonal") as e:
        op.run_cg_ir(op, None, 10, 1e-9, 40, 1e-5,
                     inv_diag32=torch.ones(1))
    assert "Jacobi preconditioning is a no-op" in str(e.value)
    with pytest.raises(NotImplementedError, match="does not expose"):
        op.diagonal()


def test_sharded_heat_cli_needs_a_process_group(tmp_path, capsys):
    g0 = heat.initial_grid(10, 10)
    with pytest.raises(ValueError, match="unknown precision"):
        heat.solve_heat_cg(g0, devices=2, precision="df64", device="cpu")
    # one device is the one-device path
    one = heat.solve_heat_cg(g0, devices=1, precision="ir", device="cpu")
    assert np.array_equal(one[0], heat.solve_heat_cg(
        g0, precision="ir", device="cpu")[0])
    with contextlib.redirect_stdout(io.StringIO()):
        assert heat_cli.main(["10", "10", str(tmp_path / "h.bin"),
                              "--devices", "2", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("lam-heat: requested 2 devices")
    assert len(err.strip().splitlines()) == 1
    with contextlib.redirect_stdout(io.StringIO()):
        assert heat_cli.main(["10", "10", str(tmp_path / "h.bin"),
                              "--process-id", "0", "--device", "cpu"]) == 1
    assert "--coordinator" in capsys.readouterr().err


# -- rank processes --------------------------------------------------------


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """{g: (records of each rank, output directory)}: the halo exchange,
    the sharded solve of the plate, and at G=2 the heat CLI."""
    d = tmp_path_factory.mktemp("heat_clusters")
    out = {}
    for g in RANKS:
        run_dir = str(d / f"g{g}")
        jobs = [{"kind": "halo", "name": "halo"},
                {"kind": "heat", "name": "heat", "nx": NX, "ny": NY,
                 "rel_error": 1e-11}]
        if g == 2:
            jobs.append({"kind": "heat-cli", "name": "heat-cli", "argv": [
                str(NX), str(NY), os.path.join(run_dir, "heat.bin"),
                "100000", "--devices", "2", "--rel-error", "1e-11"]})
        out[g] = (launch_cluster(g, jobs, run_dir, CLUSTER_TIMEOUT_S),
                  run_dir)
    return out


@pytest.fixture(scope="module")
def lam_ref():
    """lam_tpu's row-sharded solves on the virtual mesh, and its f64
    one-device grid."""
    g0 = jheat.initial_grid(NX, NY)
    out = {g: jheat.solve_heat_cg(g0, devices=g, rel_error=1e-11)
           for g in RANKS}
    out["f64"] = jheat.solve_heat_cg(g0, precision="f64", rel_error=1e-11)
    return out


@pytest.mark.parametrize("g", RANKS)
def test_halo_exchange_zeroes_the_mesh_edges(clusters, g):
    records, run_dir = clusters[g]
    for r in range(g):
        up, dn = np.load(os.path.join(run_dir, f"halo.r{r}.npy"))
        # rank r sent r+1 up and -(r+1) down
        np.testing.assert_array_equal(up, np.full(4, -float(r) if r else 0.0))
        np.testing.assert_array_equal(
            dn, np.full(4, float(r + 2) if r < g - 1 else 0.0))


@pytest.mark.parametrize("g", RANKS)
def test_sharded_heat_matches_lam_tpu(clusters, lam_ref, g):
    records, run_dir = clusters[g]
    recs = [rank["heat"] for rank in records]
    grids = [np.load(os.path.join(run_dir, f"heat.r{r}.npy"))
             for r in range(g)]
    ref_grid, ref_iters, ref_rel = lam_ref[g]
    assert ref_rel < 1e-11
    for rec, grid in zip(recs, grids):
        assert rec["backend"] == "gloo" and rec["device"] == "cpu"
        assert rec["rel"] < 1e-11
        assert rec["iters"] == recs[0]["iters"]
        # every rank took the same steps: each holds rank 0's grid
        assert np.array_equal(grid, grids[0])
    np.testing.assert_allclose(grids[0], ref_grid, rtol=0, atol=1e-6)
    np.testing.assert_allclose(grids[0], lam_ref["f64"][0], rtol=0, atol=1e-6)
    # f32 inner sums in another order: within 10% of lam_tpu's count
    assert abs(recs[0]["iters"] - ref_iters) <= 0.1 * ref_iters, (
        recs[0]["iters"], ref_iters)
    counts = recs[0]["counts"]
    assert counts["laplace5_f32_halo_plain"] > 0
    assert not any(v for k, v in counts.items()
                   if k != "laplace5_f32_halo_plain")


def test_heat_cli_runs_as_rank_processes(clusters, lam_ref):
    records, run_dir = clusters[2]
    recs = [rank["heat-cli"] for rank in records]
    assert [rec["rc"] for rec in recs] == [0, 0]
    assert "Iterations converged in" in recs[0]["stdout"]
    assert "Finished successfully" in recs[0]["stdout"]
    assert recs[1]["stdout"] == ""  # only rank 0 prints
    grid = tio.read_matrix(os.path.join(run_dir, "heat.bin"))
    assert grid.shape == (NY, NX)
    np.testing.assert_array_equal(
        grid, np.load(os.path.join(run_dir, "heat.r0.npy")))
