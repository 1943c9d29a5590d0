"""The port's dense 2-D grid (lam_tpu_torch/parallel/pcg2d.py, `Mesh2D`)
against lam_tpu's `Sharded2DOperator`, on the CPU.

Layout: the transpose permutation, the padding and every rank's block
byte-equal to lam_tpu's shards on its R x R virtual mesh for R = 1, 2, the
blocks built here rank by rank without a process group; the column-windowed
block read against lam_tpu's. Solves run in one gloo CPU cluster of 4 rank
processes (R = 2; tests/torch_sharded_worker.py) against lam_tpu's solves on
its 2 x 2 virtual mesh (f64 engine 'xla' for df64, its 'ir', f32 'xla' for
f32): df64 iterations within 2 of lam_tpu's grid count or of its one-device
f64 count, ir and f32 (to 1e-5) within 2%, x within 1e-6 (f32: 1e-3) of
lam_tpu's and identical on every rank, TRUE residual <= 1e-8 (f32: 1e-4),
the matvec to 1e-13 of a @ p; every rank ran the plain dense matvecs on its
block.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import lam_tpu
from lam_tpu import generate as jgen
from lam_tpu import io as jio
from lam_tpu.parallel import pcg2d as jpcg2d
from lam_tpu.solver import cg as jcg
from lam_tpu_torch import ConjugateGradient, cg_solve, cg_solve_block
from lam_tpu_torch import cli as tcli
from lam_tpu_torch import io as tio
from lam_tpu_torch.parallel import mesh as pmesh
from lam_tpu_torch.parallel import pcg2d
from torch_sharded_worker import launch_cluster

N, SEED = 500, 43
CLUSTER_TIMEOUT_S = 240
PRECISIONS = ("f32", "df64", "ir")
F32_REL_ERROR = 1e-5
JACOBI_REL = 5e-10  # half the TRUE gate of the Jacobi solves, 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _true_rel(a, b, x):
    return np.linalg.norm(b - a @ x) / np.linalg.norm(b)


# -- layout ----------------------------------------------------------------


@pytest.mark.parametrize("r", [1, 2, 3])
def test_transpose_perm_equals_lam_tpu(r):
    assert pmesh.transpose_perm(r) == jpcg2d._transpose_perm(r)
    for rank in range(r * r):  # Mesh2D.transpose talks to that peer
        mesh = pmesh.Mesh2D(rank, r, "cpu")
        src = dict((dst, s) for s, dst in pmesh.transpose_perm(r))
        assert src[rank] == mesh.j * r + mesh.i


@pytest.mark.parametrize("n", [1, 500, 2048, 2049])
@pytest.mark.parametrize("r", [1, 2])
def test_block_padded_size_equals_lam_tpu(r, n):
    ref = jpcg2d.Sharded2DOperator.block_padded_size(
        n, jpcg2d.make_mesh2d(r), "pallas")
    assert pcg2d.Sharded2DOperator.block_padded_size(n, r) == ref


def _blocks(arr, r):
    """{(i, j): block} of a lam_tpu array sharded over the R x R mesh."""
    m = arr.shape[0] // r
    return {((s.index[0].start or 0) // m, (s.index[1].start or 0) // m):
            np.asarray(s.data) for s in arr.addressable_shards}


@pytest.mark.parametrize("precision", ["f32", "df64"])
@pytest.mark.parametrize("r", [1, 2])
def test_blocks_byte_equal_lam_tpu(r, precision):
    a = jgen.random_spd_matrix(700, seed=r)
    ref = jpcg2d.Sharded2DOperator.from_dense(
        a, mesh=jpcg2d.make_mesh2d(r), precision=precision, engine="pallas")
    planes = ref.operand if precision == "df64" else (ref.operand,)
    for rank in range(r * r):
        op = pcg2d.Sharded2DOperator.from_dense(
            a, mesh=pmesh.Mesh2D(rank, r, "cpu"), precision=precision,
            engine="pallas_symm", device="cpu")  # folds to the dense engine
        assert (op.n_padded, op.engine) == (ref.n_padded, "pallas")
        assert op.m == ref.n_padded // r
        mine = op.operand if precision == "df64" else (op.operand,)
        for x, plane in zip(mine, planes):
            want = _blocks(plane, r)[divmod(rank, r)]
            assert x.numpy().dtype == want.dtype
            assert np.array_equal(x.numpy(), want)


@pytest.mark.parametrize("ext", ["bin", "npy"])
def test_read_matrix_block_equals_lam_tpu(tmp_path, ext):
    a = np.random.default_rng(3).uniform(-1, 1, (37, 37))
    path = str(tmp_path / f"A.{ext}")
    if ext == "npy":
        np.save(path, a)
    else:
        tio.write_matrix(path, a)
    for window in ((0, 0, 37, 37), (5, 9, 11, 20), (36, 0, 1, 37)):
        mine = tio.read_matrix_block(path, *window)
        assert np.array_equal(mine, jio.read_matrix_block(path, *window))
        r0, c0, h, w = window
        assert np.array_equal(mine, a[r0:r0 + h, c0:c0 + w])
        assert mine.flags["C_CONTIGUOUS"]
    with pytest.raises(ValueError, match="out of range"):
        tio.read_matrix_block(path, 30, 0, 8, 4)


# -- one rank, no process group --------------------------------------------


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    a = jgen.random_spd_matrix_fast(N, seed=SEED)
    b = jgen.random_rhs(N, seed=SEED + 10)
    d = tmp_path_factory.mktemp("grid_system")
    tio.write_matrix(d / "A.bin", a)
    tio.write_matrix(d / "b.bin", b)
    return a, b, str(d / "A.bin"), str(d / "b.bin")


def test_grid_of_one_rank_is_the_identity(capsys):
    mesh = pmesh.make_mesh2d(device="cpu")
    assert (mesh.rank, mesh.r, mesh.size, mesh.backend) == (0, 1, 1, None)
    assert mesh.active and (mesh.i, mesh.j) == (0, 0)
    x = torch.arange(4.0)
    assert mesh.transpose(x) is x and mesh.all_reduce_row(x) is x
    assert mesh.all_gather_col(x) is x
    assert float(mesh.dot(x, x)) == 14.0
    with pytest.raises(ValueError, match="need 4 devices for a 2x2 grid"):
        pmesh.make_mesh2d(2, device="cpu")
    outside = pmesh.Mesh2D(4, 2, "cpu")
    assert not outside.active
    with pytest.raises(RuntimeError, match="outside the 2x2 grid"):
        pcg2d.Sharded2DOperator.from_dense(np.eye(4), mesh=outside,
                                           device="cpu")
    assert capsys.readouterr().err == ""  # one rank: nothing stays idle


@pytest.mark.parametrize("precision", PRECISIONS)
def test_one_rank_grid_solve(system, precision, capsys):
    a, b, a_path, b_path = system
    cg = ConjugateGradient(backend="sharded2d", precision=precision,
                           device="cpu", pack_cache=True)
    assert cg.mesh.size == 1 and cg.used_devices() == 1 and cg.rank == 0
    cg.load_matrix_from_file(a_path)
    assert "--pack-cache only accelerates" in capsys.readouterr().err
    assert isinstance(cg.op, pcg2d.Sharded2DOperator)
    cg.load_rhs_from_file(b_path)
    f32 = precision == "f32"
    assert cg.solve(max_iters=10000,
                    rel_error=F32_REL_ERROR if f32 else 1e-9)
    assert _true_rel(a, b, cg.x) <= (1e-4 if f32 else 1e-8)
    assert cg.measure_gemv(repeats=2) > 0


def test_grid_refusals(system):
    a = system[0]
    mesh = pmesh.Mesh2D(0, 1, "cpu")
    # the plain path (engine xla; f64 forces it): padded only to R
    for kw, precision in (({"precision": "f64"}, "f64"),
                          ({"engine": "xla"}, "df64")):
        op = pcg2d.Sharded2DOperator.from_dense(a, mesh=mesh, device="cpu",
                                                **kw)
        assert (op.engine, op.precision, op.n_padded) == (
            "xla", precision, a.shape[0])
        res = cg_solve(op, system[1], max_iters=10000, rel_error=1e-9)
        assert _true_rel(a, system[1], res.x.numpy()) <= 1e-9
    f64 = pcg2d.Sharded2DOperator.from_dense(a, mesh=mesh, precision="f64",
                                             device="cpu")
    with pytest.raises(NotImplementedError, match="rebuild with df64"):
        f64.as_f32()  # lam_tpu's words: ir runs on the df64 pair
    with pytest.raises(ValueError, match="unknown precision"):
        pcg2d.Sharded2DOperator.from_dense(a, mesh=mesh, precision="dfq",
                                           device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        pcg2d.Sharded2DOperator.from_dense(a, mesh=mesh, engine="mxu",
                                           device="cpu")
    with pytest.raises(ValueError, match="square"):
        pcg2d.Sharded2DOperator.from_dense(a[:, :10], mesh=mesh,
                                           device="cpu")
    gen64 = pcg2d.Sharded2DOperator.from_gen_tridiagonal(100, mesh=mesh,
                                                         precision="f64")
    assert (gen64.engine, gen64.n_padded) == ("xla", 100)
    assert gen64.operand.dtype == torch.float64
    op = pcg2d.Sharded2DOperator.from_dense(a, mesh=mesh, device="cpu")
    # the Jacobi preconditioner runs (one rank: the whole diagonal), and
    # the block matvec
    d = op.diagonal()
    assert d.dtype == torch.float64
    np.testing.assert_allclose(d[:a.shape[0]].numpy(), np.diag(a),
                               rtol=2.0 ** -48, atol=0)
    res = op.run_pcg(op.prepare_b(system[1]), 10000, 1e-9)
    assert bool(res.converged)
    assert _true_rel(a, system[1], op.extract_x(res.x).numpy()) <= 1e-9
    bb = np.stack([system[1], -system[1]], axis=1)
    blk = cg_solve_block(op, bb, max_iters=10000, rel_error=1e-9)
    assert blk.x.shape == bb.shape and bool(blk.converged.all())
    assert blk.num_iters[0] == blk.num_iters[1]
    with pytest.raises(ValueError, match="rhs block must be"):
        op.prepare_b_block(np.zeros(3))
    assert op.as_f32().operand is op.operand
    assert op.as_f32().as_f32().precision == "f32"
    with pytest.raises(ValueError, match="rhs has shape"):
        op.prepare_b(np.zeros(3))


# -- the 2 x 2 grid in rank processes --------------------------------------


def _jobs(a_path, b_path, p_path, out):
    jobs = [{"kind": "solve", "name": f"grid-{precision}", "op": "grid",
             "precision": precision, "matrix": a_path, "rhs": b_path,
             "rel_error": F32_REL_ERROR if precision == "f32" else 1e-9}
            for precision in PRECISIONS]
    jobs.append({"kind": "matvec", "name": "mv-grid", "op": "grid",
                 "precision": "df64", "matrix": a_path, "p": p_path})
    jobs.append({"kind": "cli", "name": "cli-grid-ir", "argv": [
        "-A", a_path, "-b", b_path, "-o", os.path.join(out, "x_cli.bin"),
        "--backend", "sharded2d", "--precision", "ir", "--engine",
        "pallas"]})
    # the Jacobi preconditioner: the grid's diagonal, PCG and ir's inner PCG
    for precision in ("f32", "df64"):
        jobs.append({"kind": "diagonal", "name": f"diag-{precision}",
                     "op": "grid", "precision": precision, "matrix": a_path})
    for precision in ("df64", "ir"):
        jobs.append({"kind": "solve", "name": f"jacobi-{precision}",
                     "op": "grid", "precision": precision, "matrix": a_path,
                     "rhs": b_path, "rel_error": JACOBI_REL,
                     "preconditioner": "jacobi"})
    # resumable solves on the grid: engine xla's f64 and the dense
    # kernels' ir, each stopped with its state on disk and resumed; the
    # CLI's --checkpoint and --resume; block CG over the xla blocks
    for name, precision, engine in (("ck-grid-xla", "f64", "xla"),
                                    ("ck-grid-ir", "ir", "auto")):
        jobs.append({"kind": "checkpoint", "name": name, "op": "grid",
                     "precision": precision, "engine": engine,
                     "matrix": a_path, "rhs": b_path, "rel_error": 1e-9,
                     "dir": os.path.join(out, name)})
    ck_argv = ["-A", a_path, "-b", b_path, "--backend", "sharded2d",
               "--precision", "df64", "--checkpoint",
               os.path.join(out, "cli-ck")]
    jobs.append({"kind": "cli", "name": "cli-ck", "argv": ck_argv + [
        "-o", os.path.join(out, "x_ck.bin"), "-i", "30"]})
    jobs.append({"kind": "cli", "name": "cli-resume", "argv": ck_argv + [
        "-o", os.path.join(out, "x_resume.bin"), "--resume"]})
    jobs.append({"kind": "block", "name": "block-grid-xla", "op": "grid",
                 "precision": "f64", "engine": "xla", "matrix": a_path,
                 "rhs_block": p_path[:-4] + "_block.npy",
                 "rel_error": 1e-9})
    return jobs


@pytest.fixture(scope="module")
def cluster(system, tmp_path_factory):
    """(records of each rank, output directory) of one 4-rank launch."""
    a, b, a_path, b_path = system
    d = tmp_path_factory.mktemp("grid_cluster")
    p_path = str(d / "p.npy")
    np.save(p_path, np.random.default_rng(6).uniform(-1, 1, N))
    np.save(str(d / "p_block.npy"), _rhs_block())
    run_dir = str(d / "r2")
    return launch_cluster(4, _jobs(a_path, b_path, p_path, run_dir), run_dir,
                          CLUSTER_TIMEOUT_S), run_dir


@pytest.fixture(scope="module")
def lam_ref(system):
    """lam_tpu's solves on its 2 x 2 virtual mesh and its one-device f64
    solve: {kind: (iterations, x)}."""
    a, b = system[:2]
    mesh = jpcg2d.make_mesh2d(2)
    mk = jpcg2d.Sharded2DOperator.from_dense
    df64 = mk(a, mesh=mesh, precision="df64", engine="xla")
    out = {
        "one": lam_tpu.cg_solve(
            lam_tpu.DenseOperator.from_dense(a, precision="f64"), b,
            max_iters=10000, rel_error=1e-9),
        "df64": lam_tpu.cg_solve(
            mk(a, mesh=mesh, precision="f64", engine="xla"), b,
            max_iters=10000, rel_error=1e-9),
        "ir": lam_tpu.cg_solve_ir(df64.as_f32(), df64, b, max_iters=10000,
                                  rel_error=1e-9),
        "f32": lam_tpu.cg_solve(
            mk(a, mesh=mesh, precision="f32", engine="xla"), b,
            max_iters=10000, rel_error=F32_REL_ERROR),
    }
    out["jacobi-one"] = lam_tpu.cg_solve(
        lam_tpu.DenseOperator.from_dense(a, precision="f64"), b,
        max_iters=10000, rel_error=JACOBI_REL, preconditioner="jacobi")
    out["jacobi-df64"] = lam_tpu.cg_solve(
        mk(a, mesh=mesh, precision="f64", engine="xla"), b,
        max_iters=10000, rel_error=JACOBI_REL, preconditioner="jacobi")
    out["jacobi-ir"] = lam_tpu.cg_solve_ir(
        df64.as_f32(), df64, b, max_iters=10000, rel_error=JACOBI_REL,
        preconditioner="jacobi")
    for key, res in out.items():
        assert bool(res.converged), key
    return {k: (int(r.num_iters), np.asarray(r.x)[:N])
            for k, r in out.items()}


_KERNELS = {"f32": ["gemv_f32"], "df64": ["gemv_df64"],
            "ir": ["gemv_f32", "gemv_df64"]}


@pytest.mark.parametrize("precision", PRECISIONS)
def test_grid_solve_matches_lam_tpu(system, cluster, lam_ref, precision):
    a, b = system[:2]
    records, run_dir = cluster
    name = f"grid-{precision}"
    recs = [rank[name] for rank in records]
    xs = [np.load(os.path.join(run_dir, f"{name}.r{r}.npy"))
          for r in range(4)]
    for rec, x in zip(recs, xs):
        assert rec["converged"] and rec["size"] == 4
        assert rec["backend"] == "gloo" and rec["device"] == "cpu"
        assert rec["iters"] == recs[0]["iters"]
        assert np.array_equal(x, xs[0])  # every rank holds the same x
        for k in _KERNELS[precision]:  # every rank multiplied its block
            assert rec["counts"][k + "_plain"] > 0, (k, rec["counts"])
        assert rec["counts"]["gemv_f32_symm_slab_plain"] == 0
        assert rec["counts"]["gemv_df64_symm_slab_plain"] == 0
    iters, (ref_iters, ref_x) = recs[0]["iters"], lam_ref[precision]
    if precision == "df64":
        one = lam_ref["one"][0]
        assert min(abs(iters - ref_iters), abs(iters - one)) <= 2, \
            (iters, ref_iters, one)
    else:
        assert abs(iters - ref_iters) <= math.ceil(0.02 * ref_iters), \
            (iters, ref_iters)
    f32 = precision == "f32"
    assert _rel(xs[0], ref_x) <= (1e-3 if f32 else 1e-6)
    assert _true_rel(a, b, xs[0]) <= (1e-4 if f32 else 1e-8)


def test_grid_matvec_matches_f64(system, cluster):
    a = system[0]
    p = np.random.default_rng(6).uniform(-1, 1, N)
    for r in range(4):
        y = np.load(os.path.join(cluster[1], f"mv-grid.r{r}.npy"))
        assert _rel(y, a @ p) <= 1e-13


def test_cli_on_the_grid(system, cluster, lam_ref):
    a, b = system[:2]
    records, run_dir = cluster
    recs = [rank["cli-grid-ir"] for rank in records]
    assert [rec["rc"] for rec in recs] == [0] * 4
    lines = recs[0]["stdout"].strip().splitlines()
    assert len(lines) == 1
    assert not any(rec["stdout"].strip() for rec in recs[1:])
    fields = lines[0].split(",")
    assert (int(fields[0]), int(fields[1])) == (N, 4)
    ref_iters = lam_ref["ir"][0]
    assert abs(int(fields[6]) - ref_iters) <= math.ceil(0.02 * ref_iters)
    x = tio.read_vector(os.path.join(run_dir, "x_cli.bin"))
    assert _true_rel(a, b, x) <= 1e-8
    for rec in recs:
        assert rec["counts"]["gemv_f32_plain"] > 0
        assert rec["counts"]["gemv_df64_plain"] > 0


def test_cli_names_the_grid(capsys):
    assert tcli.main(["--backend", "sharded2d", "--devices", "4", "--device",
                      "cpu"]) == 1  # no process group: one rank
    assert "need 4 devices for a 2x2 grid" in capsys.readouterr().err


@pytest.mark.parametrize("precision", ["f32", "df64"])
def test_grid_diagonal_matches_lam_tpu(system, cluster, precision):
    """Every rank's whole diagonal (its grid row's block, from the
    diagonal rank, gathered over the grid column) and the f32 inverse
    diagonal, bit for bit lam_tpu's."""
    jop = jpcg2d.Sharded2DOperator.from_dense(
        system[0], mesh=jpcg2d.make_mesh2d(2), precision=precision,
        engine="xla")
    ref_d = np.asarray(jop.diagonal())[:N]
    ref_inv = np.asarray(jcg._inv_diag_f32(jop))[:N]
    for r in range(4):
        d = np.load(os.path.join(cluster[1], f"diag-{precision}.r{r}.npy"))
        inv = np.load(os.path.join(cluster[1],
                                   f"diag-{precision}.inv.r{r}.npy"))
        assert d.dtype == ref_d.dtype
        np.testing.assert_array_equal(d, ref_d)
        np.testing.assert_array_equal(inv, ref_inv)


@pytest.mark.parametrize("precision", ["df64", "ir"])
def test_grid_jacobi_solve_matches_lam_tpu(system, cluster, lam_ref,
                                           precision):
    a, b = system[:2]
    records, run_dir = cluster
    name = f"jacobi-{precision}"
    recs = [rank[name] for rank in records]
    xs = [np.load(os.path.join(run_dir, f"{name}.r{r}.npy"))
          for r in range(4)]
    for rec, x in zip(recs, xs):
        assert rec["converged"] and rec["iters"] == recs[0]["iters"]
        assert np.array_equal(x, xs[0])
        for k in _KERNELS[precision]:
            assert rec["counts"][k + "_plain"] > 0, (k, rec["counts"])
    iters, (ref_iters, ref_x) = recs[0]["iters"], lam_ref[name]
    if precision == "df64":
        one = lam_ref["jacobi-one"][0]
        assert min(abs(iters - ref_iters), abs(iters - one)) <= 2, \
            (iters, ref_iters, one)
    else:
        assert abs(iters - ref_iters) <= math.ceil(0.02 * ref_iters), \
            (iters, ref_iters)
    assert _rel(xs[0], ref_x) <= 1e-6
    assert _true_rel(a, b, xs[0]) < 1e-9


def _rhs_block():
    return np.random.default_rng(7).uniform(-1, 1, (N, 2))


@pytest.mark.parametrize("name", ["ck-grid-xla", "ck-grid-ir"])
def test_grid_checkpoint_resume(system, cluster, lam_ref, name):
    """Stopped (CG at 30 iterations, ir after one cycle) with the whole
    vectors on disk, resumed on every rank of the grid: bitwise the
    uninterrupted resumable run (CG: and cg_solve's; ir: the fused
    cg_solve_ir's, the grid-ir job)."""
    a, b = system[:2]
    records, run_dir = cluster
    recs = [rank[name] for rank in records]
    xs = [np.load(os.path.join(run_dir, f"{name}.r{r}.npy"))
          for r in range(4)]
    for rec, x in zip(recs, xs):
        assert rec["converged"] and rec["bitwise"]
        assert not rec["part_converged"]
        assert rec["resumed_iters"] == rec["iters"] == recs[0]["iters"]
        assert rec["mono_bitwise"] in (None, True)
        assert np.array_equal(x, xs[0])
    assert _true_rel(a, b, xs[0]) <= 1e-8
    if name == "ck-grid-ir":
        grid_ir = np.load(os.path.join(run_dir, "grid-ir.r0.npy"))
        assert np.array_equal(xs[0], grid_ir)
        assert recs[0]["counts"]["gemv_f32_plain"] > 0
    else:
        assert abs(recs[0]["iters"] - lam_ref["df64"][0]) <= 2
        assert not any(recs[0]["counts"].values())  # xla: no kernel
    with open(os.path.join(run_dir, name, "state.json" if name.endswith(
            "xla") else "ir_state.json")) as f:
        assert json.load(f)["n_padded"] == (
            N if name.endswith("xla") else
            pcg2d.Sharded2DOperator.block_padded_size(N, 2))


def test_grid_cli_checkpoint_then_resume(cluster):
    records, run_dir = cluster
    rows = {}
    for name in ("cli-ck", "cli-resume"):
        recs = [rank[name] for rank in records]
        assert [rec["rc"] for rec in recs] == [0] * 4
        assert not any(rec["stdout"].strip() for rec in recs[1:])
        rows[name] = recs[0]["stdout"].strip().split(",")
    assert rows["cli-ck"][6] == "31"
    assert int(rows["cli-resume"][6]) == records[0]["grid-df64"]["iters"]
    np.testing.assert_array_equal(
        tio.read_vector(os.path.join(run_dir, "x_resume.bin")),
        np.load(os.path.join(run_dir, "grid-df64.r0.npy")))


def test_grid_block_cg(system, cluster):
    a = system[0]
    records, run_dir = cluster
    bb = _rhs_block()
    xs = [np.load(os.path.join(run_dir, f"block-grid-xla.r{r}.npy"))
          for r in range(4)]
    iters = records[0]["block-grid-xla"]["iters"]
    ref = lam_tpu.cg_solve_block(
        lam_tpu.DenseOperator.from_dense(a, precision="f64"), bb,
        max_iters=10000, rel_error=1e-9)
    for j in range(2):
        # within 2% (as test_torch_sharded.py's block test says why)
        ref_j = int(ref.num_iters[j])
        assert abs(iters[j] - ref_j) <= math.ceil(0.02 * ref_j)
        assert _true_rel(a, bb[:, j], xs[0][:, j]) <= 1e-8
    for r in range(4):
        assert np.array_equal(xs[r], xs[0])
        assert records[r]["block-grid-xla"]["iters"] == iters
