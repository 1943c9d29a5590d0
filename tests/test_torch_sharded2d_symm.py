"""The port's symmetric 2-D grid (lam_tpu_torch/parallel/pcg2d_symm.py)
against lam_tpu's `Symm2DOperator`, on the CPU.

Layout: the padding rule, and every rank's planes, scales and diagonal
pair byte-equal to that rank's slice of lam_tpu's operand on its virtual
R x R mesh (df64, dfq, fq), each rank built alone without a process group;
the per-rank shard files byte-equal and readable both ways. Routing: every
rank's (own, payload) of a matvec against numpy on the padded matrix, and
the parts exchanged by hand and summed against a @ p, for R = 1, 2, 3, the
accurate matvec and the f32 view. Solves run in one gloo CPU cluster of 4
rank processes (R = 2; tests/torch_sharded_worker.py) against lam_tpu's
solves on its 2 x 2 virtual mesh, which off a TPU computes its accurate
matvec in f64.

Tolerances. Matvec against a @ p: df64 1e-13; fq 1e-12 and dfq 1e-11 (their
storage bounds); the f32 views 1e-4 (q1 alone keeps ~2^-16 of a tile's
largest entry). Iterations: the df64 class (df64, dfq, fq) within 2 of
lam_tpu's grid count or of its one-device f64 count; the refinement class
within 2% (an f32 inner loop sums in another order than XLA's, and stops
cycle by cycle). x within 1e-6 of lam_tpu's, identical on every rank; TRUE
residual <= 2e-9.
"""

import math
import os
import shutil

import numpy as np
import pytest
import torch

import lam_tpu
from lam_tpu import generate as jgen
from lam_tpu import io as jio
from lam_tpu.parallel import pcg2d as jpcg2d
from lam_tpu.parallel import pcg2d_symm as jsym
from lam_tpu.solver import cg as jcg
from lam_tpu.solver import pack_cache as jpc
from lam_tpu_torch import ConjugateGradient
from lam_tpu_torch import io as tio
from lam_tpu_torch.parallel import mesh as pmesh
from lam_tpu_torch.parallel import pcg2d_symm as sym
from lam_tpu_torch.solver import pack_cache as pc
from lam_tpu_torch.solver.operators import QUANT_LAYOUT
from torch_sharded_worker import launch_cluster

JACOBI = ("df64", "ir")   # the Jacobi-preconditioned solves
JACOBI_REL = 5e-10  # half their TRUE gate, 1e-9
TB = 128
N, SEED = 500, 47
CLUSTER_TIMEOUT_S = 240
STORAGES = ("df64", "dfq", "fq")
PRECISIONS = ("df64", "ir", "fq", "irfq", "dfq", "irq")
_BASE = {"ir": "df64", "irq": "dfq", "irfq": "fq"}
MATVEC_BOUND = {"df64": 1e-13, "fq": 1e-12, "dfq": 1e-11}
TRUE_GATE = 2e-9


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


def _rank_op(a, rank, r, storage, **kw):
    """Rank `rank`'s operator of an R x R grid, built alone."""
    return sym.Symm2DOperator.from_dense(
        a, mesh=pmesh.Mesh2D(rank, r, "cpu"), tb=TB, precision=storage,
        device="cpu", **kw)


# -- layout ----------------------------------------------------------------


@pytest.mark.parametrize("tb", [128, 512])
@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 500, 2048, 2049])
def test_sym2d_padded_size_equals_lam_tpu(n, r, tb):
    assert sym.sym2d_padded_size(n, r, tb) == jsym.sym2d_padded_size(n, r,
                                                                    tb)
    tb_, n_p, m, c, T = sym._geometry(n, r, tb)
    assert n_p % (2 * r * tb) == 0 and m * r == n_p and c % 2 == 0
    assert T == c * (c + 1) // 2


def _rank_slices(operand, r, n_p, storage):
    """{(i, j): rank (i, j)'s buffers} of a lam_tpu Symm2DOperator
    operand: planes (R*T*tb, R*tb), scales (R*T, R), the diagonal pair
    (n_p,) split over grid rows."""
    m = n_p // r
    arrs = [np.asarray(x) for x in operand]
    n_planes = (len(QUANT_LAYOUT[storage][0]) if storage in QUANT_LAYOUT
                else 2)
    n_scales = QUANT_LAYOUT[storage][1] if storage in QUANT_LAYOUT else 0
    rows = arrs[0].shape[0] // r
    T = rows // TB
    out = {}
    for i in range(r):
        for j in range(r):
            bufs = [x[i * rows:(i + 1) * rows, j * TB:(j + 1) * TB]
                    for x in arrs[:n_planes]]
            bufs += [x[i * T:(i + 1) * T, j]
                     for x in arrs[n_planes:n_planes + n_scales]]
            if storage in QUANT_LAYOUT:
                bufs += [x[i * m:(i + 1) * m] for x in arrs[-2:]]
            out[i, j] = bufs
    return out


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("r", [1, 2])
def test_rank_buffers_byte_equal_lam_tpu(r, storage):
    a = jgen.random_spd_matrix(700, seed=10 + r)
    ref = jsym.Symm2DOperator.from_dense(a, mesh=jpcg2d.make_mesh2d(r),
                                         tb=TB, precision=storage)
    want = _rank_slices(ref.operand, r, ref.n_padded, storage)
    n_vec = 2 if storage in QUANT_LAYOUT else 0
    for rank in range(r * r):
        op = _rank_op(a, rank, r, storage)
        i, j = divmod(rank, r)
        assert (op.n_padded, op.engine) == (ref.n_padded,
                                            "pallas_symm_packed")
        assert op.precision == storage and op.m == ref.n_padded // r
        assert len(op.operand) == len(want[i, j])
        for k, (x, w) in enumerate(zip(op.operand, want[i, j])):
            mine = x.numpy()
            if k >= len(op.operand) - n_vec and i != j:
                # lam_tpu replicates rank (i, i)'s pair over the grid row;
                # an off-diagonal rank of the port holds zeros
                assert not mine.any() and mine.shape == w.shape
                continue
            assert mine.dtype == w.dtype and mine.shape == w.shape
            assert mine.tobytes() == np.ascontiguousarray(w).tobytes(), \
                (rank, k)


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    a = jgen.random_spd_matrix(700, seed=5)
    d = tmp_path_factory.mktemp("sym2d_files")
    tio.write_matrix(d / "A.bin", a)
    return a, str(d / "A.bin")


def _no_pack(*_):
    raise AssertionError("the shard cache missed: a rank packed its block")


def _from_file(src, mesh, tb, precision, pack_cache=False, device="cpu"):
    """A rank's operator read from the file, as the facade reads it: only
    its block's bytes, with the shard cache where pack_cache is set."""
    return sym.Symm2DOperator.from_block_fn(
        lambda r0, c0, h, w: tio.read_matrix_block(src, r0, c0, h, w),
        tio.read_header(src)[0], mesh=mesh, tb=tb, precision=precision,
        pack_cache_src=src if pack_cache else None, device=device)


@pytest.mark.parametrize("storage", ["dfq", "fq"])
def test_shard_files_interchangeable_with_lam_tpu(matrix_file, storage,
                                                  monkeypatch):
    a, src = matrix_file
    r, n = 2, a.shape[0]
    cache_dir = f"{src}.shardpack"
    shutil.rmtree(cache_dir, ignore_errors=True)
    paths = [pc.shard_cache_path(src, storage, "r", r, k)
             for k in range(r * r)]
    assert paths[3] == f"{src}.shardpack/{storage}.r2.s3"
    assert paths == [jpc.shard_cache_path(src, storage, "r", r, k)
                     for k in range(r * r)]
    # the port writes, lam_tpu reads every rank's pack without packing
    mine = [_from_file(src, mesh=pmesh.Mesh2D(k, r, "cpu"), tb=TB,
                       precision=storage, pack_cache=True)
            for k in range(r * r)]
    written = [open(p, "rb").read() for p in paths]
    jmesh = jpcg2d.make_mesh2d(r)
    ref = jsym.Symm2DOperator.from_block_fn(
        _no_pack, n, mesh=jmesh, tb=TB, precision=storage,
        pack_cache_src=src)
    want = _rank_slices(ref.operand, r, ref.n_padded, storage)
    for k, op in enumerate(mine):
        i, j = divmod(k, r)
        for x, w in list(zip(op.operand, want[i, j]))[:-2]:
            assert np.array_equal(x.numpy(), w)
        if i == j:
            for x, w in list(zip(op.operand, want[i, j]))[-2:]:
                assert np.array_equal(x.numpy(), w)
    # lam_tpu writes the same bytes, and the port reads them without packing
    shutil.rmtree(cache_dir)
    jsym.Symm2DOperator.from_block_fn(
        lambda r0, c0, h, w: jio.read_matrix_block(src, r0, c0, h, w), n,
        mesh=jmesh, tb=TB, precision=storage, pack_cache_src=src)
    assert [open(p, "rb").read() for p in paths] == written
    monkeypatch.setattr(sym, "_pack_chip_block", _no_pack)
    for k, op in enumerate(mine):
        again = _from_file(src, mesh=pmesh.Mesh2D(k, r, "cpu"), tb=TB,
                           precision=storage, pack_cache=True)
        for x, y in zip(op.operand, again.operand):
            assert torch.equal(x, y)
    # another grid, storage or tile width is a miss, not an error
    with pytest.raises(AssertionError, match="cache missed"):
        _from_file(src, mesh=pmesh.Mesh2D(0, 1, "cpu"), tb=TB,
                   precision=storage, pack_cache=True)
    with pytest.raises(AssertionError, match="cache missed"):
        _from_file(src, mesh=pmesh.Mesh2D(0, r, "cpu"), tb=256,
                   precision=storage, pack_cache=True)


def test_shard_cache_is_off_by_default(matrix_file):
    a, src = matrix_file
    shutil.rmtree(f"{src}.shardpack", ignore_errors=True)
    _from_file(src, mesh=pmesh.Mesh2D(1, 2, "cpu"), tb=TB, precision="fq")
    # the df64 storage has no shard cache, asked for or not
    _from_file(src, mesh=pmesh.Mesh2D(1, 2, "cpu"), tb=TB, precision="df64",
               pack_cache=True)
    assert not os.path.exists(f"{src}.shardpack")


# -- routing, rank by rank, no process group -------------------------------


def _expected_pair(a_p, p_p, i, j, m):
    """Rank (i, j)'s (own, payload) of A p in numpy, from the padded
    matrix and vector."""
    m2 = m // 2
    blk = lambda k: p_p[k * m:(k + 1) * m]  # noqa: E731
    zero = np.zeros(m)
    if i == j:
        return a_p[i * m:(i + 1) * m, i * m:(i + 1) * m] @ blk(i), zero
    if i > j:  # top half of the lower block A_ij
        s = a_p[i * m:i * m + m2, j * m:(j + 1) * m]
        return np.concatenate([s @ blk(j), zero[m2:]]), s.T @ blk(i)[:m2]
    # bottom half of the lower block A_ji
    s = a_p[j * m + m2:(j + 1) * m, i * m:(i + 1) * m]
    return s.T @ blk(j)[m2:], np.concatenate([zero[:m2], s @ blk(i)])


@pytest.mark.parametrize("which", ["acc", "f32"])
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("r", [1, 2, 3])
def test_rank_parts_and_assembled_matvec(r, storage, which):
    n = 600
    a = jgen.random_spd_matrix(n, seed=20 + r)
    p = np.random.default_rng(r).uniform(-1, 1, n)
    ops_ = [_rank_op(a, k, r, storage) for k in range(r * r)]
    if which == "f32":
        ops_ = [op.as_f32() for op in ops_]
    n_p, m = ops_[0].n_padded, ops_[0].m
    a_p = np.zeros((n_p, n_p))
    a_p[:n, :n] = a
    p_p = np.zeros(n_p)
    p_p[:n] = p
    bound = 1e-4 if which == "f32" else MATVEC_BOUND[storage]
    scale = np.linalg.norm(a @ p)
    blocks = [op.prepare_b(p) for op in ops_]
    pairs = {}
    for k, op in enumerate(ops_):
        i, j = divmod(k, r)
        assert blocks[k].shape == (m,)
        # exchange 1 by hand: rank (i, j) receives block j from (j, i)
        own, payload = op.mv_pair(op.operand, blocks[k], blocks[j * r + i])
        want_own, want_payload = _expected_pair(a_p, p_p, i, j, m)
        assert own.shape == payload.shape == (m,)
        assert own.dtype == payload.dtype == op.vector_dtype
        assert np.linalg.norm(own.double().numpy() - want_own) <= \
            bound * scale, (i, j)
        assert np.linalg.norm(payload.double().numpy() - want_payload) <= \
            bound * scale, (i, j)
        if i == j:
            assert not payload.any()
        pairs[i, j] = (own, payload)
    # exchange 2 and the grid-row sum by hand
    y = torch.cat([sum(pairs[i, j][0] + pairs[j, i][1] for j in range(r))
                   for i in range(r)]).double().numpy()
    assert _rel(y[:n], a @ p) <= bound
    assert not y[n:].any()  # padding rows exactly 0


@pytest.mark.parametrize("storage", STORAGES)
def test_one_rank_grid_matvec_chain_and_diagonal(storage):
    """R = 1: only a diagonal rank, no exchange and no group."""
    n = 300
    a = jgen.random_spd_matrix(n, seed=31)
    s = np.exp(np.linspace(0, 4, n))
    a = a * np.outer(s, s)
    op = _rank_op(a, 0, 1, storage)
    p = np.random.default_rng(3).uniform(-1, 1, n)
    y = op.extract_x(op.matvec(op.prepare_b(p))).numpy()
    assert _rel(y, a @ p) <= MATVEC_BOUND[storage]
    d = op.diagonal().numpy()
    np.testing.assert_allclose(d[:n], np.diag(a), rtol=2.0 ** -47, atol=0)
    assert not d[n:].any()
    out = op.matvec_chain(op.prepare_b(p), 3).numpy()
    ref = a @ (a @ (a @ p))
    assert abs(np.linalg.norm(out) - 1.0) < 1e-10
    np.testing.assert_allclose(out[:n], ref / np.linalg.norm(ref),
                               rtol=1e-7, atol=1e-10)
    op32 = op.as_f32()
    assert op32.operand is op.operand and op32.precision == "f32"
    assert op32.as_f32() is op32 and op32.vector_dtype == torch.float32


def test_sym2d_refusals():
    a = jgen.random_spd_matrix(48, seed=105)
    mesh = pmesh.Mesh2D(0, 1, "cpu")
    bad = np.asarray(a).copy()
    bad[0, 1] += 1.0
    with pytest.raises(ValueError, match="requires a symmetric matrix"):
        sym.Symm2DOperator.from_dense(bad, mesh=mesh, tb=TB, device="cpu")
    with pytest.raises(ValueError, match="symmetric"):  # lam_tpu's too
        jsym.Symm2DOperator.from_dense(bad, mesh=jpcg2d.make_mesh2d(1),
                                       tb=TB)
    with pytest.raises(ValueError, match="must be 'df64', 'dfq' or 'fq'"):
        sym.Symm2DOperator.from_dense(a, mesh=mesh, tb=TB, precision="f32",
                                      device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        sym.Symm2DOperator.from_dense(a, mesh=mesh, tb=192, device="cpu")
    with pytest.raises(ValueError, match="square"):
        sym.Symm2DOperator.from_dense(a[:, :10], mesh=mesh, device="cpu")
    with pytest.raises(RuntimeError, match="outside the 2x2 grid"):
        sym.Symm2DOperator.from_dense(a, mesh=pmesh.Mesh2D(4, 2, "cpu"),
                                      tb=TB, device="cpu")
    for ctor in (sym.Symm2DOperator.from_gen_tridiagonal,
                 sym.Symm2DOperator.from_gen_fq):
        with pytest.raises(RuntimeError, match="outside the 2x2 grid"):
            ctor(100, mesh=pmesh.Mesh2D(4, 2, "cpu"), tb=TB)
        with pytest.raises(ValueError, match="power-of-two"):
            ctor(100, mesh=mesh, tb=192)
    op = sym.Symm2DOperator.from_dense(a, mesh=mesh, tb=TB, device="cpu")
    # the Jacobi preconditioner runs (one rank: the whole diagonal)
    b = np.random.default_rng(106).uniform(-1, 1, 48)
    res = op.run_pcg(op.prepare_b(b), 10000, 1e-9)
    x = op.extract_x(res.x).numpy()
    assert bool(res.converged)
    assert (np.linalg.norm(b - np.asarray(a) @ x)
            <= 1e-9 * np.linalg.norm(b))
    with pytest.raises(ValueError, match="rhs has shape"):
        op.prepare_b(np.zeros(3))
    with pytest.raises(ValueError, match="unknown symmetric-grid storage"):
        sym.Symm2DOperator(op.operand, 48, op.n_padded, mesh, TB, "slab")


# -- the facade and its routing --------------------------------------------


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    a = jgen.random_spd_matrix_fast(N, seed=SEED)
    b = jgen.random_rhs(N, seed=SEED + 10)
    d = tmp_path_factory.mktemp("sym2d_system")
    tio.write_matrix(d / "A.bin", a)
    tio.write_matrix(d / "b.bin", b)
    return a, b, str(d / "A.bin"), str(d / "b.bin")


@pytest.mark.parametrize("precision", PRECISIONS)
def test_one_rank_symmetric_grid_solve(system, precision, capsys,
                                       tmp_path):
    a, b, a_path, b_path = system
    src = str(tmp_path / "A.bin")
    shutil.copy2(a_path, src)
    engine = "pallas_symm_packed" if precision in ("df64", "ir") else "auto"
    cg = ConjugateGradient(backend="sharded2d", precision=precision,
                           engine=engine, device="cpu", pack_cache=True)
    assert cg.mesh.size == 1 and cg._sharded_engine == "pallas_symm_packed"
    cg.load_matrix_from_file(src)
    storage = _BASE.get(precision, precision)
    quant = storage in QUANT_LAYOUT
    # the shard cache serves the quantized storages and no other
    assert ("--pack-cache only accelerates" in capsys.readouterr().err) \
        == (not quant)
    assert os.path.exists(f"{src}.shardpack/{storage}.r1.s0") == quant
    assert isinstance(cg.op, sym.Symm2DOperator)
    assert cg.op.storage == storage and cg.op.tb == 512
    cg.load_rhs_from_file(b_path)
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    assert _true_rel(a, b, cg.x) <= TRUE_GATE
    assert cg.measure_gemv(repeats=2) > 0


def test_api_routes_the_2d_grid():
    for precision in PRECISIONS:
        for engine in ("pallas_symm", "pallas_symm_packed"):
            cg = ConjugateGradient(backend="sharded2d", precision=precision,
                                   engine=engine, device="cpu")
            assert cg._sharded_engine == engine
    for precision in ("dfq", "irq", "fq", "irfq"):
        cg = ConjugateGradient(backend="sharded2d", precision=precision,
                               device="cpu")
        assert cg._sharded_engine == "pallas_symm_packed"
        with pytest.raises(ValueError, match="only on the symmetric grid"):
            ConjugateGradient(backend="sharded2d", precision=precision,
                              engine="pallas", device="cpu")
    for precision in ("f32", "df64", "ir"):  # auto stays on dense blocks
        cg = ConjugateGradient(backend="sharded2d", precision=precision,
                               device="cpu")
        assert cg._sharded_engine == "auto"
    for engine in ("pallas_symm", "pallas_symm_packed"):
        with pytest.raises(ValueError, match="supports precision "
                           "df64/ir/dfq/irq/fq/irfq"):
            ConjugateGradient(backend="sharded2d", precision="f32",
                              engine=engine, device="cpu")
    # engine xla: the dense grid with plain torch products, as in lam_tpu
    cg = ConjugateGradient(backend="sharded2d", engine="xla",
                           precision="f64", device="cpu")
    assert cg._sharded_engine == "xla"
    with pytest.raises(ValueError, match="unknown engine"):
        ConjugateGradient(backend="sharded2d", engine="mxu", device="cpu")


# -- the 2 x 2 grid in rank processes --------------------------------------


def _jobs(a_path, b_path, p_path, out):
    def solve(name, precision, **kw):
        return {"kind": "solve", "name": name, "op": "symgrid", "tb": TB,
                "precision": precision, "matrix": a_path, "rhs": b_path,
                "rel_error": 1e-9, **kw}

    jobs = [solve("sym-df64", "df64"), solve("sym-ir", "ir"),
            solve("sym-fq", "fq"),
            solve("sym-irfq-cold", "irfq", pack_cache=True),
            solve("sym-irfq-warm", "irfq", pack_cache=True),
            solve("sym-dfq", "dfq"), solve("sym-irq", "irq")]
    for storage in STORAGES:
        jobs.append({"kind": "matvec", "name": f"mv-{storage}",
                     "op": "symgrid", "tb": TB, "precision": storage,
                     "matrix": a_path, "p": p_path})
        jobs.append({"kind": "diagonal", "name": f"diag-{storage}",
                     "op": "symgrid", "tb": TB, "precision": storage,
                     "matrix": a_path})
    jobs.append({"kind": "cli", "name": "cli-irq", "argv": [
        "-A", a_path, "-b", b_path, "-o", os.path.join(out, "x_cli.bin"),
        "--backend", "sharded2d", "--precision", "irq"]})
    for precision in JACOBI:
        jobs.append(solve(f"jacobi-{precision}", precision,
                          rel_error=JACOBI_REL, preconditioner="jacobi"))
    return jobs


@pytest.fixture(scope="module")
def cluster(system, tmp_path_factory):
    """(records of each rank, output directory) of one 4-rank launch."""
    a, b, a_path, b_path = system
    d = tmp_path_factory.mktemp("sym2d_cluster")
    p_path = str(d / "p.npy")
    np.save(p_path, np.random.default_rng(6).uniform(-1, 1, N))
    run_dir = str(d / "r2")
    return launch_cluster(4, _jobs(a_path, b_path, p_path, run_dir), run_dir,
                          CLUSTER_TIMEOUT_S), run_dir


@pytest.fixture(scope="module")
def lam_ref(system):
    """lam_tpu's solves on its 2 x 2 virtual mesh and its one-device f64
    solve: {precision: (iterations, x)}."""
    a, b = system[:2]
    mesh = jpcg2d.make_mesh2d(2)
    out = {"one": lam_tpu.cg_solve(
        lam_tpu.DenseOperator.from_dense(a, precision="f64"), b,
        max_iters=10000, rel_error=1e-9)}
    for storage, ir in (("df64", "ir"), ("dfq", "irq"), ("fq", "irfq")):
        op = jsym.Symm2DOperator.from_dense(a, mesh=mesh, tb=TB,
                                            precision=storage)
        out[storage] = lam_tpu.cg_solve(op, b, max_iters=10000,
                                        rel_error=1e-9)
        out[ir] = lam_tpu.cg_solve_ir(
            op.as_f32(), op, b, max_iters=10000, rel_error=1e-9,
            inner_floor=jcg.default_inner_floor(ir))
    out["jacobi-one"] = lam_tpu.cg_solve(
        lam_tpu.DenseOperator.from_dense(a, precision="f64"), b,
        max_iters=10000, rel_error=JACOBI_REL, preconditioner="jacobi")
    op = jsym.Symm2DOperator.from_dense(a, mesh=mesh, tb=TB)
    out["jacobi-df64"] = lam_tpu.cg_solve(
        op, b, max_iters=10000, rel_error=JACOBI_REL,
        preconditioner="jacobi")
    out["jacobi-ir"] = lam_tpu.cg_solve_ir(
        op.as_f32(), op, b, max_iters=10000, rel_error=JACOBI_REL,
        preconditioner="jacobi")
    for key, res in out.items():
        assert bool(res.converged), key
    return {k: (int(r.num_iters), np.asarray(r.x)[:N])
            for k, r in out.items()}


# precision -> (a diagonal rank's plain versions, an off-diagonal rank's)
_PLAIN = {
    "df64": (["gemv_df64_symm"], ["gemv_df64_dual"]),
    "ir": (["gemv_f32_symm", "gemv_df64_symm"],
           ["gemv_f32_dual", "gemv_df64_dual"]),
    "fq": (["gemv_fq_symm"], ["gemv_fq_dual"]),
    "irfq": (["gemv_q16_symm", "gemv_fq_symm"],
             ["gemv_q16_dual", "gemv_fq_dual"]),
    "dfq": (["gemv_dfq_symm"], ["gemv_dfq_dual"]),
    "irq": (["gemv_f32_symm", "gemv_dfq_symm"],
            ["gemv_f32_dual", "gemv_dfq_dual"]),
}


def _check_counts(counts, rank, precision):
    """A diagonal rank ran its triangle walks and no dual matvec, an
    off-diagonal rank the dual matvecs and no triangle walk."""
    diag, off = _PLAIN[precision]
    ran, not_ran = (diag, off) if rank in (0, 3) else (off, diag)
    for k in ran:
        assert counts[k + "_plain"] > 0, (rank, k, counts)
    others = {k for pair in _PLAIN.values() for ks in pair for k in ks}
    for k in others - set(ran):
        assert counts[k + "_plain"] == 0, (rank, k, counts)
    assert not_ran and counts["gemv_f32_plain"] == 0


@pytest.mark.parametrize("name,precision", [
    ("sym-df64", "df64"), ("sym-ir", "ir"), ("sym-fq", "fq"),
    ("sym-irfq-cold", "irfq"), ("sym-irfq-warm", "irfq"),
    ("sym-dfq", "dfq"), ("sym-irq", "irq")])
def test_symmetric_grid_solve_matches_lam_tpu(system, cluster, lam_ref, name,
                                              precision):
    a, b = system[:2]
    records, run_dir = cluster
    recs = [rank[name] for rank in records]
    xs = [np.load(os.path.join(run_dir, f"{name}.r{r}.npy"))
          for r in range(4)]
    for r, (rec, x) in enumerate(zip(recs, xs)):
        assert rec["converged"] and rec["size"] == 4
        assert rec["backend"] == "gloo" and rec["device"] == "cpu"
        assert rec["iters"] == recs[0]["iters"]
        assert np.array_equal(x, xs[0])  # every rank holds the same x
        _check_counts(rec["counts"], r, precision)
    iters, (ref_iters, ref_x) = recs[0]["iters"], lam_ref[precision]
    if precision in STORAGES:
        one = lam_ref["one"][0]
        assert min(abs(iters - ref_iters), abs(iters - one)) <= 2, \
            (iters, ref_iters, one)
    else:
        assert abs(iters - ref_iters) <= math.ceil(0.02 * ref_iters), \
            (iters, ref_iters)
    assert _rel(xs[0][:N], ref_x) <= 1e-6
    assert _true_rel(a, b, xs[0][:N]) <= TRUE_GATE


def test_shard_cache_cold_then_warm(system, cluster):
    a_path = system[2]
    records, run_dir = cluster
    for k in range(4):
        assert os.path.exists(f"{a_path}.shardpack/fq.r2.s{k}")
    assert not os.path.exists(f"{a_path}.shardpack/dfq.r2.s0")
    cold, warm = (records[0][n] for n in ("sym-irfq-cold", "sym-irfq-warm"))
    assert cold["iters"] == warm["iters"]
    assert np.array_equal(
        np.load(os.path.join(run_dir, "sym-irfq-cold.r0.npy")),
        np.load(os.path.join(run_dir, "sym-irfq-warm.r0.npy")))


@pytest.mark.parametrize("storage", STORAGES)
def test_symmetric_grid_matvec_and_diagonal(system, cluster, storage):
    a = system[0]
    p = np.random.default_rng(6).uniform(-1, 1, N)
    ys = [np.load(os.path.join(cluster[1], f"mv-{storage}.r{r}.npy"))
          for r in range(4)]
    for r, y in enumerate(ys):
        assert _rel(y, a @ p) <= MATVEC_BOUND[storage]
        assert np.array_equal(y, ys[0])  # one y on every rank
        d = np.load(os.path.join(cluster[1], f"diag-{storage}.r{r}.npy"))
        np.testing.assert_allclose(d, np.diag(a), rtol=2.0 ** -47, atol=0)


def test_cli_on_the_symmetric_grid(system, cluster, lam_ref):
    a, b = system[:2]
    records, run_dir = cluster
    recs = [rank["cli-irq"] for rank in records]
    assert [rec["rc"] for rec in recs] == [0] * 4
    lines = recs[0]["stdout"].strip().splitlines()
    assert len(lines) == 1
    assert not any(rec["stdout"].strip() for rec in recs[1:])
    fields = lines[0].split(",")
    assert (int(fields[0]), int(fields[1])) == (N, 4)
    # the CLI's 512-wide tiles quantize another operator than the
    # reference's 128-wide ones
    ref_iters = lam_ref["irq"][0]
    assert abs(int(fields[6]) - ref_iters) <= math.ceil(0.02 * ref_iters)
    x = tio.read_vector(os.path.join(run_dir, "x_cli.bin"))
    assert _true_rel(a, b, x) <= TRUE_GATE
    assert _rel(x, lam_ref["irq"][1]) <= 1e-6
    for r, rec in enumerate(recs):
        _check_counts(rec["counts"], r, "irq")


@pytest.mark.parametrize("storage", STORAGES)
def test_symmetric_grid_diagonal_matches_lam_tpu(system, cluster, storage):
    """Every rank's whole diagonal and the preconditioner's f32 inverse
    diagonal, bit for bit lam_tpu's."""
    jop = jsym.Symm2DOperator.from_dense(
        system[0], mesh=jpcg2d.make_mesh2d(2), tb=TB, precision=storage)
    ref_d = np.asarray(jop.diagonal())[:N]
    ref_inv = np.asarray(jcg._inv_diag_f32(jop))[:N]
    for r in range(4):
        d = np.load(os.path.join(cluster[1], f"diag-{storage}.r{r}.npy"))
        inv = np.load(os.path.join(cluster[1],
                                   f"diag-{storage}.inv.r{r}.npy"))
        np.testing.assert_array_equal(d, ref_d)
        np.testing.assert_array_equal(inv, ref_inv)


@pytest.mark.parametrize("precision", JACOBI)
def test_symmetric_grid_jacobi_solve_matches_lam_tpu(system, cluster,
                                                     lam_ref, precision):
    a, b = system[:2]
    records, run_dir = cluster
    name = f"jacobi-{precision}"
    recs = [rank[name] for rank in records]
    xs = [np.load(os.path.join(run_dir, f"{name}.r{r}.npy"))
          for r in range(4)]
    for r, (rec, x) in enumerate(zip(recs, xs)):
        assert rec["converged"] and rec["iters"] == recs[0]["iters"]
        assert np.array_equal(x, xs[0])
        _check_counts(rec["counts"], r, precision)
    iters, (ref_iters, ref_x) = recs[0]["iters"], lam_ref[name]
    if precision == "df64":
        one = lam_ref["jacobi-one"][0]
        assert min(abs(iters - ref_iters), abs(iters - one)) <= 2, \
            (iters, ref_iters, one)
    else:
        # the preconditioned inner loop stops on the UNpreconditioned
        # r.r, which PCG does not minimise: near ir's inner floor it jumps
        # by 2-5x from one iteration to the next, so the f32 sums' order
        # moves the cycle's last iteration by up to ~10 (here 121 against
        # lam_tpu's 131 on this grid; the dense grid and one device give
        # 130-131): within 10%, where the unpreconditioned runs hold 2%
        assert abs(iters - ref_iters) <= math.ceil(0.1 * ref_iters), \
            (iters, ref_iters)
    assert _rel(xs[0][:N], ref_x) <= 1e-6
    assert _true_rel(a, b, xs[0][:N]) < 1e-9
