"""lam_tpu_torch.solver.checkpoint against lam_tpu.solver.checkpoint (CPU).

lam_tpu's tests/test_checkpoint.py case by case on the port (its meshes
here of one rank, with no process group; the 2-rank cluster runs are in
tests/test_torch_sharded.py), the files byte-equal to lam_tpu's for the
same state, checkpoints of either package resumed by the other, the
segmented CG bitwise the port's cg_solve and the resumed refinement
bitwise the uninterrupted one, and --checkpoint/--resume through the
port's CLI on --device cpu.
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
from lam_tpu import generate as gen
from lam_tpu.solver import checkpoint as jckpt
from lam_tpu_torch import DenseOperator, cg_solve, cg_solve_ir
from lam_tpu_torch import cli as tcli
from lam_tpu_torch import io as tio
from lam_tpu_torch.parallel import mesh as pmesh
from lam_tpu_torch.parallel.pcg import ShardedDenseOperator
from lam_tpu_torch.parallel.pcg2d import Sharded2DOperator
from lam_tpu_torch.parallel.pcg_symm import SymmShardedOperator
from lam_tpu_torch.solver import checkpoint as ckpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test processes on shared cores: torch's own
    # thread pool would oversubscribe them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(n=96, seed=31):
    return gen.random_spd_matrix(n, seed=seed), gen.random_rhs(n, seed + 1)


def _f64(a):
    return DenseOperator.from_dense(a, precision="f64", engine="xla",
                                    device="cpu")


def _true_rel(a, b, x):
    x = np.asarray(x)[:a.shape[0]]
    return np.linalg.norm(b - a @ x) / np.linalg.norm(b)


def _badly_scaled_system(n=96, seed=87):
    a = gen.random_spd_matrix(n, seed=seed)
    s = np.exp(np.linspace(0, 4, n))
    return a * np.outer(s, s), gen.random_rhs(n, seed + 1)


# -- lam_tpu's tests/test_checkpoint.py, case by case -----------------------


@pytest.mark.parametrize("preconditioner", [None, "jacobi"])
def test_segmented_equals_monolithic(preconditioner):
    # and test_pcg_segmented_equals_monolithic: bitwise, not within 1e-12
    a, b = (_system() if preconditioner is None
            else _badly_scaled_system())
    op = _f64(a)
    mono = cg_solve(op, b, max_iters=3000, rel_error=1e-9,
                    preconditioner=preconditioner)
    seg, seg_times = ckpt.cg_solve_resumable(
        op, b, max_iters=3000, rel_error=1e-9, segment=17,
        preconditioner=preconditioner)
    assert int(seg.num_iters) == int(mono.num_iters)
    assert torch.equal(seg.x, mono.x)
    assert sum(k for k, _ in seg_times) == int(seg.num_iters)
    assert all(k <= 17 for k, _ in seg_times)


@pytest.mark.parametrize("preconditioner", [None, "jacobi"])
def test_checkpoint_resume_roundtrip(tmp_path, preconditioner):
    # and test_pcg_checkpoint_resume_roundtrip
    a, b = (_system(seed=37) if preconditioner is None
            else _badly_scaled_system(seed=91))
    op = _f64(a)
    ck = str(tmp_path / "ck")
    partial, segs = ckpt.cg_solve_resumable(
        op, b, max_iters=30, rel_error=1e-9, segment=10, checkpoint_path=ck,
        preconditioner=preconditioner)
    assert not bool(partial.converged)
    assert int(partial.num_iters) == 30 and [k for k, _ in segs] == [10] * 3
    with open(os.path.join(ck, "state.json")) as f:
        assert json.load(f)["k"] == 30
    resumed, _ = ckpt.cg_solve_resumable(
        op, b, max_iters=3000, rel_error=1e-9, segment=50,
        checkpoint_path=ck, resume=True, preconditioner=preconditioner)
    assert bool(resumed.converged)
    mono = cg_solve(op, b, max_iters=3000, rel_error=1e-9,
                    preconditioner=preconditioner)
    assert int(resumed.num_iters) == int(mono.num_iters)
    assert torch.equal(resumed.x, mono.x)


def test_checkpoint_rejects_wrong_size(tmp_path):
    a, b = _system(seed=41)
    ck = str(tmp_path / "ck")
    ckpt.cg_solve_resumable(_f64(a), b, max_iters=10, rel_error=1e-9,
                            segment=10, checkpoint_path=ck)
    a2, b2 = _system(n=64, seed=43)
    with pytest.raises(ValueError, match="checkpoint is for n=96/pad=96"):
        ckpt.cg_solve_resumable(_f64(a2), b2, max_iters=10, rel_error=1e-9,
                                checkpoint_path=ck, resume=True)
    # the same n on another layout (the packed engine pads to 1024)
    op = DenseOperator.from_dense(a, precision="df64", device="cpu")
    with pytest.raises(ValueError, match="operator has n=96/pad=1024"):
        ckpt.cg_solve_resumable(op, b, checkpoint_path=ck, resume=True)


def _mesh_ops(a, storage):
    """Every mesh operator of the port on a mesh of one rank."""
    mesh, grid = pmesh.Mesh(0, 1, "cpu"), pmesh.Mesh2D(0, 1, "cpu")
    if storage == "ir":
        return [SymmShardedOperator.from_dense(a, mesh=mesh, tb=128,
                                               packed=True, device="cpu"),
                ShardedDenseOperator.from_dense(a, mesh=mesh,
                                                precision="df64",
                                                device="cpu"),
                Sharded2DOperator.from_dense(a, mesh=grid,
                                             precision="df64", device="cpu")]
    return [ShardedDenseOperator.from_dense(a, mesh=mesh, precision="f64",
                                            engine="xla", device="cpu"),
            SymmShardedOperator.from_dense(a, mesh=mesh, tb=128,
                                           device="cpu"),
            Sharded2DOperator.from_dense(a, mesh=grid, precision="f64",
                                         device="cpu")]


@pytest.mark.parametrize("preconditioner", [None, "jacobi"])
def test_resumable_on_sharded_and_symm_backends(tmp_path, preconditioner):
    # and test_pcg_resumable_sharded: the row shards (engine xla), the
    # band pairs and the dense grid drive the segmented solve
    a, b = (gen.random_spd_matrix(256, seed=61), gen.random_rhs(256,
                                                                seed=71))
    if preconditioner:
        a, b = _badly_scaled_system(n=256, seed=99)
    for op in _mesh_ops(a, None):
        ck = str(tmp_path / type(op).__name__)
        res, segs = ckpt.cg_solve_resumable(
            op, b, max_iters=40, segment=20, rel_error=1e-9,
            checkpoint_path=ck, preconditioner=preconditioner)
        assert int(res.num_iters) == 40 and len(segs) == 2
        res2, _ = ckpt.cg_solve_resumable(
            op, b, max_iters=5000, segment=500, rel_error=1e-9,
            checkpoint_path=ck, resume=True, preconditioner=preconditioner)
        assert bool(res2.converged)
        assert _true_rel(a, b, res2.x.numpy()) < 1e-8
        mono = cg_solve(op, b, max_iters=5000, rel_error=1e-9,
                        preconditioner=preconditioner)
        assert torch.equal(res2.x, mono.x)


def test_pcg_checkpoint_kind_mismatch_rejected(tmp_path):
    a, b = _badly_scaled_system(seed=95)
    op = _f64(a)
    ck = str(tmp_path / "ck")
    ckpt.cg_solve_resumable(op, b, max_iters=10, rel_error=1e-9, segment=10,
                            checkpoint_path=ck, preconditioner="jacobi")
    with pytest.raises(ValueError, match="'pcg' solve; cannot resume it as "
                       "'cg'"):
        ckpt.cg_solve_resumable(op, b, max_iters=10, rel_error=1e-9,
                                checkpoint_path=ck, resume=True)
    ck2 = str(tmp_path / "ck2")
    ckpt.cg_solve_resumable(op, b, max_iters=10, rel_error=1e-9, segment=10,
                            checkpoint_path=ck2)
    with pytest.raises(ValueError, match="'cg' solve; cannot resume it as "
                       "'pcg'"):
        ckpt.cg_solve_resumable(op, b, max_iters=10, rel_error=1e-9,
                                checkpoint_path=ck2, resume=True,
                                preconditioner="jacobi")


@pytest.mark.parametrize("preconditioner", [None, "jacobi"])
def test_ir_checkpoint_resume_matches_uninterrupted(tmp_path,
                                                    preconditioner):
    # and test_ir_jacobi_checkpoint_resume_matches_uninterrupted: a
    # resumed solve lands bitwise on the uninterrupted resumable one,
    # which is bitwise the fused cg_solve_ir
    n = 300
    a, b = gen.random_spd_system(n, seed=33 if preconditioner is None
                                 else 34)
    if preconditioner:
        s = np.exp(np.linspace(0, 3, n))
        a = a * np.outer(s, s)
    op = DenseOperator.from_dense(a, precision="df64", device="cpu")
    op32 = op.as_f32()
    kw = dict(max_iters=20000, rel_error=1e-9, preconditioner=preconditioner)
    full, cycles = ckpt.cg_solve_ir_resumable(op32, op, b, **kw)
    assert bool(full.converged) and len(cycles) >= 2
    assert int(full.num_iters) == sum(k for k, _ in cycles)
    fused = cg_solve_ir(op32, op, b, **kw)
    assert torch.equal(full.x, fused.x)
    assert int(full.num_iters) == int(fused.num_iters)
    ck = str(tmp_path / "ir_ck")
    part, _ = ckpt.cg_solve_ir_resumable(op32, op, b, max_cycles=1,
                                         checkpoint_path=ck, **kw)
    assert not bool(part.converged)
    res, _ = ckpt.cg_solve_ir_resumable(op32, op, b, checkpoint_path=ck,
                                        resume=True, **kw)
    assert bool(res.converged) and torch.equal(res.x, full.x)
    assert int(res.num_iters) == int(full.num_iters)
    assert _true_rel(a, b, res.x.numpy()) < 1e-8
    other = None if preconditioner else "jacobi"
    with pytest.raises(ValueError, match="preconditioner"):
        ckpt.cg_solve_ir_resumable(op32, op, b, checkpoint_path=ck,
                                   resume=True, max_iters=20000,
                                   preconditioner=other)


def test_ir_checkpoint_wrong_size_rejected(tmp_path):
    a, b = gen.random_spd_system(200, seed=34)
    op = DenseOperator.from_dense(a, precision="df64", engine="xla",
                                  device="cpu")
    ck = str(tmp_path / "ck")
    ckpt.cg_solve_ir_resumable(op.as_f32(), op, b, max_iters=100,
                               rel_error=1e-9, max_cycles=1,
                               checkpoint_path=ck)
    a2, b2 = gen.random_spd_system(300, seed=35)
    op2 = DenseOperator.from_dense(a2, precision="df64", engine="xla",
                                   device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        ckpt.cg_solve_ir_resumable(op2.as_f32(), op2, b2,
                                   checkpoint_path=ck, resume=True)


def test_ir_checkpoint_sharded(tmp_path):
    """The band pairs (packed), the row shards and the dense grid, each
    of one rank: the resumed refinement is bitwise the uninterrupted
    one."""
    a, b = gen.random_spd_system(300, seed=36)
    for op in _mesh_ops(a, "ir"):
        ck = str(tmp_path / type(op).__name__)
        kw = dict(max_iters=10000, rel_error=1e-9)
        full, _ = ckpt.cg_solve_ir_resumable(op.as_f32(), op, b, **kw)
        ckpt.cg_solve_ir_resumable(op.as_f32(), op, b, max_cycles=1,
                                   checkpoint_path=ck, **kw)
        res, _ = ckpt.cg_solve_ir_resumable(op.as_f32(), op, b,
                                            checkpoint_path=ck, resume=True,
                                            **kw)
        assert bool(res.converged) and torch.equal(res.x, full.x)
        assert _true_rel(a, b, res.x.numpy()) < 1e-8


@pytest.mark.parametrize("storage,floor,cycles", [("dfq", 1e-5, 1),
                                                  ("fq", (3e-2, 1e-2), 2)])
def test_quantized_ir_checkpoint_resume_matches_uninterrupted(
        tmp_path, storage, floor, cycles):
    """irq and irfq (lam_tpu's two last cases) at the full 1e-9: the
    port's plain versions keep the compensated sums that XLA:CPU breaks
    in lam_tpu's interpreted kernels. irfq's schedule puts the resumed
    cycle on the floor of the restored cycle counter."""
    n = 700
    a = gen.random_spd_matrix(n, seed=31 if storage == "dfq" else 33)
    b = gen.random_rhs(n, seed=32 if storage == "dfq" else 34)
    op = getattr(DenseOperator, f"from_dense_{storage}")(a, device="cpu")
    kw = dict(max_iters=10000, rel_error=1e-9, inner_floor=floor)
    full, cyc = ckpt.cg_solve_ir_resumable(op.as_f32(), op, b, **kw)
    assert len(cyc) > cycles
    assert torch.equal(full.x, cg_solve_ir(op.as_f32(), op, b, **kw).x)
    ck = str(tmp_path / f"{storage}.ck")
    ckpt.cg_solve_ir_resumable(op.as_f32(), op, b, max_cycles=cycles,
                               checkpoint_path=ck, **kw)
    with open(os.path.join(ck, "ir_state.json")) as f:
        assert json.load(f)["cycle"] == cycles
    res, _ = ckpt.cg_solve_ir_resumable(op.as_f32(), op, b,
                                        checkpoint_path=ck, resume=True,
                                        **kw)
    assert bool(res.converged) and torch.equal(res.x, full.x)
    assert _true_rel(a, b, res.x.numpy()) < 2e-9


# -- the files: lam_tpu's bytes ---------------------------------------------


def _bytes(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("kind,dtype", [("cg", np.float64),
                                        ("pcg", np.float64),
                                        ("cg", np.float32)])
def test_state_files_byte_equal_lam_tpu(tmp_path, kind, dtype):
    rng = np.random.default_rng(3)
    vecs = [rng.standard_normal(130).astype(dtype) for _ in range(3)]
    scalars = [dtype(v) for v in rng.uniform(0.1, 9.0, 3)]
    mine = dict(zip("xrp", (torch.from_numpy(v) for v in vecs)))
    theirs = dict(zip("xrp", (jnp.asarray(v) for v in vecs)))
    rz, rr, bb = scalars
    if kind == "pcg":
        t = ckpt.PCGState(rz=torch.tensor(rz), rr=torch.tensor(rr),
                          bb=torch.tensor(bb), k=torch.tensor(17), **mine)
        j = jckpt.PCGState(rz=jnp.asarray(rz), rr=jnp.asarray(rr),
                           bb=jnp.asarray(bb), k=jnp.int32(17), **theirs)
    else:
        t = ckpt.CGState(rr=torch.tensor(rr), bb=torch.tensor(bb),
                         k=torch.tensor(17), **mine)
        j = jckpt.CGState(rr=jnp.asarray(rr), bb=jnp.asarray(bb),
                          k=jnp.int32(17), **theirs)
    ckpt.save_state(str(tmp_path / "t"), t, 120)
    jckpt.save_state(str(tmp_path / "j"), j, 120)
    assert _bytes(tmp_path / "t") == _bytes(tmp_path / "j")
    with open(tmp_path / "t" / "state.json") as f:
        keys = list(json.load(f))
    assert keys == ["rr", "bb", "k", "n", "n_padded"] + (
        ["kind", "rz"] if kind == "pcg" else [])


@pytest.mark.parametrize("preconditioner", [None, "jacobi"])
def test_ir_state_files_byte_equal_lam_tpu(tmp_path, preconditioner):
    rng = np.random.default_rng(4)
    x, r = rng.standard_normal(130), rng.standard_normal(130)
    ckpt.save_ir_state(str(tmp_path / "t"), torch.from_numpy(x),
                       torch.from_numpy(r), 377, 3, 120, preconditioner)
    jckpt.save_ir_state(str(tmp_path / "j"), x, r, 377, 3, 120,
                        preconditioner)
    assert _bytes(tmp_path / "t") == _bytes(tmp_path / "j")


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A lam_tpu f64/xla checkpoint at k=30 resumed by the port, and the
    port's resumed by lam_tpu: each converges within 2 iterations of the
    uninterrupted count to a TRUE residual <= 1e-8."""
    # the benchmark's spectrum (eigenvalues exp(3.5 U(-1, 1))): f64 CGs
    # that sum in other orders end within a few iterations of each other
    a, b = gen.random_spd_matrix_fast(200, seed=52), gen.random_rhs(200, 53)
    jop = lam_tpu.DenseOperator.from_dense(a, precision="f64", engine="xla")
    op = _f64(a)
    for kind in (None, "jacobi"):
        kw = dict(max_iters=3000, rel_error=1e-9, preconditioner=kind)
        whole = int(cg_solve(op, b, **kw).num_iters)
        jwhole = int(lam_tpu.cg_solve(jop, b, **kw).num_iters)
        j_ck, t_ck = str(tmp_path / f"j{kind}"), str(tmp_path / f"t{kind}")
        jckpt.cg_solve_resumable(jop, b, max_iters=30, rel_error=1e-9,
                                 segment=10, checkpoint_path=j_ck,
                                 preconditioner=kind)
        res, _ = ckpt.cg_solve_resumable(op, b, checkpoint_path=j_ck,
                                         resume=True, **kw)
        ckpt.cg_solve_resumable(op, b, max_iters=30, rel_error=1e-9,
                                segment=10, checkpoint_path=t_ck,
                                preconditioner=kind)
        jres, _ = jckpt.cg_solve_resumable(jop, b, checkpoint_path=t_ck,
                                           resume=True, **kw)
        # each package's resumed run against its own uninterrupted count
        for r, ref in ((res, whole), (jres, jwhole)):
            assert bool(r.converged)
            assert abs(int(r.num_iters) - ref) <= 2, (int(r.num_iters), ref)
            assert _true_rel(a, b, np.asarray(r.x)) <= 1e-8


def test_ir_checkpoints_cross_between_the_packages(tmp_path):
    """An ir checkpoint after one cycle on the xla df64 operator of either
    package resumes in the other (the same unpadded layout)."""
    a, b = gen.random_spd_system(300, seed=52)
    jop = lam_tpu.DenseOperator.from_dense(a, precision="df64",
                                           engine="xla")
    op = DenseOperator.from_dense(a, precision="df64", engine="xla",
                                  device="cpu")
    kw = dict(max_iters=10000, rel_error=1e-9)
    jckpt.cg_solve_ir_resumable(jop.as_f32(), jop, b, max_cycles=1,
                                checkpoint_path=str(tmp_path / "j"), **kw)
    res, _ = ckpt.cg_solve_ir_resumable(op.as_f32(), op, b, resume=True,
                                        checkpoint_path=str(tmp_path / "j"),
                                        **kw)
    ckpt.cg_solve_ir_resumable(op.as_f32(), op, b, max_cycles=1,
                               checkpoint_path=str(tmp_path / "t"), **kw)
    jres, _ = jckpt.cg_solve_ir_resumable(jop.as_f32(), jop, b, resume=True,
                                          checkpoint_path=str(tmp_path / "t"),
                                          **kw)
    for r in (res, jres):
        assert bool(r.converged) and _true_rel(a, b, np.asarray(r.x)) <= 1e-8


def test_resumable_refusals(tmp_path):
    a, b = _system()
    op = _f64(a)
    with pytest.raises(ValueError, match="requires checkpoint_path"):
        ckpt.cg_solve_resumable(op, b, resume=True)
    with pytest.raises(ValueError, match="requires checkpoint_path"):
        ckpt.cg_solve_ir_resumable(op.as_f32(), op, b, resume=True)
    other = DenseOperator.from_dense(a, precision="df64", engine="xla",
                                     device="cpu")
    with pytest.raises(ValueError, match="VIEW of the accurate operator"):
        ckpt.cg_solve_ir_resumable(other.as_f32(), op, b)
    with pytest.raises(ValueError, match="unknown preconditioner"):
        ckpt.cg_solve_resumable(op, b, preconditioner="ssor")
    with pytest.raises(ValueError, match="segment must be a positive"):
        ckpt.cg_solve_resumable(op, b, segment=0)
    seen = []
    res, segs = ckpt.cg_solve_resumable(
        op, b, max_iters=25, segment=10,
        on_segment=lambda state, dt: seen.append(int(state.k)))
    assert seen == [10, 20, 25] and int(res.num_iters) == 25
    assert not bool(res.converged)


# -- the CLI ----------------------------------------------------------------


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tcli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ck_cli")
    a, b = gen.random_spd_system(300, seed=53)
    tio.write_matrix(d / "A.bin", a)
    tio.write_matrix(d / "b.bin", b)
    return a, b, str(d / "A.bin"), str(d / "b.bin"), d


@pytest.mark.parametrize("precision", ["df64", "f64", "ir", "irfq"])
def test_cli_checkpoint_then_resume(files, precision):
    """-i 20 --checkpoint (CSV num_iter 21 for a CG precision; ir stops
    at its limit inside a cycle), then --resume: the CSV of a plain solve
    and the x of the uninterrupted checkpointed run."""
    a, b, a_path, b_path, d = files
    ck = str(d / f"ck-{precision}")
    common = ["-A", a_path, "-b", b_path, "--precision", precision,
              "--device", "cpu"]
    whole = common + ["--checkpoint", str(d / f"whole-{precision}"), "-o",
                      str(d / f"w-{precision}.bin")]
    rc, out, _ = _run(whole)
    assert rc == 0
    row = out.strip().split(",")
    assert len(row) == 9 and row[0] == "300" and float(row[7]) < 1e-9
    if precision in ("df64", "f64"):
        rc, out, _ = _run(common + ["--checkpoint", ck, "-i", "20",
                                    "--checkpoint-every", "7", "-o",
                                    str(d / "p.bin")])
        assert rc == 0 and out.strip().split(",")[6] == "21"
        rc, out, _ = _run(common + ["--checkpoint", ck, "--resume", "-o",
                                    str(d / f"r-{precision}.bin")])
        assert rc == 0 and out.strip().split(",")[6] == row[6]
        np.testing.assert_array_equal(
            tio.read_vector(str(d / f"r-{precision}.bin")),
            tio.read_vector(str(d / f"w-{precision}.bin")))
        names = ["p.bin", "r.bin", "state.json", "x.bin"]
    else:
        names = ["ir_state.json", "r.bin", "x.bin"]
    assert sorted(os.listdir(d / f"whole-{precision}")) == names
    assert _true_rel(a, b, tio.read_vector(str(d / f"w-{precision}.bin"))) \
        < 1e-8


def test_cli_checkpoint_refusals(files):
    _, _, a_path, b_path, d = files
    for extra, words in ((["--resume"], "--resume needs --checkpoint"),
                         (["--checkpoint", str(d / "h"), "--precision",
                           "irfq", "--outer", "host"], "--outer host")):
        rc, out, err = _run(["-A", a_path, "-b", b_path, "--device", "cpu",
                             "-o", str(d / "no.bin")] + extra)
        assert rc == 1 and not out and words in err
        assert err.startswith("lam-cg: ") and len(err.splitlines()) == 1
    assert not os.path.exists(d / "no.bin") and not os.path.exists(d / "h")
    rc, _, err = _run(["-A", a_path, "-b", b_path, "--device", "cpu",
                       "--checkpoint", str(d / "missing"), "--resume"])
    assert rc == 1 and "state.json" in err and len(err.splitlines()) == 1
    rc, _, err = _run(["-A", a_path, "-b", b_path, "--device", "cpu",
                       "--checkpoint", str(d / "z"), "--checkpoint-every",
                       "0"])
    assert rc == 1 and "segment must be a positive" in err


def test_cli_resumes_a_lam_tpu_checkpoint(files):
    """lam_tpu's lam-cg writes the checkpoint (-i 30, f64/xla, its CPU
    defaults on one device), the port's CLI resumes it."""
    from lam_tpu import cli as jcli
    a, b, a_path, b_path, d = files
    ck = str(d / "from-lam")
    with contextlib.redirect_stdout(io.StringIO()):
        assert jcli.main(["-A", a_path, "-b", b_path, "--backend", "local",
                          "--checkpoint", ck, "-i", "30", "-o",
                          str(d / "j.bin")]) == 0
    rc, out, _ = _run(["-A", a_path, "-b", b_path, "--device", "cpu",
                       "--precision", "f64", "--checkpoint", ck, "--resume",
                       "-o", str(d / "t.bin")])
    assert rc == 0 and float(out.strip().split(",")[7]) < 1e-9
    assert _true_rel(a, b, tio.read_vector(str(d / "t.bin"))) < 1e-8
