"""The port's 1-D sharded backends (lam_tpu_torch/parallel) against
lam_tpu's, on the CPU.

Kernels, at tb=128 and n <= 1024: the plain column-block matvecs and slab
walks against lam_tpu's Pallas kernels in interpret mode (the f32 ones to
1e-6; the df64 ones to 1e-6 only, since XLA:CPU defeats their in-kernel
compensation) and against an f64 numpy oracle (1e-13), for every rank's
walk tables of g = 1, 2, 3 ranks. Storage: the walk tables and every
rank's slab, packed and row-block buffers byte-equal to lam_tpu's shards on
the conftest's 8-device virtual mesh, built here rank by rank without a
process group; the ranks' parts summed equal the port's one-device plain
matvecs.

Solves run in gloo CPU clusters of 2 and 4 rank processes
(tests/torch_sharded_worker.py), one launch per rank count, each running
the whole job list; the tests assert on the records. Against lam_tpu's
sharded solves on a virtual mesh of as many devices (f64 engine 'xla' for
df64, its 'ir' for ir, f32 'xla' for f32): df64 iterations within 2 of
lam_tpu's sharded count or of its one-device f64 count (the two part by 3
at G=4 on this system), ir within 2%, f32 (to 1e-5) within 2%, x within 1e-6 (f32: 1e-3) of lam_tpu's
and identical on every rank, TRUE residual <= 1e-8 (f32: 1e-4).
"""

import contextlib
import io
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import lam_tpu
from lam_tpu import generate as jgen
from lam_tpu.ops import gemv as jgemv
from lam_tpu.parallel import pcg_symm as jpcg_symm
from lam_tpu.parallel.mesh import make_mesh as jmake_mesh
from lam_tpu.parallel.pcg import ShardedDenseOperator as JDense
from lam_tpu_torch import ConjugateGradient, DenseOperator, cg_solve_ir
from lam_tpu_torch import cli as tcli
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import gemv
from lam_tpu_torch.parallel import mesh as pmesh
from lam_tpu_torch.parallel import pcg, pcg_symm
from lam_tpu_torch.precision import split_f64_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_sharded_worker.py")
N, SEED = 500, 41
TB = 128
RANKS = (2, 4)
CLUSTER_TIMEOUT_S = 240
DENSE_PRECISIONS = ("f32", "df64", "ir")
F32_REL_ERROR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _symmetric(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, size=(n, n))
    return m + m.T


def _pair(p):
    return tuple(torch.from_numpy(x) for x in split_f64_host(p))


def _rank_op(cls, a, c, g, **kw):
    """Rank c's operator of a g-rank mesh, built without a process group."""
    return cls.from_dense(a, mesh=pmesh.Mesh(c, g, "cpu"), device="cpu",
                          **kw)


def _shards(arr):
    """The per-device pieces of a lam_tpu row-sharded array, in row order."""
    return [np.asarray(s.data) for s in
            sorted(arr.addressable_shards, key=lambda s: s.index[0].start
                   or 0)]


# -- kernels ---------------------------------------------------------------


@pytest.mark.parametrize("blk", range(4))
def test_gemv_f32_cols_plain_matches_lam_tpu(blk):
    rng = np.random.default_rng(blk)
    a = rng.uniform(-1, 1, size=(256, 512)).astype(np.float32)
    p = rng.uniform(-1, 1, size=128).astype(np.float32)
    y = gemv.gemv_f32_cols(torch.from_numpy(a), torch.from_numpy(p), blk)
    ref = np.asarray(jgemv.gemv_f32_cols(a, p, blk))
    assert _rel(y, ref) <= 1e-6
    assert _rel(y, a[:, blk * 128:(blk + 1) * 128].astype(np.float64)
                @ p.astype(np.float64)) <= 1e-6


@pytest.mark.parametrize("blk", range(4))
def test_gemv_df64_cols_plain_matches_f64(blk):
    rng = np.random.default_rng(10 + blk)
    a = rng.uniform(-1, 1, size=(256, 512))
    p = rng.uniform(-1, 1, size=128)
    (ah, al), (ph, pl) = split_f64_host(a), split_f64_host(p)
    yh, yl = gemv.gemv_df64_cols(*(torch.from_numpy(x)
                                   for x in (ah, al, ph, pl)), blk)
    y = yh.double().numpy() + yl.double().numpy()
    cols = slice(blk * 128, (blk + 1) * 128)
    oracle = ((ah[:, cols].astype(np.float64) + al[:, cols])
              @ (ph.astype(np.float64) + pl))
    assert _rel(y, oracle) <= 1e-13
    rh, rl = jgemv.gemv_df64_cols(ah, al, ph, pl, blk)
    assert _rel(y, np.asarray(rh, np.float64) + np.asarray(rl)) <= 1e-6


def test_cols_rejects_a_block_outside_the_row():
    a, p = torch.zeros(128, 256), torch.zeros(128)
    with pytest.raises(ValueError, match="block index"):
        gemv.gemv_f32_cols(a, p, 2)
    with pytest.raises(ValueError, match="not divisible"):
        gemv.gemv_f32_cols(torch.zeros(128, 384), torch.zeros(256), 0)


def _walk_oracle(tiles, p, it, kt, lt, ms):
    """f64 numpy walk: (yd (ms,), yt (n,)) of tiles (T, tb, tb)."""
    tb = tiles.shape[1]
    yd, yt = np.zeros(ms), np.zeros(p.shape[0])
    for t, (i, k, l) in enumerate(zip(it, kt, lt)):
        yd[l * tb:(l + 1) * tb] += tiles[t] @ p[k * tb:(k + 1) * tb]
        if k < i:
            yt[k * tb:(k + 1) * tb] += tiles[t].T @ p[i * tb:(i + 1) * tb]
    return yd, yt


SLAB_CASES = [(g, mt, packed) for g, mt in ((1, 2), (2, 2), (3, 1))
              for packed in (False, True)]


def _slab_ranks(g, mt, packed, seed):
    """(a, p, [(operand, tiles f64) of each rank]) of a g-rank band-pair
    geometry with mt tile-rows per band, built by the port rank by rank."""
    n = 2 * g * mt * TB
    a, p = _symmetric(n, seed), np.random.default_rng(seed).uniform(-1, 1, n)
    out = []
    for c in range(g):
        op = _rank_op(pcg_symm.SymmShardedOperator, a, c, g, tb=TB,
                      packed=packed)
        hi, lo, it, kt, lt = (x.numpy() for x in op.operand)
        if packed:
            tiles = (hi.astype(np.float64) + lo).reshape(-1, TB, TB)
        else:
            s = (hi.astype(np.float64) + lo)
            tiles = np.stack([s[l * TB:(l + 1) * TB, k * TB:(k + 1) * TB]
                              for k, l in zip(kt, lt)])
        out.append((op, tiles))
    return a, p, out


@pytest.mark.parametrize("g,mt,packed", SLAB_CASES)
def test_gemv_f32_symm_slab_plain_matches_lam_tpu(g, mt, packed):
    a, p, ranks = _slab_ranks(g, mt, packed, seed=g * 10 + mt)
    p32 = p.astype(np.float32)
    for op, _ in ranks:
        hi, _, it, kt, lt = op.operand
        ms = 2 * op.m
        yd, yt = gemv.gemv_f32_symm_slab(hi, torch.from_numpy(p32), it, kt,
                                         lt, ms=ms, packed=packed, tb=TB)
        rd, rt = jgemv.gemv_f32_symm_slab(hi.numpy(), p32, it.numpy(),
                                          kt.numpy(), lt.numpy(), tb=TB,
                                          packed=packed,
                                          ms=ms if packed else None)
        assert _rel(yd, np.asarray(rd)) <= 1e-6
        rt = np.asarray(rt)
        assert (_rel(yt, rt) <= 1e-6) if np.any(rt) else not torch.any(yt)


@pytest.mark.parametrize("g,mt,packed", SLAB_CASES)
def test_gemv_df64_symm_slab_plain_matches_f64(g, mt, packed):
    a, p, ranks = _slab_ranks(g, mt, packed, seed=g * 10 + mt + 5)
    ph, pl = _pair(p)
    for op, tiles in ranks:
        hi, lo, it, kt, lt = op.operand
        ms = 2 * op.m
        ydh, ydl, yth, ytl = gemv.gemv_df64_symm_slab(
            hi, lo, ph, pl, it, kt, lt, ms=ms, packed=packed, tb=TB)
        yd = ydh.double().numpy() + ydl.numpy()
        yt = yth.double().numpy() + ytl.numpy()
        od, ot = _walk_oracle(tiles, ph.double().numpy() + pl.numpy(),
                              it.numpy(), kt.numpy(), lt.numpy(), ms)
        assert _rel(yd, od) <= 1e-13
        assert (_rel(yt, ot) <= 1e-13) if np.any(ot) else not np.any(yt)
        # lam_tpu's interpret-mode compensation is defeated by XLA:CPU
        r = jgemv.gemv_df64_symm_slab(
            hi.numpy(), lo.numpy(), ph.numpy(), pl.numpy(), it.numpy(),
            kt.numpy(), lt.numpy(), tb=TB, packed=packed,
            ms=ms if packed else None)
        assert _rel(yd, np.asarray(r[0], np.float64) + r[1]) <= 1e-6
        if np.any(ot):
            assert _rel(yt, np.asarray(r[2], np.float64) + r[3]) <= 1e-6


def test_df64_slab_refuses_the_broadcast_lo_tile():
    op = _rank_op(pcg_symm.SymmShardedOperator, _symmetric(512, 3), 0, 2,
                  tb=TB, packed=True)
    hi, lo, it, kt, lt = op.operand
    p = torch.zeros(512)
    with pytest.raises(NotImplementedError, match="broadcast"):
        gemv.gemv_df64_symm_slab(hi, lo[:TB], p, p, it, kt, lt, ms=2 * op.m,
                                 packed=True)


# -- storage ---------------------------------------------------------------


@pytest.mark.parametrize("g,mt,tb", [(1, 1, 128), (2, 2, 128), (3, 1, 256),
                                     (4, 3, 512)])
def test_band_tables_equal_lam_tpu(g, mt, tb):
    mine, ref = pcg_symm._band_tables(g, mt, tb), \
        jpcg_symm._band_tables(g, mt, tb)
    for x, y in zip(mine, ref):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_band_shards_byte_equal_lam_tpu(g, packed):
    a = _symmetric(700, g)
    ref = jpcg_symm.SymmShardedOperator.from_dense(
        a, mesh=jmake_mesh(g), tb=TB, packed=packed)
    ref_shards = [_shards(x) for x in ref.operand]
    for c in range(g):
        op = _rank_op(pcg_symm.SymmShardedOperator, a, c, g, tb=TB,
                      packed=packed)
        assert op.n_padded == ref.n_padded
        for mine, shards in zip(op.operand, ref_shards):
            want = shards[c].reshape(mine.shape)  # tables: (1, T) shards
            assert mine.numpy().dtype == want.dtype
            assert np.array_equal(mine.numpy(), want)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_row_shards_byte_equal_lam_tpu(g):
    a = jgen.random_spd_matrix(700, seed=g)
    ref = JDense.from_dense(a, mesh=jmake_mesh(g), precision="df64",
                            engine="pallas")
    for c in range(g):
        op = _rank_op(pcg.ShardedDenseOperator, a, c, g, precision="df64")
        assert (op.n_padded, op.m) == (ref.n_padded, ref.n_padded // g)
        for mine, plane in zip(op.operand, ref.operand):
            assert np.array_equal(mine.numpy(), _shards(plane)[c])


@pytest.mark.parametrize("g", [1, 2, 4])
def test_ring_parts_sum_to_the_one_device_matvec(g):
    a = _symmetric(900, g)
    rng = np.random.default_rng(g)
    ops_ = [_rank_op(pcg.ShardedDenseOperator, a, c, g, precision="df64")
            for c in range(g)]
    n_p, m = ops_[0].n_padded, ops_[0].m
    p = np.zeros(n_p)
    p[:900] = rng.uniform(-1, 1, 900)
    ph, pl = _pair(p)
    y32, y64 = [], []
    for c, op in enumerate(ops_):
        hi, lo = op.operand
        acc32, acc64 = torch.zeros(m), torch.zeros(m, dtype=torch.float64)
        for s in range(g):  # the ring's order: own block first
            blk = (c + s) % g
            cols = slice(blk * m, (blk + 1) * m)
            acc32 += gemv.gemv_f32_cols(hi, ph[cols], blk)
            acc64 += sum(x.double() for x in gemv.gemv_df64_cols(
                hi, lo, ph[cols], pl[cols], blk))
        y32.append(acc32)
        y64.append(acc64)
    hi_sq = torch.cat([op.operand[0] for op in ops_])
    lo_sq = torch.cat([op.operand[1] for op in ops_])
    assert _rel(torch.cat(y32), gemv.gemv_f32(hi_sq, ph)) <= 1e-6
    one = gemv.gemv_df64(hi_sq, lo_sq, ph, pl)
    assert _rel(torch.cat(y64), one[0].double() + one[1].double()) <= 1e-13
    a_p = np.zeros((n_p, n_p))
    a_p[:900, :900] = a
    assert _rel(torch.cat(y64), a_p @ p) <= 1e-13


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("g", [1, 2, 3, 4])
def test_band_parts_sum_to_the_one_device_matvec(g, packed):
    n = 900
    a = _symmetric(n, 30 + g)
    ops_ = [_rank_op(pcg_symm.SymmShardedOperator, a, c, g, tb=TB,
                     packed=packed) for c in range(g)]
    n_p, m = ops_[0].n_padded, ops_[0].m
    p = np.zeros(n_p)
    p[:n] = np.random.default_rng(g).uniform(-1, 1, n)
    ph, pl = _pair(p)
    y32 = torch.zeros(n_p)
    y64 = torch.zeros(n_p, dtype=torch.float64)
    for c, op in enumerate(ops_):
        hi, lo, it, kt, lt = op.operand
        yd, yt = gemv.gemv_f32_symm_slab(hi, ph, it, kt, lt, ms=2 * m,
                                         packed=packed, tb=TB)
        y32 += pcg_symm._scatter_bands(yd, yt, c, g, m)
        ydh, ydl, yth, ytl = gemv.gemv_df64_symm_slab(
            hi, lo, ph, pl, it, kt, lt, ms=2 * m, packed=packed, tb=TB)
        y64 += pcg_symm._scatter_bands(ydh.double() + ydl.double(),
                                       yth.double() + ytl.double(), c, g, m)
    # the whole triangle, packed for the one-device kernels at n_p
    one = DenseOperator.from_dense(a, precision="df64", device="cpu")
    n1 = one.n_padded  # <= n_p for every g here
    assert _rel(y32[:n1], gemv.gemv_f32_symm_plain(one.operand[0],
                                                   ph[:n1])) <= 1e-6
    yh, yl = gemv.gemv_df64_symm_plain(*one.operand, ph[:n1], pl[:n1])
    assert _rel(y64[:n1], yh.double() + yl.double()) <= 1e-13
    a_p = np.zeros((n_p, n_p))
    a_p[:n, :n] = a
    assert _rel(y64, a_p @ p) <= 1e-13
    assert not torch.any(y32[n:]) and not torch.any(y64[n:])


def test_scatter_bands_is_the_dual_of_own_rows():
    g, m = 3, 4
    v = torch.arange(2 * g * m, dtype=torch.float64)
    total = torch.zeros_like(v)
    for c in range(g):
        own = pcg_symm._own_rows(v, c, g, m)
        total += pcg_symm._scatter_bands(own, torch.zeros_like(v), c, g, m)
    assert torch.equal(total, v)


# -- one rank, no process group --------------------------------------------


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    # the benchmark's generator (eigenvalues exp(3.5 U(-1, 1))) at n=500
    a = jgen.random_spd_matrix_fast(N, seed=SEED)
    b = jgen.random_rhs(N, seed=SEED + 10)
    d = tmp_path_factory.mktemp("sharded_system")
    tio.write_matrix(d / "A.bin", a)
    tio.write_matrix(d / "b.bin", b)
    return a, b, str(d / "A.bin"), str(d / "b.bin")


def _true_rel(a, b, x):
    return np.linalg.norm(b - a @ x) / np.linalg.norm(b)


@pytest.mark.parametrize("engine,comm", [("auto", "gather"),
                                         ("pallas", "ring"),
                                         ("pallas_symm", "gather"),
                                         ("pallas_symm_packed", "gather")])
def test_one_rank_sharded_solve(system, engine, comm, capsys):
    """A mesh of one rank (no process group): every collective is the
    identity and the ring falls back to gather."""
    a, b, a_path, b_path = system
    cg = ConjugateGradient(backend="sharded", precision="ir", engine=engine,
                           comm=comm, device="cpu", pack_cache=True)
    assert cg.mesh.size == 1 and cg.mesh.backend is None
    assert cg.used_devices() == 1 and cg.rank == 0
    cg.load_matrix_from_file(a_path)
    assert "--pack-cache only accelerates" in capsys.readouterr().err
    cg.load_rhs_from_file(b_path)
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    assert _true_rel(a, b, cg.x) <= 1e-8
    assert cg.measure_gemv(repeats=2) > 0


# -- rank processes --------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(g, jobs, out):
    """Run the jobs in a gloo CPU cluster of g worker processes; returns
    each rank's records. Every rank is killed at the timeout."""
    os.makedirs(out, exist_ok=True)
    jobs_path = os.path.join(out, "jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(g), "--process-id", str(r), "--device",
         "cpu", "--jobs", jobs_path, "--out", out], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(g)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=CLUSTER_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    codes = [proc.returncode for proc in procs]
    assert not any(codes), f"exit codes {codes}:\n" + "\n".join(logs)
    records = []
    for r in range(g):
        with open(os.path.join(out, f"results.r{r}.json")) as f:
            records.append({rec["name"]: rec for rec in json.load(f)})
    return records


def _jobs(g, a_path, b_path, p_path, out):
    jobs = []
    for comm in ("gather", "ring"):
        for precision in DENSE_PRECISIONS:
            jobs.append({"kind": "solve", "name": f"dense-{comm}-{precision}",
                         "op": "dense", "precision": precision,
                         "comm": comm, "matrix": a_path, "rhs": b_path,
                         "rel_error": (F32_REL_ERROR if precision == "f32"
                                       else 1e-9)})
        jobs.append({"kind": "matvec", "name": f"mv-dense-{comm}",
                     "op": "dense", "precision": "df64", "comm": comm,
                     "matrix": a_path, "p": p_path})
    for packed in (False, True):
        storage = "packed" if packed else "slab"
        for precision in ("df64", "ir"):
            jobs.append({"kind": "solve", "name": f"{storage}-{precision}",
                         "op": "symm", "precision": precision,
                         "packed": packed, "tb": TB, "matrix": a_path,
                         "rhs": b_path, "rel_error": 1e-9})
        jobs.append({"kind": "matvec", "name": f"mv-{storage}",
                     "op": "symm", "precision": "df64", "packed": packed,
                     "tb": TB, "matrix": a_path, "p": p_path})
    if g == 2:
        jobs.append({"kind": "cli", "name": "cli-ir", "argv": [
            "-A", a_path, "-b", b_path, "-o", os.path.join(out, "x_cli.bin"),
            "--backend", "sharded", "--precision", "ir", "--comm", "ring"]})
    return jobs


@pytest.fixture(scope="module")
def clusters(system, tmp_path_factory):
    """{g: (records of each rank, output directory)} of one cluster launch
    per rank count."""
    a, b, a_path, b_path = system
    d = tmp_path_factory.mktemp("clusters")
    p_path = str(d / "p.npy")
    np.save(p_path, np.random.default_rng(5).uniform(-1, 1, N))
    out = {}
    for g in RANKS:
        run_dir = str(d / f"g{g}")
        out[g] = (_launch(g, _jobs(g, a_path, b_path, p_path, run_dir),
                          run_dir), run_dir)
    return out


@pytest.fixture(scope="module")
def lam_ref(system):
    """lam_tpu's sharded solves on virtual meshes of 2 and 4 devices, and
    its one-device f64 solve (g=1): {(g, kind): (iterations, x)}."""
    a, b = system[:2]
    out = {(1, "df64"): lam_tpu.cg_solve(
        lam_tpu.DenseOperator.from_dense(a, precision="f64"), b,
        max_iters=10000, rel_error=1e-9)}
    for g in RANKS:
        mesh = jmake_mesh(g)
        f64 = JDense.from_dense(a, mesh=mesh, precision="f64", engine="xla")
        res = lam_tpu.cg_solve(f64, b, max_iters=10000, rel_error=1e-9)
        out[g, "df64"] = res
        df64 = JDense.from_dense(a, mesh=mesh, precision="df64",
                                 engine="xla")
        out[g, "ir"] = lam_tpu.cg_solve_ir(df64.as_f32(), df64, b,
                                           max_iters=10000, rel_error=1e-9)
        f32 = JDense.from_dense(a, mesh=mesh, precision="f32", engine="xla")
        out[g, "f32"] = lam_tpu.cg_solve(f32, b, max_iters=10000,
                                         rel_error=F32_REL_ERROR)
        symm = jpcg_symm.SymmShardedOperator.from_dense(a, mesh=mesh, tb=TB)
        out[g, "symm-df64"] = lam_tpu.cg_solve(symm, b, max_iters=10000,
                                               rel_error=1e-9)
        out[g, "symm-ir"] = lam_tpu.cg_solve_ir(symm.as_f32(), symm, b,
                                                max_iters=10000,
                                                rel_error=1e-9)
    for key, res in out.items():
        assert bool(res.converged), key
    return {k: (int(r.num_iters), np.asarray(r.x)) for k, r in out.items()}


def _rank_xs(run_dir, name, g):
    return [np.load(os.path.join(run_dir, f"{name}.r{r}.npy"))
            for r in range(g)]


def _check_solve(system, clusters, lam_ref, g, name, ref_key, precision,
                 kernels):
    a, b = system[:2]
    records, run_dir = clusters[g]
    recs = [rank[name] for rank in records]
    ref_iters, ref_x = lam_ref[g, ref_key]
    xs = _rank_xs(run_dir, name, g)
    for rec, x in zip(recs, xs):
        assert rec["converged"] and rec["size"] == g
        assert rec["backend"] == "gloo" and rec["device"] == "cpu"
        assert rec["iters"] == recs[0]["iters"]
        assert np.array_equal(x, xs[0])  # every rank holds the same x
        for k in kernels:  # every rank walked its own part
            assert rec["counts"][k + "_plain"] > 0, (k, rec["counts"])
    iters = recs[0]["iters"]
    if precision == "df64":
        # lam_tpu's own f64 counts part by 3 between one device and G=4
        # here: within 2 of either
        one = lam_ref[1, "df64"][0]
        assert min(abs(iters - ref_iters), abs(iters - one)) <= 2, \
            (iters, ref_iters, one)
    else:
        assert abs(iters - ref_iters) <= math.ceil(0.02 * ref_iters), \
            (iters, ref_iters)
    if precision == "f32":
        assert _rel(xs[0], ref_x) <= 1e-3
        assert _true_rel(a, b, xs[0]) <= 1e-4
    else:
        assert _rel(xs[0], ref_x) <= 1e-6
        assert _true_rel(a, b, xs[0]) <= 1e-8


_DENSE_KERNELS = {"gather": {"f32": ["gemv_f32"], "df64": ["gemv_df64"],
                             "ir": ["gemv_f32", "gemv_df64"]},
                  "ring": {"f32": ["gemv_f32_cols"],
                           "df64": ["gemv_df64_cols"],
                           "ir": ["gemv_f32_cols", "gemv_df64_cols"]}}


@pytest.mark.parametrize("precision", DENSE_PRECISIONS)
@pytest.mark.parametrize("comm", ["gather", "ring"])
@pytest.mark.parametrize("g", RANKS)
def test_row_sharded_solve_matches_lam_tpu(system, clusters, lam_ref, g,
                                           comm, precision):
    _check_solve(system, clusters, lam_ref, g, f"dense-{comm}-{precision}",
                 precision, precision, _DENSE_KERNELS[comm][precision])


@pytest.mark.parametrize("precision", ["df64", "ir"])
@pytest.mark.parametrize("storage", ["slab", "packed"])
@pytest.mark.parametrize("g", RANKS)
def test_band_pair_solve_matches_lam_tpu(system, clusters, lam_ref, g,
                                         storage, precision):
    kernels = ["gemv_df64_symm_slab"] + (
        ["gemv_f32_symm_slab"] if precision == "ir" else [])
    _check_solve(system, clusters, lam_ref, g, f"{storage}-{precision}",
                 f"symm-{precision}", precision, kernels)


@pytest.mark.parametrize("name", ["mv-dense-gather", "mv-dense-ring",
                                  "mv-slab", "mv-packed"])
@pytest.mark.parametrize("g", RANKS)
def test_sharded_matvec_matches_f64(system, clusters, g, name):
    a = system[0]
    p = np.random.default_rng(5).uniform(-1, 1, N)
    for y in _rank_xs(clusters[g][1], name, g):
        assert _rel(y, a @ p) <= 1e-13


def test_cli_across_two_ranks(system, clusters):
    a, b, a_path, b_path = system
    records, run_dir = clusters[2]
    recs = [rank["cli-ir"] for rank in records]
    assert [rec["rc"] for rec in recs] == [0, 0]
    lines = recs[0]["stdout"].strip().splitlines()
    assert len(lines) == 1 and not recs[1]["stdout"].strip()
    fields = lines[0].split(",")
    assert (int(fields[0]), int(fields[1])) == (N, 2)
    x = tio.read_vector(os.path.join(run_dir, "x_cli.bin"))
    local = DenseOperator.from_dense(a, precision="df64", device="cpu")
    x_local = cg_solve_ir(local.as_f32(), local, b, max_iters=10000,
                          rel_error=1e-9).x.numpy()
    assert _rel(x, x_local) <= 1e-6
    for rec in recs:  # both ranks walked their column blocks
        assert rec["counts"]["gemv_f32_cols_plain"] > 0


# -- what the backends refuse ----------------------------------------------


def test_sharded_configurations_refused():
    with pytest.raises(ValueError, match="supports precision df64/ir"):
        ConjugateGradient(backend="sharded", precision="f32",
                          engine="pallas_symm", device="cpu")
    for precision in ("dfq", "irq", "fq", "irfq"):
        with pytest.raises(NotImplementedError, match="not ported"):
            ConjugateGradient(backend="sharded", precision=precision,
                              device="cpu")
    with pytest.raises(NotImplementedError, match="xla"):
        ConjugateGradient(backend="sharded", engine="xla", device="cpu")
    with pytest.raises(ValueError, match="comm"):
        ConjugateGradient(backend="sharded", comm="tree", device="cpu")
    with pytest.raises(ValueError, match="requested 2 devices"):
        ConjugateGradient(backend="sharded", n_devices=2, device="cpu")
    with pytest.raises(NotImplementedError):
        ConjugateGradient(backend="sharded2d", device="cpu")
    if not torch.cuda.is_available():  # cuda is the default; no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            ConjugateGradient(backend="sharded")
    with pytest.raises(NotImplementedError, match="dfq"):
        pcg_symm.SymmShardedOperator.from_dense(_symmetric(256, 1),
                                                precision="dfq",
                                                device="cpu")
    with pytest.raises(ValueError, match="symmetric"):
        pcg_symm.SymmShardedOperator.from_dense(
            np.triu(_symmetric(256, 1)), device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        pcg_symm.SymmShardedOperator.from_dense(_symmetric(256, 1), tb=192,
                                                device="cpu")
    with pytest.raises(ValueError, match="f32' or 'df64"):
        pcg.ShardedDenseOperator.from_dense(_symmetric(256, 1),
                                            precision="f64", device="cpu")


def test_sharded_cli_flags_refused(capsys):
    for argv, msg in ((["--local-devices", "2"], "no counterpart"),
                      (["--num-processes", "2"], "need --coordinator"),
                      (["--process-id", "0"], "need --coordinator")):
        assert tcli.main(argv + ["--device", "cpu"]) == 1
        assert msg in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="sharded2d"):
        tcli.main(["--backend", "sharded2d", "--device", "cpu"])
    with pytest.raises(ValueError, match="outside"):
        pmesh.distributed_init("127.0.0.1:1", 2, 2, device="cpu")


def test_mesh_of_one_rank_is_the_identity():
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, None)
    x = torch.arange(4.0)
    assert mesh.all_reduce(x) is x and mesh.all_gather(x) is x
    assert mesh.ppermute_prev(x) is x
    assert float(mesh.dot(x, x)) == 14.0
    assert pmesh.choose_backend("cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="requested 3 devices"):
        pmesh.make_mesh(3, device="cpu")


def test_help_names_the_sharded_flags():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main(["-h"]) == 0
    assert "--backend local|sharded" in out.getvalue()
    assert "--coordinator" in out.getvalue()
