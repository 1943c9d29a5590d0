"""Generate mode (`-s N`) on the meshes, the port against lam_tpu, on the
CPU.

- Per-rank buffers: for G in {1, 2, 4} (the 1-D backends) and R in {1, 2}
  (the 2-D grids) and n in {300, 1000, 2100} (padding, one tile a band,
  the corner tiles), every rank's operand of the port's `from_gen_*`,
  built alone without a process group, is byte-equal to that rank's slice
  of lam_tpu's `from_gen_*` on its virtual CPU mesh: the row shards, the
  band pairs' slab, packed and fq storages, the dense grid's blocks and the
  symmetric grid's df64 and fq storages (an off-diagonal rank of the port
  holds a zero diagonal pair, where lam_tpu replicates the diagonal rank's
  over the grid row).
- The broadcast modes of kernels 9, 17, 12 and 19: their plain versions
  on a zero and a non-zero (tb, tb) tile against lam_tpu's Pallas kernels
  in interpret mode (1e-6: XLA:CPU degrades lam_tpu's float-float
  arithmetic, tests/test_torch_dual.py) and the f64 oracle of the stored
  values (1e-13), and on a zero tile bit for bit against the port's
  full-plane plain walk over a zero plane.
- Rank parts: each rank's part of a gen operator's matvec, summed by hand,
  is the one-device gen matvec and the exact tridiagonal product (1e-13;
  the f32 views 1e-6).
- Facade and CLI: `-s 600` solves in one gloo CPU cluster of 2 ranks
  (`--backend sharded`) and one of 4 (`--backend sharded2d`, R=2), shared
  by the tests through module-scoped fixtures, each run through its
  broadcast mode where it has one, against lam_tpu's facade on its virtual
  mesh: the f64 class within 2 iterations (the host f64 CG's n/2), irfq
  within 2% (it gives lam_tpu's 653 on both meshes), ir within a
  tolerance of its own on each engine, just above the gap measured
  there (IR_COUNT_TOL): on the tridiagonal the f32 recurrence follows the
  order of its f32 sums (tests/test_torch_gen.py), and at n=600 lam_tpu's
  own ir takes 336 (dense grid), 387 (row shards, gather and ring), 486
  (band pairs) and 491 (symmetric grid) iterations, a spread of x1.46
  over its engines, where the port's take 316, 443 (gather), 505 (ring),
  315 and 315. The ranks run one thread each, so the counts repeat. Every
  TRUE residual <= 2e-9; `-s 600 -i 15` prints num_iter 16 and procs = G.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_tpu import generate as jgen
from lam_tpu.ops import gemv as jgemv
from lam_tpu.parallel import pcg as jpcg
from lam_tpu.parallel import pcg2d as jpcg2d
from lam_tpu.parallel import pcg2d_symm as jsym
from lam_tpu.parallel import pcg_symm as jpcg_symm
from lam_tpu.parallel.mesh import make_mesh as jmake_mesh
from lam_tpu.solver.api import ConjugateGradient as JConjugateGradient
from lam_tpu_torch import ConjugateGradient
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.parallel import mesh as pmesh
from lam_tpu_torch.parallel import pcg, pcg2d, pcg2d_symm, pcg_symm
from lam_tpu_torch.precision import split_f64_host
from torch_sharded_worker import launch_cluster

TB = 128
SIZES = [300, 1000, 2100]
GEN_N = 600
CLUSTER_TIMEOUT_S = 300
TRUE_GATE = 2e-9
# precision -> the tolerance of its count against lam_tpu's (see above)
COUNT_TOL = {"df64": 2, "fq": 2, "irfq": 0.02}
# (backend, run) -> the relative tolerance of an ir count against lam_tpu's
# on the same engine, just above the gap measured at n=600 (port / lam_tpu
# beside each)
IR_COUNT_TOL = {("sharded", "ir"): 0.16,             # 443 / 387 = 1.145
                ("sharded", "ir-slab"): 0.37,        # 315 / 486 = 0.648
                ("sharded", "ir-ring"): 0.32,        # 505 / 387 = 1.305
                ("sharded2d", "ir"): 0.07,           # 316 / 336 = 0.940
                ("sharded2d", "ir-symgrid"): 0.37}   # 315 / 491 = 0.642


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _tridiag_mv(x):
    """The generate-mode tridiagonal times x, O(n), in f64."""
    y = 2.0 * x
    y[1:] += x[:-1]
    y[:-1] += x[1:]
    return y


def _assert_bytes(mine, want, what):
    mine = mine.numpy()
    want = np.ascontiguousarray(want)
    assert mine.dtype == want.dtype, what
    assert mine.size == want.size, what
    assert mine.tobytes() == want.tobytes(), what


# -- per-rank buffers against lam_tpu's shards -----------------------------


def _rows_of(x, g, c):
    """Rank c's part of a global array sharded by rows over g ranks."""
    return np.split(np.asarray(x), g, axis=0)[c]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("g", [1, 2, 4])
def test_row_shards_byte_equal_lam_tpu(g, n):
    ref = jpcg.ShardedDenseOperator.from_gen_tridiagonal(
        n, mesh=jmake_mesh(g), engine="pallas")
    for c in range(g):
        op = pcg.ShardedDenseOperator.from_gen_tridiagonal(
            n, mesh=pmesh.Mesh(c, g, "cpu"), device="cpu")
        assert (op.n_padded, op.precision) == (ref.n_padded, "df64")
        for k, (x, w) in enumerate(zip(op.operand, ref.operand)):
            _assert_bytes(x, _rows_of(w, g, c), (c, k))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("kind", ["slab", "packed", "fq"])
def test_band_pairs_byte_equal_lam_tpu(kind, g, n):
    """Every operand entry, the walk tables too: planes, tiles and the
    slab-order diagonal by rows, the (g, T) scales and tables by row."""
    jmesh = jmake_mesh(g)
    if kind == "fq":
        ref = jpcg_symm.SymmShardedOperator.from_gen_fq(n, mesh=jmesh, tb=TB)
    else:
        ref = jpcg_symm.SymmShardedOperator.from_gen_tridiagonal(
            n, mesh=jmesh, tb=TB, packed=kind == "packed")
    for c in range(g):
        mesh = pmesh.Mesh(c, g, "cpu")
        if kind == "fq":
            op = pcg_symm.SymmShardedOperator.from_gen_fq(
                n, mesh=mesh, tb=TB, device="cpu")
        else:
            op = pcg_symm.SymmShardedOperator.from_gen_tridiagonal(
                n, mesh=mesh, tb=TB, packed=kind == "packed", device="cpu")
        assert op.storage == kind and op.n_padded == ref.n_padded
        assert len(op.operand) == len(ref.operand)
        for k, (x, w) in enumerate(zip(op.operand, ref.operand)):
            _assert_bytes(x, _rows_of(w, g, c), (c, k))
        if kind != "slab":  # one broadcast tile a rank
            assert tuple(op.operand[1].shape) == (TB, TB)


def _block_of(x, r, i, j):
    """Rank (i, j)'s block of a global array sharded over an R x R grid
    (P(ROWS, COLS)), or of a vector sharded over the grid rows."""
    x = np.asarray(x)
    if x.ndim == 1:
        return np.split(x, r)[i]
    return np.split(np.split(x, r, axis=0)[i], r, axis=1)[j]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("precision", ["df64", "f32"])
def test_dense_grid_byte_equal_lam_tpu(precision, r, n):
    ref = jpcg2d.Sharded2DOperator.from_gen_tridiagonal(
        n, mesh=jpcg2d.make_mesh2d(r), precision=precision, engine="pallas")
    want = ref.operand if precision == "df64" else (ref.operand,)
    for k in range(r * r):
        i, j = divmod(k, r)
        op = pcg2d.Sharded2DOperator.from_gen_tridiagonal(
            n, mesh=pmesh.Mesh2D(k, r, "cpu"), precision=precision,
            device="cpu")
        mine = op.operand if precision == "df64" else (op.operand,)
        assert (op.n_padded, op.precision) == (ref.n_padded, precision)
        for x, w in zip(mine, want):
            _assert_bytes(x, _block_of(w, r, i, j), (k, precision))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("storage", ["df64", "fq"])
def test_symmetric_grid_byte_equal_lam_tpu(storage, r, n):
    """The diagonal ranks' triangles with their within-rank corners, the
    cross-block corner on rank (i, i-1), one (tb, tb) tile a rank for lo
    or each of q2 and q3, the scale tables, and the diagonal pair on the
    diagonal ranks (zeros on the others)."""
    jmesh = jpcg2d.make_mesh2d(r)
    ctor = "from_gen_fq" if storage == "fq" else "from_gen_tridiagonal"
    ref = getattr(jsym.Symm2DOperator, ctor)(n, mesh=jmesh, tb=TB)
    for k in range(r * r):
        i, j = divmod(k, r)
        op = getattr(pcg2d_symm.Symm2DOperator, ctor)(
            n, mesh=pmesh.Mesh2D(k, r, "cpu"), tb=TB, device="cpu")
        assert op.storage == storage and op.n_padded == ref.n_padded
        assert len(op.operand) == len(ref.operand)
        for e, (x, w) in enumerate(zip(op.operand, ref.operand)):
            w = _block_of(w, r, i, j)
            if storage == "fq" and e >= 6 and i != j:
                assert not x.any() and x.numel() == w.size
                continue
            _assert_bytes(x, w, (k, e))
        assert tuple(op.operand[1].shape) == (TB, TB)


# -- the four broadcast modes against lam_tpu's kernels --------------------


def _symmetric(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, size=(n, n))
    return m + m.T, rng.uniform(-1, 1, size=n)


def _pair64(x):
    return np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)


@pytest.mark.parametrize("zero", [True, False])
def test_slab_broadcast_modes_match_lam_tpu(zero):
    """Kernels 9 and 17 at rank 1 of G=2 (tb=128, n=700)."""
    a, p = _symmetric(700, 5)
    mesh = pmesh.Mesh(1, 2, "cpu")
    op = pcg_symm.SymmShardedOperator.from_dense(a, mesh=mesh, tb=TB,
                                                 packed=True, device="cpu")
    fq = pcg_symm.SymmShardedOperator.from_dense(a, mesh=mesh, tb=TB,
                                                 precision="fq", device="cpu")
    hi, lo, it, kt, lt = op.operand
    ms, n_p, T = 2 * op.m, op.n_padded, it.shape[0]
    v = np.zeros(n_p)
    v[:700] = p
    ph, pl = map(_t, split_f64_host(v))
    walk = (it, kt, lt)
    tile = torch.zeros(TB, TB) if zero else lo[TB:2 * TB] * 5.0
    gemv.reset_counters()
    out = gemv.gemv_df64_symm_slab(hi, tile, ph, pl, *walk, ms=ms,
                                   packed=True)
    assert gemv.counters()["gemv_df64_symm_slab_bcast_plain"] == 1
    ref = jgemv.gemv_df64_symm_slab(*(x.numpy() for x in (hi, tile, ph, pl,
                                                          *walk)),
                                    tb=TB, packed=True, ms=ms)
    y = np.concatenate([_pair64(out[:2]), _pair64(out[2:])])
    assert _rel(y, np.concatenate([_pair64(ref[:2]), _pair64(ref[2:])])) \
        <= 1e-6
    tiles = hi.double() + tile.double().repeat(T, 1)
    oracle = torch.cat(gemv._slab_parts(tiles, ph.double() + pl.double(),
                                        *walk, ms, TB, True))
    assert _rel(y, oracle) <= 1e-13
    if zero:
        full = gemv.gemv_df64_symm_slab_plain(hi, torch.zeros_like(hi), ph,
                                              pl, *walk, ms=ms, packed=True)
        assert all(torch.equal(u, w) for u, w in zip(out, full))

    q1, q2, q3, s1, s2, s3 = fq.operand[:6]
    zt = torch.zeros(TB, TB, dtype=torch.int16)
    t2, t3 = (zt, zt) if zero else (q2[TB:2 * TB].clone(), q3[:TB].clone())
    args = (q1, t2, t3, s1, s2, s3, ph, pl, *walk)
    gemv.reset_counters()
    out = gemv.gemv_fq_symm_slab(*args, ms=ms)
    assert gemv.counters()["gemv_fq_symm_slab_bcast_plain"] == 1
    ref = jgemv.gemv_fq_symm_slab(*(x.numpy() for x in args), ms=ms)
    y = np.concatenate([_pair64(out[:2]), _pair64(out[2:])])
    assert _rel(y, np.concatenate([_pair64(ref[:2]), _pair64(ref[2:])])) \
        <= 1e-6
    tiles = sum(gemv._tile_plane(q, q1).double()
                * s.double().repeat_interleave(TB)[:, None]
                for q, s in ((q1, s1), (t2, s2), (t3, s3)))
    oracle = torch.cat(gemv._slab_parts(tiles, ph.double() + pl.double(),
                                        *walk, ms, TB, True))
    assert _rel(y, oracle) <= 1e-13
    if zero:
        zp = torch.zeros_like(q1)
        full = gemv.gemv_fq_symm_slab_plain(q1, zp, zp, s1, s2, s3, ph, pl,
                                            *walk, ms=ms)
        assert all(torch.equal(u, w) for u, w in zip(out, full))


@pytest.mark.parametrize("zero", [True, False])
def test_dual_broadcast_modes_match_lam_tpu(zero):
    """Kernels 12 and 19 on a (256, 512) rectangle with 3 pad tiles."""
    from lam_tpu_torch.solver.operators import quantize_storage_tiles
    ms, n = 256, 512
    rng = np.random.default_rng(9)
    s = rng.uniform(-1, 1, (ms, n))
    buf = layout.pack_rect_host(s, TB, pad_tiles=3)
    hi, lo = map(_t, split_f64_host(buf))
    fq = [_t(x) for x in quantize_storage_tiles("fq", buf, TB)]
    vecs = [_t(x) for v in (rng.uniform(-1, 1, n), rng.uniform(-1, 1, ms))
            for x in split_f64_host(v)]
    mb, cb = ms // TB, n // TB
    nt = mb * cb

    def stored_rect(planes, scales):
        rows = nt * TB
        if scales:
            x = sum(q[:rows].double()
                    * sc[:nt].double().repeat_interleave(TB)[:, None]
                    for q, sc in zip(planes, scales))
        else:
            x = sum(q[:rows].double() for q in planes)
        return x.reshape(mb, cb, TB, TB).permute(0, 2, 1, 3).reshape(ms, n)

    def check(out, ref, stored):
        y = np.concatenate([_pair64(out[:2]), _pair64(out[2:])])
        assert _rel(y, np.concatenate([_pair64(ref[:2]),
                                       _pair64(ref[2:])])) <= 1e-6
        p64 = vecs[0].double() + vecs[1].double()
        q64 = vecs[2].double() + vecs[3].double()
        assert _rel(y, torch.cat([stored @ p64, stored.T @ q64])) <= 1e-13

    tile = torch.zeros(TB, TB) if zero else lo[:TB] * 5.0
    gemv.reset_counters()
    out = gemv.gemv_df64_dual(hi, tile, *vecs)
    assert gemv.counters()["gemv_df64_dual_bcast_plain"] == 1
    ref = jgemv.gemv_df64_dual(*(jnp.asarray(x.numpy())
                                 for x in (hi, tile, *vecs)))
    check(out, ref, stored_rect([hi, gemv._tile_plane(tile, hi)], []))
    if zero:
        full = gemv.gemv_df64_dual_plain(hi, torch.zeros_like(hi), *vecs)
        assert all(torch.equal(u, w) for u, w in zip(out, full))

    q1, q2, q3, s1, s2, s3 = fq
    zt = torch.zeros(TB, TB, dtype=torch.int16)
    t2, t3 = (zt, zt) if zero else (q2[TB:2 * TB].clone(), q3[:TB].clone())
    args = (q1, t2, t3, s1, s2, s3, *vecs)
    gemv.reset_counters()
    out = gemv.gemv_fq_dual(*args)
    assert gemv.counters()["gemv_fq_dual_bcast_plain"] == 1
    ref = jgemv.gemv_fq_dual(*(jnp.asarray(x.numpy()) for x in args))
    check(out, ref, stored_rect(
        [q1, gemv._tile_plane(t2, q1), gemv._tile_plane(t3, q1)],
        [s1, s2, s3]))
    if zero:
        zp = torch.zeros_like(q1)
        full = gemv.gemv_fq_dual_plain(q1, zp, zp, s1, s2, s3, *vecs)
        assert all(torch.equal(u, w) for u, w in zip(out, full))


# -- each rank's part of a gen matvec --------------------------------------


class _PartsMesh(pmesh.Mesh):
    """A rank whose collectives hand back their input, so its matvec is
    its own part: the band pairs' n-vector part (all-reduce), or the row
    shard's rows of A p given the whole p (all-gather)."""

    def all_reduce(self, x):
        return x

    def all_gather(self, x):
        return x


class _PartsMesh2D(pmesh.Mesh2D):
    """A dense-grid rank whose matvec is its block's product A_ij p_j."""

    def transpose(self, x):
        return x

    def all_reduce_row(self, x):
        return x


def _gen_ops(kind, size, n):
    """Every rank's operator of a gen mesh operator, built alone."""
    if kind.startswith("band"):
        def mk(c):
            mesh = _PartsMesh(c, size, "cpu")
            if kind == "band-fq":
                return pcg_symm.SymmShardedOperator.from_gen_fq(
                    n, mesh=mesh, tb=TB, device="cpu")
            return pcg_symm.SymmShardedOperator.from_gen_tridiagonal(
                n, mesh=mesh, tb=TB, packed=kind == "band-packed",
                device="cpu")
        return [mk(c) for c in range(size)]
    if kind == "rows":
        return [pcg.ShardedDenseOperator.from_gen_tridiagonal(
            n, mesh=_PartsMesh(c, size, "cpu"), device="cpu")
            for c in range(size)]
    if kind == "grid":
        return [pcg2d.Sharded2DOperator.from_gen_tridiagonal(
            n, mesh=_PartsMesh2D(k, size, "cpu"), device="cpu")
            for k in range(size * size)]
    ctor = ("from_gen_fq" if kind == "symgrid-fq"
            else "from_gen_tridiagonal")
    return [getattr(pcg2d_symm.Symm2DOperator, ctor)(
        n, mesh=pmesh.Mesh2D(k, size, "cpu"), tb=TB, device="cpu")
        for k in range(size * size)]


def _assembled(kind, ops_, p_pad):
    """A p, the ranks' parts summed by hand, over the padded length."""
    size = ops_[0].mesh.size
    if kind.startswith("band"):
        return sum(op.matvec(p_pad) for op in ops_)
    if kind == "rows":
        return torch.cat([op.matvec(p_pad) for op in ops_])
    r, m = ops_[0].mesh.r, ops_[0].m
    blk = [p_pad[(k // r) * m:(k // r + 1) * m] for k in range(size)]
    if kind == "grid":
        return torch.cat([sum(ops_[i * r + j].matvec(blk[j * r])
                              for j in range(r)) for i in range(r)])
    pairs = [op.mv_pair(op.operand, blk[k], blk[(k % r) * r + k // r])
             for k, op in enumerate(ops_)]
    return torch.cat([sum(pairs[i * r + j][0] + pairs[j * r + i][1]
                          for j in range(r)) for i in range(r)])


@pytest.mark.parametrize("kind,size", [
    ("rows", 2), ("rows", 4), ("band-slab", 2), ("band-packed", 2),
    ("band-packed", 4), ("band-fq", 2), ("band-fq", 4), ("grid", 2),
    ("symgrid", 2), ("symgrid-fq", 2)])
def test_gen_rank_parts_sum_to_the_one_device_matvec(kind, size):
    """The accurate matvec and the f32 view (the refinement's inner loop),
    assembled from the ranks' parts, against the exact product and the
    one-device gen operator's matvec; the padding rows exactly 0."""
    n = 1100
    x = np.random.default_rng(size).uniform(-1, 1, n)
    ops_ = _gen_ops(kind, size, n)
    n_p = ops_[0].n_padded
    exact = _tridiag_mv(x)
    one = ConjugateGradient(precision="fq" if "fq" in kind else "df64",
                            device="cpu")
    one.generate_matrix(n)
    y_one = one.op.matvec(one.op.prepare_b(x)).numpy()[:n]
    for view, tol in ((lambda op: op, 1e-13), (lambda op: op.as_f32(), 1e-6)):
        views = [view(op) for op in ops_]
        dtype = views[0].vector_dtype
        p_pad = torch.zeros(n_p, dtype=dtype)
        p_pad[:n] = torch.from_numpy(x).to(dtype)
        y = _assembled(kind, views, p_pad)
        assert y.shape == (n_p,) and not y[n:].any()
        assert _rel(y[:n].numpy(), exact) <= tol
        if dtype == torch.float64:
            assert _rel(y[:n].numpy(), y_one) <= 1e-13


def test_gen_constructors_refuse_what_lam_tpu_refuses():
    # engine xla: the tridiagonal rows, padded only to the ranks, with
    # plain torch products
    op = pcg.ShardedDenseOperator.from_gen_tridiagonal(
        100, mesh=pmesh.Mesh(0, 1, "cpu"), engine="xla")
    assert (op.engine, op.n_padded, op.precision) == ("xla", 100, "df64")
    p = torch.arange(100, dtype=torch.float64)
    y = op.matvec(p).numpy()
    assert np.array_equal(y, jgen.tridiagonal_matrix(100) @ p.numpy())
    with pytest.raises(ValueError, match="comm"):
        pcg.ShardedDenseOperator.from_gen_tridiagonal(
            100, mesh=pmesh.Mesh(0, 1, "cpu"), comm="tree")
    with pytest.raises(ValueError, match="power-of-two"):
        pcg_symm.SymmShardedOperator.from_gen_fq(
            100, mesh=pmesh.Mesh(0, 1, "cpu"), tb=192)
    with pytest.raises(ValueError, match="unknown precision"):
        pcg2d.Sharded2DOperator.from_gen_tridiagonal(
            100, mesh=pmesh.Mesh2D(0, 1, "cpu"), precision="fq")


# -- the facade and the CLI in gloo clusters -------------------------------

# (run, precision, CLI flags, the plain version its accurate matvec runs)
SHARDED_RUNS = [
    ("df64", "df64", [], "gemv_df64_plain"),
    ("ir", "ir", [], "gemv_df64_plain"),
    ("fq", "fq", [], "gemv_fq_symm_slab_zero_plain"),
    ("irfq", "irfq", [], "gemv_fq_symm_slab_zero_plain"),
    ("df64-packed", "df64", ["--engine", "pallas_symm_packed"],
     "gemv_df64_symm_slab_zero_plain"),
    ("ir-slab", "ir", ["--engine", "pallas_symm"],
     "gemv_df64_symm_slab_plain"),
    ("ir-ring", "ir", ["--comm", "ring"], "gemv_df64_cols_plain"),
    ("dfq", "dfq", [], "gemv_dfq_symm_slab_plain")]
GRID_RUNS = [
    ("df64", "df64", [], "gemv_df64_plain"),
    ("ir", "ir", [], "gemv_df64_plain"),
    ("fq", "fq", [], ("gemv_fq_symm_zero_plain",
                      "gemv_fq_dual_zero_plain")),
    ("irfq", "irfq", [], ("gemv_fq_symm_zero_plain",
                          "gemv_fq_dual_zero_plain")),
    ("df64-symgrid", "df64", ["--engine", "pallas_symm_packed"],
     ("gemv_df64_symm_bcast_plain", "gemv_df64_dual_zero_plain")),
    ("ir-symgrid", "ir", ["--engine", "pallas_symm"],
     ("gemv_df64_symm_bcast_plain", "gemv_df64_dual_zero_plain"))]


def _cluster_jobs(backend, runs, out):
    jobs = [{"kind": "cli", "name": run, "argv": [
        "-s", str(GEN_N), "-e", "1e-9", "-o", os.path.join(out, f"{run}.bin"),
        "--backend", backend, "--precision", precision, *flags]}
        for run, precision, flags, _ in runs]
    jobs.append({"kind": "cli", "name": "i15", "argv": [
        "-s", str(GEN_N), "-i", "15", "-o", os.path.join(out, "i15.bin"),
        "--backend", backend]})
    return jobs


@pytest.fixture(scope="module")
def sharded_cluster(tmp_path_factory):
    """The 2-rank cluster, started as mpirun starts it: the rank count and
    rank in Open MPI's variables, an explicit --coordinator."""
    out = str(tmp_path_factory.mktemp("gen_sharded"))
    return launch_cluster(2, _cluster_jobs("sharded", SHARDED_RUNS, out),
                          out, CLUSTER_TIMEOUT_S, launcher="ompi"), out


@pytest.fixture(scope="module")
def grid_cluster(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gen_grid"))
    return launch_cluster(4, _cluster_jobs("sharded2d", GRID_RUNS, out),
                          out, CLUSTER_TIMEOUT_S), out


def _lam_count(backend, size, precision, engine):
    cg = JConjugateGradient(backend=backend, precision=precision,
                            engine=engine, n_devices=size)
    cg.generate_matrix(GEN_N)
    cg.generate_rhs()
    cg.solve(max_iters=10000, rel_error=1e-9)
    return cg.timings["num_iters"]


def _check_run(records, out, run, precision, flags, plain, backend, size,
               symgrid):
    rows = [rec[run]["stdout"].strip() for rec in records]
    assert all(rec[run]["rc"] == 0 for rec in records)
    assert rows[0] and not any(rows[1:])  # rank 0 reports
    fields = rows[0].split(",")
    assert fields[:2] == [str(GEN_N), str(size)]
    k = int(fields[6])
    x = tio.read_vector(os.path.join(out, f"{run}.bin"))
    assert np.linalg.norm(1 - _tridiag_mv(x)) / np.sqrt(GEN_N) <= TRUE_GATE
    engine = flags[1] if flags[:1] == ["--engine"] else "auto"
    kj = _lam_count(backend, size, precision, engine)
    tol = (IR_COUNT_TOL[backend, run] if precision == "ir"
           else COUNT_TOL.get(precision, 2))
    assert abs(k - kj) <= (tol if tol >= 1 else tol * kj), (k, kj)
    if tol >= 1:  # the f64 class: the host f64 CG's n/2
        assert k == GEN_N // 2
    for r, rec in enumerate(records):
        # symmetric grid: the diagonal ranks' mode, then the others'
        name = plain[r not in (0, 3)] if symgrid else plain
        assert rec[run]["counts"][name] > 0, (r, name)


def test_sharded_cluster_starts_by_open_mpi(sharded_cluster):
    """Each rank took its rank and the rank count from Open MPI's
    variables and the coordinator from --coordinator, its card index from
    OMPI_COMM_WORLD_LOCAL_RANK; the CLI runs, given --coordinator alone,
    found that group."""
    records, _ = sharded_cluster
    for r, rec in enumerate(records):
        launch = rec["launch"]
        assert (launch["rank"], launch["size"], launch["device"],
                launch["backend"]) == (r, 2, "cpu", "gloo")
        assert launch["source"] == {
            "coordinator": "flags", "num_processes": "ompi",
            "process_id": "ompi", "local_id": "ompi", "card": None,
            "backend": "cpu"}
        assert all(rec[run]["rc"] == 0 for run, *_ in SHARDED_RUNS)


@pytest.mark.parametrize("run,precision,flags,plain", SHARDED_RUNS)
def test_sharded_gen_solves_match_lam_tpu(sharded_cluster, run, precision,
                                          flags, plain):
    records, out = sharded_cluster
    _check_run(records, out, run, precision, flags, plain, "sharded", 2,
               False)


@pytest.mark.parametrize("run,precision,flags,plain", GRID_RUNS)
def test_grid_gen_solves_match_lam_tpu(grid_cluster, run, precision, flags,
                                       plain):
    records, out = grid_cluster
    _check_run(records, out, run, precision, flags, plain, "sharded2d", 4,
               isinstance(plain, tuple))


@pytest.mark.parametrize("which", ["sharded", "grid"])
def test_gen_csv_of_an_unconverged_mesh_run(sharded_cluster, grid_cluster,
                                            which):
    """-s 600 -i 15: the reference's CSV, num_iter max_iters + 1, procs the
    mesh's ranks, x after 15 df64 iterations equal to lam_tpu's one-device
    solve's."""
    records, out = sharded_cluster if which == "sharded" else grid_cluster
    fields = records[0]["i15"]["stdout"].strip().split(",")
    assert len(fields) == 9
    assert fields[:3] == [str(GEN_N), "2" if which == "sharded" else "4",
                          "1"]
    assert fields[6] == "16" and float(fields[7]) > 1e-9
    cg = JConjugateGradient(backend="local", precision="f64")
    cg.generate_matrix(GEN_N)
    cg.generate_rhs()
    cg.solve(max_iters=15, rel_error=1e-9)
    x = tio.read_vector(os.path.join(out, "i15.bin"))
    assert _rel(x, np.asarray(cg.x)) <= 1e-12


@pytest.mark.parametrize("storage", ["df64", "fq"])
def test_symmetric_grid_gen_diagonal(storage):
    """diagonal() of a one-rank grid's gen operator: 2 on the real rows, 0
    on the padding, read through the broadcast lo tile or the fq pair."""
    ctor = "from_gen_fq" if storage == "fq" else "from_gen_tridiagonal"
    op = getattr(pcg2d_symm.Symm2DOperator, ctor)(
        700, mesh=pmesh.Mesh2D(0, 1, "cpu"), tb=TB, device="cpu")
    d = op.diagonal().numpy()
    assert d.shape == (op.n_padded,)
    assert (d[:700] == 2.0).all() and not d[700:].any()
