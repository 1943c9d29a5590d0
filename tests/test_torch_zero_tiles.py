"""Generate mode's zero broadcast tiles, counted when the operator is built.

Kernels 15-bcast, 9-bcast, 12-bcast, 17-bcast and 19-bcast have a kernel
of their own for broadcast tiles that hold only zeros,
`gemv_fq_symm_zero`, `gemv_fq_symm_slab_zero` and `gemv_fq_dual_zero`
(q1 alone), `gemv_df64_symm_slab_zero` and `gemv_df64_dual_zero` (hi
alone), with their own counters and plain versions (csrc/strip_walk.cuh
on the card). On the CPU:

- the operators choose it once, when they are built: generate mode's fq
  operator (one device, every rank of the symmetric grid), packed
  band-pair df64 and fq operators and the symmetric grid's off-diagonal
  df64 ranks multiply by it, as does an operator handed tiles of zeros; a
  non-zero tile, a tile beside a plane and full planes keep the
  tile-reading or full-plane kernels;
- the zero kernels' plain versions equal the tile-reading ones over zero
  tiles, and the wrappers check their operands;
- a numpy model of the kernels' sums: the dropped-term elements (e1 * c1;
  h + 0.0) against the full ones ((e1*c1 + e2*c2) + e3*c3 with e2 = e3 =
  0; h + l with l = +-0), summed as the kernels sum them (from +0.0, in
  order, direct and transpose), equal bit for bit over e1 = 0, +-0 hi
  entries, -0.0 operand entries and zero, -0.0 and negative scales, though
  the elements themselves differ in the sign of a zero; and so are the
  walks' partials summed as pass 2 sums them, over the rectangle (every
  tile both terms; the df64 pair and the fq cascade with a scale per
  tile) and over a rank's band-pair tables (scales per walk position,
  transpose terms off the diagonal only);
- the operators' matvecs and solves still match lam_tpu's: the grid's
  off-diagonal df64 and fq parts against lam_tpu's `gemv_df64_dual` and
  `gemv_fq_dual` and the band-pair fq parts against its
  `gemv_fq_symm_slab`, all in Pallas interpret mode (the port within
  2^-48 of the f64 oracle), and one short solve of each operator at
  lam_tpu's iteration count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lam_tpu
from lam_tpu.ops import gemv as jgemv
from lam_tpu.parallel import pcg2d as jpcg2d
from lam_tpu.parallel import pcg2d_symm as jsym
from lam_tpu.parallel import pcg_symm as jpcg_symm
from lam_tpu.parallel.mesh import make_mesh as jmake_mesh
from lam_tpu.solver import operators as jops
from lam_tpu_torch import DenseOperator
from lam_tpu_torch import generate as tgen
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.parallel import mesh as pmesh
from lam_tpu_torch.parallel import pcg2d_symm, pcg_symm
from lam_tpu_torch.precision import split_f64, split_f64_host
from lam_tpu_torch.solver import cg as tcg
from lam_tpu_torch.solver import operators as tops

TB = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test processes on shared cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tridiag_mv(x):
    """The generate-mode tridiagonal times x, O(n), in f64."""
    y = 2.0 * x
    y[1:] += x[:-1]
    y[:-1] += x[1:]
    return y


def _gen_q1(n, tb):
    n_p = layout.padded_size(n, tb)
    nblk = n_p // tb
    tables = (layout._symm_tables_padded if nblk >= 2
              else layout._symm_tables)  # as the facade builds it
    it, kt = (torch.from_numpy(x.astype(np.int64)) for x in tables(nblk))
    return tgen._tridiag_q1_packed_impl(n, tb, it, kt, nblk), n_p


def _band_mesh(g=1):
    return pmesh.Mesh(0, g, "cpu")


def _ran(matvec, *args):
    """The plain versions that one call of `matvec` ran, by name."""
    gemv.reset_counters()
    matvec(*args)
    return {k for k, v in gemv.counters().items() if v}


def _mv(op):
    """The plain versions one matvec of `op` runs."""
    return _ran(op.matvec, torch.zeros(op.n_padded, dtype=op.vector_dtype))


# -- the operators choose once, when built ---------------------------------

def test_gen_fq_operator_takes_the_zero_walk():
    q1, n_pq = _gen_q1(1000, layout.SYMM_TB)
    op = DenseOperator.from_gen_fq(q1, 1000, n_pq, device="cpu")
    assert _mv(op) == {"gemv_fq_symm_zero_plain"}
    assert _mv(op.as_f32()) == {"gemv_q16_symm_plain"}


@pytest.mark.parametrize("storage,plain", [
    ("packed", "gemv_df64_symm_slab_zero_plain"),
    ("slab", "gemv_df64_symm_slab_plain"),  # a zero slab, not a tile
    ("fq", "gemv_fq_symm_slab_zero_plain")])
def test_gen_band_pair_operators_walks(storage, plain):
    if storage == "fq":
        op = pcg_symm.SymmShardedOperator.from_gen_fq(
            1000, mesh=_band_mesh(), tb=TB, device="cpu")
    else:
        op = pcg_symm.SymmShardedOperator.from_gen_tridiagonal(
            1000, mesh=_band_mesh(), tb=TB, packed=storage == "packed",
            device="cpu")
    assert _mv(op) == {plain}


@pytest.mark.parametrize("rank,storage,plain", [
    (0, "fq", "gemv_fq_symm_zero_plain"),
    (3, "fq", "gemv_fq_symm_zero_plain"),
    (2, "fq", "gemv_fq_dual_zero_plain"),
    (1, "fq", "gemv_fq_dual_zero_plain"),
    (0, "df64", "gemv_df64_symm_bcast_plain"),  # kernel 2's: no zero walk
    (3, "df64", "gemv_df64_symm_bcast_plain"),
    (1, "df64", "gemv_df64_dual_zero_plain"),
    (2, "df64", "gemv_df64_dual_zero_plain")])
def test_gen_grid_ranks_walks(rank, storage, plain):
    """Rank `rank` of the R=2 symmetric grid: its part of a matvec before
    the exchanges (a diagonal rank's triangle, another's half-slab)."""
    ctor = "from_gen_fq" if storage == "fq" else "from_gen_tridiagonal"
    op = getattr(pcg2d_symm.Symm2DOperator, ctor)(
        1000, mesh=pmesh.Mesh2D(rank, 2, "cpu"), tb=TB, device="cpu")
    p = torch.zeros(op.n_padded // 2, dtype=torch.float64)
    assert _ran(op.mv_pair, op.operand, p, p) == {plain}


def _fq_bufs(n=1000):
    q1, n_pq = _gen_q1(n, layout.SYMM_TB)
    gen = DenseOperator.from_gen_fq(q1, n, n_pq, device="cpu")
    return [x.numpy() for x in gen.operand], n, n_pq


@pytest.mark.parametrize("case", ["zero", "zero-q2", "zero-q3", "plane"])
def test_fq_tiles_handed_in_are_counted_once(case):
    bufs, n, n_pq = _fq_bufs()
    tb = layout.SYMM_TB
    one = np.zeros((tb, tb), np.int16)
    one[3, 5] = 1
    q2, q3 = {"zero": (bufs[1], bufs[2]), "zero-q2": (bufs[1], one),
              "zero-q3": (one, bufs[2]),
              "plane": (np.zeros_like(bufs[0]), bufs[2])}[case]
    op = DenseOperator.from_fq_planes(bufs[0], q2, q3, *bufs[3:], n, n_pq,
                                      device="cpu")
    assert _mv(op) == {"gemv_fq_symm_zero_plain" if case == "zero"
                       else "gemv_fq_symm_bcast_plain"}


@pytest.mark.parametrize("lo", ["+0.0", "-0.0", "2^-30", "plane"])
def test_df64_tile_handed_in_is_counted_once(lo):
    """A band pair's packed hi plane with a lo handed in: a tile of
    zeros (-0.0 counts: its terms never change a sum's bits) takes the
    zero walk, any other tile or a plane the tile-reading or full walk."""
    gen = pcg_symm.SymmShardedOperator.from_gen_tridiagonal(
        1000, mesh=_band_mesh(), tb=TB, packed=True, device="cpu")
    hi, _, *tables = gen.operand
    tile = torch.zeros(TB, TB)
    if lo == "-0.0":
        tile[7, 9] = -0.0
    elif lo == "2^-30":
        tile[7, 9] = 2.0 ** -30
    elif lo == "plane":
        tile = torch.zeros_like(hi)
    op = pcg_symm.SymmShardedOperator(
        (hi, tile, *tables), 1000, gen.n_padded, gen.mesh, gen.m, TB,
        "packed")
    assert _mv(op) == {
        "+0.0": {"gemv_df64_symm_slab_zero_plain"},
        "-0.0": {"gemv_df64_symm_slab_zero_plain"},
        "2^-30": {"gemv_df64_symm_slab_bcast_plain"},
        "plane": {"gemv_df64_symm_slab_plain"}}[lo]


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("lo", ["+0.0", "-0.0", "2^-30", "plane"])
def test_grid_df64_tile_handed_in_is_counted_once(rank, lo):
    """An off-diagonal rank of the R=2 symmetric grid with a lo handed in:
    a tile of zeros takes the dual zero walk, any other tile the
    tile-reading walk, a plane the full-plane kernel; the f32 view reads
    hi alone whatever the lo."""
    mesh = pmesh.Mesh2D(rank, 2, "cpu")
    gen = pcg2d_symm.Symm2DOperator.from_gen_tridiagonal(
        1000, mesh=mesh, tb=TB, device="cpu")
    hi, _ = gen.operand
    tile = torch.zeros(TB, TB)
    if lo == "-0.0":
        tile[7, 9] = -0.0
    elif lo == "2^-30":
        tile[7, 9] = 2.0 ** -30
    elif lo == "plane":
        tile = torch.zeros_like(hi)
    p = torch.zeros(gen.n_padded // 2, dtype=torch.float64)
    for dtype, want in ((torch.float64, {
            "+0.0": "gemv_df64_dual_zero_plain",
            "-0.0": "gemv_df64_dual_zero_plain",
            "2^-30": "gemv_df64_dual_bcast_plain",
            "plane": "gemv_df64_dual_plain"}[lo]),
            (torch.float32, "gemv_f32_dual_plain")):
        op = pcg2d_symm.Symm2DOperator((hi, tile), 1000, gen.n_padded, mesh,
                                       TB, vector_dtype=dtype)
        assert _ran(op.mv_pair, op.operand, p.to(dtype), p.to(dtype)) \
            == {want}


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("case", ["zero", "zero-q2", "zero-q3", "plane"])
def test_grid_fq_tiles_handed_in_are_counted_once(rank, case):
    """An off-diagonal rank of the R=2 symmetric grid with q2 and q3
    handed in: tiles of zeros take the dual zero walk, a non-zero tile the
    tile-reading walk, planes the full-plane kernel; the f32 view reads q1
    alone whatever q2 and q3."""
    mesh = pmesh.Mesh2D(rank, 2, "cpu")
    gen = pcg2d_symm.Symm2DOperator.from_gen_fq(1000, mesh=mesh, tb=TB,
                                                device="cpu")
    q1, q2, q3, *rest = gen.operand
    one = torch.zeros(TB, TB, dtype=torch.int16)
    one[3, 5] = 1
    q2, q3 = {"zero": (q2, q3), "zero-q2": (q2, one), "zero-q3": (one, q3),
              "plane": (torch.zeros_like(q1), torch.zeros_like(q1))}[case]
    p = torch.zeros(gen.n_padded // 2, dtype=torch.float64)
    for dtype, want in ((torch.float64, {
            "zero": "gemv_fq_dual_zero_plain",
            "plane": "gemv_fq_dual_plain"}.get(
                case, "gemv_fq_dual_bcast_plain")),
            (torch.float32, "gemv_q16_dual_plain")):
        op = pcg2d_symm.Symm2DOperator((q1, q2, q3, *rest), 1000,
                                       gen.n_padded, mesh, TB, "fq",
                                       vector_dtype=dtype)
        assert _ran(op.mv_pair, op.operand, p.to(dtype), p.to(dtype)) \
            == {want}


@pytest.mark.parametrize("case", ["zero", "zero-q2", "zero-q3", "plane"])
def test_band_pair_fq_tiles_handed_in_are_counted_once(case):
    """A band pair's packed fq storage with q2 and q3 handed in: tiles of
    zeros take the slab zero walk, a non-zero tile the tile-reading walk,
    planes the full-plane kernel."""
    gen = pcg_symm.SymmShardedOperator.from_gen_fq(
        1000, mesh=_band_mesh(), tb=TB, device="cpu")
    q1, q2, q3, *rest = gen.operand
    one = torch.zeros(TB, TB, dtype=torch.int16)
    one[3, 5] = 1
    q2, q3 = {"zero": (q2, q3), "zero-q2": (q2, one), "zero-q3": (one, q3),
              "plane": (torch.zeros_like(q1), torch.zeros_like(q1))}[case]
    op = pcg_symm.SymmShardedOperator((q1, q2, q3, *rest), 1000,
                                      gen.n_padded, gen.mesh, gen.m, TB, "fq")
    assert _mv(op) == {{"zero": "gemv_fq_symm_slab_zero_plain",
                        "plane": "gemv_fq_symm_slab_plain"}.get(
                            case, "gemv_fq_symm_slab_bcast_plain")}


# -- the zero kernels' plain versions and checks ---------------------------

def _signed(rng, n):
    x = rng.uniform(-1, 1, n).astype(np.float32)
    x[rng.uniform(size=n) < 0.2] = -0.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("scales", ["gen", "odd"])
def test_fq_zero_plain_equals_the_tile_walk_over_zero_tiles(scales):
    bufs, n, n_pq = _fq_bufs()
    q1, zq, _, s1, s2, s3 = map(torch.from_numpy, bufs[:6])
    rng = np.random.default_rng(5)
    if scales == "odd":  # zero, -0.0 and negative scales in every table
        odd = np.array([0.0, -0.0, -(2.0 ** -14), 2.0 ** -20], np.float32)
        s1, s2, s3 = (torch.from_numpy(odd[rng.integers(0, 4, s.shape[0])])
                      for s in (s1, s2, s3))
    ph, pl = _signed(rng, n_pq), _signed(rng, n_pq)
    mine = gemv.gemv_fq_symm_zero(q1, s1, ph, pl)
    full = gemv.gemv_fq_symm_bcast(q1, zq, zq, s1, s2, s3, ph, pl)
    assert all(torch.equal(u, v) for u, v in zip(mine, full))


def test_df64_zero_plain_equals_the_tile_walk_over_a_zero_tile():
    gen = pcg_symm.SymmShardedOperator.from_gen_tridiagonal(
        1000, mesh=_band_mesh(2), tb=TB, packed=True, device="cpu")
    hi, lo, *walk = gen.operand
    rng = np.random.default_rng(6)
    ph, pl = _signed(rng, gen.n_padded), _signed(rng, gen.n_padded)
    mine = gemv.gemv_df64_symm_slab_zero(hi, ph, pl, *walk, ms=2 * gen.m)
    for tile in (lo, torch.full_like(lo, -0.0)):
        full = gemv.gemv_df64_symm_slab_bcast(hi, tile, ph, pl, *walk,
                                              ms=2 * gen.m)
        assert all(torch.equal(u, v) for u, v in zip(mine, full))


def test_df64_dual_zero_plain_equals_the_tile_walk_over_a_zero_tile():
    """Rank (0, 1)'s half-slab of the gen grid, -0.0 entries written into
    hi and the operands."""
    gen = pcg2d_symm.Symm2DOperator.from_gen_tridiagonal(
        1000, mesh=pmesh.Mesh2D(1, 2, "cpu"), tb=TB, device="cpu")
    hi, lo = gen.operand
    rng = np.random.default_rng(7)
    hi = hi.clone()
    hi[(hi == 0) & torch.from_numpy(rng.uniform(size=hi.shape) < 0.3)] = -0.0
    m = gen.m
    vecs = (_signed(rng, m), _signed(rng, m), _signed(rng, m // 2),
            _signed(rng, m // 2))
    mine = gemv.gemv_df64_dual_zero(hi, *vecs)
    for full in [gemv.gemv_df64_dual(hi, torch.zeros_like(hi), *vecs)] + [
            gemv.gemv_df64_dual_bcast(hi, tile, *vecs)
            for tile in (lo, torch.full_like(lo, -0.0))]:
        assert all(torch.equal(u, v) for u, v in zip(mine, full))


@pytest.mark.parametrize("scales", ["gen", "odd", "large"])
def test_fq_dual_zero_plain_equals_the_tile_walk_over_zero_tiles(scales):
    """Rank (1, 0)'s fq half-slab of the gen grid, e1 = 0 entries in q1,
    -0.0 entries in the operands and, beside generate mode's own scales,
    zero, -0.0 and negative ones, or large finite s2 and s3."""
    gen = pcg2d_symm.Symm2DOperator.from_gen_fq(
        1000, mesh=pmesh.Mesh2D(2, 2, "cpu"), tb=TB, device="cpu")
    q1, zq2, zq3, s1, s2, s3 = gen.operand[:6]
    rng = np.random.default_rng(18)
    q1 = torch.from_numpy(rng.integers(-3, 4, q1.shape).astype(np.int16))
    if scales == "odd":
        odd = np.array([0.0, -0.0, -(2.0 ** -14), 2.0 ** -20], np.float32)
        s1, s2, s3 = (torch.from_numpy(odd[rng.integers(0, 4, s.shape[0])])
                      for s in (s1, s2, s3))
    elif scales == "large":
        s2, s3 = torch.full_like(s2, 2.0 ** 100), torch.full_like(s3, -3e38)
    m = gen.m
    vecs = (_signed(rng, m), _signed(rng, m), _signed(rng, m // 2),
            _signed(rng, m // 2))
    mine = gemv.gemv_fq_dual_zero(q1, s1, *vecs)
    zp = torch.zeros_like(q1)
    for full in (gemv.gemv_fq_dual_bcast(q1, zq2, zq3, s1, s2, s3, *vecs),
                 gemv.gemv_fq_dual_bcast(q1, torch.full_like(zq2, 0), zp,
                                         s1, s2, s3, *vecs),
                 gemv.gemv_fq_dual(q1, zp, zp, s1, s2, s3, *vecs)):
        assert all(torch.equal(u, v) for u, v in zip(mine, full))


@pytest.mark.parametrize("scales", ["gen", "odd"])
def test_fq_slab_zero_plain_equals_the_tile_walk_over_zero_tiles(scales):
    gen = pcg_symm.SymmShardedOperator.from_gen_fq(
        1000, mesh=_band_mesh(2), tb=TB, device="cpu")
    q1, zq2, zq3, s1, s2, s3 = gen.operand[:6]
    walk, ms = gen.operand[-3:], 2 * gen.m
    rng = np.random.default_rng(8)
    if scales == "odd":  # zero, -0.0 and negative scales in every table
        odd = np.array([0.0, -0.0, -(2.0 ** -14), 2.0 ** -20], np.float32)
        s1, s2, s3 = (torch.from_numpy(odd[rng.integers(0, 4, s.shape[0])])
                      for s in (s1, s2, s3))
    ph, pl = _signed(rng, gen.n_padded), _signed(rng, gen.n_padded)
    mine = gemv.gemv_fq_symm_slab_zero(q1, s1, ph, pl, *walk, ms=ms)
    zp = torch.zeros_like(q1)
    for full in (gemv.gemv_fq_symm_slab_bcast(q1, zq2, zq3, s1, s2, s3, ph,
                                              pl, *walk, ms=ms),
                 gemv.gemv_fq_symm_slab(q1, zp, zp, s1, s2, s3, ph, pl,
                                        *walk, ms=ms)):
        assert all(torch.equal(u, v) for u, v in zip(mine, full))


def _zero_args():
    """Operands of the four zero-tile kernels at small n: one device's fq
    triangle, the band pairs' packed df64 and fq walks (rank 0 of G=2),
    rank (0, 1)'s half-slab of the R=2 grid."""
    bufs, _, n_pq = _fq_bufs()
    gen = pcg_symm.SymmShardedOperator.from_gen_tridiagonal(
        1000, mesh=_band_mesh(2), tb=TB, packed=True, device="cpu")
    band = pcg_symm.SymmShardedOperator.from_gen_fq(
        1000, mesh=_band_mesh(2), tb=TB, device="cpu")
    grid = pcg2d_symm.Symm2DOperator.from_gen_tridiagonal(
        1000, mesh=pmesh.Mesh2D(1, 2, "cpu"), tb=TB, device="cpu")
    return {"q1": torch.from_numpy(bufs[0]), "s1": torch.from_numpy(bufs[3]),
            "p": torch.zeros(n_pq), "hi": gen.operand[0],
            "walk": gen.operand[2:], "v": torch.zeros(gen.n_padded),
            "ms": 2 * gen.m, "bq1": band.operand[0], "bs1": band.operand[3],
            "bwalk": band.operand[-3:], "ghi": grid.operand[0],
            "gp": torch.zeros(grid.m), "gq": torch.zeros(grid.m // 2),
            "gq1": torch.zeros(grid.operand[0].shape, dtype=torch.int16),
            "gs1": torch.ones(grid.operand[0].shape[0] // TB)}


@pytest.mark.parametrize("case,match", [
    ("fq-scales", r"s1 table shape"),
    ("fq-dtype", "int16"),
    ("fq-pair", "differ"),
    ("fq-comp", "comp="),
    ("df64-dtype", "float32"),
    ("df64-pair", "differ"),
    ("df64-ms", "multiple of tb"),
    ("dual-dtype", "float32"),
    ("dual-pair", "differ"),
    ("dual-q-pair", "differ"),
    ("dual-comp", "comp="),
    ("dual-rows", "multiples of tb"),
    ("dual-tiles", "needs"),
    ("slab-scales", r"s1 table shape"),
    ("slab-dtype", "int16"),
    ("slab-pair", "differ"),
    ("slab-comp", "comp="),
    ("slab-ms", "multiple of tb"),
    ("fqdual-scales", r"s1 table shape"),
    ("fqdual-dtype", "int16"),
    ("fqdual-pair", "differ"),
    ("fqdual-q-pair", "differ"),
    ("fqdual-comp", "comp="),
    ("fqdual-rows", "multiples of tb"),
    ("fqdual-tiles", "needs")])
def test_zero_walks_check_their_operands(case, match):
    a = _zero_args()
    q1, s1, p, hi, walk, v, ms = (a[k] for k in (
        "q1", "s1", "p", "hi", "walk", "v", "ms"))
    bq1, bs1, bwalk, ghi, gp, gq, gq1, gs1 = (a[k] for k in (
        "bq1", "bs1", "bwalk", "ghi", "gp", "gq", "gq1", "gs1"))
    calls = {
        "fq-scales": lambda: gemv.gemv_fq_symm_zero(q1, s1[:3].clone(), p,
                                                    p),
        "fq-dtype": lambda: gemv.gemv_fq_symm_zero(q1.float(), s1, p, p),
        "fq-pair": lambda: gemv.gemv_fq_symm_zero(q1, s1, p, p[:-128]),
        "fq-comp": lambda: gemv.gemv_fq_symm_zero(q1, s1, p, p, comp="x"),
        "df64-dtype": lambda: gemv.gemv_df64_symm_slab_zero(
            hi.double(), v, v, *walk, ms=ms),
        "df64-pair": lambda: gemv.gemv_df64_symm_slab_zero(
            hi, v, v[:-128], *walk, ms=ms),
        "df64-ms": lambda: gemv.gemv_df64_symm_slab_zero(
            hi, v, v, *walk, ms=ms + 7),
        "dual-dtype": lambda: gemv.gemv_df64_dual_zero(ghi.double(), gp, gp,
                                                       gq, gq),
        "dual-pair": lambda: gemv.gemv_df64_dual_zero(ghi, gp, gp[:-128], gq,
                                                      gq),
        "dual-q-pair": lambda: gemv.gemv_df64_dual_zero(ghi, gp, gp, gq,
                                                        gq[:-128]),
        "dual-comp": lambda: gemv.gemv_df64_dual_zero(ghi, gp, gp, gq, gq,
                                                      comp="x"),
        "dual-rows": lambda: gemv.gemv_df64_dual_zero(ghi, gp, gp, gq[:-7],
                                                      gq[:-7]),
        "dual-tiles": lambda: gemv.gemv_df64_dual_zero(ghi, gp, gp, gp, gp),
        "slab-scales": lambda: gemv.gemv_fq_symm_slab_zero(
            bq1, bs1[:3].clone(), v, v, *bwalk, ms=ms),
        "slab-dtype": lambda: gemv.gemv_fq_symm_slab_zero(
            bq1.float(), bs1, v, v, *bwalk, ms=ms),
        "slab-pair": lambda: gemv.gemv_fq_symm_slab_zero(
            bq1, bs1, v, v[:-128], *bwalk, ms=ms),
        "slab-comp": lambda: gemv.gemv_fq_symm_slab_zero(
            bq1, bs1, v, v, *bwalk, ms=ms, comp="x"),
        "slab-ms": lambda: gemv.gemv_fq_symm_slab_zero(
            bq1, bs1, v, v, *bwalk, ms=ms + 7),
        "fqdual-scales": lambda: gemv.gemv_fq_dual_zero(
            gq1, gs1[:3].clone(), gp, gp, gq, gq),
        "fqdual-dtype": lambda: gemv.gemv_fq_dual_zero(
            gq1.float(), gs1, gp, gp, gq, gq),
        "fqdual-pair": lambda: gemv.gemv_fq_dual_zero(
            gq1, gs1, gp, gp[:-128], gq, gq),
        "fqdual-q-pair": lambda: gemv.gemv_fq_dual_zero(
            gq1, gs1, gp, gp, gq, gq[:-128]),
        "fqdual-comp": lambda: gemv.gemv_fq_dual_zero(
            gq1, gs1, gp, gp, gq, gq, comp="x"),
        "fqdual-rows": lambda: gemv.gemv_fq_dual_zero(
            gq1, gs1, gp, gp, gq[:-7], gq[:-7]),
        "fqdual-tiles": lambda: gemv.gemv_fq_dual_zero(
            gq1, gs1, gp, gp, gp, gp)}
    gemv.reset_counters()
    with pytest.raises(ValueError, match=match):
        calls[case]()
    assert not any(gemv.counters().values())


# -- the kernels' sums: a numpy model --------------------------------------

def _sums(vals, pk, pi):
    """The direct and transpose sums of one strip as the kernels take
    them: from +0.0, column by column (d += a * pk) and row by row (tacc
    += a * pi), each in f64."""
    d = np.zeros(vals.shape[0])
    for q in range(vals.shape[1]):
        d = d + vals[:, q] * pk[q]
    t = np.zeros(vals.shape[1])
    for r in range(vals.shape[0]):
        t = t + vals[r] * pi[r]
    return d, t


def _bits(x):
    return np.ascontiguousarray(x, np.float64).view(np.uint64)


def _signed_zeros(rng, shape, share=0.3):
    """Random f64 values with a share of +0.0 and -0.0 entries."""
    x = rng.uniform(-1, 1, size=shape)
    z = rng.uniform(size=shape)
    x[z < share] = 0.0
    x[z < share / 2] = -0.0
    return x


SCALES = [1.0, -1.0, 0.0, -0.0, 2.0 ** -20, -(2.0 ** -14)]


@pytest.mark.parametrize("c1", SCALES)
@pytest.mark.parametrize("c2", SCALES)
@pytest.mark.parametrize("c3", [0.0, -0.0, -(2.0 ** -30)])
def test_fq_dropped_terms_keep_the_sums_bits(c1, c2, c3):
    rng = np.random.default_rng(abs(hash((c1, c2, c3))) % 2 ** 32)
    e1 = rng.integers(-3, 4, size=(16, 24)).astype(np.float64)
    e1[rng.uniform(size=e1.shape) < 0.5] = 0.0
    e1[3] = 0.0  # a whole row of zeros: its sums are zeros
    e1[:, 5] = 0.0
    zero = np.zeros_like(e1)  # e2 = e3 = 0, converted from int16 0
    full = (e1 * c1 + zero * c2) + zero * c3
    dropped = e1 * c1
    # the elements differ at most in a zero's sign
    assert np.array_equal(full, dropped)
    pk = _signed_zeros(rng, 24)
    pi = _signed_zeros(rng, 16)
    for a, b in zip(_sums(full, pk, pi), _sums(dropped, pk, pi)):
        assert np.array_equal(_bits(a), _bits(b))
        assert not np.signbit(a[a == 0]).any()  # no sum is ever -0.0


def test_fq_model_elements_differ_in_a_zeros_sign():
    """The case the sums must absorb: e1 = 0 against a negative scale."""
    full = (0.0 * -1.0 + 0.0 * 1.0) + 0.0 * 1.0
    dropped = 0.0 * -1.0
    assert _bits(full) != _bits(dropped) and full == dropped


@pytest.mark.parametrize("lo_zero", [0.0, -0.0, "mixed"])
def test_df64_dropped_tile_keeps_the_sums_bits(lo_zero):
    rng = np.random.default_rng(9)
    h = _signed_zeros(rng, (16, 24)).astype(np.float32).astype(np.float64)
    h[2] = -0.0
    if lo_zero == "mixed":
        lo = np.where(rng.uniform(size=h.shape) < 0.5, 0.0, -0.0)
    else:
        lo = np.full(h.shape, lo_zero)
    full = h + lo
    dropped = h + 0.0
    assert np.array_equal(full, dropped)
    assert (_bits(full) != _bits(dropped)).any() or lo_zero == 0.0
    pk = _signed_zeros(rng, 24)
    pi = _signed_zeros(rng, 16)
    for a, b in zip(_sums(full, pk, pi), _sums(dropped, pk, pi)):
        assert np.array_equal(_bits(a), _bits(b))


def _summed(parts, width):
    """Pass 2's sum of partials: from +0.0, in order."""
    y = np.zeros(width)
    for x in parts:
        y = y + x
    return y


def _rect_sums(vals, p, q, mb, cb, tb):
    """(yd, yt) of a dual walk over the mb x cb tiles of `vals`: every
    tile's strip sums (`_sums`, direct and transpose: every tile of the
    rectangle has both), then its row tiles' and column tiles' partials
    summed as rect_pass2 sums them."""
    part = {(i, k): _sums(vals[i * tb:(i + 1) * tb, k * tb:(k + 1) * tb],
                          p[k * tb:(k + 1) * tb], q[i * tb:(i + 1) * tb])
            for i in range(mb) for k in range(cb)}
    yd = [_summed((part[i, k][0] for k in range(cb)), tb) for i in range(mb)]
    yt = [_summed((part[i, k][1] for i in range(mb)), tb) for k in range(cb)]
    return np.concatenate(yd), np.concatenate(yt)


@pytest.mark.parametrize("lo_zero", [0.0, -0.0, "mixed"])
def test_df64_dual_dropped_tile_keeps_the_sums_bits(lo_zero):
    """Kernel 12-bcast's zero walk: h + 0.0 against h + l over the
    rectangle's tiles, +-0 entries in hi, p and q."""
    mb, cb, tb = 2, 3, 8
    rng = np.random.default_rng(12)
    h = _signed_zeros(rng, (mb * tb, cb * tb)).astype(np.float32).astype(
        np.float64)
    h[:, 5] = -0.0  # a column of -0.0: its transpose sums are zeros
    if lo_zero == "mixed":
        lo = np.where(rng.uniform(size=h.shape) < 0.5, 0.0, -0.0)
    else:
        lo = np.full(h.shape, lo_zero)
    full, dropped = h + lo, h + 0.0
    assert np.array_equal(full, dropped)
    p = _signed_zeros(rng, cb * tb)
    q = _signed_zeros(rng, mb * tb)
    for a, b in zip(_rect_sums(full, p, q, mb, cb, tb),
                    _rect_sums(dropped, p, q, mb, cb, tb)):
        assert np.array_equal(_bits(a), _bits(b))
        assert not np.signbit(a[a == 0]).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fq_dual_dropped_terms_keep_the_sums_bits(seed):
    """Kernel 19-bcast's zero walk: e1 * c1 against (e1*c1 + 0*c2) + 0*c3
    over the rectangle's tiles, a scale of each table per tile drawn from
    zero, -0.0, negative and positive ones, +-0 entries in p and q."""
    mb, cb, tb = 2, 3, 8
    rng = np.random.default_rng(seed + 19)
    e1 = rng.integers(-3, 4, size=(mb * tb, cb * tb)).astype(np.float64)
    e1[rng.uniform(size=e1.shape) < 0.5] = 0.0
    e1[:, 5] = 0.0  # a column of zeros: its transpose sums are zeros
    pick = np.array(SCALES)
    c1, c2, c3 = (np.kron(pick[rng.integers(0, len(SCALES), (mb, cb))],
                          np.ones((tb, tb))) for _ in range(3))
    zero = np.zeros_like(e1)
    full = (e1 * c1 + zero * c2) + zero * c3
    dropped = e1 * c1
    assert np.array_equal(full, dropped)
    p = _signed_zeros(rng, cb * tb)
    q = _signed_zeros(rng, mb * tb)
    for a, b in zip(_rect_sums(full, p, q, mb, cb, tb),
                    _rect_sums(dropped, p, q, mb, cb, tb)):
        assert np.array_equal(_bits(a), _bits(b))
        assert not np.signbit(a[a == 0]).any()


def _table_sums(vals, p, it, kt, lt, mst, nblk, tb):
    """(yd, yt) of a band-pair walk over the tiles `vals` (T, tb, tb) at
    blocks (it, kt), slab row tiles lt: each tile's strip sums, the
    transpose terms only off the diagonal, then slab_pass2's sums in walk
    order."""
    part = [_sums(v, p[k * tb:(k + 1) * tb], p[i * tb:(i + 1) * tb])
            for v, i, k in zip(vals, it, kt)]
    yd = [_summed((part[t][0] for t in range(len(it)) if lt[t] == r), tb)
          for r in range(mst)]
    yt = [_summed((part[t][1] for t in range(len(it))
                   if kt[t] == c and kt[t] < it[t]), tb)
          for c in range(nblk)]
    return np.concatenate(yd), np.concatenate(yt)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fq_band_walk_dropped_terms_keep_the_sums_bits(seed):
    """Kernel 17-bcast's zero walk: e1 * c1 against (e1*c1 + 0*c2) + 0*c3
    with a scale of each table per walk position, drawn from zero, -0.0,
    negative and positive ones, on rank 0's tables of G=2 (n=2048, tb=8
    tiles of the walk)."""
    tb, nblk = 8, 8
    tables = layout._symm_tables(nblk)
    g = 2
    # rank 0 of G=2: its band pair's row tiles 0, 1 and 6, 7, as slab rows
    rows = {0: 0, 1: 1, 6: 2, 7: 3}
    walk = [(i, k) for i, k in zip(*tables) if i in rows]
    it = np.array([i for i, _ in walk])
    kt = np.array([k for _, k in walk])
    lt = np.array([rows[i] for i in it])
    rng = np.random.default_rng(seed)
    T = len(walk)
    e1 = rng.integers(-3, 4, size=(T, tb, tb)).astype(np.float64)
    e1[rng.uniform(size=e1.shape) < 0.5] = 0.0
    e1[0, 2] = 0.0
    pick = np.array(SCALES)
    c1, c2, c3 = (pick[rng.integers(0, len(SCALES), T)] for _ in range(3))
    zero = np.zeros((tb, tb))
    full = np.stack([(e1[t] * c1[t] + zero * c2[t]) + zero * c3[t]
                     for t in range(T)])
    dropped = np.stack([e1[t] * c1[t] for t in range(T)])
    assert np.array_equal(full, dropped)
    p = _signed_zeros(rng, nblk * tb)
    for a, b in zip(_table_sums(full, p, it, kt, lt, 2 * g, nblk, tb),
                    _table_sums(dropped, p, it, kt, lt, 2 * g, nblk, tb)):
        assert np.array_equal(_bits(a), _bits(b))
        assert not np.signbit(a[a == 0]).any()


# -- the operators against lam_tpu -----------------------------------------

@pytest.mark.parametrize("n", [300, 1000])
def test_gen_fq_operator_matches_lam_tpu(n):
    q1, n_pq = _gen_q1(n, layout.SYMM_TB)
    mine = DenseOperator.from_gen_fq(q1, n, n_pq, device="cpu")
    theirs = jops.DenseOperator.from_gen_fq(jnp.asarray(q1.numpy()), n,
                                            n_pq)
    x = np.zeros(n_pq)
    x[:n] = np.random.default_rng(n).uniform(-1, 1, n)
    gemv.reset_counters()
    y = mine.matvec(mine.prepare_b(x[:n])).numpy()
    yj = np.asarray(theirs.matvec(theirs.prepare_b(x[:n])), np.float64)
    one_tile = n_pq == layout.SYMM_TB  # the tile is the whole plane
    assert gemv.counters()["gemv_fq_symm_plain" if one_tile
                           else "gemv_fq_symm_zero_plain"] == 1
    assert np.linalg.norm(y[:n] - _tridiag_mv(x[:n])) \
        <= 1e-14 * np.linalg.norm(_tridiag_mv(x[:n]))
    assert np.linalg.norm(y - yj) <= 1e-6 * np.linalg.norm(yj)
    b = np.ones(n)
    res = tcg.cg_solve(mine, b, max_iters=10 * n, rel_error=1e-9)
    ref = lam_tpu.cg_solve(theirs, b, max_iters=10 * n, rel_error=1e-9)
    assert int(res.num_iters) == int(ref.num_iters) == n // 2
    x = res.x.numpy()
    assert np.linalg.norm(x - np.asarray(ref.x)) <= 1e-9 * np.linalg.norm(x)


@pytest.mark.parametrize("n", [300, 1000])
def test_gen_band_pair_df64_matches_lam_tpu(n):
    """One rank's packed gen df64 operator (G=1: the whole triangle, no
    collective), its zero lo tile dropped, against lam_tpu's on a mesh of
    one device: the same matvec, the host f64 CG's n/2 iterations and
    lam_tpu's x."""
    mine = pcg_symm.SymmShardedOperator.from_gen_tridiagonal(
        n, mesh=_band_mesh(1), tb=TB, packed=True, device="cpu")
    theirs = jpcg_symm.SymmShardedOperator.from_gen_tridiagonal(
        n, mesh=jmake_mesh(1), tb=TB, packed=True)
    x = np.zeros(mine.n_padded)
    x[:n] = np.random.default_rng(n + 1).uniform(-1, 1, n)
    gemv.reset_counters()
    y = mine.matvec(mine.prepare_b(x[:n])).numpy()
    assert gemv.counters()["gemv_df64_symm_slab_zero_plain"] == 1
    yj = np.asarray(theirs.matvec(theirs.prepare_b(x[:n])), np.float64)
    assert np.linalg.norm(y - yj) <= 1e-13 * np.linalg.norm(yj)
    b = np.ones(n)
    res = tcg.cg_solve(mine, b, max_iters=10 * n, rel_error=1e-9)
    ref = lam_tpu.cg_solve(theirs, b, max_iters=10 * n, rel_error=1e-9)
    assert int(res.num_iters) == int(ref.num_iters) == n // 2
    x = res.x.numpy()
    assert np.linalg.norm(x - np.asarray(ref.x)) <= 1e-9 * np.linalg.norm(x)
    assert np.linalg.norm(1 - _tridiag_mv(x)) / np.sqrt(n) <= 1e-9


def _rect_oracle(hi, vecs, mb, cb):
    """The f64 (S p, S^T q) of the hi rectangle's first mb x cb tiles."""
    tb = hi.shape[1]
    s = hi[:mb * cb * tb].double().reshape(mb, cb, tb, tb).permute(
        0, 2, 1, 3).reshape(mb * tb, cb * tb)
    p = vecs[0].double() + vecs[1].double()
    q = vecs[2].double() + vecs[3].double()
    return torch.cat([s @ p, s.T @ q])


def _pairs(out):
    return torch.cat([out[0].double() + out[1].double(),
                      out[2].double() + out[3].double()])


def _rel(y, ref):
    return float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))


def test_df64_dual_zero_matches_lam_tpu():
    """The grid's off-diagonal df64 part: a seeded (256, 512) hi rectangle
    with 3 pad tiles and a zero lo tile, against lam_tpu's gemv_df64_dual
    in Pallas interpret mode (1e-6: XLA:CPU degrades its float-float
    arithmetic, tests/test_torch_dual.py) and the f64 oracle (2^-48)."""
    ms, n = 256, 512
    rng = np.random.default_rng(17)
    buf = layout.pack_rect_host(rng.uniform(-1, 1, (ms, n)), TB, pad_tiles=3)
    hi = torch.from_numpy(buf.astype(np.float32))
    vecs = tuple(torch.from_numpy(x) for v in (rng.uniform(-1, 1, n),
                                               rng.uniform(-1, 1, ms))
                 for x in split_f64_host(v))
    gemv.reset_counters()
    out = gemv.gemv_df64_dual_zero(hi, *vecs)
    assert gemv.counters()["gemv_df64_dual_zero_plain"] == 1
    ref = jgemv.gemv_df64_dual(*(jnp.asarray(x.numpy()) for x in (
        hi, torch.zeros(TB, TB), *vecs)))
    y = _pairs(out)
    oracle = _rect_oracle(hi, vecs, ms // TB, n // TB)
    assert _rel(y, oracle) <= 2.0 ** -48
    assert _rel(y, _pairs([torch.from_numpy(np.array(x, np.float32))
                           for x in ref])) <= 1e-6


def test_fq_dual_zero_matches_lam_tpu():
    """The grid's off-diagonal fq part: a seeded (256, 512) rectangle of
    int16 tiles against power-of-two scales, with 3 pad tiles, against
    lam_tpu's gemv_fq_dual over (tb, tb) zero q2/q3 tiles in Pallas
    interpret mode (1e-6, as the df64 dual above) and the f64 oracle of the
    stored values (2^-48)."""
    ms, n = 256, 512
    mb, cb = ms // TB, n // TB
    rng = np.random.default_rng(19)
    T = mb * cb + 3
    q1 = torch.from_numpy(rng.integers(-32767, 32768, (T * TB, TB))
                          .astype(np.int16))
    s1 = torch.from_numpy((2.0 ** -rng.integers(8, 20, T)).astype(np.float32))
    vecs = tuple(torch.from_numpy(x) for v in (rng.uniform(-1, 1, n),
                                               rng.uniform(-1, 1, ms))
                 for x in split_f64_host(v))
    gemv.reset_counters()
    out = gemv.gemv_fq_dual_zero(q1, s1, *vecs)
    assert gemv.counters()["gemv_fq_dual_zero_plain"] == 1
    zt = np.zeros((TB, TB), np.int16)
    ref = jgemv.gemv_fq_dual(q1.numpy(), zt, zt, s1.numpy(), s1.numpy(),
                             s1.numpy(), *(x.numpy() for x in vecs))
    y = _pairs(out)
    tiles = q1.double() * s1.double().repeat_interleave(TB)[:, None]
    oracle = _rect_oracle(tiles, vecs, mb, cb)
    assert _rel(y, oracle) <= 2.0 ** -48
    assert _rel(y, _pairs([torch.from_numpy(np.array(x, np.float32))
                           for x in ref])) <= 1e-6


@pytest.mark.parametrize("rank", [0, 1])
def test_fq_slab_zero_matches_lam_tpu(rank):
    """The band pair's fq part: rank `rank` of G=2 of generate mode's fq
    storage (n=1000), seeded operands, against lam_tpu's gemv_fq_symm_slab
    over the same zero q2/q3 tiles in Pallas interpret mode and the f64
    oracle of the stored values (2^-48)."""
    op = pcg_symm.SymmShardedOperator.from_gen_fq(
        1000, mesh=pmesh.Mesh(rank, 2, "cpu"), tb=TB, device="cpu")
    q1, q2, q3, s1, s2, s3 = op.operand[:6]
    walk, ms = op.operand[-3:], 2 * op.m
    rng = np.random.default_rng(rank + 40)
    ph, pl = (torch.from_numpy(x)
              for x in split_f64_host(rng.uniform(-1, 1, op.n_padded)))
    gemv.reset_counters()
    out = gemv.gemv_fq_symm_slab_zero(q1, s1, ph, pl, *walk, ms=ms)
    assert gemv.counters()["gemv_fq_symm_slab_zero_plain"] == 1
    ref = jgemv.gemv_fq_symm_slab(*(x.numpy() for x in (
        q1, q2, q3, s1, s2, s3, ph, pl, *walk)), ms=ms)
    y = _pairs(out)
    tiles = q1.double() * s1.double().repeat_interleave(TB)[:, None]
    oracle = torch.cat(gemv._slab_parts(tiles, ph.double() + pl.double(),
                                        *walk, ms, TB, True))
    assert _rel(y, oracle) <= 2.0 ** -48
    assert _rel(y, _pairs([torch.from_numpy(np.array(x, np.float32))
                           for x in ref])) <= 1e-6


class _GridParts(tops.LinearOperator):
    """The R=2 symmetric grid's four gen df64 ranks in one process: each
    rank's (own, payload) exchanged by hand and summed, a whole matvec."""

    def __init__(self, n):
        self.ranks = [pcg2d_symm.Symm2DOperator.from_gen_tridiagonal(
            n, mesh=pmesh.Mesh2D(k, 2, "cpu"), tb=TB, device="cpu")
            for k in range(4)]
        n_p, m = self.ranks[0].n_padded, self.ranks[0].m
        super().__init__(self._mv, None, n, n_p, torch.float64, "cpu")
        self.m = m

    def _mv(self, _, p):
        m = self.m
        blk = [p[(k // 2) * m:(k // 2 + 1) * m] for k in range(4)]
        pairs = [op.mv_pair(op.operand, blk[k], blk[(k % 2) * 2 + k // 2])
                 for k, op in enumerate(self.ranks)]
        return torch.cat([sum(pairs[i * 2 + j][0] + pairs[j * 2 + i][1]
                              for j in range(2)) for i in range(2)])


def test_gen_grid_df64_matches_lam_tpu():
    """The R=2 symmetric grid's gen df64 operator, its off-diagonal ranks
    on the dual zero walk, assembled from the four ranks: the matvec
    against the exact tridiagonal product (2^-48) and lam_tpu's grid
    operator on its virtual mesh, and one solve at the host f64 CG's n/2
    iterations, lam_tpu's count."""
    n = 600
    mine = _GridParts(n)
    theirs = jsym.Symm2DOperator.from_gen_tridiagonal(
        n, mesh=jpcg2d.make_mesh2d(2), tb=TB)
    x = np.zeros(mine.n_padded)
    x[:n] = np.random.default_rng(n + 2).uniform(-1, 1, n)
    gemv.reset_counters()
    y = mine.matvec(torch.from_numpy(x)).numpy()
    counts = gemv.counters()
    assert counts["gemv_df64_dual_zero_plain"] == 2
    assert counts["gemv_df64_dual_bcast_plain"] == 0
    assert not y[n:].any()
    exact = _tridiag_mv(x[:n])
    assert np.linalg.norm(y[:n] - exact) <= 2.0 ** -48 * np.linalg.norm(exact)
    yj = np.asarray(theirs.matvec(theirs.prepare_b(x[:n])), np.float64)
    assert np.linalg.norm(y - yj) <= 1e-13 * np.linalg.norm(yj)
    b = np.ones(n)
    res = tcg.cg_solve(mine, b, max_iters=10 * n, rel_error=1e-9)
    ref = lam_tpu.cg_solve(theirs, b, max_iters=10 * n, rel_error=1e-9)
    assert int(res.num_iters) == int(ref.num_iters) == n // 2
    xs = res.x.numpy()
    assert np.linalg.norm(xs - np.asarray(ref.x)) <= 1e-9 * np.linalg.norm(xs)


def test_gen_band_pair_fq_matches_lam_tpu():
    """One rank's gen fq band pair (G=1: the whole triangle, no
    collective), its zero q2/q3 tiles dropped, against lam_tpu's on a mesh
    of one device: the same matvec and the host f64 CG's n/2 iterations."""
    n = 600
    mine = pcg_symm.SymmShardedOperator.from_gen_fq(
        n, mesh=_band_mesh(1), tb=TB, device="cpu")
    theirs = jpcg_symm.SymmShardedOperator.from_gen_fq(
        n, mesh=jmake_mesh(1), tb=TB)
    x = np.zeros(mine.n_padded)
    x[:n] = np.random.default_rng(n + 3).uniform(-1, 1, n)
    gemv.reset_counters()
    y = mine.matvec(mine.prepare_b(x[:n])).numpy()
    assert gemv.counters()["gemv_fq_symm_slab_zero_plain"] == 1
    exact = _tridiag_mv(x[:n])
    assert np.linalg.norm(y[:n] - exact) <= 2.0 ** -48 * np.linalg.norm(exact)
    yj = np.asarray(theirs.matvec(theirs.prepare_b(x[:n])), np.float64)
    assert np.linalg.norm(y - yj) <= 1e-13 * np.linalg.norm(yj)
    b = np.ones(n)
    res = tcg.cg_solve(mine, b, max_iters=10 * n, rel_error=1e-9)
    ref = lam_tpu.cg_solve(theirs, b, max_iters=10 * n, rel_error=1e-9)
    assert int(res.num_iters) == int(ref.num_iters) == n // 2
    xs = res.x.numpy()
    assert np.linalg.norm(xs - np.asarray(ref.x)) <= 1e-9 * np.linalg.norm(xs)
