"""Generate mode's zero broadcast tiles, counted when the operator is built.

Kernels 15-bcast and 9-bcast have a kernel of their own for broadcast
tiles that hold only zeros, `gemv_fq_symm_zero` (q1 alone) and
`gemv_df64_symm_slab_zero` (hi alone), with their own counters and plain
versions (csrc/strip_walk.cuh on the card). On the CPU:

- the operators choose it once, when they are built: generate mode's fq
  operator (one device, the symmetric grid's diagonal ranks) and packed
  band-pair df64 operator multiply by it, as does an operator handed tiles
  of zeros; a non-zero tile, a tile beside a plane and full planes keep
  the tile-reading or full-plane kernels;
- the zero kernels' plain versions equal the tile-reading ones over zero
  tiles, and the wrappers check their operands;
- a numpy model of the kernels' sums: the dropped-term elements (e1 * c1;
  h + 0.0) against the full ones ((e1*c1 + e2*c2) + e3*c3 with e2 = e3 =
  0; h + l with l = +-0), summed as the kernels sum them (from +0.0, in
  order, direct and transpose), equal bit for bit over e1 = 0, +-0 hi
  entries, -0.0 operand entries and zero, -0.0 and negative scales, though
  the elements themselves differ in the sign of a zero;
- the operators' matvecs and solves still match lam_tpu's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lam_tpu
from lam_tpu.parallel import pcg_symm as jpcg_symm
from lam_tpu.parallel.mesh import make_mesh as jmake_mesh
from lam_tpu.solver import operators as jops
from lam_tpu_torch import DenseOperator
from lam_tpu_torch import generate as tgen
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.parallel import mesh as pmesh
from lam_tpu_torch.parallel import pcg2d_symm, pcg_symm
from lam_tpu_torch.solver import cg as tcg

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
    ("fq", "gemv_fq_symm_slab_bcast_plain")])  # kernel 17's: no zero walk
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
    (2, "fq", "gemv_fq_dual_bcast_plain"),  # kernel 19's: no zero walk
    (0, "df64", "gemv_df64_symm_bcast_plain")])  # kernel 2's: no zero walk
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


def _zero_args():
    bufs, _, n_pq = _fq_bufs()
    q1, s1 = torch.from_numpy(bufs[0]), torch.from_numpy(bufs[3])
    gen = pcg_symm.SymmShardedOperator.from_gen_tridiagonal(
        1000, mesh=_band_mesh(2), tb=TB, packed=True, device="cpu")
    hi, _, *walk = gen.operand
    return q1, s1, torch.zeros(n_pq), hi, walk, torch.zeros(gen.n_padded), \
        2 * gen.m


@pytest.mark.parametrize("case,match", [
    ("fq-scales", r"s1 table shape"),
    ("fq-dtype", "int16"),
    ("fq-pair", "differ"),
    ("fq-comp", "comp="),
    ("df64-dtype", "float32"),
    ("df64-pair", "differ"),
    ("df64-ms", "multiple of tb")])
def test_zero_walks_check_their_operands(case, match):
    q1, s1, p, hi, walk, v, ms = _zero_args()
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
            hi, v, v, *walk, ms=ms + 7)}
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
