"""Generate mode (`-s N`) of the port against lam_tpu, on the CPU.

- The host builders byte-equal to lam_tpu.generate's, and the device
  builders (plain torch programs) byte-equal to jax.jit of lam_tpu's
  `_tridiag_hi_packed_impl`, `_tridiag_q1_packed_impl` and
  `tridiagonal_hi_plane_device`, at n in {300, 512, 1000, 1536} (padding,
  nblk = 1, the Q16_P-padded tables) and tb in {512, 128}.
- The plain versions of the four storage modes against lam_tpu's Pallas
  kernels in interpret mode: the square walk of kernels 1 and 2
  (packed=False), the broadcast lo tile of kernel 2 and the broadcast
  q2/q3 tiles of kernel 15, zero and non-zero; bitwise against the port's
  own full-plane forms on zero tiles and packed squares.
- The constructors against lam_tpu's on the same operands (`from_gen_fq`,
  `from_packed_f32`, `from_packed_planes` with the lo tile,
  `from_df64_planes(engine="pallas_symm")`), the facade and the CLI
  against lam_tpu's (the CSV contract, iteration counts, -s with -A, the
  --pack-cache notice, file mode with --engine pallas_symm, -s on a mesh
  of one rank).

On the tridiagonal the f32 recurrence of the refinement modes is
sensitive to the order of f32 sums: at n=200 the port's ir count moves
from 126 to 151 with the order of its dot products and the padding alone,
and lam_tpu's from 163 to 176 with its engine. Their counts are held to
25% of lam_tpu's; the f64-class modes to 2 iterations.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lam_tpu
from lam_tpu import cli as jcli
from lam_tpu import generate as jgen
from lam_tpu.ops import gemv as jgemv
from lam_tpu.solver import operators as jops
from lam_tpu_torch import ConjugateGradient, DenseOperator
from lam_tpu_torch import cli as tcli
from lam_tpu_torch import generate as tgen
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.precision import split_f64_host

TB = 512
SIZES = [300, 512, 1000, 1536]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test processes on shared cores: torch's own
    # thread pool would oversubscribe them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(y, ref):
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _tridiag_mv(x):
    """The generate-mode tridiagonal times x, O(n), in f64."""
    y = 2.0 * x
    y[1:] += x[:-1]
    y[:-1] += x[1:]
    return y


# -- host and device builders ----------------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_host_builders_are_byte_equal(n):
    for start, rows in ((0, n), (0, 7), (n // 3, 50), (n - 5, 5)):
        mine = tgen.tridiagonal_rows(start, rows, n)
        assert mine.tobytes() == jgen.tridiagonal_rows(start, rows,
                                                       n).tobytes()
    assert (tgen.tridiagonal_rows(3, 9, n, np.float32).tobytes()
            == jgen.tridiagonal_rows(3, 9, n, np.float32).tobytes())
    assert (tgen.tridiagonal_matrix(n).tobytes()
            == jgen.tridiagonal_matrix(n).tobytes())
    n_p = layout.padded_size(n)
    for pad in (None, n_p):
        assert (tgen.tridiagonal_hi_plane(n, pad).tobytes()
                == jgen.tridiagonal_hi_plane(n, pad).tobytes())
    assert tgen.ones_rhs(n).tobytes() == jgen.ones_rhs(n).tobytes()
    assert tgen.TRIDIAG_Q1_SCALE == jgen.TRIDIAG_Q1_SCALE == 2.0 ** -14


@pytest.mark.parametrize("n", SIZES)
def test_hi_square_on_the_device_is_byte_equal(n):
    n_p = layout.padded_size(n)
    mine = tgen.tridiagonal_hi_plane_device(n, n_p, device="cpu")
    theirs = np.asarray(jgen.tridiagonal_hi_plane_device(n, n_p))
    assert mine.dtype == torch.float32
    assert mine.numpy().tobytes() == theirs.tobytes()
    assert (tgen.tridiagonal_hi_plane_device(n, device="cpu").numpy()
            .tobytes() == jgen.tridiagonal_hi_plane(n).tobytes())


def _tables(nblk, padded):
    return (layout._symm_tables_padded(nblk) if padded and nblk >= 2
            else layout._symm_tables(nblk))


@pytest.mark.parametrize("tb", [512, 128])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("plane", ["hi", "q1", "q1-padded"])
def test_packed_planes_on_the_device_are_byte_equal(plane, n, tb):
    n_p = layout.padded_size(n, tb)
    nblk = n_p // tb
    it, kt = _tables(nblk, plane == "q1-padded")
    name = ("_tridiag_hi_packed_impl" if plane == "hi"
            else "_tridiag_q1_packed_impl")
    theirs = np.asarray(jax.jit(getattr(jgen, name),
                                static_argnums=(0, 1, 4))(
        n, tb, jnp.asarray(it), jnp.asarray(kt), nblk))
    mine = getattr(tgen, name)(n, tb, torch.from_numpy(it.astype(np.int64)),
                               torch.from_numpy(kt.astype(np.int64)), nblk)
    assert mine.shape == theirs.shape == (len(it) * tb, tb)
    assert mine.numpy().dtype == theirs.dtype
    assert mine.numpy().tobytes() == theirs.tobytes()
    # and the planes are the matrix: the packed square, diagonal extracted
    # and quantized for q1
    full = tgen.tridiagonal_hi_plane(n, n_p)
    if plane != "hi":
        full = np.where(np.eye(n_p, dtype=bool), 0.0, full) * 2.0 ** 14
    packed = layout.pack_tri_host(full, tb, it, kt)
    pad = (it < kt)  # the inert pad entries of the padded tables
    packed[np.repeat(pad, tb)] = 0
    assert np.array_equal(mine.numpy(), packed.astype(mine.numpy().dtype))


# -- the storage modes against lam_tpu's kernels ----------------------------

def _symmetric(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, size=(n, n))
    return m + m.T, rng.uniform(-1, 1, size=n)


@pytest.mark.parametrize("n", [768, 1024, 1536])
def test_square_walks_match_lam_tpu(n):
    """packed=False: 768 fits 256-wide tiles (lam_tpu's _fit_tile), 1024
    and 1536 the 512-wide ones. Bitwise the port's packed walk over
    pack_tri_host of the same square."""
    a, p = _symmetric(n, n)
    hi, lo = split_f64_host(a)
    ph, pl = split_f64_host(p)
    th, tl, tph, tpl = map(torch.from_numpy, (hi, lo, ph, pl))
    gemv.reset_counters()
    y = gemv.gemv_f32_symm(th, tph)
    assert gemv.counters()["gemv_f32_symm_square_plain"] == 1
    ref = np.asarray(jgemv.gemv_f32_symm(jnp.asarray(hi), jnp.asarray(ph)))
    assert _rel(y.numpy().astype(np.float64), ref.astype(np.float64)) <= 1e-6
    assert _rel(y.numpy().astype(np.float64), hi.astype(np.float64) @ ph) \
        <= 1e-6
    tb = 256 if n == 768 else TB
    packed = torch.from_numpy(layout.pack_tri_host(hi, tb))
    assert torch.equal(y, gemv.gemv_f32_symm_plain(packed, tph))
    yh, yl = gemv.gemv_df64_symm(th, tl, tph, tpl)
    assert gemv.counters()["gemv_df64_symm_square_plain"] == 1
    y64 = yh.numpy().astype(np.float64) + yl.numpy()
    jh, jl = jgemv.gemv_df64_symm(*map(jnp.asarray, (hi, lo, ph, pl)))
    yj = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    # XLA:CPU breaks lam_tpu's compensation (tests/test_kernels.py:186-190)
    assert _rel(y64, yj) <= 1e-6
    assert _rel(y64, a @ (ph.astype(np.float64) + pl)) <= 1e-13
    lo_packed = torch.from_numpy(layout.pack_tri_host(lo, tb))
    qh, ql = gemv.gemv_df64_symm_plain(packed, lo_packed, tph, tpl)
    assert torch.equal(yh, qh) and torch.equal(yl, ql)


@pytest.mark.parametrize("zero", [True, False])
def test_df64_broadcast_lo_tile_matches_lam_tpu(zero):
    n = 1536
    a, p = _symmetric(n, 11)
    hi, lo = (layout.pack_tri_host(x, TB) for x in split_f64_host(a))
    tile = np.zeros((TB, TB), np.float32) if zero else lo[TB:2 * TB] * 7
    ph, pl = split_f64_host(p)
    th, tt, tph, tpl = map(torch.from_numpy, (hi, tile, ph, pl))
    gemv.reset_counters()
    yh, yl = gemv.gemv_df64_symm(th, tt, tph, tpl)
    assert gemv.counters()["gemv_df64_symm_bcast_plain"] == 1
    y = yh.numpy().astype(np.float64) + yl.numpy()
    jh, jl = jgemv.gemv_df64_symm(*map(jnp.asarray, (hi, tile, ph, pl)),
                                  packed=True)
    yj = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    assert _rel(y, yj) <= 1e-6  # XLA:CPU's compensation, as above
    # the f64 oracle: the tile added to every stored tile
    tiles = hi.astype(np.float64).reshape(-1, TB, TB) + tile.astype(
        np.float64)
    dense = np.zeros((n, n))
    for t, (i, k) in enumerate(zip(*layout._symm_tables(n // TB))):
        dense[i * TB:(i + 1) * TB, k * TB:(k + 1) * TB] = tiles[t]
        if k < i:
            dense[k * TB:(k + 1) * TB, i * TB:(i + 1) * TB] = tiles[t].T
    assert _rel(y, dense @ (ph.astype(np.float64) + pl)) <= 1e-13
    if zero:
        zh, zl = gemv.gemv_df64_symm_plain(th, torch.zeros_like(th), tph,
                                           tpl)
        assert torch.equal(yh, zh) and torch.equal(yl, zl)


@pytest.mark.parametrize("tiles", ["zero", "nonzero", "q2-only"])
def test_fq_broadcast_tiles_match_lam_tpu(tiles):
    n = 1536
    a, p = _symmetric(n, 13)
    np.fill_diagonal(a, 0.0)
    from lam_tpu_torch.solver.operators import _host_pack_tri
    q1, q2, q3, s1, s2, s3, _, _ = _host_pack_tri(a, "fq", TB)
    if tiles == "zero":
        t2 = t3 = np.zeros((TB, TB), np.int16)
    elif tiles == "nonzero":
        t2, t3 = q2[TB:2 * TB].copy(), q3[:TB].copy()
    else:
        t2, t3 = q2[:TB].copy(), q3
    ph, pl = split_f64_host(p)
    args = (q1, t2, t3, s1, s2, s3, ph, pl)
    gemv.reset_counters()
    yh, yl = gemv.gemv_fq_symm(*map(torch.from_numpy, args))
    assert gemv.counters()["gemv_fq_symm_bcast_plain"] == 1
    y = yh.numpy().astype(np.float64) + yl.numpy()
    jh, jl = jgemv.gemv_fq_symm(*map(jnp.asarray, args))
    yj = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    assert _rel(y, yj) <= 1e-6  # XLA:CPU breaks lam_tpu's in-kernel two_sum
    nblk = n // TB
    T = layout.tri_tile_count(nblk)
    deq = sum(q.astype(np.float64).reshape(-1, TB, TB)[:T]
              * s[:T].astype(np.float64)[:, None, None]
              for q, s in ((q1, s1), (t2, s2), (t3, s3)))
    packed = deq.reshape(-1, TB)
    pt = torch.from_numpy(packed)
    yo = gemv._walk(pt.reshape(-1, TB, TB),
                    torch.from_numpy(ph.astype(np.float64) + pl), nblk)
    assert _rel(y, yo.numpy()) <= 1e-13
    if tiles == "zero":
        z = np.zeros_like(q1)
        zh, zl = gemv.gemv_fq_symm_plain(*map(torch.from_numpy,
                                              (q1, z, z, s1, s2, s3, ph,
                                               pl)))
        assert torch.equal(yh, zh) and torch.equal(yl, zl)


def test_square_and_tile_shapes_that_raise():
    a, p = _symmetric(1024, 3)
    sq = torch.from_numpy(a.astype(np.float32))
    pt = torch.from_numpy(p.astype(np.float32))
    with pytest.raises(ValueError, match="packed hi plane only"):
        gemv.gemv_df64_symm(sq, torch.zeros(TB, TB), pt, pt)
    with pytest.raises(ValueError, match="square planes"):
        gemv.gemv_df64_symm_square(sq, sq[:, :TB].contiguous(), pt, pt)
    with pytest.raises(ValueError, match="square matrix"):
        gemv.gemv_f32_symm_square(sq[:TB].contiguous(), pt)
    with pytest.raises(ValueError, match="multiple of any usable tile"):
        gemv.gemv_f32_symm_square(torch.zeros(1000, 1000),
                                  torch.zeros(1000))
    hi = torch.from_numpy(layout.pack_tri_host(a.astype(np.float32), TB))
    with pytest.raises(ValueError, match="lo tile must be"):
        gemv.gemv_df64_symm_bcast(hi, hi, pt, pt)


# -- constructors -----------------------------------------------------------

def _gen_planes(n, padded=False):
    n_p = layout.padded_size(n, TB)
    nblk = n_p // TB
    it, kt = _tables(nblk, padded)
    impl = "_tridiag_q1_packed_impl" if padded else "_tridiag_hi_packed_impl"
    plane = getattr(tgen, impl)(n, TB, torch.from_numpy(it.astype(np.int64)),
                                torch.from_numpy(kt.astype(np.int64)), nblk)
    return plane, n_p


def _matvecs(mine, theirs, n, seed, as_f32_tol):
    """Accurate and as_f32() matvecs of a port operator against lam_tpu's
    and the O(n) tridiagonal product."""
    x = np.zeros(mine.n_padded)
    x[:n] = np.random.default_rng(seed).uniform(-1, 1, n)
    y = mine.matvec(mine.prepare_b(x[:n])).numpy().astype(np.float64)
    yj = np.asarray(theirs.matvec(theirs.prepare_b(x[:n])), np.float64)
    # f32: x rounded to f32; the f64 class: the f32 split of the f64 sum
    assert _rel(y[:n], _tridiag_mv(x[:n])) <= (
        1e-7 if mine.precision == "f32" else 1e-14)
    assert _rel(y, yj) <= 1e-6
    m32, j32 = mine.as_f32(), theirs.as_f32()
    y = m32.matvec(m32.prepare_b(x[:n])).numpy().astype(np.float64)
    yj = np.asarray(j32.matvec(j32.prepare_b(x[:n])), np.float64)
    assert _rel(y, yj) <= as_f32_tol
    assert _rel(y[:n], _tridiag_mv(x[:n])) <= 1e-6


@pytest.mark.parametrize("n", [300, 1000])
def test_gen_constructors_match_lam_tpu(n):
    hi, n_p = _gen_planes(n)
    lo = np.zeros((TB, TB), np.float32)
    # f32: the packed plane is the matrix
    mine = DenseOperator.from_packed_f32(hi, n, n_p, device="cpu")
    theirs = jops.DenseOperator.from_packed_f32(hi.numpy(), n, n_p)
    assert np.asarray(theirs.operand).tobytes() == mine.operand.numpy() \
        .tobytes()
    _matvecs(mine, theirs, n, 1, 1e-6)
    # df64: the packed hi plane and ONE broadcast zero lo tile
    mine = DenseOperator.from_packed_planes(hi, lo, n, n_p, device="cpu")
    theirs = jops.DenseOperator.from_packed_planes(hi.numpy(), lo, n, n_p)
    assert tuple(mine.operand[1].shape) == (TB, TB)
    for m, t in zip(mine.operand, theirs.operand):
        assert m.numpy().tobytes() == np.asarray(t).tobytes()
    # at nblk = 1 the tile is the whole plane: the full-plane walk, as in
    # lam_tpu (_lo_plane_map takes a plane of the hi plane's shape first)
    one_tile = n_p == TB
    gemv.reset_counters()
    _matvecs(mine, theirs, n, 2, 1e-6)
    assert gemv.counters()["gemv_df64_symm_plain" if one_tile
                           else "gemv_df64_symm_bcast_plain"] == 1
    # fq: the exact q1 plane, zero q2/q3 tiles (which the matvec does not
    # read: kernel 15's zero-tile walk), the exact diagonal pair
    q1, n_pq = _gen_planes(n, padded=True)
    mine = DenseOperator.from_gen_fq(q1, n, n_pq, device="cpu")
    theirs = jops.DenseOperator.from_gen_fq(jnp.asarray(q1.numpy()), n, n_pq)
    for m, t in zip(mine.operand, theirs.operand):
        assert m.numpy().dtype == np.asarray(t).dtype
        assert m.numpy().tobytes() == np.asarray(t).tobytes()
    gemv.reset_counters()
    _matvecs(mine, theirs, n, 3, 1e-6)
    assert gemv.counters()["gemv_fq_symm_plain" if one_tile
                           else "gemv_fq_symm_zero_plain"] == 1
    with pytest.raises(ValueError, match="not exact"):
        DenseOperator.from_gen_fq(q1, n, n_pq, diag_value=0.1, device="cpu")


@pytest.mark.parametrize("n", [300, 1000])
def test_square_df64_planes_match_lam_tpu(n):
    n_p = layout.padded_size(n)
    hi = tgen.tridiagonal_hi_plane_device(n, n_p, device="cpu")
    lo = torch.zeros_like(hi)
    mine = DenseOperator.from_df64_planes(hi, lo, n, engine="pallas_symm",
                                          device="cpu")
    assert mine.operand[0] is hi  # a tensor on the device is not copied
    theirs = jops.DenseOperator.from_df64_planes(hi.numpy(), lo.numpy(), n,
                                                 engine="pallas_symm")
    gemv.reset_counters()
    _matvecs(mine, theirs, n, 4, 1e-6)
    counts = gemv.counters()
    assert counts["gemv_df64_symm_square_plain"] == 1
    assert counts["gemv_f32_symm_square_plain"] == 1
    d = mine.diagonal().numpy()
    assert np.array_equal(d[:n], np.full(n, 2.0)) and not d[n:].any()


# -- the facade and the CLI -------------------------------------------------

def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _csv(main, argv):
    rc, out, _ = _run(main, argv)
    assert rc == 0
    return out.strip().splitlines()[-1].split(",")


def test_gen_csv_contract_matches_lam_tpu(tmp_path):
    argv = ["-s", "200", "-i", "15"]
    mine = _csv(tcli.main, argv + ["-o", str(tmp_path / "x.bin"),
                                   "--device", "cpu"])
    theirs = _csv(jcli.main, argv + ["-o", str(tmp_path / "xj.bin"),
                                     "--backend", "local"])
    # N,procs,threads,load_s,avg_gemv_s,avg_iter_s,num_iter,err,total_cg_s
    assert len(mine) == len(theirs) == 9
    assert mine[:3] == theirs[:3] == ["200", "1", "1"]
    assert mine[6] == theirs[6] == "16"  # unconverged: max_iters + 1
    assert float(mine[7]) > 1e-9 and float(theirs[7]) > 1e-9
    x, xj = (tio.read_vector(tmp_path / f) for f in ("x.bin", "xj.bin"))
    assert _rel(x, xj) <= 1e-12  # 15 df64 iterations on the same system


# precision -> the tolerance of its count against lam_tpu's (see the
# module docstring)
GEN_PRECISIONS = {"df64": 2, "fq": 2, "dfq": 2, "ir": 0.25, "irq": 0.25,
                  "irfq": 0.25}


@pytest.mark.parametrize("precision", sorted(GEN_PRECISIONS))
def test_gen_solves_match_lam_tpu(tmp_path, precision):
    n = 200
    argv = ["-s", str(n), "-e", "1e-9", "--precision", precision]
    mine = _csv(tcli.main, argv + ["-o", str(tmp_path / "x.bin"),
                                   "--device", "cpu"])
    theirs = _csv(jcli.main, argv + ["-o", str(tmp_path / "xj.bin"),
                                     "--backend", "local"])
    k, kj = int(mine[6]), int(theirs[6])
    tol = GEN_PRECISIONS[precision]
    assert abs(k - kj) <= (tol if tol >= 1 else tol * kj), (k, kj)
    assert float(mine[7]) < 1e-9
    x = tio.read_vector(tmp_path / "x.bin")
    assert np.linalg.norm(1 - _tridiag_mv(x)) / np.sqrt(n) <= 1e-9
    if tol >= 1:  # the f64 class: the host f64 CG's n/2 iterations
        assert k == n // 2


@pytest.mark.parametrize("engine", ["pallas_symm", "pallas"])
@pytest.mark.parametrize("precision", ["df64", "ir", "f32"])
def test_gen_full_square_engines(engine, precision):
    n = 300
    cg = ConjugateGradient(precision=precision, engine=engine, device="cpu")
    cg.generate_matrix(n)
    cg.generate_rhs()
    planes = (cg.op.operand if isinstance(cg.op.operand, tuple)
              else (cg.op.operand,))
    assert cg.op.engine == engine
    assert all(tuple(x.shape) == (1024, 1024) for x in planes)
    gemv.reset_counters()
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    walk = {"pallas_symm": "gemv_f32_symm_square_plain",
            "pallas": "gemv_f32_plain"}[engine]
    if precision == "df64":
        walk = walk.replace("f32", "df64")
    assert gemv.counters()[walk] > 0
    gate = 1e-5 if precision == "f32" else 1e-9
    assert np.linalg.norm(1 - _tridiag_mv(cg.x)) / np.sqrt(n) <= gate
    if precision == "df64":
        assert cg.timings["num_iters"] == n // 2


def test_gen_operators_by_precision():
    """What lam_tpu's _generate_fast builds on its device, built here on
    the CPU (lam_tpu/solver/api.py:339-418)."""
    shapes = {}
    for precision in ("df64", "ir", "f32", "fq", "irfq", "dfq", "irq"):
        cg = ConjugateGradient(precision=precision, device="cpu")
        cg.generate_matrix(1000)
        operand = cg.op.operand
        shapes[precision] = [tuple(x.shape) for x in (
            operand if isinstance(operand, tuple) else (operand,))]
        assert cg.timings["load_s"] >= 0
    assert shapes["df64"] == shapes["ir"] == [(3 * TB, TB), (TB, TB)]
    assert shapes["f32"] == [(3 * TB, TB)]
    assert shapes["fq"][:3] == [(8 * TB, TB), (TB, TB), (TB, TB)]
    assert shapes["dfq"][:2] == [(3 * TB, TB), (3 * TB, TB)]  # host build
    with pytest.raises(ValueError, match="square"):
        ConjugateGradient(device="cpu").generate_matrix(100, 50)
    with pytest.raises(RuntimeError, match="generate_matrix first"):
        ConjugateGradient(device="cpu").generate_rhs()


def test_gen_cli_rules_match_lam_tpu(tmp_path, capsys):
    for argv in (["-s", "10", "-A", "x.bin"], ["-s", "10", "-b", "y.bin"]):
        rc, _, err = _run(tcli.main, argv + ["--device", "cpu"])
        rcj, _, errj = _run(jcli.main, argv + ["--backend", "local"])
        assert rc == rcj == 1
        assert err == errj == "Option -A and -b cannot be used with -s.\n"
    argv = ["-s", "100", "-i", "5", "--pack-cache"]
    rc, _, err = _run(tcli.main, argv + ["-o", str(tmp_path / "x.bin"),
                                         "--device", "cpu"])
    rcj, _, errj = _run(jcli.main, argv + ["-o", str(tmp_path / "y.bin"),
                                           "--backend", "local"])
    notice = ("lam-cg: --pack-cache only accelerates file-mode loads; "
              "ignored in generate mode")
    assert rc == rcj == 0 and notice in err and notice in errj
    rc, out, _ = _run(tcli.main, ["-s", "100", "-i", "5", "-v", "-o",
                                  str(tmp_path / "x.bin"), "--device", "cpu"])
    assert rc == 0
    for line in ("  rows/cols:         100",
                 "  size of the problem: 0.000075 GB",
                 "Generating the system ...",
                 "Did not converge in 5 iterations"):
        assert line in out.splitlines() or line in out
    # the meshes take -s too: a mesh of one rank needs no process group
    for backend in ("sharded", "sharded2d"):
        row = _csv(tcli.main, ["-s", "100", "-i", "5", "--backend", backend,
                               "-o", str(tmp_path / "x.bin"), "--device",
                               "cpu"])
        assert row[:2] == ["100", "1"] and row[6] == "6"
    cg = ConjugateGradient(backend="sharded2d", engine="pallas_symm_packed",
                           precision="df64", device="cpu")
    cg.generate_matrix(100)
    assert type(cg.op).__name__ == "Symm2DOperator"


def test_file_mode_pallas_symm_matches_lam_tpu(tmp_path):
    a, b = jgen.random_spd_system(300, seed=17)
    tio.write_matrix(tmp_path / "A.bin", a)
    tio.write_matrix(tmp_path / "b.bin", b)
    common = ["-A", str(tmp_path / "A.bin"), "-b", str(tmp_path / "b.bin"),
              "--engine", "pallas_symm", "-e", "1e-9", "--precision", "df64"]
    gemv.reset_counters()
    rc, out, err = _run(tcli.main, common + ["-o", str(tmp_path / "x.bin"),
                                             "--device", "cpu",
                                             "--pack-cache"])
    assert rc == 0 and "ignored for --engine pallas_symm" in err
    assert gemv.counters()["gemv_df64_symm_square_plain"] > 0
    mine = out.strip().splitlines()[-1].split(",")
    assert float(mine[7]) < 1e-9
    # lam_tpu's f64 oracle path: XLA:CPU breaks its df64 kernels'
    # compensation, so their count is no reference here
    # (tests/test_torch_cg.py's docstring)
    ref = lam_tpu.cg_solve(lam_tpu.DenseOperator.from_dense(
        a, precision="f64"), b, max_iters=10000, rel_error=1e-9)
    assert abs(int(mine[6]) - int(ref.num_iters)) <= 2
    x = tio.read_vector(tmp_path / "x.bin")
    assert _rel(x, np.asarray(ref.x)) <= 1e-8
    # the operand against lam_tpu's from_dense(engine="pallas_symm")
    op = DenseOperator.from_dense(a, precision="df64", engine="pallas_symm",
                                  device="cpu")
    jop = lam_tpu.DenseOperator.from_dense(a, precision="df64",
                                           engine="pallas_symm")
    for m, t in zip(op.operand, jop.operand):
        assert m.numpy().tobytes() == np.asarray(t).tobytes()
    p = op.prepare_b(np.random.default_rng(5).uniform(-1, 1, 300))
    y = op.matvec(p).numpy()
    yj = np.asarray(jop.matvec(jnp.asarray(p.numpy())))
    assert _rel(y, yj) <= 1e-6  # XLA:CPU's compensation
    assert _rel(y[:300], a @ p.numpy()[:300]) <= 1e-13
    y32 = op.as_f32().matvec(p.float()).numpy()
    yj32 = np.asarray(jop.as_f32().matvec(jnp.asarray(p.numpy(),
                                                      jnp.float32)))
    assert _rel(y32, yj32) <= 1e-6
