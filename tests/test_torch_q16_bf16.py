"""The bf16 product engine of the port's three q16 matvecs against lam_tpu's
'mxu' bodies, on the CPU.

lam_tpu_torch/ops/gemv.py keeps lam_tpu's engine knob: `_Q16_IMPL` (from
LAM_Q16_IMPL), `Q16_MXU_MIN_N` and `_q16_impl(n)`. Under 'mxu' the q16
walks round both operands of every product to bf16 (the converted int16
tile value and p * s, nearest even) and sum the exact products in f32,
which is what lam_tpu's single-pass DEFAULT-precision MXU dots compute on
a TPU. XLA:CPU computes such a dot in full f32, so on this host lam_tpu's
'mxu' body pins down the port's routing only:
- on small-integer tiles, power-of-two scales and small-integer operands,
  which bf16 holds exactly, the two agree bit for bit (the data of
  tests/test_tpu.py:446-510);
- on general inputs they agree within the bf16 class (1e-2), while the
  port's bf16 result differs from its exact-f32 one by more than 1e-5.
The rounding itself is held to a numpy model of round-to-nearest-even
(within 1e-6: the plain versions sum in f32, the model in f64). Shapes:
tb=128, n <= 1024, and rectangles and slabs of a few tiles at the
engine's threshold n = 16384.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lam_tpu.generate import random_spd_system
from lam_tpu.ops import gemv as jgemv
from lam_tpu_torch import ConjugateGradient, DenseOperator, cg_solve_ir
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.parallel import pcg_symm
from lam_tpu_torch.parallel.pcg2d_symm import sym2d_padded_size
from lam_tpu_torch.solver.cg import IRFQ_INNER_FLOOR

TB = 128
MIN_N = 16384


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def port_mxu(monkeypatch):
    monkeypatch.setattr(gemv, "_Q16_IMPL", "mxu")


@pytest.fixture
def lam_tpu_mxu():
    """lam_tpu's engine forced to 'mxu' (tests/test_fq.py:94-104); its
    kernels resolve the knob when traced, hence the cleared caches."""
    old = jgemv._Q16_IMPL
    jgemv._Q16_IMPL = "mxu"
    jax.clear_caches()
    yield
    jgemv._Q16_IMPL = old
    jax.clear_caches()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _bf16_np(x):
    """Round-to-nearest-even of f32 x to bf16, as f32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _calls(*names):
    counts = gemv.counters()
    return tuple(counts[name] for name in names)


# -- (a) the knob ------------------------------------------------------------

@pytest.mark.parametrize("impl", ["auto", "mxu", "vpu"])
def test_q16_impl_matches_lam_tpu(monkeypatch, impl):
    monkeypatch.setattr(gemv, "_Q16_IMPL", impl)
    monkeypatch.setattr(jgemv, "_Q16_IMPL", impl)
    assert gemv.Q16_MXU_MIN_N == jgemv.Q16_MXU_MIN_N == MIN_N
    for n in (8, MIN_N - 1, MIN_N, 10 ** 6):
        assert gemv._q16_impl(n) == jgemv._q16_impl(n)
    if impl == "auto":
        assert gemv._q16_impl(MIN_N - 1) == "vpu"
        assert gemv._q16_impl(MIN_N) == "mxu"


def _small_int_rect(mb, cb, seed):
    rng = np.random.default_rng(seed)
    q1 = rng.integers(-3, 4, (mb * cb * TB, TB)).astype(np.int16)
    sc = np.full(mb * cb, 0.5, np.float32)
    return q1, sc, rng


@pytest.mark.parametrize("ms,n,engine", [
    (TB, MIN_N, "mxu"), (MIN_N, TB, "mxu"), (TB, MIN_N - TB, "vpu"),
    (MIN_N - TB, TB, "vpu")])
def test_dual_engine_follows_the_larger_extent(monkeypatch, ms, n, engine):
    """Under 'auto' gemv_q16_dual chooses on max(n, ms), as lam_tpu does
    (lam_tpu/ops/gemv.py:2556); the plain version that ran says which."""
    monkeypatch.setattr(gemv, "_Q16_IMPL", "auto")
    monkeypatch.setattr(jgemv, "_Q16_IMPL", "auto")
    assert jgemv._q16_impl(max(n, ms)) == engine
    q1, sc, rng = _small_int_rect(ms // TB, n // TB, seed=ms + n)
    p = rng.integers(-3, 4, n).astype(np.float32)
    q = rng.integers(-3, 4, ms).astype(np.float32)
    gemv.reset_counters()
    yd, yt = gemv.gemv_q16_dual(*map(_t, (q1, sc, p, q)))
    bf16, exact = _calls("gemv_q16_dual_bf16_plain", "gemv_q16_dual_plain")
    assert (bf16, exact) == ((1, 0) if engine == "mxu" else (0, 1))
    s = (q1.astype(np.float64).reshape(ms // TB, n // TB, TB, TB)
         .transpose(0, 2, 1, 3).reshape(ms, n) * 0.5)
    np.testing.assert_array_equal(yd.numpy(), s @ p)
    np.testing.assert_array_equal(yt.numpy(), s.T @ q)


@pytest.mark.parametrize("n,engine", [(MIN_N, "mxu"), (MIN_N - TB, "vpu")])
def test_slab_engine_follows_p(monkeypatch, n, engine):
    """Under 'auto' gemv_q16_symm_slab chooses on p's length: a two-tile
    walk of an n-column slab (tiles (1, 0) and (1, 1))."""
    monkeypatch.setattr(gemv, "_Q16_IMPL", "auto")
    rng = np.random.default_rng(n)
    q1 = rng.integers(-3, 4, (2 * TB, TB)).astype(np.int16)
    sc = np.array([0.5, 0.25], np.float32)
    p = rng.integers(-3, 4, n).astype(np.float32)
    it, kt, lt = (torch.tensor(x, dtype=torch.int32)
                  for x in ([1, 1], [0, 1], [0, 0]))
    gemv.reset_counters()
    yd, yt = gemv.gemv_q16_symm_slab(_t(q1), _t(sc), _t(p), it, kt, lt,
                                     ms=TB)
    bf16, exact = _calls("gemv_q16_symm_slab_bf16_plain",
                         "gemv_q16_symm_slab_plain")
    assert (bf16, exact) == ((1, 0) if engine == "mxu" else (0, 1))
    a0 = q1[:TB].astype(np.float64) * 0.5
    a1 = q1[TB:].astype(np.float64) * 0.25
    np.testing.assert_array_equal(yd.numpy(), a0 @ p[:TB] + a1 @ p[TB:2 * TB])
    ref_t = np.zeros(n)
    ref_t[:TB] = a0.T @ p[TB:2 * TB]
    np.testing.assert_array_equal(yt.numpy(), ref_t)


@pytest.mark.parametrize("n,engine", [(512, "mxu"), (384, "vpu")])
def test_symm_engine_follows_p(monkeypatch, n, engine):
    """Under 'auto' gemv_q16_symm chooses on p's length (the threshold
    lowered to 512 here: a triangle at n = 16384 is 270 MB of int16)."""
    monkeypatch.setattr(gemv, "Q16_MXU_MIN_N", 512)
    monkeypatch.setattr(gemv, "_Q16_IMPL", "auto")
    nblk = n // TB
    T = layout.padded_tri_tile_count(nblk)
    rng = np.random.default_rng(n)
    q1 = rng.integers(-3, 4, (T * TB, TB)).astype(np.int16)
    s1 = np.full(T, 0.5, np.float32)
    p = rng.integers(-3, 4, n).astype(np.float32)
    gemv.reset_counters()
    gemv.gemv_q16_symm(*map(_t, (q1, s1, p)))
    bf16, exact = _calls("gemv_q16_symm_bf16_plain", "gemv_q16_symm_plain")
    assert (bf16, exact) == ((1, 0) if engine == "mxu" else (0, 1))


def test_unknown_engine_raises(monkeypatch):
    """The port refuses a value other than auto/mxu/vpu: at import from
    LAM_Q16_IMPL, and at a call from the module attribute. lam_tpu hands
    such a value to its kernels, whose bodies take it as 'vpu' (ROADMAP
    Queue 3)."""
    env = dict(os.environ, LAM_Q16_IMPL="bf16")
    proc = subprocess.run(
        [sys.executable, "-c", "import lam_tpu_torch.ops.gemv"], env=env,
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode != 0
    assert "ValueError: LAM_Q16_IMPL='bf16' must be one of" in proc.stderr
    monkeypatch.setattr(gemv, "_Q16_IMPL", "MXU")
    with pytest.raises(ValueError, match="must be one of"):
        gemv._q16_impl(MIN_N)
    monkeypatch.setattr(jgemv, "_Q16_IMPL", "MXU")
    assert jgemv._q16_impl(MIN_N) == "MXU"  # taken as 'vpu' by its kernels


# -- the three walks on small systems ----------------------------------------

def _triangle(nblk, rng, small, padded=True):
    """A padded q1 triangle plane and scales (zero pad tiles and scales,
    the fq storage's layout) or, with padded=False, an exact-count one (the
    symmetric grid's diagonal ranks), and p: small integers and scales
    0.5/0.25, or int16 within +-30000 against 2^-15 and Gaussian p."""
    T = layout.tri_tile_count(nblk)
    Ts = layout.padded_tri_tile_count(nblk) if padded else T
    q1 = np.zeros((Ts * TB, TB), np.int16)
    s1 = np.zeros(Ts, np.float32)
    if small:
        q1[:T * TB] = rng.integers(-3, 4, (T * TB, TB))
        s1[:T] = np.where(np.arange(T) % 2, 0.25, 0.5)
        p = rng.integers(-3, 4, nblk * TB).astype(np.float32)
    else:
        q1[:T * TB] = rng.integers(-30000, 30001, (T * TB, TB))
        s1[:T] = 2.0 ** -15
        p = rng.standard_normal(nblk * TB).astype(np.float32)
    return q1, s1, p


def _tri_model(q1, s1, p, nblk):
    """numpy model of the bf16 engine on a triangle, summed in f64."""
    y = np.zeros(nblk * TB)
    for t, (i, k) in enumerate(zip(*layout._symm_tables(nblk))):
        tile = _bf16_np(q1[t * TB:(t + 1) * TB].astype(np.float32)).astype(
            np.float64)
        pk = _bf16_np(p[k * TB:(k + 1) * TB] * s1[t]).astype(np.float64)
        y[i * TB:(i + 1) * TB] += tile @ pk
        if k < i:
            pi = _bf16_np(p[i * TB:(i + 1) * TB] * s1[t]).astype(np.float64)
            y[k * TB:(k + 1) * TB] += tile.T @ pi
    return y


def _slab_ranks(g, mt, rng, small):
    """Every rank's (q1, sc, it, kt, lt) of a g-rank band-pair walk with
    mt tile-rows per band, one scale per walk position, and p."""
    tables = pcg_symm._band_tables(g, mt, TB)
    n = 2 * g * mt * TB
    ranks = []
    for c in range(g):
        it, kt, lt = (np.asarray(x[c], np.int32) for x in tables)
        T = it.shape[0]
        if small:
            q1 = rng.integers(-3, 4, (T * TB, TB)).astype(np.int16)
            sc = np.where(np.arange(T) % 3, 0.5, 0.25).astype(np.float32)
        else:
            q1 = rng.integers(-30000, 30001, (T * TB, TB)).astype(np.int16)
            sc = np.full(T, 2.0 ** -15, np.float32)
        ranks.append((q1, sc, it, kt, lt))
    p = (rng.integers(-3, 4, n) if small else rng.standard_normal(n))
    return ranks, p.astype(np.float32), 2 * mt * TB


def _slab_model(q1, sc, p, it, kt, lt, ms):
    yd, yt = np.zeros(ms), np.zeros(p.shape[0])
    for t in range(it.shape[0]):
        i, k, l = it[t], kt[t], lt[t]
        tile = _bf16_np(q1[t * TB:(t + 1) * TB].astype(np.float32)).astype(
            np.float64)
        pk = _bf16_np(p[k * TB:(k + 1) * TB] * sc[t]).astype(np.float64)
        yd[l * TB:(l + 1) * TB] += tile @ pk
        if k < i:
            pi = _bf16_np(p[i * TB:(i + 1) * TB] * sc[t]).astype(np.float64)
            yt[k * TB:(k + 1) * TB] += tile.T @ pi
    return yd, yt


def _grid_rect_ranks(n, rng, small):
    """The two off-diagonal ranks' dual operands of the 2 x 2 symmetric
    grid (chip_smoke.py's routing): for rank (i, j), the rank's half-slab
    (m/2, m) as a row-major tile pack with the diagonal rank's tile count
    (garbage pad tiles and pad scales), and the (p, q) slices it gets."""
    n_p = sym2d_padded_size(n, 2, TB)
    m = n_p // 2
    m2, c = m // 2, m // TB
    mb, T = c // 2, c * (c + 1) // 2
    real = mb * c
    if small:
        p = rng.integers(-3, 4, n_p).astype(np.float32)
    else:
        p = rng.standard_normal(n_p).astype(np.float32)
    out = []
    for i, j in ((0, 1), (1, 0)):
        q1 = np.full((T * TB, TB), 7, np.int16)
        sc = np.full(T, 3.0, np.float32)
        if small:
            q1[:real * TB] = rng.integers(-3, 4, (real * TB, TB))
            sc[:real] = np.where(np.arange(real) % 2, 0.25, 0.5)
        else:
            q1[:real * TB] = rng.integers(-30000, 30001, (real * TB, TB))
            sc[:real] = 2.0 ** -15
        if i > j:
            pv, qv = p[j * m:(j + 1) * m], p[i * m:i * m + m2]
        else:
            pv, qv = p[i * m:(i + 1) * m], p[j * m + m2:(j + 1) * m]
        out.append((q1, sc, pv.copy(), qv.copy(), mb, c))
    return out


def _dual_model(q1, sc, p, q, mb, cb):
    yd, yt = np.zeros(mb * TB), np.zeros(cb * TB)
    for li in range(mb):
        for k in range(cb):
            t = li * cb + k
            tile = _bf16_np(q1[t * TB:(t + 1) * TB].astype(np.float32))
            tile = tile.astype(np.float64)
            pk = _bf16_np(p[k * TB:(k + 1) * TB] * sc[t]).astype(np.float64)
            ql = _bf16_np(q[li * TB:(li + 1) * TB] * sc[t]).astype(np.float64)
            yd[li * TB:(li + 1) * TB] += tile @ pk
            yt[k * TB:(k + 1) * TB] += tile.T @ ql
    return yd, yt


# -- (b) the rounding against a numpy model ----------------------------------

def test_bf16_rounding_model_matches_torch():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32),
                        np.float32([1 + 2 ** -8, 1 + 3 * 2 ** -8, -1 - 2 ** -8,
                                    32767, -32767, 257, 259])])
    np.testing.assert_array_equal(gemv._bf16(_t(x)).numpy(), _bf16_np(x))
    # ties to even: 1 + 2^-8 -> 1, 1 + 3 * 2^-8 -> 1 + 2^-6, 257 -> 256
    assert list(_bf16_np(np.float32([1 + 2 ** -8, 1 + 3 * 2 ** -8, 257,
                                     259]))) == [1.0, 1 + 2 ** -6, 256, 260]


@pytest.mark.parametrize("nblk", [2, 4])
def test_symm_bf16_plain_matches_rounding_model(nblk):
    q1, s1, p = _triangle(nblk, np.random.default_rng(nblk), small=False)
    y = gemv.gemv_q16_symm_bf16(*map(_t, (q1, s1, p)))
    assert y.dtype == torch.float32
    assert _rel(y.numpy(), _tri_model(q1, s1, p, nblk)) <= 1e-6


@pytest.mark.parametrize("g,mt", [(2, 1), (3, 1)])
def test_slab_bf16_plain_matches_rounding_model(g, mt):
    ranks, p, ms = _slab_ranks(g, mt, np.random.default_rng(g), small=False)
    for q1, sc, it, kt, lt in ranks:
        yd, yt = gemv.gemv_q16_symm_slab_bf16(*map(_t, (q1, sc, p, it, kt,
                                                        lt)), ms=ms)
        md, mt_ = _slab_model(q1, sc, p, it, kt, lt, ms)
        assert _rel(yd.numpy(), md) <= 1e-6
        assert (_rel(yt.numpy(), mt_) <= 1e-6 if np.any(mt_)
                else not torch.any(yt))


def test_dual_bf16_plain_matches_rounding_model():
    for q1, sc, pv, qv, mb, cb in _grid_rect_ranks(
            1000, np.random.default_rng(5), small=False):
        yd, yt = gemv.gemv_q16_dual_bf16(*map(_t, (q1, sc, pv, qv)))
        md, mt_ = _dual_model(q1, sc, pv, qv, mb, cb)
        assert _rel(yd.numpy(), md) <= 1e-6
        assert _rel(yt.numpy(), mt_) <= 1e-6


# -- (c) bitwise against lam_tpu's 'mxu' bodies on exact data ----------------

@pytest.mark.parametrize("nblk", [2, 4])
def test_symm_bf16_bitwise_lam_tpu_mxu(port_mxu, lam_tpu_mxu, nblk):
    """The padded triangle: lam_tpu's blocked grid, its 'mxu' body."""
    q1, s1, p = _triangle(nblk, np.random.default_rng(10 + nblk), small=True)
    gemv.reset_counters()
    y = gemv.gemv_q16_symm(*map(_t, (q1, s1, p)))
    assert _calls("gemv_q16_symm_bf16_plain", "gemv_q16_symm_plain") == (1, 0)
    ref = np.asarray(jgemv.gemv_q16_symm(q1, s1, p))
    np.testing.assert_array_equal(y.numpy(), ref)
    np.testing.assert_array_equal(y.numpy(), _tri_model(q1, s1, p, nblk))


@pytest.mark.parametrize("nblk,padded,engine", [
    (2, False, "exact"), (4, False, "exact"), (1, True, "exact"),
    (15, False, "bf16")])
def test_symm_mxu_engine_follows_lam_tpu_grid(port_mxu, lam_tpu_mxu, nblk,
                                              padded, engine):
    """Under 'mxu' lam_tpu's gemv_q16_symm runs its bf16 body only on the
    blocked grid, a stored tile count that is a multiple of Q16_P with
    nblk >= 2 (lam_tpu/ops/gemv.py:2089); any other plane, such as the
    exact-count triangles of the symmetric grid's diagonal ranks, takes the
    one-tile grid's exact body. The port routes alike: exact counts of 3
    and 10 tiles and a one-block plane padded to 8 keep exact products,
    the exact count of 120 tiles (nblk = 15) is blocked. Bitwise against
    lam_tpu on small-integer data; on general data the port's result is
    bitwise its own exact ('vpu') or bf16 kernel's."""
    rng = np.random.default_rng(50 + nblk)
    q1, s1, p = _triangle(nblk, rng, small=True, padded=padded)
    gemv.reset_counters()
    y = gemv.gemv_q16_symm(*map(_t, (q1, s1, p)))
    assert _calls("gemv_q16_symm_bf16_plain", "gemv_q16_symm_plain") == (
        (1, 0) if engine == "bf16" else (0, 1))
    np.testing.assert_array_equal(y.numpy(),
                                  np.asarray(jgemv.gemv_q16_symm(q1, s1, p)))
    q1, s1, p = _triangle(nblk, rng, small=False, padded=padded)
    y = gemv.gemv_q16_symm(*map(_t, (q1, s1, p)))
    body = (gemv.gemv_q16_symm_bf16_plain if engine == "bf16"
            else gemv.gemv_q16_symm_plain)
    np.testing.assert_array_equal(y.numpy(), body(*map(_t, (q1, s1, p))).numpy())


@pytest.mark.parametrize("g,mt", [(2, 1), (2, 2), (3, 1)])
def test_slab_bf16_bitwise_lam_tpu_mxu(port_mxu, lam_tpu_mxu, g, mt):
    """Every rank's tables and scales of the band pairs."""
    ranks, p, ms = _slab_ranks(g, mt, np.random.default_rng(20 + g + mt),
                               small=True)
    for q1, sc, it, kt, lt in ranks:
        gemv.reset_counters()
        yd, yt = gemv.gemv_q16_symm_slab(*map(_t, (q1, sc, p, it, kt, lt)),
                                         ms=ms)
        assert _calls("gemv_q16_symm_slab_bf16_plain",
                      "gemv_q16_symm_slab_plain") == (1, 0)
        rd, rt = jgemv.gemv_q16_symm_slab(q1, sc, p, it, kt, lt, ms=ms)
        np.testing.assert_array_equal(yd.numpy(), np.asarray(rd))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(rt))
        md, mt_ = _slab_model(q1, sc, p, it, kt, lt, ms)
        np.testing.assert_array_equal(yd.numpy(), md)
        np.testing.assert_array_equal(yt.numpy(), mt_)


def test_dual_bf16_bitwise_lam_tpu_mxu(port_mxu, lam_tpu_mxu):
    """Both off-diagonal ranks of the 2 x 2 grid; the pad tiles and pad
    scales hold garbage, which neither side may read."""
    for q1, sc, pv, qv, mb, cb in _grid_rect_ranks(
            1000, np.random.default_rng(30), small=True):
        gemv.reset_counters()
        yd, yt = gemv.gemv_q16_dual(*map(_t, (q1, sc, pv, qv)))
        assert _calls("gemv_q16_dual_bf16_plain",
                      "gemv_q16_dual_plain") == (1, 0)
        rd, rt = jgemv.gemv_q16_dual(q1, sc, pv, qv)
        np.testing.assert_array_equal(yd.numpy(), np.asarray(rd))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(rt))
        md, mt_ = _dual_model(q1, sc, pv, qv, mb, cb)
        np.testing.assert_array_equal(yd.numpy(), md)
        np.testing.assert_array_equal(yt.numpy(), mt_)


# -- (d) general inputs: the bf16 class, visibly rounded ---------------------

def _engines(fn, args, **kw):
    """fn's result under 'mxu' and under 'vpu' (the port's engines)."""
    out = []
    for impl in ("mxu", "vpu"):
        old, gemv._Q16_IMPL = gemv._Q16_IMPL, impl
        try:
            y = fn(*map(_t, args), **kw)
        finally:
            gemv._Q16_IMPL = old
        y = y if isinstance(y, torch.Tensor) else torch.cat(y)
        out.append(y.numpy().astype(np.float64))
    return out


def _check_bf16_class(bf16, exact, ref):
    assert _rel(bf16, ref) <= 1e-2
    assert _rel(bf16, exact) > 1e-5
    assert _rel(exact, ref) <= 1e-6


def test_symm_general_inputs_bf16_class(lam_tpu_mxu):
    nblk = 4
    q1, s1, p = _triangle(nblk, np.random.default_rng(40), small=False)
    bf16, exact = _engines(gemv.gemv_q16_symm, (q1, s1, p))
    _check_bf16_class(bf16, exact, np.asarray(jgemv.gemv_q16_symm(q1, s1, p)))


def test_slab_general_inputs_bf16_class(lam_tpu_mxu):
    ranks, p, ms = _slab_ranks(2, 2, np.random.default_rng(41), small=False)
    for q1, sc, it, kt, lt in ranks:
        bf16, exact = _engines(gemv.gemv_q16_symm_slab,
                               (q1, sc, p, it, kt, lt), ms=ms)
        rd, rt = jgemv.gemv_q16_symm_slab(q1, sc, p, it, kt, lt, ms=ms)
        _check_bf16_class(bf16, exact, np.concatenate(
            [np.asarray(rd), np.asarray(rt)]))


def test_dual_general_inputs_bf16_class(lam_tpu_mxu):
    for q1, sc, pv, qv, _, _ in _grid_rect_ranks(
            1000, np.random.default_rng(42), small=False):
        bf16, exact = _engines(gemv.gemv_q16_dual, (q1, sc, pv, qv))
        rd, rt = jgemv.gemv_q16_dual(q1, sc, pv, qv)
        _check_bf16_class(bf16, exact, np.concatenate(
            [np.asarray(rd), np.asarray(rt)]))


# -- the control of kernel 18-bf16 (ops/probe.py) ----------------------------

# (ms, n) of tests/test_torch_dual_walk.py: one tile, mb < cb, mb > cb and a
# wider mb < cb; two garbage pad tiles and pad scales after the real ones
CONTROL_SHAPES = [(128, 128), (256, 512), (384, 256), (256, 640)]


def _garbage_rect(ms, n, seed):
    rng = np.random.default_rng(seed)
    mb, cb = ms // TB, n // TB
    real = mb * cb
    q1 = np.full(((real + 2) * TB, TB), 7, np.int16)
    q1[:real * TB] = rng.integers(-30000, 30001, (real * TB, TB))
    sc = np.full(real + 2, 3.0, np.float32)
    sc[:real] = 2.0 ** rng.integers(-16, -13, real)
    p = rng.standard_normal(n).astype(np.float32)
    q = rng.standard_normal(ms).astype(np.float32)
    return q1, sc, p, q, mb, cb


@pytest.mark.parametrize("ms,n", CONTROL_SHAPES)
def test_dual_bf16_control_matches_its_kernel_and_the_model(ms, n):
    """On the card the control is kernel 18-bf16's two-pass walk; on the
    CPU both take the plain bf16 walk: bitwise equal, and within 1e-5 of
    the numpy round-to-nearest-even model (f32 sums against f64)."""
    from lam_tpu_torch.ops import probe
    q1, sc, p, q, mb, cb = _garbage_rect(ms, n, seed=ms * 7 + n)
    args = tuple(map(_t, (q1, sc, p, q)))
    probe.reset_counters()
    gemv.reset_counters()
    yd, yt = probe.gemv_q16_dual_bf16_twopass(*args)
    counts = {**probe.counters(), **gemv.counters()}
    assert counts["gemv_q16_dual_bf16_twopass_plain"] == 1
    assert sum(counts.values()) == 1  # nothing launched, no other plain
    assert yd.shape == (ms,) and yt.shape == (n,)
    kd, kt = gemv.gemv_q16_dual_bf16(*args)
    assert torch.equal(yd, kd) and torch.equal(yt, kt)
    md, mt_ = _dual_model(q1, sc, p, q, mb, cb)
    assert _rel(yd.numpy(), md) <= 1e-5
    assert _rel(yt.numpy(), mt_) <= 1e-5


@pytest.mark.parametrize("edit,match", [
    (lambda a: (a[0].float(), *a[1:]), "int16"),
    (lambda a: (a[0], a[1][:-1], *a[2:]), "table shape"),
    (lambda a: (a[0][:TB], *a[1:]), "needs"),
    (lambda a: (*a[:2], a[2].to("meta"), a[3]), "expected"),
    (lambda a: (*a[:2], a[2].double(), a[3]), "float32"),
    (lambda a: (*a[:3], a[3][:-1]), "multiples of tb"),
])
def test_dual_bf16_control_refuses_what_the_kernel_refuses(edit, match):
    from lam_tpu_torch.ops import probe
    q1, sc, p, q, _, _ = _garbage_rect(256, 512, seed=4)
    args = edit(tuple(map(_t, (q1, sc, p, q))))
    probe.reset_counters()
    gemv.reset_counters()
    for fn in (gemv.gemv_q16_dual_bf16, probe.gemv_q16_dual_bf16_twopass):
        with pytest.raises(ValueError, match=match):
            fn(*args)
    assert not any(probe.counters().values())
    assert not any(gemv.counters().values())


# -- (e) irfq solves with the engine forced -----------------------------------

def _well_conditioned_system(n, seed):
    """A = H diag(d) H with one Householder reflection H and eigenvalues
    d = exp(U(-1, 1)) (condition number <= e^2), and a U(-1, 1) rhs."""
    rng = np.random.default_rng(seed)
    d = np.exp(rng.uniform(-1, 1, n))
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    h = np.eye(n) - 2 * np.outer(v, v)
    return (h * d) @ h, rng.uniform(-1, 1, n)


def test_irfq_facade_solve_with_bf16_engine(port_mxu, tmp_path):
    """Through the facade and the file format, n = 1000 (n_p = 1024, tb =
    512, T = 3 tiles stored padded to 8): the bf16 inner engine runs, the
    exact one does not, and the refinement reaches bench.py's TRUE 2e-9."""
    n = 1000
    a, b = _well_conditioned_system(n, seed=8)
    tio.write_matrix(str(tmp_path / "A.bin"), a)
    tio.write_matrix(str(tmp_path / "b.bin"), b)
    xs = {}
    for impl, inner in (("mxu", "gemv_q16_symm_bf16_plain"),
                        ("vpu", "gemv_q16_symm_plain")):
        gemv._Q16_IMPL = impl
        cg = ConjugateGradient(precision="irfq", device="cpu")
        cg.load_matrix_from_file(str(tmp_path / "A.bin"))
        cg.load_rhs_from_file(str(tmp_path / "b.bin"))
        gemv.reset_counters()
        assert cg.solve(max_iters=10000, rel_error=1e-9, warmup=False)
        counts = gemv.counters()
        x = np.asarray(cg.x, np.float64)[:n]
        assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) <= 2e-9
        assert counts[inner] >= cg.timings["num_iters"] > 0
        assert {k for k, v in counts.items() if v} == {
            inner, "gemv_fq_symm_plain"}
        xs[impl] = x
    assert _rel(xs["mxu"], xs["vpu"]) <= 1e-8


def test_bf16_engine_costs_cycles_at_small_n(port_mxu):
    """bench.py's spectrum (condition number up to e^7) at n = 1000: the
    bf16 inner operator's ~2^-9 error slows the refinement, so lam_tpu's 6
    cycles leave the exact engine's 383 inner iterations short and 30
    cycles take several times as many; the reason 'auto' keeps exact
    products below Q16_MXU_MIN_N (lam_tpu/ops/gemv.py:307-313)."""
    a, b = random_spd_system(1000, seed=25)
    op = DenseOperator.from_dense_fq(a, device="cpu")
    runs = {}
    for impl, cycles in (("vpu", 6), ("mxu", 6), ("mxu", 30)):
        gemv._Q16_IMPL = impl
        res = cg_solve_ir(op.as_f32(), op, b, max_iters=10000,
                          rel_error=1e-9, inner_floor=IRFQ_INNER_FLOOR,
                          max_cycles=cycles)
        x = res.x.numpy()[:1000]
        runs[impl, cycles] = (bool(res.converged), int(res.num_iters),
                              np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    assert runs["vpu", 6][0] and runs["vpu", 6][2] <= 2e-9
    assert not runs["mxu", 6][0] and runs["mxu", 6][2] > 1e-7
    assert runs["mxu", 30][0] and runs["mxu", 30][2] <= 2e-9
    assert runs["mxu", 30][1] > 2 * runs["vpu", 6][1]


def test_row_reads_past_2_gib_keep_their_offset(monkeypatch, tmp_path):
    """A rank of the band pairs reads its tile-rows at row indices taken
    from the int32 walk tables; at N=20000 the byte offset of row 15360
    (2.46e9) overflows int32 arithmetic. read_matrix_rows computes it in
    Python ints. This is its numpy branch; the native reader's offset is
    a uint64 (tests/test_torch_native.py)."""
    from lam_tpu_torch import _native_io
    monkeypatch.setattr(_native_io, "available", lambda: False)
    path = str(tmp_path / "A.bin")
    with open(path, "wb") as f:
        f.write(tio._HEADER.pack(20000, 20000))
    seen = {}

    def fromfile(p, dtype, count, offset):
        seen["offset"] = offset
        return np.zeros(count, dtype)

    monkeypatch.setattr(tio.np, "fromfile", fromfile)
    rows = tio.read_matrix_rows(path, np.int32(30) * 512, np.int32(2))
    assert rows.shape == (2, 20000)
    assert seen["offset"] == tio._HEADER.size + 15360 * 20000 * 8
