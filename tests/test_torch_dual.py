"""The port's dual matvecs (lam_tpu_torch/ops/gemv.py: gemv_f32_dual,
gemv_df64_dual, gemv_dfq_dual, gemv_q16_dual, gemv_fq_dual) and the
rectangle pack against lam_tpu's, on the CPU.

`pack_rect_host` is byte-equal to lam_tpu's. Each plain version gets the
same numpy-seeded inputs as lam_tpu's Pallas kernel in interpret mode, at
tb=128, rectangles (256, 512) and (256, 384), with 0 and 3 trailing pad
tiles (filled with garbage on the port's side: they must be inert).
Tolerances: the f32 and q16 kernels sum exact f32 products in another
order than lam_tpu's lane folds: rtol 2e-5, atol 1e-4 (lam_tpu's own
bound, tests/test_sharded2d_symm.py:48). The df64-class kernels compute
in native f64: <= 1e-13 relative l2 of a numpy f64 oracle of the STORED
values, and <= 1e-6 of lam_tpu's interpret-mode result, whose float-float
arithmetic XLA:CPU degrades (tests/test_sharded2d_symm.py:71-76). On a
CPU tensor a wrapper runs its plain version; the refusals carry lam_tpu's
messages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_tpu.ops import gemv as jgemv
from lam_tpu_torch.ops import gemv, layout
from lam_tpu_torch.precision import split_f64_host

TB = 128
SHAPES = [(256, 512), (256, 384)]
PADS = [0, 3]


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


def _join(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _case(ms, n, pad, seed):
    """A rectangle, its operands and its padded packs: (s, p, q, the f64
    pack with zero pad tiles)."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1, 1, (ms, n))
    return (s, rng.uniform(-1, 1, n), rng.uniform(-1, 1, ms),
            layout.pack_rect_host(s, TB, pad_tiles=pad))


def _garbage(x, real_tiles, scale=False):
    """x with its pad tiles (or pad scales) overwritten with finite
    garbage: a kernel that read them would show it."""
    y = np.array(x, copy=True)
    if scale:
        y[real_tiles:] = 3.0
    else:
        y[real_tiles * TB:] = 7
    return y


def _dense_of(buf, ms, n):
    """The (ms, n) rectangle of a row-major tile pack."""
    mb, cb = ms // TB, n // TB
    return (np.asarray(buf, np.float64)[:mb * cb * TB]
            .reshape(mb, cb, TB, TB).transpose(0, 2, 1, 3).reshape(ms, n))


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int16])
@pytest.mark.parametrize("pad", [0, 1, 3])
@pytest.mark.parametrize("shape", SHAPES + [(128, 128)])
def test_pack_rect_host_byte_equal_lam_tpu(shape, pad, dtype):
    rng = np.random.default_rng(2)
    s = (rng.uniform(-1, 1, shape) * 1000).astype(dtype)
    mine = layout.pack_rect_host(s, TB, pad_tiles=pad)
    ref = jgemv.pack_rect_host(s, TB, pad_tiles=pad)
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    assert mine.tobytes() == ref.tobytes()
    assert np.array_equal(_dense_of(mine, *shape), s.astype(np.float64))


@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("ms,n", SHAPES)
def test_gemv_f32_dual_plain_matches_lam_tpu(ms, n, pad):
    s, p, q, buf = _case(ms, n, pad, seed=0)
    buf32, p32, q32 = (x.astype(np.float32) for x in (buf, p, q))
    rd, rt = jgemv.gemv_f32_dual(jnp.asarray(buf32), jnp.asarray(p32),
                                 jnp.asarray(q32))
    mb_cb = (ms // TB) * (n // TB)
    before = gemv.gemv_f32_dual_plain.calls
    yd, yt = gemv.gemv_f32_dual(_t(_garbage(buf32, mb_cb)), _t(p32), _t(q32))
    assert gemv.gemv_f32_dual_plain.calls == before + 1  # the CPU path
    assert yd.shape == (ms,) and yt.shape == (n,)
    assert yd.dtype == yt.dtype == torch.float32
    np.testing.assert_allclose(yd.numpy(), np.asarray(rd), rtol=2e-5,
                               atol=1e-4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(rt), rtol=2e-5,
                               atol=1e-4)
    s32 = s.astype(np.float32).astype(np.float64)
    assert _rel(yd.numpy(), s32 @ p32.astype(np.float64)) <= 1e-6
    assert _rel(yt.numpy(), s32.T @ q32.astype(np.float64)) <= 1e-6


@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("ms,n", SHAPES)
def test_gemv_q16_dual_plain_matches_lam_tpu(ms, n, pad):
    s, p, q, buf = _case(ms, n, pad, seed=1)
    q1, _, _, s1, _, _ = layout.quantize_fq_tiles(buf, TB)
    p32, q32 = p.astype(np.float32), q.astype(np.float32)
    rd, rt = jgemv.gemv_q16_dual(jnp.asarray(q1), jnp.asarray(s1),
                                 jnp.asarray(p32), jnp.asarray(q32))
    mb_cb = (ms // TB) * (n // TB)
    yd, yt = gemv.gemv_q16_dual(_t(_garbage(q1, mb_cb)),
                                _t(_garbage(s1, mb_cb, scale=True)),
                                _t(p32), _t(q32))
    np.testing.assert_allclose(yd.numpy(), np.asarray(rd), rtol=2e-5,
                               atol=1e-4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(rt), rtol=2e-5,
                               atol=1e-4)
    stored = _dense_of(q1.astype(np.float64)
                       * np.repeat(s1.astype(np.float64), TB)[:, None], ms, n)
    assert _rel(yd.numpy(), stored @ p32.astype(np.float64)) <= 1e-6
    assert _rel(yt.numpy(), stored.T @ q32.astype(np.float64)) <= 1e-6
    assert _rel(stored, s) <= 1e-4  # ~2^-16 of each tile's largest entry


def _pairs(p, q):
    ph, pl = split_f64_host(p)
    qh, ql = split_f64_host(q)
    return (ph, pl, qh, ql), _join(ph, pl), _join(qh, ql)


def _check_df64_class(out, ref, stored, p64, q64, ms):
    """A df64-class dual result (yd_hi, yd_lo, yt_hi, yt_lo) against the
    f64 oracle of the stored rectangle and lam_tpu's interpret result."""
    assert all(x.dtype == torch.float32 for x in out)
    yd = _join(out[0].numpy(), out[1].numpy())
    yt = _join(out[2].numpy(), out[3].numpy())
    assert yd.shape == (ms,) and yt.shape == p64.shape
    assert _rel(yd, stored @ p64) <= 1e-13
    assert _rel(yt, stored.T @ q64) <= 1e-13
    assert _rel(yd, _join(ref[0], ref[1])) <= 1e-6
    assert _rel(yt, _join(ref[2], ref[3])) <= 1e-6


@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("ms,n", SHAPES)
def test_gemv_df64_dual_plain_matches_f64(ms, n, pad):
    s, p, q, buf = _case(ms, n, pad, seed=3)
    hi, lo = split_f64_host(buf)
    vecs, p64, q64 = _pairs(p, q)
    ref = jgemv.gemv_df64_dual(jnp.asarray(hi), jnp.asarray(lo),
                               *map(jnp.asarray, vecs))
    mb_cb = (ms // TB) * (n // TB)
    out = gemv.gemv_df64_dual(_t(_garbage(hi, mb_cb)),
                              _t(_garbage(lo, mb_cb)), *map(_t, vecs))
    stored = _dense_of(_join(hi, lo), ms, n)
    assert _rel(stored, s) <= 1e-14  # the pair keeps ~48 bits
    _check_df64_class(out, ref, stored, p64, q64, ms)


@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("ms,n", SHAPES)
def test_gemv_dfq_dual_plain_matches_f64(ms, n, pad):
    s, p, q, buf = _case(ms, n, pad, seed=4)
    hi, lo = split_f64_host(buf)
    loq, sc = layout.quantize_lo_tiles(lo, TB)
    jq, jsc = jgemv.quantize_lo_tiles(lo, TB)
    assert np.array_equal(loq, jq) and np.array_equal(sc, jsc)
    vecs, p64, q64 = _pairs(p, q)
    ref = jgemv.gemv_dfq_dual(jnp.asarray(hi), jnp.asarray(loq),
                              jnp.asarray(sc), *map(jnp.asarray, vecs))
    mb_cb = (ms // TB) * (n // TB)
    out = gemv.gemv_dfq_dual(_t(_garbage(hi, mb_cb)),
                             _t(_garbage(loq, mb_cb)),
                             _t(_garbage(sc, mb_cb, scale=True)),
                             *map(_t, vecs))
    stored = _dense_of(hi.astype(np.float64) + loq.astype(np.float64)
                       * np.repeat(sc.astype(np.float64), TB)[:, None], ms, n)
    _check_df64_class(out, ref, stored, p64, q64, ms)
    assert _rel(stored, s) <= 1e-11  # the dfq storage bound


@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("ms,n", SHAPES)
def test_gemv_fq_dual_plain_matches_f64(ms, n, pad):
    s, p, q, buf = _case(ms, n, pad, seed=5)
    fq = layout.quantize_fq_tiles(buf, TB)
    vecs, p64, q64 = _pairs(p, q)
    ref = jgemv.gemv_fq_dual(*map(jnp.asarray, fq), *map(jnp.asarray, vecs))
    mb_cb = (ms // TB) * (n // TB)
    out = gemv.gemv_fq_dual(
        *(_t(_garbage(x, mb_cb)) for x in fq[:3]),
        *(_t(_garbage(x, mb_cb, scale=True)) for x in fq[3:]),
        *map(_t, vecs))
    stored = _dense_of(sum(
        x.astype(np.float64) * np.repeat(sc.astype(np.float64), TB)[:, None]
        for x, sc in zip(fq[:3], fq[3:])), ms, n)
    _check_df64_class(out, ref, stored, p64, q64, ms)
    assert _rel(stored, s) <= 1e-12  # the fq storage bound


def test_dual_vectors_may_be_offset_views():
    """The operator hands the kernels halves of a block: views at an
    element offset, contiguous, not copies."""
    ms, n = 256, 512
    s, p, q, buf = _case(ms, n, 0, seed=6)
    buf32 = _t(buf.astype(np.float32))
    whole = _t(np.concatenate([q, q]).astype(np.float32))
    p32 = _t(p.astype(np.float32))
    yd, yt = gemv.gemv_f32_dual(buf32, p32, whole[ms:])
    zd, zt = gemv.gemv_f32_dual(buf32, p32, whole[ms:].clone())
    assert torch.equal(yd, zd) and torch.equal(yt, zt)
    with pytest.raises(ValueError, match="contiguous"):
        gemv.gemv_f32_dual(buf32, p32, whole[::2])


def _zeros(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def test_dual_kernels_reject_bad_geometry():
    one_tile = _zeros((TB, TB))
    p2, q1 = _zeros(2 * TB), _zeros(TB)
    # lam_tpu's own case (tests/test_sharded2d_symm.py:79): 1 tile, 2 needed
    with pytest.raises(ValueError, match="packed buffer has 1 tiles, "
                       r"rectangle \(128, 256\) needs 2"):
        gemv.gemv_f32_dual(one_tile, p2, q1)
    with pytest.raises(ValueError, match="packed buffer has"):
        jgemv.gemv_f32_dual(jnp.zeros((TB, TB), jnp.float32),
                            jnp.zeros(2 * TB, jnp.float32),
                            jnp.zeros(TB, jnp.float32))
    with pytest.raises(ValueError, match="packed buffer has"):
        gemv.gemv_f32_dual_plain(one_tile, p2, q1)
    with pytest.raises(ValueError, match="packed tile width 96 must be a "
                       "power-of-two multiple of 128"):
        gemv.gemv_f32_dual(_zeros((96, 96)), _zeros(96), _zeros(96))
    with pytest.raises(ValueError, match="n=200, ms=128 and packed rows 128 "
                       "must be multiples of tb=128"):
        gemv.gemv_f32_dual(one_tile, _zeros(200), q1)
    with pytest.raises(ValueError, match="must be float32"):
        gemv.gemv_f32_dual(one_tile.double(), q1, q1)
    with pytest.raises(ValueError, match="must be int16"):
        gemv.gemv_q16_dual(one_tile, _zeros(1), q1, q1)
    with pytest.raises(ValueError, match="q_ has shape"):
        gemv.gemv_f32_dual(one_tile, q1, one_tile)


def test_dual_kernels_reject_bad_planes_and_scales():
    two = _zeros((2 * TB, TB))
    twoq = _zeros((2 * TB, TB), torch.int16)
    v = _zeros(TB)
    pair = (v, v, v, v)
    with pytest.raises(ValueError, match=r"scale table shape \(1,\) != "
                       r"\(2,\)"):
        gemv.gemv_q16_dual(twoq, _zeros(1), v, v)
    with pytest.raises(ValueError, match=r"scale table shape \(3,\) != "
                       r"\(2,\)"):
        gemv.gemv_dfq_dual(two, twoq, _zeros(3), *pair)
    with pytest.raises(ValueError, match=r"s2 table shape \(1,\) != \(2,\)"):
        gemv.gemv_fq_dual(twoq, twoq, twoq, _zeros(2), _zeros(1), _zeros(2),
                          *pair)
    with pytest.raises(ValueError, match="quantized lo plane shape"):
        gemv.gemv_dfq_dual(two, twoq[:TB], _zeros(2), *pair)
    with pytest.raises(ValueError, match="lo plane must match the hi plane"):
        gemv.gemv_df64_dual(two, two[:64], *pair)
    with pytest.raises(ValueError, match="q3 plane shape"):
        gemv.gemv_fq_dual(twoq, twoq, twoq[:64], _zeros(2), _zeros(2),
                          _zeros(2), *pair)
    with pytest.raises(ValueError, match="q_hi .* and q_lo .* differ"):
        gemv.gemv_df64_dual(two, two, v, v, v, _zeros(2 * TB))
    with pytest.raises(ValueError, match="comp='half'"):
        gemv.gemv_df64_dual(two, two, *pair, comp="half")
    for comp in (None, "nolow", "full"):  # native f64: comp selects nothing
        out = gemv.gemv_df64_dual(two, two, *pair, comp=comp)
        assert all(not x.any() for x in out)


def test_dual_kernels_refuse_the_broadcast_tile():
    """lam_tpu's generate mode hands the dual kernels ONE (tb, tb) zero
    tile for the lo or q2/q3 plane: routed to the broadcast modes (their
    plain versions here). What they refuse, with lam_tpu's words: a shape
    that is neither form, and tiles beside a q1 that is one tile itself."""
    two = _zeros((2 * TB, TB))
    twoq = _zeros((2 * TB, TB), torch.int16)
    tile, tileq = _zeros((TB, TB)), _zeros((TB, TB), torch.int16)
    v = _zeros(TB)
    pair = (v, v, v, v)
    scales = (_zeros(2), _zeros(2), _zeros(2))
    gemv.reset_counters()
    gemv.gemv_df64_dual(two, tile, *pair)
    for planes in ((twoq, tileq, twoq), (twoq, twoq, tileq)):
        gemv.gemv_fq_dual(*planes, *scales, *pair)
    counts = gemv.counters()
    assert counts["gemv_df64_dual_bcast_plain"] == 1
    assert counts["gemv_fq_dual_bcast_plain"] == 2
    with pytest.raises(ValueError, match="broadcast"):
        gemv.gemv_df64_dual(two, _zeros((TB, TB // 2)), *pair)
    with pytest.raises(ValueError, match="plane shape"):
        gemv.gemv_fq_dual(twoq, _zeros((3 * TB, TB), torch.int16), twoq,
                          *scales, *pair)
    with pytest.raises(ValueError, match="plane shape"):
        gemv.gemv_fq_dual(tileq, twoq, tileq, _zeros(1), _zeros(1),
                          _zeros(1), *pair)


def test_dual_kernels_are_registered():
    from lam_tpu_torch import ops
    names = ["gemv_f32_dual", "gemv_df64_dual", "gemv_dfq_dual",
             "gemv_q16_dual", "gemv_fq_dual"]
    kernels = [fn.__name__ for fn in ops.KERNELS]
    plain = [fn.__name__ for fn in ops.PLAIN]
    for name in names:
        assert name in kernels and name + "_plain" in plain
        assert name in ops.counters() and name + "_plain" in ops.counters()
    assert len(gemv.KERNELS) == len(gemv.PLAIN) == 35
    from lam_tpu_torch.ops import _build
    for name in names:
        assert "lam_" + name in _build.SIGNATURES
    src = (_build.CSRC / "gemv_symm.cu").read_text()
    for name in names:
        assert f'extern "C" int lam_{name}(' in src
