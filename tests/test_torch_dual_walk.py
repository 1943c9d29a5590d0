"""The controls of kernels 18 and 19 (lam_tpu_torch/ops/probe.py:
gemv_q16_dual_twopass, gemv_fq_dual_twopass) against lam_tpu's
gemv_q16_dual and gemv_fq_dual, on the CPU.

On the card, kernels 18 (`gemv.gemv_q16_dual`, exact products) and 19
(`gemv.gemv_fq_dual`) run the strip walk of csrc/strip_walk.cuh and their
controls the two-pass walk; the card tests hold the two bit for bit. On the
CPU each control takes its plain version. Here the same numpy-seeded inputs
go through lam_tpu's Pallas kernel in interpret mode, at tb=128, on
rectangles of one tile, of fewer row tiles than column tiles and of more,
with trailing pad tiles (filled with garbage on the port's side: they must
be inert). Tolerances: the q16 control sums exact f32 products in another
order than lam_tpu's lane folds: 1e-6 relative l2. The fq control computes
in native f64: <= 1e-13 relative l2 of a numpy f64 oracle of the STORED
values, and <= 1e-6 of lam_tpu's interpret-mode pair, whose float-float
arithmetic XLA:CPU degrades (tests/test_torch_dual.py). Each control equals
its kernel's wrapper bit for bit (the same plain computation), and refuses
what the wrapper refuses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_tpu.ops import gemv as jgemv
from lam_tpu_torch import ops
from lam_tpu_torch.ops import gemv, layout, probe
from lam_tpu_torch.precision import split_f64_host

TB = 128
PAD = 2
# (ms, n): one tile, mb < cb, mb > cb, and a wider mb < cb
SHAPES = [(128, 128), (256, 512), (384, 256), (256, 640)]


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


def _garbage(x, real_tiles, scale=False):
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


def _case(ms, n, seed):
    """The fq pack of a random (ms, n) rectangle with PAD pad tiles, its
    stored f64 rectangle, and p, q."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1, 1, (ms, n))
    fq = layout.quantize_fq_tiles(layout.pack_rect_host(s, TB, pad_tiles=PAD),
                                  TB)
    stored = _dense_of(sum(
        x.astype(np.float64) * np.repeat(sc.astype(np.float64), TB)[:, None]
        for x, sc in zip(fq[:3], fq[3:])), ms, n)
    return fq, stored, rng.uniform(-1, 1, n), rng.uniform(-1, 1, ms)


def _control_calls(name):
    """The launches and plain calls of one control and of its kernel."""
    counts = {**probe.counters(), **ops.counters()}
    return {k: counts[k] for k in (
        f"{name}_twopass", f"{name}_twopass_plain", name, f"{name}_plain")}


@pytest.mark.parametrize("ms,n", SHAPES)
def test_q16_dual_control_matches_lam_tpu(ms, n, monkeypatch):
    monkeypatch.setattr(gemv, "_Q16_IMPL", "vpu")
    fq, _, p, q = _case(ms, n, seed=ms + n)
    q1, s1 = fq[0], fq[3]
    p32, q32 = p.astype(np.float32), q.astype(np.float32)
    real = (ms // TB) * (n // TB)
    args = (_t(_garbage(q1, real)), _t(_garbage(s1, real, scale=True)),
            _t(p32), _t(q32))
    probe.reset_counters()
    ops.reset_counters()
    yd, yt = probe.gemv_q16_dual_twopass(*args)
    assert _control_calls("gemv_q16_dual") == {
        "gemv_q16_dual_twopass": 0, "gemv_q16_dual_twopass_plain": 1,
        "gemv_q16_dual": 0, "gemv_q16_dual_plain": 0}
    assert yd.shape == (ms,) and yt.shape == (n,)
    assert yd.dtype == yt.dtype == torch.float32
    rd, rt = jgemv.gemv_q16_dual(jnp.asarray(q1), jnp.asarray(s1),
                                 jnp.asarray(p32), jnp.asarray(q32))
    assert _rel(yd.numpy(), rd) <= 1e-6
    assert _rel(yt.numpy(), rt) <= 1e-6
    zd, zt = gemv.gemv_q16_dual(*args)
    assert torch.equal(yd, zd) and torch.equal(yt, zt)


@pytest.mark.parametrize("ms,n", SHAPES)
def test_fq_dual_control_matches_f64_and_lam_tpu(ms, n):
    fq, stored, p, q = _case(ms, n, seed=7 * ms + n)
    ph, pl = split_f64_host(p)
    qh, ql = split_f64_host(q)
    real = (ms // TB) * (n // TB)
    args = (*(_t(_garbage(x, real)) for x in fq[:3]),
            *(_t(_garbage(x, real, scale=True)) for x in fq[3:]),
            *map(_t, (ph, pl, qh, ql)))
    probe.reset_counters()
    ops.reset_counters()
    out = probe.gemv_fq_dual_twopass(*args)
    assert _control_calls("gemv_fq_dual") == {
        "gemv_fq_dual_twopass": 0, "gemv_fq_dual_twopass_plain": 1,
        "gemv_fq_dual": 0, "gemv_fq_dual_plain": 0}
    assert all(x.dtype == torch.float32 for x in out)
    yd = out[0].double().numpy() + out[1].double().numpy()
    yt = out[2].double().numpy() + out[3].double().numpy()
    p64 = ph.astype(np.float64) + pl
    q64 = qh.astype(np.float64) + ql
    assert _rel(yd, stored @ p64) <= 1e-13
    assert _rel(yt, stored.T @ q64) <= 1e-13
    ref = jgemv.gemv_fq_dual(*map(jnp.asarray, fq),
                             *map(jnp.asarray, (ph, pl, qh, ql)))
    ref = [np.asarray(x, np.float64) for x in ref]
    assert _rel(yd, ref[0] + ref[1]) <= 1e-6
    assert _rel(yt, ref[2] + ref[3]) <= 1e-6
    again = gemv.gemv_fq_dual(*args)
    assert all(torch.equal(u, v) for u, v in zip(out, again))


def _refusals(ms=256, n=512):
    """(q16 args, fq args) of a valid CPU rectangle."""
    fq, _, p, q = _case(ms, n, seed=3)
    ph, pl = split_f64_host(p)
    qh, ql = split_f64_host(q)
    return ((_t(fq[0]), _t(fq[3]), _t(ph), _t(qh)),
            (*map(_t, fq), *map(_t, (ph, pl, qh, ql))))


@pytest.mark.parametrize("what,edit,error,match", [
    ("q16", lambda a: (a[0].float(), *a[1:]), ValueError, "int16"),
    ("q16", lambda a: (a[0], a[1][:-1], *a[2:]), ValueError, "table shape"),
    ("q16", lambda a: (a[0][:128], *a[1:]), ValueError, "needs"),
    ("q16", lambda a: (*a[:2], a[2].to("meta"), a[3]), ValueError,
     "expected"),
    ("q16", lambda a: (*a[:2], a[2].double(), a[3]), ValueError, "float32"),
    ("fq", lambda a: (a[0], a[1][:2 * TB], *a[2:]), ValueError,
     "plane shape"),
    ("fq", lambda a: (*a[:4], a[4][:-1], *a[5:]), ValueError, "table shape"),
    ("fq", lambda a: (*a[:7], a[7][:-1], *a[8:]), ValueError, "differ"),
    ("fq", lambda a: (*a[:6], a[6][::2].contiguous(), *a[7:]), ValueError,
     "differ"),
    ("fq", lambda a: (*a[:8], a[8].to("meta"), a[9]), ValueError,
     "expected"),
])
def test_controls_refuse_what_their_kernels_refuse(what, edit, error, match):
    q16, fq = _refusals()
    args = edit(q16 if what == "q16" else fq)
    name = "gemv_q16_dual" if what == "q16" else "gemv_fq_dual"
    probe.reset_counters()
    ops.reset_counters()
    for fn in (getattr(gemv, name), getattr(probe, f"{name}_twopass")):
        with pytest.raises(error, match=match):
            fn(*args)
    assert not any(probe.counters().values())
    assert not any(ops.counters().values())


def test_fq_control_refuses_the_broadcast_tiles_its_kernel_routes():
    """The two-pass control reads full q2/q3 planes only: one (tb, tb)
    tile, which gemv_fq_dual hands to its broadcast mode, is refused there
    and nothing runs."""
    fq = list(_refusals()[1])
    fq[1] = fq[1][:TB].contiguous()
    probe.reset_counters()
    ops.reset_counters()
    gemv.gemv_fq_dual(*fq)
    assert ops.counters()["gemv_fq_dual_bcast_plain"] == 1
    ops.reset_counters()
    with pytest.raises(ValueError, match="gemv_fq_dual_bcast"):
        probe.gemv_fq_dual_twopass(*fq)
    assert not any(probe.counters().values())
    assert not any(ops.counters().values())
