"""The control of kernel 20 (lam_tpu_torch/ops/probe.py:
laplace5_f32_halo_twopass) against lam_tpu's laplace5_f32_halo, on the CPU.

On the card, kernel 20 (`stencil.laplace5_f32_halo`) runs in one launch,
its blocks' partial dots summed by the block that finishes last, and its
control in the two launches it replaced; the card tests hold the two bit
for bit. On the CPU the control takes the plain version. Here the same
numpy-seeded inputs go through lam_tpu's Pallas kernel in interpret mode
(as tests/test_heat.py runs it): a zero-edged grid and halo shards of a
row-sharded grid (non-zero edge rows, a row limit below H or at it, a
column limit below W), with H a multiple of 8 but not of 32, the small
shards' row tile. Tolerances: y takes the same f32 roundings in the same
order as lam_tpu's, so it is held to 0 against the plain version and to
1e-6 against lam_tpu's; p . y is a sum in another order: 1e-6 relative to
lam_tpu's and to a numpy f64 oracle. The control equals the kernel's
wrapper bit for bit (the same plain computation) and refuses what the
wrapper refuses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_tpu.ops import stencil as jst
from lam_tpu_torch import ops
from lam_tpu_torch.ops import probe, stencil


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _oracle(p, up, dn, nrows, nxi):
    """The masked stencil and p . y in float64."""
    g = p.astype(np.float64)
    full = 4 * g
    full[1:] -= g[:-1]
    full[0] -= up[0]
    full[:-1] -= g[1:]
    full[-1] -= dn[0]
    full[:, 1:] -= g[:, :-1]
    full[:, :-1] -= g[:, 1:]
    y = np.zeros_like(full)
    y[:nrows, :nxi] = full[:nrows, :nxi]
    return y, float((g * y).sum())


def _calls():
    counts = {**probe.counters(), **ops.counters()}
    return {k: counts[k] for k in (
        "laplace5_f32_halo_twopass", "laplace5_f32_halo_twopass_plain",
        "laplace5_f32_halo", "laplace5_f32_halo_plain")}


# (H, W, nrows, nxi, tbr, halo): the demo's zero-edged form at a small
# grid (padded_hw(98, 250): H = 104, one row tile), and shards of a
# row-sharded grid with live edge rows
CASES = [(104, 256, 98, 250, 104, False), (40, 384, 37, 300, 8, True),
         (24, 128, 24, 128, 8, True), (72, 256, 72, 200, 24, True),
         (200, 512, 190, 511, 40, True)]


@pytest.mark.parametrize("H,W,nrows,nxi,tbr,halo", CASES)
def test_stencil_control_matches_lam_tpu(H, W, nrows, nxi, tbr, halo):
    assert H % 8 == 0 and H % 32
    rng = np.random.default_rng(H * W + nrows)
    if halo:
        p, up, dn = (rng.standard_normal(s).astype(np.float32)
                     for s in ((H, W), (1, W), (1, W)))
    else:
        p = np.zeros((H, W), np.float32)
        p[:nrows, :nxi] = rng.standard_normal((nrows, nxi))
        up = dn = np.zeros((1, W), np.float32)
    args = tuple(map(torch.from_numpy, (p, up, dn)))
    probe.reset_counters()
    ops.reset_counters()
    y, d = probe.laplace5_f32_halo_twopass(*args, nrows, nxi=nxi, tbr=tbr)
    assert _calls() == {"laplace5_f32_halo_twopass": 0,
                        "laplace5_f32_halo_twopass_plain": 1,
                        "laplace5_f32_halo": 0, "laplace5_f32_halo_plain": 0}
    assert y.dtype == d.dtype == torch.float32 and d.dim() == 0
    y_plain, d_plain = stencil.laplace5_f32_halo_plain(*args, nrows, nxi=nxi)
    assert torch.equal(y, y_plain) and torch.equal(d, d_plain)
    yj, dj = jst.laplace5_f32_halo(*map(jnp.asarray, (p, up, dn)), nrows,
                                   nxi=nxi, tbr=tbr)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0, atol=1e-6)
    assert not y[nrows:].any() and not y[:, nxi:].any()
    y64, d64 = _oracle(p, up, dn, nrows, nxi)
    np.testing.assert_allclose(y.numpy(), y64, rtol=0, atol=1e-5)
    assert abs(float(d) - float(dj)) <= 1e-6 * abs(float(dj))
    assert abs(float(d) - d64) <= 1e-6 * abs(d64)
    yk, dk = stencil.laplace5_f32_halo(*args, nrows, nxi=nxi, tbr=tbr)
    assert torch.equal(y, yk) and torch.equal(d, dk)


def _valid():
    W = 256
    return (torch.zeros(64, W), torch.zeros(1, W), torch.zeros(1, W))


@pytest.mark.parametrize("edit,tbr,match", [
    (lambda a: (a[0].double(), *a[1:]), 8, "float32"),
    (lambda a: (a[0].t().contiguous().t(), *a[1:]), 8, "contiguous"),
    (lambda a: a, 48, "multiple"),
    (lambda a: (a[0][:, :200].contiguous(), a[1][:, :200].contiguous(),
                a[2][:, :200].contiguous()), 8, "multiple"),
    (lambda a: (a[0], a[1][:, :128].contiguous(), a[2]), 8, "up_edge"),
    (lambda a: (a[0], a[1], a[2].double()), 8, "float32"),
    (lambda a: (a[0], a[1].to("meta"), a[2]), 8, "expected"),
    (lambda a: (a[0][0], *a[1:]), 8, "shape"),
])
def test_stencil_control_refuses_what_the_kernel_refuses(edit, tbr, match):
    args = edit(_valid())
    probe.reset_counters()
    ops.reset_counters()
    for fn in (stencil.laplace5_f32_halo, probe.laplace5_f32_halo_twopass):
        with pytest.raises(ValueError, match=match):
            fn(*args, 64, nxi=256, tbr=tbr)
    assert not any(probe.counters().values())
    assert not any(ops.counters().values())
