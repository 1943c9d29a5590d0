"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: skipped where torch.cuda is unavailable. On a machine
with an H100 (and no JAX) run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest` because tests/conftest.py configures JAX). The shapes
are the main path's: tb=512 tiles, n=2048 (4 row tiles) and n=10240
(the N=10000 bench system padded, 20 row tiles). The q16 and fq kernels
read the port's own fq pack, stored padded (T=10 -> 16 tiles at n=2048,
T=210 -> 216 at n=10240); the dfq kernel the port's own dfq pack (exactly
T tiles). The dense kernels take the full square and a row block of a
matrix that is not symmetric; kernels 4 and 5 (the dense_stream walk) also
the edges of its row partition and the ring's column blocks, equal bit for
bit to the dense_rows walk on the same bytes, and their SASS the TMA bulk
copy. The stencil kernel takes padded grids up
to the heat demo's 998 x 1198 interior (1024 x 1280), with zero edges and
with the non-zero edge rows of a row-sharded grid.
"""

import numpy as np
import pytest
import torch

from lam_tpu_torch import ops
from lam_tpu_torch.ops import gemv, layout, stencil
from lam_tpu_torch.parallel import mesh as pmesh
from lam_tpu_torch.parallel import pcg, pcg_symm
from lam_tpu_torch.precision import split_f64_host
from lam_tpu_torch.solver.operators import _host_pack_tri

pytestmark = pytest.mark.cuda

SIZES = [(2048, 2048), (10000, 10240)]  # (n, padded n)


def _system(n, n_p, seed):
    """Packed planes of a random symmetric n x n matrix zero-padded to
    n_p, and a (hi, lo) operand vector, from a numpy seed."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, size=(n, n))
    a = np.zeros((n_p, n_p))
    a[:n, :n] = m + m.T
    p = np.zeros(n_p)
    p[:n] = rng.uniform(-1, 1, size=n)
    hi, lo = split_f64_host(a)
    ph, pl = split_f64_host(p)
    dev = torch.device("cuda")
    tb = layout.SYMM_TB
    planes = [torch.from_numpy(layout.pack_tri_host(x, tb)).to(dev)
              for x in (hi, lo)]
    return a, planes, torch.from_numpy(ph).to(dev), torch.from_numpy(pl).to(dev)


def _rel(y, ref):
    return float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))


@pytest.mark.parametrize("n,n_p", SIZES)
def test_gemv_f32_symm_kernel_matches_plain(n, n_p):
    a, (hi, _), ph, _ = _system(n, n_p, seed=n)
    gemv.reset_counters()
    y = gemv.gemv_f32_symm(hi, ph)
    torch.cuda.synchronize()
    assert gemv.counters()["gemv_f32_symm"] == 1
    y_plain = gemv.gemv_f32_symm_plain(hi, ph)
    oracle = torch.mv(torch.from_numpy(a.astype(np.float32)).cuda().double(),
                      ph.double())
    # f32 accumulation in two different orders: rounding-level agreement
    assert _rel(y, y_plain) <= 1e-5
    assert _rel(y.double(), oracle) <= 1e-5
    assert _rel(y_plain.double(), oracle) <= 1e-5
    assert torch.count_nonzero(y[n:]) == 0
    # fixed-order reduction: bitwise repeatable
    assert torch.equal(y, gemv.gemv_f32_symm(hi, ph))


@pytest.mark.parametrize("n,n_p", SIZES)
def test_gemv_df64_symm_kernel_matches_f64(n, n_p):
    a, (hi, lo), ph, pl = _system(n, n_p, seed=n + 1)
    gemv.reset_counters()
    yh, yl = gemv.gemv_df64_symm(hi, lo, ph, pl)
    torch.cuda.synchronize()
    assert gemv.counters()["gemv_df64_symm"] == 1
    y = yh.double() + yl.double()
    p = ph.double() + pl.double()
    oracle = torch.mv(torch.from_numpy(a).cuda(), p)
    # native f64 accumulation; the f32 (hi, lo) split of the result keeps
    # ~2^-48 of it
    assert _rel(y, oracle) <= 1e-13
    ph_, pl_ = gemv.gemv_df64_symm_plain(hi, lo, ph, pl)
    assert _rel(ph_.double() + pl_.double(), oracle) <= 1e-13
    assert torch.count_nonzero(yh[n:]) == 0
    assert torch.count_nonzero(yl[n:]) == 0
    yh2, yl2 = gemv.gemv_df64_symm(hi, lo, ph, pl)
    assert torch.equal(yh, yh2) and torch.equal(yl, yl2)


def test_kernel_rejects_other_tile_width():
    hi = torch.zeros(10 * 128, 128, device="cuda")
    p = torch.zeros(512, device="cuda")
    with pytest.raises(ValueError, match="tb=512"):
        gemv.gemv_f32_symm(hi, p)


def _fq_system(n, n_p, seed):
    """The fq pack (on the card) of a random symmetric n x n matrix with a
    zero diagonal, its f64 original zero-padded to n_p (on the card), and
    an operand vector padded with zeros."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, size=(n, n))
    a = m + m.T
    np.fill_diagonal(a, 0.0)
    bufs = [torch.from_numpy(x).cuda()
            for x in _host_pack_tri(a, "fq", layout.SYMM_TB)]
    a_p = torch.zeros(n_p, n_p, dtype=torch.float64, device="cuda")
    a_p[:n, :n] = torch.from_numpy(a).cuda()
    p = np.zeros(n_p)
    p[:n] = rng.uniform(-1, 1, size=n)
    return bufs, a_p, p


def _dense_of(tiles, nblk):
    """Full symmetric matrix of walk-order tiles (T, tb, tb)."""
    tb = tiles.shape[1]
    out = torch.zeros(nblk * tb, nblk * tb, dtype=tiles.dtype,
                      device=tiles.device)
    for t, (i, k) in enumerate(zip(*layout._symm_tables(nblk))):
        out[i * tb:(i + 1) * tb, k * tb:(k + 1) * tb] = tiles[t]
        if k < i:
            out[k * tb:(k + 1) * tb, i * tb:(i + 1) * tb] = tiles[t].T
    return out


@pytest.mark.parametrize("n,n_p", SIZES)
def test_gemv_q16_symm_kernel_matches_plain(n, n_p):
    bufs, _, p = _fq_system(n, n_p, seed=n + 2)
    q1, s1 = bufs[0], bufs[3]
    nblk = n_p // layout.SYMM_TB
    T = layout.tri_tile_count(nblk)
    assert q1.shape[0] == layout.padded_tri_tile_count(nblk) * 512 > T * 512
    pf = torch.from_numpy(p.astype(np.float32)).cuda()
    gemv.reset_counters()
    y = gemv.gemv_q16_symm(q1, s1, pf)
    torch.cuda.synchronize()
    assert gemv.counters()["gemv_q16_symm"] == 1
    y_plain = gemv.gemv_q16_symm_plain(q1, s1, pf)
    tiles = (q1[:T * 512].double().reshape(T, 512, 512)
             * s1[:T].double()[:, None, None])
    oracle = torch.mv(_dense_of(tiles, nblk), pf.double())
    # f32 accumulation in two different orders: rounding-level agreement
    assert _rel(y, y_plain) <= 1e-5
    assert _rel(y.double(), oracle) <= 1e-5
    assert _rel(y_plain.double(), oracle) <= 1e-5
    assert torch.count_nonzero(y[n:]) == 0
    # fixed-order reduction: bitwise repeatable
    assert torch.equal(y, gemv.gemv_q16_symm(q1, s1, pf))


@pytest.mark.parametrize("n,n_p", SIZES)
def test_gemv_fq_symm_kernel_matches_f64(n, n_p):
    bufs, a_p, p = _fq_system(n, n_p, seed=n + 3)
    nblk = n_p // layout.SYMM_TB
    T = layout.tri_tile_count(nblk)
    ph, pl = (torch.from_numpy(x).cuda() for x in split_f64_host(p))
    gemv.reset_counters()
    yh, yl = gemv.gemv_fq_symm(*bufs[:6], ph, pl)
    torch.cuda.synchronize()
    assert gemv.counters()["gemv_fq_symm"] == 1
    y = yh.double() + yl.double()
    pp = ph.double() + pl.double()
    tiles = sum(q[:T * 512].double().reshape(T, 512, 512)
                * s[:T].double()[:, None, None]
                for q, s in zip(bufs[:3], bufs[3:6]))
    oracle = torch.mv(_dense_of(tiles, nblk), pp)
    # native f64 over the exactly rebuilt cascade, returned as an f32 split
    assert _rel(y, oracle) <= 1e-13
    qh, ql = gemv.gemv_fq_symm_plain(*bufs[:6], ph, pl)
    assert _rel(qh.double() + ql.double(), oracle) <= 1e-13
    # the ~2^-48 storage bound against the original matrix
    assert _rel(y, torch.mv(a_p, pp)) <= 1e-12
    assert torch.count_nonzero(yh[n:]) == 0
    assert torch.count_nonzero(yl[n:]) == 0
    yh2, yl2 = gemv.gemv_fq_symm(*bufs[:6], ph, pl)
    assert torch.equal(yh, yh2) and torch.equal(yl, yl2)


def _dfq_system(n, n_p, seed):
    """The dfq pack (on the card) of a random symmetric n x n matrix with
    a zero diagonal, its f64 original zero-padded to n_p (on the card),
    and an operand vector padded with zeros."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, size=(n, n))
    a = m + m.T
    np.fill_diagonal(a, 0.0)
    bufs = [torch.from_numpy(x).cuda()
            for x in _host_pack_tri(a, "dfq", layout.SYMM_TB)]
    a_p = torch.zeros(n_p, n_p, dtype=torch.float64, device="cuda")
    a_p[:n, :n] = torch.from_numpy(a).cuda()
    p = np.zeros(n_p)
    p[:n] = rng.uniform(-1, 1, size=n)
    return bufs, a_p, p


@pytest.mark.parametrize("n,n_p", SIZES)
def test_gemv_dfq_symm_kernel_matches_f64(n, n_p):
    bufs, a_p, p = _dfq_system(n, n_p, seed=n + 4)
    hi, loq, sc = bufs[:3]
    nblk = n_p // layout.SYMM_TB
    T = layout.tri_tile_count(nblk)
    assert hi.shape[0] == T * 512 and sc.shape == (T,)
    ph, pl = (torch.from_numpy(x).cuda() for x in split_f64_host(p))
    gemv.reset_counters()
    yh, yl = gemv.gemv_dfq_symm(hi, loq, sc, ph, pl)
    torch.cuda.synchronize()
    assert gemv.counters()["gemv_dfq_symm"] == 1
    y = yh.double() + yl.double()
    pp = ph.double() + pl.double()
    tiles = (hi.double().reshape(T, 512, 512)
             + loq.double().reshape(T, 512, 512)
             * sc.double()[:, None, None])
    oracle = torch.mv(_dense_of(tiles, nblk), pp)
    # native f64 over the exactly formed hi + loq * sc, as an f32 split
    assert _rel(y, oracle) <= 1e-13
    qh, ql = gemv.gemv_dfq_symm_plain(hi, loq, sc, ph, pl)
    assert _rel(qh.double() + ql.double(), oracle) <= 1e-13
    # the ~2^-39 storage bound against the original matrix
    assert _rel(y, torch.mv(a_p, pp)) <= 1e-11
    assert torch.count_nonzero(yh[n:]) == 0
    assert torch.count_nonzero(yl[n:]) == 0
    yh2, yl2 = gemv.gemv_dfq_symm(hi, loq, sc, ph, pl)
    assert torch.equal(yh, yh2) and torch.equal(yl, yl2)


def _square_system(n, n_p, m, seed):
    """An (m, n_p) row block of a random n x n matrix that is not
    symmetric, zero-padded to n_p columns (and rows), as f64 on the card,
    and an operand vector padded with zeros."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n_p, n_p))
    a[:n, :n] = rng.uniform(-1, 1, size=(n, n))
    p = np.zeros(n_p)
    p[:n] = rng.uniform(-1, 1, size=n)
    return torch.from_numpy(a[:m]).cuda(), p


@pytest.mark.parametrize("n,n_p", SIZES)
@pytest.mark.parametrize("block", [False, True])
def test_gemv_f32_kernel_matches_plain(n, n_p, block):
    m = n_p // 4 if block else n_p
    a64, p = _square_system(n, n_p, m, seed=n + 5)
    a = a64.float()
    pf = torch.from_numpy(p.astype(np.float32)).cuda()
    gemv.reset_counters()
    y = gemv.gemv_f32(a, pf)
    torch.cuda.synchronize()
    assert gemv.counters()["gemv_f32"] == 1 and y.shape == (m,)
    y_plain = gemv.gemv_f32_plain(a, pf)
    oracle = torch.mv(a.double(), pf.double())
    # f32 accumulation in two different orders: rounding-level agreement
    assert _rel(y, y_plain) <= 1e-5
    assert _rel(y.double(), oracle) <= 1e-5
    assert _rel(y_plain.double(), oracle) <= 1e-5
    assert torch.count_nonzero(y[n:]) == 0
    # fixed-order reduction: bitwise repeatable
    assert torch.equal(y, gemv.gemv_f32(a, pf))


@pytest.mark.parametrize("n,n_p", SIZES)
@pytest.mark.parametrize("block", [False, True])
def test_gemv_df64_kernel_matches_f64(n, n_p, block):
    m = n_p // 4 if block else n_p
    a64, p = _square_system(n, n_p, m, seed=n + 6)
    ah, al = (torch.from_numpy(x).cuda()
              for x in split_f64_host(a64.cpu().numpy()))
    ph, pl = (torch.from_numpy(x).cuda() for x in split_f64_host(p))
    gemv.reset_counters()
    yh, yl = gemv.gemv_df64(ah, al, ph, pl)
    torch.cuda.synchronize()
    assert gemv.counters()["gemv_df64"] == 1 and yh.shape == (m,)
    y = yh.double() + yl.double()
    oracle = torch.mv(a64, ph.double() + pl.double())
    # native f64 accumulation, returned as an f32 split
    assert _rel(y, oracle) <= 1e-13
    qh, ql = gemv.gemv_df64_plain(ah, al, ph, pl)
    assert _rel(qh.double() + ql.double(), oracle) <= 1e-13
    assert torch.count_nonzero(yh[n:]) == 0
    assert torch.count_nonzero(yl[n:]) == 0
    yh2, yl2 = gemv.gemv_df64(ah, al, ph, pl)
    assert torch.equal(yh, yh2) and torch.equal(yl, yl2)


def test_dense_kernel_rejects_unaligned_operand():
    a = torch.zeros(256, 1024, device="cuda")
    p = torch.zeros(1025, device="cuda")[1:]
    with pytest.raises(ValueError, match="aligned"):
        gemv.gemv_f32(a, p)


# Kernels 5 and 4 run the dense_stream walk (csrc/gemv_dense.cu): a grid
# of one or two blocks a SM, each a balanced range of rows. Edges of that
# partition: fewer rows than blocks (m=128), row counts the grid does not
# divide (1152, 3968), fewer column chunks than ring stages (nb=128), the
# ring's G=2 and G=4 row shards of the N=10000 system (lda=10240 != nb,
# every block), gather-df64's row block and the full 10240^2 square.
STREAM_COLS = [(128, 1024, 512), (1152, 768, 384), (3968, 256, 128),
               (5120, 10240, 5120), (2560, 10240, 2560)]  # (m, n, nb)
STREAM_DF64 = [(128, 512), (1152, 1024), (3968, 128), (5120, 10240),
               (10240, 10240)]  # (m, n)
STREAM_PAD = 64  # zero rows at the end of each matrix


def _zero_tail(m, n, seed):
    """An (m, n) f64 matrix on the card whose last STREAM_PAD rows are 0,
    and a numpy generator for its operands."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, size=(m, n))
    a[m - STREAM_PAD:] = 0.0
    return torch.from_numpy(a).cuda(), rng


@pytest.mark.parametrize("m,n,nb", STREAM_COLS)
def test_gemv_f32_cols_stream_walk(m, n, nb):
    a64, rng = _zero_tail(m, n, seed=m + nb)
    a = a64.float()
    for blk in range(n // nb):
        cols = slice(blk * nb, (blk + 1) * nb)
        p = torch.from_numpy(rng.uniform(-1, 1, nb).astype(np.float32)).cuda()
        ops.reset_counters()
        y = gemv.gemv_f32_cols(a, p, blk)
        torch.cuda.synchronize()
        assert ops.counters()["gemv_f32_cols"] == 1 and y.shape == (m,)
        oracle = torch.mv(a[:, cols].double(), p.double())
        # f32 accumulation in two different orders: rounding-level agreement
        assert _rel(y, gemv.gemv_f32_cols_plain(a, p, blk)) <= 1e-5
        assert _rel(y.double(), oracle) <= 1e-5
        assert torch.count_nonzero(y[m - STREAM_PAD:]) == 0
        assert torch.equal(y, gemv.gemv_f32_cols(a, p, blk))
        # the dense_rows walk sums each row in the same order
        assert torch.equal(y, gemv.gemv_f32(a[:, cols].contiguous(), p))


@pytest.mark.parametrize("m,n", STREAM_DF64)
def test_gemv_df64_stream_walk(m, n):
    a64, rng = _zero_tail(m, n, seed=m + n + 1)
    ah, al = (torch.from_numpy(x).cuda()
              for x in split_f64_host(a64.cpu().numpy()))
    ph, pl = (torch.from_numpy(x).cuda()
              for x in split_f64_host(rng.uniform(-1, 1, n)))
    ops.reset_counters()
    yh, yl = gemv.gemv_df64(ah, al, ph, pl)
    torch.cuda.synchronize()
    assert ops.counters()["gemv_df64"] == 1 and yh.shape == (m,)
    y = yh.double() + yl.double()
    oracle = torch.mv(ah.double() + al.double(), ph.double() + pl.double())
    assert _rel(y, oracle) <= 1e-13
    qh, ql = gemv.gemv_df64_plain(ah, al, ph, pl)
    assert _rel(qh.double() + ql.double(), oracle) <= 1e-13
    assert torch.count_nonzero(yh[m - STREAM_PAD:]) == 0
    assert torch.count_nonzero(yl[m - STREAM_PAD:]) == 0
    zh, zl = gemv.gemv_df64(ah, al, ph, pl)
    assert torch.equal(yh, zh) and torch.equal(yl, zl)
    # the dense_rows walk (one column block of the full width): same bits
    zh, zl = gemv.gemv_df64_cols(ah, al, ph, pl, 0)
    assert torch.equal(yh, zh) and torch.equal(yl, zl)


def test_dense_stream_kernels_hold_the_bulk_copy():
    """The SASS of kernels 4 and 5 (dense_stream) issues TMA bulk copies
    (UBLKCP); that of kernels 3 and 6 (dense_rows) none."""
    from lam_tpu_torch.ops import _build
    kernels = _build.sass()
    stream = [k for k in kernels if "dense_stream" in k]
    rows = [k for k in kernels if "dense_rows" in k]
    assert sorted("DF64Stream" in k for k in stream) == [False, True]
    assert sorted("DF64Mat" in k for k in rows) == [False, True]
    for k in stream:
        assert any("UBLKCP" in line for line in kernels[k])
    for k in rows:
        assert not any("UBLKCP" in line for line in kernels[k])


def _stencil_oracle(p, up, dn, nrows, nxi):
    """The masked 5-point Laplacian and p . y in float64 on the card."""
    g = p.double()
    full = 4 * g
    full[1:] -= g[:-1]
    full[0] -= up[0].double()
    full[:-1] -= g[1:]
    full[-1] -= dn[0].double()
    full[:, 1:] -= g[:, :-1]
    full[:, :-1] -= g[:, 1:]
    y = torch.zeros_like(full)
    y[:nrows, :nxi] = full[:nrows, :nxi]
    return y, float((g * y).sum())


def _check_stencil_kernel(p, up, dn, nrows, nxi, tbr):
    ops.reset_counters()
    y, d = stencil.laplace5_f32_halo(p, up, dn, nrows, nxi=nxi, tbr=tbr)
    torch.cuda.synchronize()
    counts = ops.counters()
    assert counts["laplace5_f32_halo"] == 1
    assert counts["laplace5_f32_halo_plain"] == 0
    assert y.shape == p.shape and d.dim() == 0 and d.is_cuda
    y_plain, d_plain = stencil.laplace5_f32_halo_plain(p, up, dn, nrows,
                                                       nxi=nxi)
    # 4p is exact, so the fused first term rounds as the plain version's
    # two steps do; the other three terms in the same order: bitwise
    assert torch.equal(y, y_plain)
    assert torch.count_nonzero(y[nrows:]) == 0
    assert torch.count_nonzero(y[:, nxi:]) == 0
    y64, d64 = _stencil_oracle(p, up, dn, nrows, nxi)
    assert float((y.double() - y64).abs().max()) <= 1e-5
    # the dot: the kernel's f64 partials against an f32 sum and f64
    assert abs(float(d) - float(d_plain)) <= 1e-6 * abs(float(d_plain))
    assert abs(float(d) - d64) <= 1e-6 * abs(d64)
    # fixed-order partial sums: bitwise repeatable
    y2, d2 = stencil.laplace5_f32_halo(p, up, dn, nrows, nxi=nxi, tbr=tbr)
    assert torch.equal(y, y2) and torch.equal(d, d2)


@pytest.mark.parametrize("nyi,nxi", [(7, 5), (98, 118), (998, 1198)])
def test_laplace5_kernel_matches_plain(nyi, nxi):
    H, W, tbr = stencil.padded_hw(nyi, nxi)
    rng = np.random.default_rng(nyi + nxi)
    p = torch.zeros(H, W, device="cuda")
    p[:nyi, :nxi] = torch.from_numpy(
        rng.standard_normal((nyi, nxi)).astype(np.float32)).cuda()
    zero = torch.zeros(1, W, device="cuda")
    _check_stencil_kernel(p, zero, zero, nyi, nxi, tbr)
    ops.reset_counters()
    y, _ = stencil.laplace5_f32(p, nyi=nyi, nxi=nxi, tbr=tbr)
    assert ops.counters()["laplace5_f32_halo"] == 1
    assert torch.equal(y, stencil.laplace5_f32_halo_plain(
        p, zero, zero, nyi, nxi=nxi)[0])


@pytest.mark.parametrize("nrows,nxi", [(1000, 1198), (1024, 1280)])
def test_laplace5_kernel_halo_matches_plain(nrows, nxi):
    """The demo's grid as one shard of a row-sharded grid: non-zero edge
    rows, a row limit below H (up_edge live) or at H (dn_edge live), p
    non-zero everywhere."""
    H, W, tbr = 1024, 1280, 256
    rng = np.random.default_rng(nrows)
    p, up, dn = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .cuda() for s in ((H, W), (1, W), (1, W)))
    _check_stencil_kernel(p, up, dn, nrows, nxi, tbr)


def test_laplace5_kernel_rejects_bad_inputs():
    p = torch.zeros(64, 128, device="cuda")
    e = torch.zeros(1, 128, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        stencil.laplace5_f32_halo(p.double(), e, e, 64, nxi=128, tbr=64)
    with pytest.raises(ValueError, match="contiguous"):
        stencil.laplace5_f32_halo(torch.zeros(128, 64, device="cuda").t(),
                                  e, e, 64, nxi=128, tbr=64)
    with pytest.raises(ValueError, match="multiple"):
        stencil.laplace5_f32_halo(torch.zeros(100, 128, device="cuda"), e, e,
                                  100, nxi=128, tbr=64)
    with pytest.raises(ValueError, match="aligned"):
        stencil.laplace5_f32_halo(
            p, torch.zeros(129, device="cuda")[1:].reshape(1, 128), e, 64,
            nxi=128, tbr=64)


# -- the 1-D sharded backends' kernels (rank by rank, no process group) ----

SHARD_SIZES = [(1500, 2), (1500, 3), (10000, 2)]  # (n, ranks)


def _shard_matrix(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, size=(n, n))
    return m + m.T, rng.uniform(-1, 1, size=n)


def _cuda_pair(p, n_p):
    v = np.zeros(n_p)
    v[:p.shape[0]] = p
    return tuple(torch.from_numpy(x).cuda() for x in split_f64_host(v))


@pytest.mark.parametrize("n,g", SHARD_SIZES)
def test_cols_kernels_match_plain(n, g):
    """Every rank's rows against every column block; the last rank's rows
    past n are padding and must come out exactly 0."""
    a, p = _shard_matrix(n, seed=n + g)
    for c in range(g):
        op = pcg.ShardedDenseOperator.from_dense(
            a, mesh=pmesh.Mesh(c, g, "cuda"), precision="df64")
        hi, lo = op.operand
        m = op.m
        ph, pl = _cuda_pair(p, op.n_padded)
        pad = max(0, min(m, (c + 1) * m - n))  # this rank's padding rows
        for blk in range(g):
            cols = slice(blk * m, (blk + 1) * m)
            ops.reset_counters()
            y = gemv.gemv_f32_cols(hi, ph[cols], blk)
            yh, yl = gemv.gemv_df64_cols(hi, lo, ph[cols], pl[cols], blk)
            torch.cuda.synchronize()
            counts = ops.counters()
            assert counts["gemv_f32_cols"] == counts["gemv_df64_cols"] == 1
            assert counts["gemv_f32_cols_plain"] == 0
            y64 = yh.double() + yl.double()
            a64 = hi[:, cols].double() + lo[:, cols].double()
            oracle = torch.mv(a64, ph[cols].double() + pl[cols].double())
            if not torch.any(oracle):
                # padding only (n=1500, g=3: rank 2's rows, block 2's
                # columns): exact zeros, where a relative error is 0/0
                assert not torch.any(y) and not torch.any(y64)
                continue
            oracle32 = torch.mv(hi[:, cols].double(), ph[cols].double())
            assert _rel(y, gemv.gemv_f32_cols_plain(hi, ph[cols], blk)) \
                <= 1e-5
            assert _rel(y.double(), oracle32) <= 1e-5
            assert _rel(y64, oracle) <= 1e-13
            qh, ql = gemv.gemv_df64_cols_plain(hi, lo, ph[cols], pl[cols],
                                               blk)
            assert _rel(qh.double() + ql.double(), oracle) <= 1e-13
            if pad:
                assert torch.count_nonzero(y[m - pad:]) == 0
                assert torch.count_nonzero(yh[m - pad:]) == 0
            assert torch.equal(y, gemv.gemv_f32_cols(hi, ph[cols], blk))
            zh, zl = gemv.gemv_df64_cols(hi, lo, ph[cols], pl[cols], blk)
            assert torch.equal(yh, zh) and torch.equal(yl, zl)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n,g", SHARD_SIZES)
def test_slab_kernels_match_plain(n, g, packed):
    """Every rank's walk; the ranks' parts, placed and summed, are the
    matvec, exactly 0 on the padding rows."""
    a, p = _shard_matrix(n, seed=n + 10 * g)
    total = None
    for c in range(g):
        op = pcg_symm.SymmShardedOperator.from_dense(
            a, mesh=pmesh.Mesh(c, g, "cuda"), packed=packed)
        hi, lo, it, kt, lt = op.operand
        ms, tb = 2 * op.m, op.tb
        ph, pl = _cuda_pair(p, op.n_padded)
        ops.reset_counters()
        yd, yt = gemv.gemv_f32_symm_slab(hi, ph, it, kt, lt, ms=ms,
                                         packed=packed)
        outs = gemv.gemv_df64_symm_slab(hi, lo, ph, pl, it, kt, lt, ms=ms,
                                        packed=packed)
        torch.cuda.synchronize()
        counts = ops.counters()
        assert counts["gemv_f32_symm_slab"] == 1
        assert counts["gemv_df64_symm_slab"] == 1
        assert counts["gemv_f32_symm_slab_plain"] == 0
        qd, qt = gemv.gemv_f32_symm_slab_plain(hi, ph, it, kt, lt, ms=ms,
                                               packed=packed)
        od, ot = gemv._slab_parts(hi.double(), ph.double(), it, kt, lt, ms,
                                  tb, packed)
        y, q = torch.cat([yd, yt]), torch.cat([qd, qt])
        assert _rel(y, q) <= 1e-5
        assert _rel(y.double(), torch.cat([od, ot])) <= 1e-5
        y64 = torch.cat([outs[0].double() + outs[1].double(),
                         outs[2].double() + outs[3].double()])
        od, ot = gemv._slab_parts(hi.double() + lo.double(),
                                  ph.double() + pl.double(), it, kt, lt, ms,
                                  tb, packed)
        assert _rel(y64, torch.cat([od, ot])) <= 1e-13
        again = gemv.gemv_df64_symm_slab(hi, lo, ph, pl, it, kt, lt, ms=ms,
                                         packed=packed)
        assert all(torch.equal(u, v) for u, v in zip(outs, again))
        zd, zt = gemv.gemv_f32_symm_slab(hi, ph, it, kt, lt, ms=ms,
                                         packed=packed)
        assert torch.equal(yd, zd) and torch.equal(yt, zt)
        part = pcg_symm._scatter_bands(y64[:ms], y64[ms:], c, g, op.m)
        total = part if total is None else total + part
    p64 = torch.from_numpy(p).cuda()
    oracle = torch.mv(torch.from_numpy(a).cuda(), p64)
    assert _rel(total[:n], oracle) <= 1e-13
    assert torch.count_nonzero(total[n:]) == 0


def test_slab_kernel_rejects_bad_tables():
    op = pcg_symm.SymmShardedOperator.from_dense(
        _shard_matrix(1500, 1)[0], mesh=pmesh.Mesh(0, 2, "cuda"), packed=True)
    hi, lo, it, kt, lt = op.operand
    p = torch.zeros(op.n_padded, device="cuda")
    with pytest.raises(ValueError, match="out of range"):
        gemv.gemv_f32_symm_slab(hi, p, it, it + 1, lt, ms=2 * op.m,
                                packed=True)
    with pytest.raises(ValueError, match="int32"):
        gemv.gemv_f32_symm_slab(hi, p, it.long(), kt, lt, ms=2 * op.m,
                                packed=True)
    with pytest.raises(NotImplementedError, match="broadcast"):
        gemv.gemv_df64_symm_slab(hi, lo[:512], p, p, it, kt, lt,
                                 ms=2 * op.m, packed=True)


QSHARD_SIZES = [(1500, 2), (1500, 3), (10000, 2), (10000, 4)]  # (n, ranks)


@pytest.mark.parametrize("storage", ["fq", "dfq"])
@pytest.mark.parametrize("n,g", QSHARD_SIZES)
def test_quantized_slab_kernels_match_plain(n, g, storage):
    """Every rank's walk, tables and scales of the quantized band-pair
    storages: gemv_q16_symm_slab (fq) to 1e-5, gemv_fq_symm_slab and
    gemv_dfq_symm_slab to the f64 oracle of the stored values at 1e-13,
    bitwise repeats; the ranks' parts plus the owners' diagonal terms are
    the matvec to the storage bound, exactly 0 on the padding rows."""
    a, p = _shard_matrix(n, seed=n + 10 * g + 1)
    total = None
    for c in range(g):
        op = pcg_symm.SymmShardedOperator.from_dense(
            a, mesh=pmesh.Mesh(c, g, "cuda"), precision=storage)
        it, kt, lt = op.operand[-3:]
        dh, dl = op.operand[-5], op.operand[-4]
        ms, tb = 2 * op.m, op.tb
        T = it.shape[0]
        assert op.operand[0].shape == (T * tb, tb)  # exactly T tiles
        ph, pl = _cuda_pair(p, op.n_padded)
        p64 = ph.double() + pl.double()
        ops.reset_counters()
        if storage == "fq":
            planes, scales = op.operand[:3], op.operand[3:6]
            yd, yt = gemv.gemv_q16_symm_slab(planes[0], scales[0], ph, it,
                                             kt, lt, ms=ms)
            outs = gemv.gemv_fq_symm_slab(*planes, *scales, ph, pl, it, kt,
                                          lt, ms=ms)
            torch.cuda.synchronize()
            counts = ops.counters()
            assert counts["gemv_q16_symm_slab"] == 1
            assert counts["gemv_fq_symm_slab"] == 1
            assert counts["gemv_q16_symm_slab_plain"] == 0
            assert counts["gemv_fq_symm_slab_plain"] == 0
            terms = [q.double() * sc.double().repeat_interleave(tb)[:, None]
                     for q, sc in zip(planes, scales)]
            qd, qt = gemv.gemv_q16_symm_slab_plain(planes[0], scales[0], ph,
                                                   it, kt, lt, ms=ms)
            od, ot = gemv._slab_parts(terms[0], ph.double(), it, kt, lt, ms,
                                      tb, True)
            y, q = torch.cat([yd, yt]), torch.cat([qd, qt])
            assert _rel(y, q) <= 1e-5
            assert _rel(y.double(), torch.cat([od, ot])) <= 1e-5
            zd, zt = gemv.gemv_q16_symm_slab(planes[0], scales[0], ph, it,
                                             kt, lt, ms=ms)
            assert torch.equal(yd, zd) and torch.equal(yt, zt)
            stored = terms[0] + terms[1] + terms[2]
            plain = gemv.gemv_fq_symm_slab_plain(*planes, *scales, ph, pl,
                                                 it, kt, lt, ms=ms)
            again = gemv.gemv_fq_symm_slab(*planes, *scales, ph, pl, it, kt,
                                           lt, ms=ms)
        else:
            hi, loq, sc = op.operand[:3]
            outs = gemv.gemv_dfq_symm_slab(hi, loq, sc, ph, pl, it, kt, lt,
                                           ms=ms)
            torch.cuda.synchronize()
            counts = ops.counters()
            assert counts["gemv_dfq_symm_slab"] == 1
            assert counts["gemv_dfq_symm_slab_plain"] == 0
            stored = hi.double() + loq.double() \
                * sc.double().repeat_interleave(tb)[:, None]
            plain = gemv.gemv_dfq_symm_slab_plain(hi, loq, sc, ph, pl, it,
                                                  kt, lt, ms=ms)
            again = gemv.gemv_dfq_symm_slab(hi, loq, sc, ph, pl, it, kt, lt,
                                            ms=ms)
        assert all(torch.equal(u, v) for u, v in zip(outs, again))
        y64 = torch.cat([outs[0].double() + outs[1].double(),
                         outs[2].double() + outs[3].double()])
        q64 = torch.cat([plain[0].double() + plain[1].double(),
                         plain[2].double() + plain[3].double()])
        od, ot = gemv._slab_parts(stored, p64, it, kt, lt, ms, tb, True)
        assert _rel(y64, torch.cat([od, ot])) <= 1e-13
        assert _rel(y64, q64) <= 1e-13
        yd64 = y64[:ms] + (dh.double() + dl.double()) \
            * pcg_symm._own_rows(p64, c, g, op.m)
        part = pcg_symm._scatter_bands(yd64, y64[ms:], c, g, op.m)
        total = part if total is None else total + part
    oracle = torch.mv(torch.from_numpy(a).cuda(),
                      torch.from_numpy(p).cuda())
    assert _rel(total[:n], oracle) <= (1e-12 if storage == "fq" else 1e-11)
    assert torch.count_nonzero(total[n:]) == 0


def test_quantized_slab_kernels_reject_bad_inputs():
    op = pcg_symm.SymmShardedOperator.from_dense(
        _shard_matrix(1500, 1)[0], mesh=pmesh.Mesh(0, 2, "cuda"),
        precision="fq")
    q1, q2, q3, s1, s2, s3, _, _, it, kt, lt = op.operand
    p, ms = torch.zeros(op.n_padded, device="cuda"), 2 * op.m
    with pytest.raises(ValueError, match="out of range"):
        gemv.gemv_q16_symm_slab(q1, s1, p, it, it + 1, lt, ms=ms)
    with pytest.raises(ValueError, match="table shape"):
        gemv.gemv_fq_symm_slab(q1, q2, q3, s1, s2[:-1], s3, p, p, it, kt, lt,
                               ms=ms)
    with pytest.raises(NotImplementedError, match="broadcast"):
        gemv.gemv_fq_symm_slab(q1, q2[:512], q3, s1, s2, s3, p, p, it, kt,
                               lt, ms=ms)
    with pytest.raises(ValueError, match="int16"):
        gemv.gemv_q16_symm_slab(q1.float(), s1, p, it, kt, lt, ms=ms)
    with pytest.raises(ValueError, match="expected"):
        gemv.gemv_q16_symm_slab(q1, s1.cpu(), p, it, kt, lt, ms=ms)


def test_two_rank_gloo_solve_on_one_card(tmp_path):
    """Two rank processes share the one card over gloo: the CLI's ring ir
    solve and the packed band-pair ir solve run the shard kernels in both
    ranks (no plain version) and give the one-device solution."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from lam_tpu_torch import DenseOperator, cg_solve_ir, generate
    from lam_tpu_torch import io as tio

    n = 3000
    a = generate.random_spd_matrix_fast(n, seed=5)
    b = generate.random_rhs(n, seed=6)
    tio.write_matrix(tmp_path / "A.bin", a)
    tio.write_matrix(tmp_path / "b.bin", b)
    jobs = [{"kind": "cli", "name": "ring-ir", "argv": [
        "-A", str(tmp_path / "A.bin"), "-b", str(tmp_path / "b.bin"),
        "-o", str(tmp_path / "x.bin"), "--backend", "sharded",
        "--precision", "ir", "--comm", "ring"]},
        {"kind": "solve", "name": "packed-ir", "op": "symm",
         "precision": "ir", "packed": True, "tb": 512,
         "matrix": str(tmp_path / "A.bin"), "rhs": str(tmp_path / "b.bin"),
         "rel_error": 1e-9},
        {"kind": "solve", "name": "packed-irfq", "op": "symm",
         "precision": "irfq", "tb": 512, "pack_cache": True,
         "matrix": str(tmp_path / "A.bin"), "rhs": str(tmp_path / "b.bin"),
         "rel_error": 1e-9}]
    (tmp_path / "jobs.json").write_text(json.dumps(jobs))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests", "torch_sharded_worker.py"),
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(r), "--device", "cuda", "--jobs",
         str(tmp_path / "jobs.json"), "--out", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [proc.communicate(timeout=300)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert [proc.returncode for proc in procs] == [0, 0], "\n".join(logs)
    local = DenseOperator.from_dense(a, precision="df64", device="cuda")
    x_local = cg_solve_ir(local.as_f32(), local, b, max_iters=10000,
                          rel_error=1e-9).x.cpu().numpy()
    for r in range(2):
        recs = {rec["name"]: rec for rec in json.loads(
            (tmp_path / f"results.r{r}.json").read_text())}
        ring, band = recs["ring-ir"], recs["packed-ir"]
        assert ring["rc"] == 0 and band["converged"]
        assert band["backend"] == "gloo" and band["device"] == "cuda:0"
        for rec, kernels in ((ring, ("gemv_f32_cols", "gemv_df64_cols")),
                             (band, ("gemv_f32_symm_slab",
                                     "gemv_df64_symm_slab"))):
            for k in kernels:
                assert rec["counts"][k] > 0 and rec["counts"][k + "_plain"] == 0
        x = np.load(tmp_path / f"packed-ir.r{r}.npy")
        assert np.linalg.norm(x - x_local) <= 1e-6 * np.linalg.norm(x_local)
        irfq = recs["packed-irfq"]
        assert irfq["converged"]
        for k in ("gemv_q16_symm_slab", "gemv_fq_symm_slab"):
            assert irfq["counts"][k] > 0 and irfq["counts"][k + "_plain"] == 0
        assert irfq["counts"]["gemv_f32_symm_slab"] == 0
        x = np.load(tmp_path / f"packed-irfq.r{r}.npy")
        assert np.linalg.norm(x - x_local) <= 1e-6 * np.linalg.norm(x_local)
        assert np.linalg.norm(b - a @ x) <= 2e-9 * np.linalg.norm(b)
        assert (tmp_path / "A.bin.shardpack" / f"fq.g2.s{r}").exists()
    x = tio.read_vector(tmp_path / "x.bin")
    assert np.linalg.norm(x - x_local) <= 1e-6 * np.linalg.norm(x_local)
    assert np.linalg.norm(b - a @ x) <= 2e-9 * np.linalg.norm(b)


def test_four_rank_grid_solve_on_one_card(tmp_path):
    """Four rank processes share the one card over gloo as a 2 x 2 grid:
    the CLI's --backend sharded2d ir solve runs the dense kernels on every
    rank's block (no plain version, no symmetric kernel) and gives the
    one-device solution."""
    import json

    from lam_tpu_torch import DenseOperator, cg_solve_ir, generate
    from lam_tpu_torch import io as tio
    from torch_sharded_worker import launch_cluster

    n = 3000
    a = generate.random_spd_matrix_fast(n, seed=7)
    b = generate.random_rhs(n, seed=8)
    tio.write_matrix(tmp_path / "A.bin", a)
    tio.write_matrix(tmp_path / "b.bin", b)
    jobs = [{"kind": "cli", "name": "grid-ir", "argv": [
        "-A", str(tmp_path / "A.bin"), "-b", str(tmp_path / "b.bin"),
        "-o", str(tmp_path / "x.bin"), "--backend", "sharded2d",
        "--precision", "ir"]}]
    records = launch_cluster(4, jobs, str(tmp_path / "run"), 300,
                             device="cuda")
    local = DenseOperator.from_dense(a, precision="df64", device="cuda")
    x_local = cg_solve_ir(local.as_f32(), local, b, max_iters=10000,
                          rel_error=1e-9).x.cpu().numpy()
    for rank in records:
        rec = rank["grid-ir"]
        assert rec["rc"] == 0
        for k in ("gemv_f32", "gemv_df64"):
            assert rec["counts"][k] > 0 and rec["counts"][k + "_plain"] == 0
        assert rec["counts"]["gemv_f32_symm"] == 0
        assert rec["counts"]["gemv_f32_symm_slab"] == 0
    assert int(records[0]["grid-ir"]["stdout"].split(",")[1]) == 4
    x = tio.read_vector(tmp_path / "x.bin")
    assert np.linalg.norm(x - x_local) <= 1e-6 * np.linalg.norm(x_local)
    assert np.linalg.norm(b - a @ x) <= 2e-9 * np.linalg.norm(b)


# -- the dual kernels of the symmetric 2-D grid ----------------------------

DUAL_SHAPES = [(512, 1024, 0), (1024, 2048, 2), (2560, 5120, 5)]  # ms, n, pad


def _dual_case(ms, n, pad, seed):
    """A random (ms, n) rectangle packed at tb=512 with `pad` trailing pad
    tiles, as df64, dfq and fq buffers on the card, the pad tiles and pad
    scales overwritten with finite garbage (a kernel that read them would
    show it), and p, q as (hi, lo) views at an element offset inside longer
    vectors, as the operator hands them."""
    from lam_tpu_torch.solver.operators import quantize_storage_tiles
    tb = layout.SYMM_TB
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1, 1, (ms, n))
    buf = layout.pack_rect_host(s, tb, pad_tiles=pad)
    real = (ms // tb) * (n // tb)

    def up(x, scale=False):
        x = np.array(x, copy=True)
        if scale:
            x[real:] = 3.0
        else:
            x[real * tb:] = 7
        return torch.from_numpy(x).cuda()

    packs = {"df64": [up(x) for x in split_f64_host(buf)]}
    for storage, n_planes in (("dfq", 2), ("fq", 3)):
        out = quantize_storage_tiles(storage, buf, tb)
        packs[storage] = ([up(x) for x in out[:n_planes]]
                          + [up(x, scale=True) for x in out[n_planes:]])
    whole = rng.uniform(-1, 1, 2 * (n + ms))
    wh, wl = (torch.from_numpy(x).cuda() for x in split_f64_host(whole))
    vecs = (wh[n:2 * n], wl[n:2 * n], wh[2 * n + ms:], wl[2 * n + ms:])
    assert all(v.storage_offset() > 0 and v.is_contiguous() for v in vecs)
    return packs, vecs


def _stored_rect(planes, scales, ms, n):
    """The f64 (ms, n) rectangle a storage's buffers hold."""
    tb = layout.SYMM_TB
    mb, cb = ms // tb, n // tb
    rows = mb * cb * tb
    if scales:
        buf = sum(q[:rows].double()
                  * s[:mb * cb].double().repeat_interleave(tb)[:, None]
                  for q, s in zip(planes[-len(scales):], scales))
        if len(planes) > len(scales):  # dfq: the f32 hi plane beside it
            buf = buf + planes[0][:rows].double()
    else:
        buf = sum(x[:rows].double() for x in planes)
    return buf.reshape(mb, cb, tb, tb).permute(0, 2, 1, 3).reshape(ms, n)


@pytest.mark.parametrize("ms,n,pad", DUAL_SHAPES)
def test_f32_dual_kernels_match_plain(ms, n, pad):
    packs, (ph, _, qh, _) = _dual_case(ms, n, pad, seed=ms)
    hi = packs["df64"][0]
    q1, s1 = packs["fq"][0], packs["fq"][3]
    for name, args, stored in (
            ("gemv_f32_dual", (hi, ph, qh), _stored_rect([hi], [], ms, n)),
            ("gemv_q16_dual", (q1, s1, ph, qh),
             _stored_rect([q1], [s1], ms, n))):
        kernel, plain = getattr(gemv, name), getattr(gemv, name + "_plain")
        ops.reset_counters()
        yd, yt = kernel(*args)
        torch.cuda.synchronize()
        counts = ops.counters()
        assert counts[name] == 1 and counts[name + "_plain"] == 0
        assert yd.shape == (ms,) and yt.shape == (n,)
        qd, qt = plain(*args)
        y, q = torch.cat([yd, yt]), torch.cat([qd, qt])
        oracle = torch.cat([stored @ ph.double(), stored.T @ qh.double()])
        # exact f32 products, f32 sums in two different orders
        assert _rel(y, q) <= 1e-5
        assert _rel(y.double(), oracle) <= 1e-5
        zd, zt = kernel(*args)  # fixed-order sums: bitwise repeatable
        assert torch.equal(yd, zd) and torch.equal(yt, zt)


@pytest.mark.parametrize("storage", ["df64", "dfq", "fq"])
@pytest.mark.parametrize("ms,n,pad", DUAL_SHAPES)
def test_f64_dual_kernels_match_f64(ms, n, pad, storage):
    packs, vecs = _dual_case(ms, n, pad, seed=ms + 1)
    bufs = packs[storage]
    name = f"gemv_{storage}_dual"
    n_scales = {"df64": 0, "dfq": 1, "fq": 3}[storage]
    planes = bufs[:len(bufs) - n_scales]
    stored = _stored_rect(planes, bufs[len(planes):], ms, n)
    kernel, plain = getattr(gemv, name), getattr(gemv, name + "_plain")
    ops.reset_counters()
    out = kernel(*bufs, *vecs)
    torch.cuda.synchronize()
    counts = ops.counters()
    assert counts[name] == 1 and counts[name + "_plain"] == 0
    ref = plain(*bufs, *vecs)
    again = kernel(*bufs, *vecs)
    assert all(torch.equal(u, v) for u, v in zip(out, again))

    def join(o):
        return torch.cat([o[0].double() + o[1].double(),
                          o[2].double() + o[3].double()])

    p64 = vecs[0].double() + vecs[1].double()
    q64 = vecs[2].double() + vecs[3].double()
    oracle = torch.cat([stored @ p64, stored.T @ q64])
    # native f64 sums; the f32 (hi, lo) split of the result keeps ~2^-48
    assert _rel(join(out), oracle) <= 1e-13
    assert _rel(join(out), join(ref)) <= 1e-13


def test_dual_kernels_reject_bad_inputs():
    tb = layout.SYMM_TB
    dev = torch.device("cuda")
    small = torch.zeros(2 * 128, 128, device=dev)
    v = torch.zeros(128, device=dev)
    with pytest.raises(ValueError, match="tb=512"):
        gemv.gemv_f32_dual(small, v, v)
    buf = torch.zeros(tb, tb, device=dev)
    p = torch.zeros(2 * tb, device=dev)
    q = torch.zeros(tb, device=dev)
    with pytest.raises(ValueError, match="packed buffer has 1 tiles"):
        gemv.gemv_f32_dual(buf, p, q)
    with pytest.raises(ValueError, match="expected"):
        gemv.gemv_f32_dual(buf, q.cpu(), q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gemv.gemv_f32_dual(torch.zeros(tb * tb + 1, device=dev)[1:].view(
            tb, tb), q, q)
    with pytest.raises(NotImplementedError, match="items 8 and 10"):
        gemv.gemv_df64_dual(torch.zeros(2 * tb, tb, device=dev), buf, q, q,
                            q, q)


def test_four_rank_symmetric_grid_solve_on_one_card(tmp_path):
    """Four rank processes share the one card over gloo as a 2 x 2 grid:
    the CLI's --backend sharded2d ir solve with --engine pallas_symm_packed
    and its irfq solve run the triangle kernels on the diagonal ranks and
    the dual kernels on the others (no plain version, no dense kernel) and
    give the one-device solution."""
    from lam_tpu_torch import DenseOperator, cg_solve_ir, generate
    from lam_tpu_torch import io as tio
    from torch_sharded_worker import launch_cluster

    n = 3000
    a = generate.random_spd_matrix_fast(n, seed=9)
    b = generate.random_rhs(n, seed=10)
    tio.write_matrix(tmp_path / "A.bin", a)
    tio.write_matrix(tmp_path / "b.bin", b)
    common = ["-A", str(tmp_path / "A.bin"), "-b", str(tmp_path / "b.bin"),
              "--backend", "sharded2d"]
    jobs = [{"kind": "cli", "name": "ir", "argv": common + [
        "-o", str(tmp_path / "x_ir.bin"), "--precision", "ir", "--engine",
        "pallas_symm_packed"]},
        {"kind": "cli", "name": "irfq", "argv": common + [
            "-o", str(tmp_path / "x_irfq.bin"), "--precision", "irfq",
            "--pack-cache"]}]
    records = launch_cluster(4, jobs, str(tmp_path / "run"), 300,
                             device="cuda")
    local = DenseOperator.from_dense(a, precision="df64", device="cuda")
    x_local = cg_solve_ir(local.as_f32(), local, b, max_iters=10000,
                          rel_error=1e-9).x.cpu().numpy()
    kernels = {"ir": (("gemv_f32_symm", "gemv_df64_symm"),
                      ("gemv_f32_dual", "gemv_df64_dual")),
               "irfq": (("gemv_q16_symm", "gemv_fq_symm"),
                        ("gemv_q16_dual", "gemv_fq_dual"))}
    for name, (diag, off) in kernels.items():
        for r, rank in enumerate(records):
            rec = rank[name]
            assert rec["rc"] == 0
            ran, idle = (diag, off) if r in (0, 3) else (off, diag)
            for k in ran:
                assert rec["counts"][k] > 0
            for k in idle + ("gemv_f32", "gemv_df64"):
                assert rec["counts"][k] == 0
            assert all(v == 0 for k, v in rec["counts"].items()
                       if k.endswith("_plain"))
        assert int(records[0][name]["stdout"].split(",")[1]) == 4
        x = tio.read_vector(tmp_path / f"x_{name}.bin")
        assert np.linalg.norm(x - x_local) <= 1e-6 * np.linalg.norm(x_local)
        assert np.linalg.norm(b - a @ x) <= 2e-9 * np.linalg.norm(b)
    for k in range(4):
        assert (tmp_path / "A.bin.shardpack" / f"fq.r2.s{k}").exists()


# -- the bf16 product engine of the q16 kernels ------------------------------

def _bf16_triangle(nblk, rng, small):
    """A padded q1 triangle plane, scales and p on the card: small integers
    against scales 0.5/0.25 (bf16 holds every value: exact products and
    sums), or int16 within +-30000 against 2^-15 and Gaussian p."""
    tb = layout.SYMM_TB
    T, Ts = layout.tri_tile_count(nblk), layout.padded_tri_tile_count(nblk)
    q1 = np.zeros((Ts * tb, tb), np.int16)
    s1 = np.zeros(Ts, np.float32)
    if small:
        q1[:T * tb] = rng.integers(-3, 4, (T * tb, tb))
        s1[:T] = np.where(np.arange(T) % 2, 0.25, 0.5)
        p = rng.integers(-3, 4, nblk * tb).astype(np.float32)
    else:
        q1[:T * tb] = rng.integers(-30000, 30001, (T * tb, tb))
        s1[:T] = 2.0 ** -15
        p = rng.standard_normal(nblk * tb).astype(np.float32)
    return tuple(torch.from_numpy(x).cuda() for x in (q1, s1, p))


def _bf16_slab_ranks(g, mt, rng, small):
    """Every rank's (q1, sc, it, kt, lt) of a g-rank band-pair walk at
    tb=512, one scale per walk position, and p, on the card."""
    tb = layout.SYMM_TB
    tables = pcg_symm._band_tables(g, mt, tb)
    n = 2 * g * mt * tb
    ranks = []
    for c in range(g):
        it, kt, lt = (torch.from_numpy(np.asarray(x[c], np.int32)).cuda()
                      for x in tables)
        T = it.shape[0]
        if small:
            q1 = rng.integers(-3, 4, (T * tb, tb))
            sc = np.where(np.arange(T) % 3, 0.5, 0.25)
        else:
            q1 = rng.integers(-30000, 30001, (T * tb, tb))
            sc = np.full(T, 2.0 ** -15)
        ranks.append((torch.from_numpy(q1.astype(np.int16)).cuda(),
                      torch.from_numpy(sc.astype(np.float32)).cuda(),
                      it, kt, lt))
    p = rng.integers(-3, 4, n) if small else rng.standard_normal(n)
    return ranks, torch.from_numpy(p.astype(np.float32)).cuda(), 2 * mt * tb


def _bf16_rect(ms, n, pad, rng, small):
    """A (ms, n) q1 rectangle of row-major tiles with `pad` garbage pad
    tiles and garbage pad scales, and p (n,), q (ms,), on the card."""
    tb = layout.SYMM_TB
    real = (ms // tb) * (n // tb)
    q1 = np.full(((real + pad) * tb, tb), 7, np.int16)
    sc = np.full(real + pad, 3.0, np.float32)
    if small:
        q1[:real * tb] = rng.integers(-3, 4, (real * tb, tb))
        sc[:real] = np.where(np.arange(real) % 2, 0.25, 0.5)
        p, q = rng.integers(-3, 4, n), rng.integers(-3, 4, ms)
    else:
        q1[:real * tb] = rng.integers(-30000, 30001, (real * tb, tb))
        sc[:real] = 2.0 ** -15
        p, q = rng.standard_normal(n), rng.standard_normal(ms)
    return tuple(torch.from_numpy(np.asarray(x, dt)).cuda() for x, dt in (
        (q1, np.int16), (sc, np.float32), (p, np.float32), (q, np.float32)))


def _f64_tri(q1, s1, p, nblk):
    """f64 oracle of the triangle walk of stored values q1 * s1."""
    tb = layout.SYMM_TB
    T = layout.tri_tile_count(nblk)
    tiles = q1[:T * tb].double().reshape(T, tb, tb) * s1[:T].double()[
        :, None, None]
    return torch.mv(_dense_of(tiles, nblk), p.double())


def _f64_rect(q1, sc, ms, n):
    tb = layout.SYMM_TB
    mb, cb = ms // tb, n // tb
    rows = mb * cb * tb
    buf = q1[:rows].double() * sc[:mb * cb].double().repeat_interleave(
        tb)[:, None]
    return buf.reshape(mb, cb, tb, tb).permute(0, 2, 1, 3).reshape(ms, n)


def _bf16_walks():
    """(name, [(args, kwargs, f64 oracle or None)]) of the three bf16
    kernels, general inputs first, then small-integer ones."""
    rng = np.random.default_rng(51)
    cases = {"gemv_q16_symm_bf16": [], "gemv_q16_symm_slab_bf16": [],
             "gemv_q16_dual_bf16": []}
    for small in (False, True):
        for nblk in (4, 20):
            q1, s1, p = _bf16_triangle(nblk, rng, small)
            cases["gemv_q16_symm_bf16"].append(
                ((q1, s1, p), {}, _f64_tri(q1, s1, p, nblk) if small
                 else None))
        for g, mt in ((2, 2), (4, 1)):
            ranks, p, ms = _bf16_slab_ranks(g, mt, rng, small)
            for q1, sc, it, kt, lt in ranks:
                oracle = None
                if small:
                    tb = layout.SYMM_TB
                    od, ot = gemv._slab_parts(
                        q1.double() * sc.double().repeat_interleave(tb)[
                            :, None], p.double(), it, kt, lt, ms, tb, True)
                    oracle = torch.cat([od, ot])
                cases["gemv_q16_symm_slab_bf16"].append(
                    ((q1, sc, p, it, kt, lt), {"ms": ms}, oracle))
        for ms, n, pad in ((512, 1024, 0), (2560, 5120, 5)):
            q1, sc, p, q = _bf16_rect(ms, n, pad, rng, small)
            oracle = None
            if small:
                s = _f64_rect(q1, sc, ms, n)
                oracle = torch.cat([s @ p.double(), s.T @ q.double()])
            cases["gemv_q16_dual_bf16"].append(((q1, sc, p, q), {}, oracle))
    return cases


def _flat(y):
    return y if isinstance(y, torch.Tensor) else torch.cat(y)


@pytest.mark.parametrize("name", ["gemv_q16_symm_bf16",
                                  "gemv_q16_symm_slab_bf16",
                                  "gemv_q16_dual_bf16"])
def test_q16_bf16_kernels_match_plain(name):
    """Each bf16 kernel against its plain version (the same bf16 operands
    and exact products, f32 sums in another order: 1e-5), bitwise equal
    to the f64 oracle on small-integer data, bitwise repeatable; the dual
    walk's pad tiles and pad scales hold garbage."""
    kernel, plain = getattr(gemv, name), getattr(gemv, name + "_plain")
    for args, kw, oracle in _bf16_walks()[name]:
        ops.reset_counters()
        y = _flat(kernel(*args, **kw))
        torch.cuda.synchronize()
        counts = ops.counters()
        assert counts[name] == 1 and counts[name + "_plain"] == 0
        assert _rel(y, _flat(plain(*args, **kw))) <= 1e-5
        if oracle is not None:
            assert torch.equal(y.double(), oracle)
        assert torch.equal(y, _flat(kernel(*args, **kw)))


def test_q16_bf16_kernels_are_not_the_exact_ones():
    """On general data the bf16 engine visibly rounds: its result differs
    from the exact kernel's by more than 1e-5 and stays within 1e-2."""
    for name, cases in _bf16_walks().items():
        exact = getattr(gemv, name.replace("_bf16", ""))
        for args, kw, oracle in cases:
            if oracle is None:
                y = _flat(getattr(gemv, name)(*args, **kw))
                z = _flat(exact(*args, **kw))
                assert 1e-5 < _rel(y, z) <= 1e-2


def test_q16_engine_routes_to_the_bf16_kernels(monkeypatch):
    """Under 'mxu' the public q16 wrappers launch the bf16 kernels and not
    the exact ones; under 'auto' at these sizes (n < 16384) the reverse."""
    rng = np.random.default_rng(52)
    q1, s1, p = _bf16_triangle(4, rng, False)
    ranks, ps, ms = _bf16_slab_ranks(2, 1, rng, False)
    rect = _bf16_rect(512, 1024, 1, rng, False)
    for impl, suffix in (("mxu", "_bf16"), ("auto", "")):
        monkeypatch.setattr(gemv, "_Q16_IMPL", impl)
        ops.reset_counters()
        gemv.gemv_q16_symm(q1, s1, p)
        gemv.gemv_q16_symm_slab(*ranks[0][:2], ps, *ranks[0][2:], ms=ms)
        gemv.gemv_q16_dual(*rect)
        torch.cuda.synchronize()
        launched = {k for k, v in ops.counters().items() if v}
        assert launched == {"gemv_q16_symm" + suffix,
                            "gemv_q16_symm_slab" + suffix,
                            "gemv_q16_dual" + suffix}


def test_q16_mxu_keeps_exact_products_on_exact_count_triangles(monkeypatch):
    """Under 'mxu' an exact-count triangle plane whose tile count is not a
    multiple of Q16_P (the symmetric grid's diagonal ranks) launches the
    exact kernel, as lam_tpu's one-tile grid runs its exact body there."""
    rng = np.random.default_rng(55)
    tb, nblk = layout.SYMM_TB, 4
    T = layout.tri_tile_count(nblk)
    q1, s1, p = _bf16_triangle(nblk, rng, False)
    q1, s1 = q1[:T * tb].clone(), s1[:T].clone()
    monkeypatch.setattr(gemv, "_Q16_IMPL", "mxu")
    ops.reset_counters()
    y = gemv.gemv_q16_symm(q1, s1, p)
    torch.cuda.synchronize()
    assert {k for k, v in ops.counters().items() if v} == {"gemv_q16_symm"}
    assert _rel(y, gemv.gemv_q16_symm_plain(q1, s1, p)) <= 1e-5


def test_q16_bf16_engine_has_no_fallback(monkeypatch):
    """'mxu' with a kernel library that fails to build raises; nothing else
    runs in its place (no exact kernel, no plain version)."""
    from lam_tpu_torch.ops import _build

    def broken():
        raise RuntimeError("nvcc failed (exit 1)")

    monkeypatch.setattr(gemv, "_Q16_IMPL", "mxu")
    monkeypatch.setattr(_build, "library", broken)
    rng = np.random.default_rng(53)
    q1, s1, p = _bf16_triangle(4, rng, False)
    ranks, ps, ms = _bf16_slab_ranks(2, 1, rng, False)
    rect = _bf16_rect(512, 1024, 0, rng, False)
    ops.reset_counters()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        gemv.gemv_q16_symm(q1, s1, p)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        gemv.gemv_q16_symm_slab(*ranks[0][:2], ps, *ranks[0][2:], ms=ms)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        gemv.gemv_q16_dual(*rect)
    assert not any(ops.counters().values())


def test_stream_i16_checksum():
    """The read-floor probe: its int64 checksum equals the plain sum."""
    from lam_tpu_torch.ops import probe
    rng = np.random.default_rng(54)
    for rows in (1, 1000, 210 * 512):
        plane = torch.from_numpy(rng.integers(
            -32768, 32768, (rows, 512)).astype(np.int16)).cuda()
        before = probe.stream_i16.launches
        got = probe.stream_i16(plane)
        torch.cuda.synchronize()
        assert probe.stream_i16.launches == before + 1
        assert int(got) == int(probe.stream_i16_plain(plane))
        assert int(got) == int(plane.cpu().numpy().astype(np.int64).sum())


# -- the q16 probes (lam_tpu_torch/ops/probe.py, csrc/q16_probe.cu) ----------

PROBE_WALKS = {"magic": 512, "tb1024": 1024, "sub8": 512, "split": 512,
               "hi": 512, "hybrid": 512}
# split rounds p * s to bf16 on both sides; the others are exact f32 walks:
# hi and hybrid take tensor-core products held to f32 rounding
PROBE_TOL = {"magic": 1e-5, "tb1024": 1e-5, "sub8": 1e-5, "split": 1e-5,
             "hi": 1e-6, "hybrid": 1e-6}


def _probe_plane(tb, n, seed):
    """Random int16 tiles (full range) of an n x n triangle walk against
    random power-of-two scales, and a Gaussian p, on the card."""
    rng = np.random.default_rng(seed)
    T = layout.tri_tile_count(n // tb)
    q1 = rng.integers(-32767, 32768, (T * tb, tb)).astype(np.int16)
    sc = (2.0 ** -rng.integers(8, 20, T)).astype(np.float32)
    p = rng.standard_normal(n).astype(np.float32)
    return tuple(torch.from_numpy(x).cuda() for x in (q1, sc, p))


@pytest.mark.parametrize("name", list(PROBE_WALKS))
def test_q16_probe_walks_match_plain(name):
    """Each probe walk at n=10240 against its plain version, launching its
    kernel once and no plain version, bitwise repeatable; magic equal to
    kernel 14's exact body bit for bit."""
    from lam_tpu_torch.ops import probe
    kernel = getattr(probe, f"gemv_q16_symm_{name}")
    plain = getattr(probe, f"gemv_q16_symm_{name}_plain")
    q1, sc, p = _probe_plane(PROBE_WALKS[name], 10240, seed=61)
    probe.reset_counters()
    y = kernel(q1, sc, p)
    torch.cuda.synchronize()
    counts = probe.counters()
    assert counts.pop(kernel.__name__) == 1
    assert set(counts.values()) == {0}
    assert _rel(y, plain(q1, sc, p)) <= PROBE_TOL[name]
    assert torch.equal(y, kernel(q1, sc, p))
    if name == "magic":
        assert torch.equal(y, gemv._q16_symm(
            gemv.gemv_q16_symm, gemv.gemv_q16_symm_plain,
            "lam_gemv_q16_symm", q1, sc, p))


def test_q16_probe_hi_is_f32_class_and_def_is_not():
    """On the same random data hi and hybrid stay within 1e-6 of the exact
    f32 plain walk, while the bf16 engine (mxu-def) stands above 1e-4."""
    from lam_tpu_torch.ops import probe
    q1, sc, p = _probe_plane(512, 10240, seed=62)
    exact = probe.gemv_q16_symm_hi_plain(q1, sc, p)
    assert _rel(probe.gemv_q16_symm_hi(q1, sc, p), exact) <= 1e-6
    assert _rel(probe.gemv_q16_symm_hybrid(q1, sc, p), exact) <= 1e-6
    assert _rel(gemv.gemv_q16_symm_bf16(q1, sc, p), exact) > 1e-4


def test_q16_magic_kernel_converts_no_integer():
    """The SASS of the magic walk has no int -> f32 conversion, where the
    exact walk's has one per element it loads."""
    from lam_tpu_torch.ops import _build, probe
    kernels = _build.sass()
    magic = [k for k in kernels if "symm_pass1" in k and "Q16MagicPlane" in k]
    exact = [k for k in kernels if "symm_pass1" in k and "8Q16Plane" in k]
    assert magic and exact
    for k in magic:
        assert probe.f32_conversions(kernels[k]) == []
    assert all(len(probe.f32_conversions(kernels[k])) >= 8 for k in exact)


def test_convert_sum_on_the_card():
    """The converting stream: exact on the probes' tridiagonal plane, and
    within its per-thread f32 rounding bound of the f64 sum elsewhere."""
    from lam_tpu_torch.ops import probe
    from lam_tpu_torch.tools import q16_probe as tool
    q1 = probe.tridiag_q1(4096, 512, pad_to=8, device="cuda")[0]
    assert float(probe.convert_f32_sum(q1)) == tool._stream_sum(q1, 512, 8)
    q1 = _probe_plane(512, 10240, seed=63)[0]
    got = float(probe.convert_f32_sum(q1))
    vecs = -(-q1.numel() // 8 // probe.convert_threads(q1.device))
    bound = 8 * vecs * 2.0 ** -24 * float(q1.double().abs().sum())
    assert abs(got - float(probe.convert_f32_sum_plain(q1))) <= bound
    assert got == float(probe.convert_f32_sum(q1))


def test_q16_probe_tool_on_the_card(capsys):
    """The tool's four probes at n=4096 on the card: every variant passes
    its closed form and gets a time."""
    from lam_tpu_torch.ops import probe
    from lam_tpu_torch.tools import q16_probe as tool
    probe.reset_counters()
    rows = tool.run((1, 2, 3, 4), 4096, 2, "cuda")
    assert all(r["ms"] > 0 and r["floor_ms"] > 0 for r in rows)
    assert all(v > 0 for k, v in probe.counters().items()
               if not k.endswith("_plain"))
    assert not any(v for k, v in probe.counters().items()
                   if k.endswith("_plain"))
