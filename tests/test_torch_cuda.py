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
matrix that is not symmetric. The stencil kernel takes padded grids up
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
    x = tio.read_vector(tmp_path / "x.bin")
    assert np.linalg.norm(x - x_local) <= 1e-6 * np.linalg.norm(x_local)
    assert np.linalg.norm(b - a @ x) <= 2e-9 * np.linalg.norm(b)
