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
matrix that is not symmetric; kernels 4, 5 and 6 (the dense_stream walk)
also the edges of its row partition and the ring's column blocks, equal
bit for bit to the dense_rows walk on the same bytes, and their SASS the
TMA bulk copy. Kernel 16 (the strip walk) takes every rank's tables of the
band pairs, a single-tile walk and misaligned operands, equal bit for bit
to its control, the two-pass walk; kernels 18 and 19 (the dual kernels on
the strip walk) take rectangles of 1 x 1 to 7 x 3 tiles with garbage pads,
equal bit for bit to their two-pass controls, and refuse misaligned
operands and a broken library. The stencil kernel takes padded grids up
to the heat demo's 998 x 1198 interior (1024 x 1280), with zero edges and
with the non-zero edge rows of a row-sharded grid. The broadcast modes of
kernels 9, 17 (every rank's walk, G = 1 to 3) and 12, 19 (rectangles of
one tile to 7 x 3) give the full-plane kernel's bits on a zero tile and
match the f64 oracle on non-zero ones. The kernels of kernels 15's, 9's,
12's and 17's modes for tiles of zeros (the strip walk over q1 or hi
alone) give the full-plane kernels' and the tile-reading walks' bits with
signed zeros in the planes, the operands and the scales; generate mode's
operators take them, and an operator handed a tile that is not zero does
not. Kernel 19's mode for tiles of zeros (the strip walk over q1 alone on
the rectangle) the same way, and probes P5s (split), P5h (hi) and P5y
(hybrid) on the strip walk's tensor-core consumers and P4s (sub8) on its
summing consumers, each warp's transpose row kept, give their two-pass
controls' bits; none spills. The stencil on each row shard of a
row-sharded grid, its edges the rows the halo exchange delivers, gives its
plain version's bits and the one-device grid's; local Jacobi PCG (df64,
irfq) launches the kernels of CG and no plain version. `dryrun.entry()`
launches kernel 4 and no plain version, and `dryrun_multichip(2)` passes
every leg on the card with no plain version. `lam-bench-torch`'s run_one
(gen mode at N=4096 -i 15, spd mode in memory at N=1024) launches its
storage's kernels and no plain version.
"""

import numpy as np
import pytest
import torch

from lam_tpu_torch import ops
from lam_tpu_torch.ops import gemv, layout, probe, stencil
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
    zh, zl = probe.gemv_df64_rows(ah, al, ph, pl, 0)
    assert torch.equal(yh, zh) and torch.equal(yl, zl)


@pytest.mark.parametrize("m,n,nb", STREAM_COLS)
def test_gemv_df64_cols_stream_walk(m, n, nb):
    a64, rng = _zero_tail(m, n, seed=m + nb + 2)
    ah, al = (torch.from_numpy(x).cuda()
              for x in split_f64_host(a64.cpu().numpy()))
    for blk in range(n // nb):
        cols = slice(blk * nb, (blk + 1) * nb)
        ph, pl = (torch.from_numpy(x).cuda()
                  for x in split_f64_host(rng.uniform(-1, 1, nb)))
        ops.reset_counters()
        yh, yl = gemv.gemv_df64_cols(ah, al, ph, pl, blk)
        torch.cuda.synchronize()
        assert ops.counters()["gemv_df64_cols"] == 1 and yh.shape == (m,)
        y = yh.double() + yl.double()
        oracle = torch.mv(ah[:, cols].double() + al[:, cols].double(),
                          ph.double() + pl.double())
        assert _rel(y, oracle) <= 1e-13
        qh, ql = gemv.gemv_df64_cols_plain(ah, al, ph, pl, blk)
        assert _rel(qh.double() + ql.double(), oracle) <= 1e-13
        assert torch.count_nonzero(yh[m - STREAM_PAD:]) == 0
        assert torch.count_nonzero(yl[m - STREAM_PAD:]) == 0
        zh, zl = gemv.gemv_df64_cols(ah, al, ph, pl, blk)
        assert torch.equal(yh, zh) and torch.equal(yl, zl)
        # the dense_rows walk on the same bytes: same bits
        zh, zl = probe.gemv_df64_rows(ah, al, ph, pl, blk)
        assert torch.equal(yh, zh) and torch.equal(yl, zl)


def test_dense_stream_kernels_hold_the_bulk_copy():
    """The SASS of kernels 4, 5 and 6 (dense_stream) and of the strip walks
    of kernels 16, 18, 19, 19-bcast (its own planes type,
    StripTilePlanes), the zero-tile walks of 15-, 9-, 12-, 17- and
    19-bcast (StripQ1Planes, StripHiPlanes) and probe P4s (the q16 plane
    on the triangle) issues TMA bulk copies (UBLKCP); that of
    the dense_rows kernels (3 and the df64 control) and of the strip
    walks' controls (the two-pass walk's pass 1 on the slab tables and on
    the q16 and fq rectangles, and the tile-reading walks of 15-, 9-, 12-
    and 17-bcast) none."""
    from lam_tpu_torch.ops import _build
    kernels = _build.sass()
    stream = [k for k in kernels if "dense_stream" in k]
    rows = [k for k in kernels if "dense_rows" in k]
    strip = [k for k in kernels if "strip_pass1" in k]
    twopass = [k for k in kernels if "symm_pass1" in k and any(
        plane in k and walk in k for plane, walk in (
            ("8Q16Plane", "TableWalk"), ("8Q16Plane", "8RectWalk"),
            ("7FQPlane", "8RectWalk"), ("11FQTilePlane", "TriangleWalk"),
            ("13DF64TilePlane", "TableWalk"), ("13DF64TilePlane", "8RectWalk"),
            ("11FQTilePlane", "TableWalk")))]
    assert sorted("DF64Stream" in k for k in stream) == [False, True, True]
    assert sorted("DF64Mat" in k for k in rows) == [False, True]
    assert len(strip) == 10 and len(twopass) == 7
    planes = ("StripPlanesILi1E", "StripPlanesILi3E", "StripTilePlanes",
              "StripQ1Planes", "StripHiPlanes")
    walks = ("TableWalk", "RectWalk", "TriangleWalk")
    assert sorted((next(p for p in planes if p in k),
                   next(w for w in walks if w in k)) for k in strip) == [
        ("StripHiPlanes", "RectWalk"), ("StripHiPlanes", "TableWalk"),
        ("StripPlanesILi1E", "RectWalk"), ("StripPlanesILi1E", "TableWalk"),
        ("StripPlanesILi1E", "TriangleWalk"), ("StripPlanesILi3E", "RectWalk"),
        ("StripQ1Planes", "RectWalk"), ("StripQ1Planes", "TableWalk"),
        ("StripQ1Planes", "TriangleWalk"), ("StripTilePlanes", "RectWalk")]
    for k in stream + strip:
        assert any("UBLKCP" in line for line in kernels[k])
    for k in rows + twopass:
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


# shards of a row-sharded grid (H a multiple of 8, not all of 32) and the
# demo's width: (H, W, nrows, nxi)
STENCIL_SHARDS = [(8, 128, 8, 100), (24, 128, 20, 128), (40, 128, 40, 90),
                  (8, 1280, 5, 1280), (24, 1280, 24, 1198),
                  (40, 1280, 33, 1100)]


@pytest.mark.parametrize("H,W,nrows,nxi", STENCIL_SHARDS)
def test_laplace5_kernel_equals_its_control(H, W, nrows, nxi):
    """Kernel 20 (every load of a lane in flight, pass 2 a programmatic
    dependent) gives its control's bits (the two ordinary launches) on
    halo shards with live edge rows; each counts its own launch."""
    rng = np.random.default_rng(H * W + nrows)
    p, up, dn = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .cuda() for s in ((H, W), (1, W), (1, W)))
    ops.reset_counters()
    probe.reset_counters()
    y, d = stencil.laplace5_f32_halo(p, up, dn, nrows, nxi=nxi, tbr=8)
    yc, dc = probe.laplace5_f32_halo_twopass(p, up, dn, nrows, nxi=nxi,
                                             tbr=8)
    torch.cuda.synchronize()
    assert ops.counters()["laplace5_f32_halo"] == 1
    assert probe.counters()["laplace5_f32_halo_twopass"] == 1
    assert not any(v for k, v in {**ops.counters(), **probe.counters()}
                   .items() if k.endswith("_plain"))
    assert torch.equal(y, yc) and torch.equal(d, dc)
    assert torch.equal(y, stencil.laplace5_f32_halo_plain(
        p, up, dn, nrows, nxi=nxi)[0])


def test_laplace5_kernel_back_to_back_on_one_stream():
    """Calls enqueued back to back with no synchronisation between them
    (each pass 2 waits on its own pass 1 only), on the demo's grid and a
    shard, in turns with the control: every result equals the control's."""
    rng = np.random.default_rng(77)
    grids = []
    for H, W, nrows, nxi in ((1024, 1280, 998, 1198), (24, 1280, 20, 1200)):
        p, up, dn = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).cuda() for s in ((H, W), (1, W), (1, W)))
        grids.append((p, up, dn, nrows, nxi))
    torch.cuda.synchronize()
    outs, ctl = [], []
    for _ in range(4):
        for p, up, dn, nrows, nxi in grids:
            outs.append(stencil.laplace5_f32_halo(p, up, dn, nrows, nxi=nxi,
                                                  tbr=8))
            ctl.append(probe.laplace5_f32_halo_twopass(p, up, dn, nrows,
                                                       nxi=nxi, tbr=8))
    torch.cuda.synchronize()
    for (y, d), (yc, dc) in zip(outs, ctl):
        assert torch.equal(y, yc) and torch.equal(d, dc)


def test_laplace5_control_refuses_and_has_no_fallback(monkeypatch):
    """The control refuses what the kernel refuses, and a kernel library
    that fails to build raises from both: nothing runs in their place."""
    from lam_tpu_torch.ops import _build
    p = torch.zeros(64, 128, device="cuda")
    e = torch.zeros(1, 128, device="cuda")
    ops.reset_counters()
    probe.reset_counters()
    for fn in (stencil.laplace5_f32_halo, probe.laplace5_f32_halo_twopass):
        with pytest.raises(ValueError, match="aligned"):
            fn(p, torch.zeros(129, device="cuda")[1:].reshape(1, 128), e, 64,
               nxi=128, tbr=64)
        with pytest.raises(ValueError, match="multiple"):
            fn(torch.zeros(100, 128, device="cuda"), e, e, 100, nxi=128,
               tbr=64)

    def broken():
        raise RuntimeError("nvcc failed (exit 1)")

    monkeypatch.setattr(_build, "library", broken)
    for fn in (stencil.laplace5_f32_halo, probe.laplace5_f32_halo_twopass):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            fn(p, e, e, 64, nxi=128, tbr=64)
    assert not any(ops.counters().values())
    assert not any(probe.counters().values())


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


@pytest.mark.parametrize("n,g", SHARD_SIZES + [(10000, 4)])
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
            # kernel 6 (dense_stream) gives the dense_rows walk's bits
            zh, zl = probe.gemv_df64_rows(hi, lo, ph[cols], pl[cols], blk)
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
    with pytest.raises(ValueError, match="broadcast tile"):
        gemv.gemv_df64_symm_slab(hi, lo[:256], p, p, it, kt, lt,
                                 ms=2 * op.m, packed=True)


# (n, ranks); 2500 at G=4 walks 9 tiles a rank (72 strips, fewer than the
# card's SMs) and 4000 at G=3 84 (672 strips, not a multiple of 132)
QSHARD_SIZES = [(1500, 2), (1500, 3), (10000, 2), (10000, 4), (2500, 4),
                (4000, 3)]


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
            # kernel 16 (the strip walk) gives the two-pass walk's bits
            zd, zt = probe.gemv_q16_symm_slab_twopass(planes[0], scales[0],
                                                      ph, it, kt, lt, ms=ms)
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


@pytest.mark.parametrize("i", [0, 1])
def test_q16_strip_walk_on_a_single_tile(i):
    """A walk of one tile (T=1, 8 strips on a grid of 8 blocks): the
    diagonal tile (0, 0), which has no transpose term, or the off-diagonal
    tile (1, 0): the two-pass walk's bits, the plain version to 1e-5,
    bitwise repeats."""
    tb = layout.SYMM_TB
    rng = np.random.default_rng(70 + i)
    n = (i + 1) * tb
    q1 = torch.from_numpy(rng.integers(-32767, 32768, (tb, tb)).astype(
        np.int16)).cuda()
    s1 = torch.tensor([2.0 ** -12], device="cuda")
    p = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    it, kt, lt = (torch.tensor([x], dtype=torch.int32, device="cuda")
                  for x in (i, 0, 0))
    ops.reset_counters()
    yd, yt = gemv.gemv_q16_symm_slab(q1, s1, p, it, kt, lt, ms=tb)
    torch.cuda.synchronize()
    assert ops.counters()["gemv_q16_symm_slab"] == 1
    assert yd.shape == (tb,) and yt.shape == (n,)
    qd, qt = gemv.gemv_q16_symm_slab_plain(q1, s1, p, it, kt, lt, ms=tb)
    assert _rel(yd, qd) <= 1e-5
    assert _rel(yt, qt) <= 1e-5 if i else not torch.any(yt)
    zd, zt = probe.gemv_q16_symm_slab_twopass(q1, s1, p, it, kt, lt, ms=tb)
    assert torch.equal(yd, zd) and torch.equal(yt, zt)
    zd, zt = gemv.gemv_q16_symm_slab(q1, s1, p, it, kt, lt, ms=tb)
    assert torch.equal(yd, zd) and torch.equal(yt, zt)


def test_q16_strip_walk_refuses_misaligned_operands():
    """The strip walk copies the plane and p with TMA, which needs 16-byte
    alignment: a view that starts 2 bytes in is refused, not launched."""
    op = pcg_symm.SymmShardedOperator.from_dense(
        _shard_matrix(1500, 1)[0], mesh=pmesh.Mesh(0, 2, "cuda"),
        precision="fq")
    q1, s1 = op.operand[0], op.operand[3]
    it, kt, lt = op.operand[-3:]
    n, ms = op.n_padded, 2 * op.m
    flat = torch.zeros(q1.numel() + 8, dtype=torch.int16, device="cuda")
    q1_off = flat[1:1 + q1.numel()].view(q1.shape)
    q1_off.copy_(q1)
    p_buf = torch.zeros(n + 4, device="cuda")
    p_off = p_buf[1:1 + n]
    ops.reset_counters()
    with pytest.raises(ValueError, match="aligned"):
        gemv.gemv_q16_symm_slab(q1_off, s1, p_buf[:n], it, kt, lt, ms=ms)
    with pytest.raises(ValueError, match="aligned"):
        gemv.gemv_q16_symm_slab(q1, s1, p_off, it, kt, lt, ms=ms)
    assert ops.counters()["gemv_q16_symm_slab"] == 0


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
    with pytest.raises(ValueError, match="plane shape"):
        gemv.gemv_fq_symm_slab(q1, q2[:256], q3, s1, s2, s3, p, p, it, kt,
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


def test_slurm_started_cluster_shares_the_card(tmp_path):
    """Two ranks started as srun starts them (SLURM_LOCALID 0 and 1, no
    rank flag) on the one card: both fold onto cuda:0, exchange the same
    card UUID and so join over gloo; the halo exchange goes through."""
    from torch_sharded_worker import launch_cluster

    records = launch_cluster(2, [{"kind": "halo", "name": "halo"}],
                             str(tmp_path / "run"), 300, device="cuda",
                             launcher="slurm")
    uuid = str(torch.cuda.get_device_properties(0).uuid)
    for r, rec in enumerate(records):
        launch = rec["launch"]
        assert (launch["rank"], launch["size"], launch["device"],
                launch["backend"], launch["uuid"]) == (r, 2, "cuda:0",
                                                       "gloo", uuid)
        assert (launch["mesh_device"], launch["mesh_backend"]) == (
            "cuda:0", "gloo")
        assert launch["source"] == {
            "coordinator": "slurm", "num_processes": "slurm",
            "process_id": "slurm", "local_id": "slurm", "card": "slurm",
            "backend": "cards"}
        # rank 1's up is rank 0's last row, -(0 + 1); rank 0's is zeros
        up, _ = np.load(tmp_path / "run" / f"halo.r{r}.npy")
        assert float(up[0]) == -float(r)


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
    with pytest.raises(ValueError, match="broadcast"):
        gemv.gemv_df64_dual(torch.zeros(2 * tb, tb, device=dev), buf[:256],
                            q, q, q, q)


# (mb, cb) of the strip walk's rectangles: one tile (8 strips, fewer than
# the card's SMs), 3 x 5, rank (1, 0)'s 5 x 10 at N=10000 and 7 x 3 (168
# strips, not a multiple of 132)
STRIP_RECTS = [(1, 1), (3, 5), (5, 10), (7, 3)]


def _strip_walk_args(mb, cb, seed):
    """{kernel name: its arguments} of kernels 18 and 19 on an fq-packed
    (mb*512, cb*512) rectangle with two garbage pad tiles and pad scales."""
    tb = layout.SYMM_TB
    packs, (ph, pl, qh, ql) = _dual_case(mb * tb, cb * tb, 2, seed)
    fq = packs["fq"]
    return {"gemv_q16_dual": (fq[0], fq[3], ph, qh),
            "gemv_fq_dual": (*fq, ph, pl, qh, ql)}


@pytest.mark.parametrize("mb,cb", STRIP_RECTS)
def test_dual_strip_walks_equal_their_controls(mb, cb, monkeypatch):
    """Kernels 18 and 19 on the strip walk give their controls' bits (the
    two-pass walk) with garbage pad tiles and pad scales, and repeat
    bitwise."""
    monkeypatch.setattr(gemv, "_Q16_IMPL", "vpu")
    for name, args in _strip_walk_args(mb, cb, seed=90 + 10 * mb + cb).items():
        kernel = getattr(gemv, name)
        control = getattr(probe, f"{name}_twopass")
        ops.reset_counters()
        probe.reset_counters()
        out = kernel(*args)
        torch.cuda.synchronize()
        assert ops.counters()[name] == 1
        assert not any(probe.counters().values())
        assert all(torch.equal(u, v) for u, v in zip(out, control(*args)))
        assert probe.counters()[f"{name}_twopass"] == 1
        assert all(torch.equal(u, v) for u, v in zip(out, kernel(*args)))
        assert not any(v for k, v in ops.counters().items()
                       if k.endswith("_plain"))


def test_dual_strip_walks_refuse_misaligned_operands():
    """The strip walk copies the planes and every operand with TMA, which
    needs 16-byte alignment: a view that starts 4 bytes in is refused by the
    kernels and by their controls, and nothing is launched."""
    args = _strip_walk_args(1, 2, seed=95)

    def off(x):
        buf = torch.zeros(x.numel() + 4, dtype=x.dtype, device="cuda")
        buf[1:1 + x.numel()].copy_(x.flatten())
        return buf[1:1 + x.numel()].view(x.shape)

    ops.reset_counters()
    probe.reset_counters()
    for name, a in args.items():
        for fn in (getattr(gemv, name), getattr(probe, f"{name}_twopass")):
            vec0 = 2 if name == "gemv_q16_dual" else 6
            for k in (0, *range(vec0, len(a))):
                bad = list(a)
                bad[k] = off(a[k])
                with pytest.raises(ValueError, match="aligned"):
                    fn(*bad)
    assert not any(ops.counters().values())
    assert not any(probe.counters().values())


def test_dual_strip_walks_have_no_fallback(monkeypatch):
    """A kernel library that fails to build raises from kernels 18 and 19
    and their controls; nothing else runs in their place."""
    from lam_tpu_torch.ops import _build

    def broken():
        raise RuntimeError("nvcc failed (exit 1)")

    args = _strip_walk_args(1, 1, seed=96)
    monkeypatch.setattr(gemv, "_Q16_IMPL", "vpu")
    monkeypatch.setattr(_build, "library", broken)
    ops.reset_counters()
    probe.reset_counters()
    for name, a in args.items():
        for fn in (getattr(gemv, name), getattr(probe, f"{name}_twopass")):
            with pytest.raises(RuntimeError, match="nvcc failed"):
                fn(*a)
    assert not any(ops.counters().values())
    assert not any(probe.counters().values())


@pytest.mark.parametrize("mb,cb", STRIP_RECTS)
def test_dual_bf16_strip_walk_equals_its_control(mb, cb):
    """Kernel 18-bf16 on the strip walk (tensor-core consumers) gives its
    control's bits (q16_bf16_pass1 and rect_pass2) with garbage pad tiles
    and pad scales, and repeats bitwise."""
    fq = _strip_walk_args(mb, cb, seed=70 + 10 * mb + cb)["gemv_q16_dual"]
    ops.reset_counters()
    probe.reset_counters()
    out = gemv.gemv_q16_dual_bf16(*fq)
    torch.cuda.synchronize()
    assert ops.counters()["gemv_q16_dual_bf16"] == 1
    assert not any(probe.counters().values())
    ref = probe.gemv_q16_dual_bf16_twopass(*fq)
    assert probe.counters()["gemv_q16_dual_bf16_twopass"] == 1
    assert all(torch.equal(u, v) for u, v in zip(out, ref))
    assert all(torch.equal(u, v) for u, v in zip(
        out, gemv.gemv_q16_dual_bf16(*fq)))
    assert not any(v for k, v in {**ops.counters(), **probe.counters()}
                   .items() if k.endswith("_plain"))


def test_dual_bf16_strip_walk_refuses_and_has_no_fallback(monkeypatch):
    """Misaligned operands are refused by kernel 18-bf16 and its control,
    and a library that fails to build raises from both; nothing runs."""
    from lam_tpu_torch.ops import _build
    a = _strip_walk_args(1, 2, seed=97)["gemv_q16_dual"]

    def off(x):
        buf = torch.zeros(x.numel() + 4, dtype=x.dtype, device="cuda")
        buf[1:1 + x.numel()].copy_(x.flatten())
        return buf[1:1 + x.numel()].view(x.shape)

    ops.reset_counters()
    probe.reset_counters()
    for fn in (gemv.gemv_q16_dual_bf16, probe.gemv_q16_dual_bf16_twopass):
        for k in (0, 2, 3):
            bad = list(a)
            bad[k] = off(a[k])
            with pytest.raises(ValueError, match="aligned"):
                fn(*bad)

    def broken():
        raise RuntimeError("nvcc failed (exit 1)")

    monkeypatch.setattr(_build, "library", broken)
    for fn in (gemv.gemv_q16_dual_bf16, probe.gemv_q16_dual_bf16_twopass):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            fn(*a)
    assert not any(ops.counters().values())
    assert not any(probe.counters().values())


def test_dual_bf16_strip_walk_holds_bulk_copies_and_mma():
    """The SASS of kernel 18-bf16's pass 1 (strip_mma_pass1) issues TMA bulk
    copies and tensor-core products (HMMA); its control's pass 1
    (q16_bf16_pass1 on the rectangle) the products only."""
    from lam_tpu_torch.ops import _build
    kernels = _build.sass()
    mma = [k for k in kernels if "strip_mma_pass1" in k and "RectWalk" in k]
    ctl = [k for k in kernels if "q16_bf16_pass1" in k and "RectWalk" in k]
    assert len(mma) == 1 and len(ctl) == 1
    assert any("UBLKCP" in line for line in kernels[mma[0]])
    assert not any("UBLKCP" in line for line in kernels[ctl[0]])
    for k in mma + ctl:
        assert any("HMMA" in line for line in kernels[k])


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
    controls = {fn.__name__ for fn in probe.CONTROLS}  # not the tool's
    assert all(v > 0 for k, v in probe.counters().items()
               if not k.endswith("_plain") and k not in controls)
    assert not any(v for k, v in probe.counters().items()
                   if k.endswith("_plain"))


# -- the square walk and the broadcast tiles (kernels 1, 2 and 15) ---------

# (n, padded n): one tile (the square is its own packed buffer), a count
# of tiles that is not a multiple of PAD_MULTIPLE's, the bench size
MODE_SIZES = [(500, 512), (1500, 1536), (10000, 10240)]


def _no_plain_ran():
    return not any(v for k, v in gemv.counters().items()
                   if k.endswith("_plain"))


@pytest.mark.parametrize("n,n_p", MODE_SIZES)
def test_square_walks_give_the_packed_bits(n, n_p):
    a, (hi, lo), ph, pl = _system(n, n_p, seed=n + 40)
    sq_hi, sq_lo = (torch.from_numpy(x).cuda() for x in split_f64_host(a))
    gemv.reset_counters()
    y = gemv.gemv_f32_symm(sq_hi, ph)
    yh, yl = gemv.gemv_df64_symm(sq_hi, sq_lo, ph, pl)
    torch.cuda.synchronize()
    walk = "gemv_f32_symm" if n_p == 512 else "gemv_f32_symm_square"
    assert gemv.counters()[walk] == 1 and _no_plain_ran()
    # the same tiles summed in the same order: the packed kernel's bits
    assert torch.equal(y, gemv.gemv_f32_symm(hi, ph))
    ph2, pl2 = gemv.gemv_df64_symm(hi, lo, ph, pl)
    assert torch.equal(yh, ph2) and torch.equal(yl, pl2)
    y_plain = gemv.gemv_f32_symm_square_plain(sq_hi, ph)
    oracle = torch.mv(sq_hi.double(), ph.double())
    assert _rel(y, y_plain) <= 1e-5 and _rel(y.double(), oracle) <= 1e-5
    p = ph.double() + pl.double()
    oracle = torch.mv(torch.from_numpy(a).cuda(), p)
    assert _rel(yh.double() + yl.double(), oracle) <= 1e-13
    qh, ql = gemv.gemv_df64_symm_square_plain(sq_hi, sq_lo, ph, pl)
    assert _rel(qh.double() + ql.double(), oracle) <= 1e-13
    assert torch.count_nonzero(y[n:]) == 0
    # fixed-order reduction: bitwise repeatable
    assert torch.equal(y, gemv.gemv_f32_symm_square(sq_hi, ph)
                       if n_p > 512 else gemv.gemv_f32_symm(sq_hi, ph))
    if n_p > 512:
        yh2, yl2 = gemv.gemv_df64_symm_square(sq_hi, sq_lo, ph, pl)
        assert torch.equal(yh, yh2) and torch.equal(yl, yl2)


def test_square_walk_past_2_31_elements():
    """n = 47104: n^2 = 2.2e9 elements, so the tiles of the last row
    tiles sit past 2^31 elements of the square (size_t offsets). Bits
    equal to the packed walk over the same tiles, and the last row tile
    against an f64 oracle of its rows."""
    n = 92 * 512
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand(n, device="cuda", generator=gen) - 0.5
    sq = torch.outer(x, x).cos_()  # symmetric by construction
    p = torch.rand(n, device="cuda", generator=gen) - 0.5
    tiles, _ = gemv._square_tiles(sq, n)
    packed = tiles.reshape(-1, 512)
    del tiles
    y = gemv.gemv_f32_symm(sq, p)
    assert torch.equal(y, gemv.gemv_f32_symm(packed, p))
    tail = slice(n - 512, n)
    oracle = torch.mv(sq[tail].double(), p.double())
    assert _rel(y[tail].double(), oracle) <= 1e-5
    lo = (sq * 2.0 ** -30).contiguous()
    zero = torch.zeros_like(p)
    yh, yl = gemv.gemv_df64_symm(sq, lo, p, zero)
    lo_packed = gemv._square_tiles(lo, n)[0].reshape(-1, 512)
    ph, pl = gemv.gemv_df64_symm(packed, lo_packed, p, zero)
    assert torch.equal(yh, ph) and torch.equal(yl, pl)
    del lo_packed
    oracle = torch.mv(sq[tail].double() + lo[tail].double(), p.double())
    assert _rel(yh[tail].double() + yl[tail].double(), oracle) <= 1e-13


@pytest.mark.parametrize("n,n_p", MODE_SIZES[1:])
def test_df64_broadcast_lo_tile(n, n_p):
    a, (hi, lo), ph, pl = _system(n, n_p, seed=n + 41)
    nblk = n_p // 512
    T = layout.tri_tile_count(nblk)
    zero = torch.zeros(512, 512, device="cuda")
    gemv.reset_counters()
    yh, yl = gemv.gemv_df64_symm(hi, zero, ph, pl)
    torch.cuda.synchronize()
    assert gemv.counters()["gemv_df64_symm_bcast"] == 1 and _no_plain_ran()
    # a zero tile: the full-plane kernel's bits over a zero plane
    zh, zl = gemv.gemv_df64_symm(hi, torch.zeros_like(hi), ph, pl)
    assert torch.equal(yh, zh) and torch.equal(yl, zl)
    # any tile, added to every stored tile
    tile = lo[:512].clone() * 3.0
    yh, yl = gemv.gemv_df64_symm_bcast(hi, tile, ph, pl)
    tiles = (hi.double().reshape(T, 512, 512) + tile.double()[None])
    p = ph.double() + pl.double()
    oracle = torch.mv(_dense_of(tiles, nblk), p)
    assert _rel(yh.double() + yl.double(), oracle) <= 1e-13
    qh, ql = gemv.gemv_df64_symm_bcast_plain(hi, tile, ph, pl)
    assert _rel(qh.double() + ql.double(), oracle) <= 1e-13
    yh2, yl2 = gemv.gemv_df64_symm_bcast(hi, tile, ph, pl)
    assert torch.equal(yh, yh2) and torch.equal(yl, yl2)


@pytest.mark.parametrize("n,n_p", MODE_SIZES[1:])
def test_fq_broadcast_tiles(n, n_p):
    bufs, _, p = _fq_system(n, n_p, seed=n + 42)
    nblk = n_p // 512
    T = layout.tri_tile_count(nblk)
    q1, q2, q3, s1, s2, s3 = bufs[:6]
    ph, pl = (torch.from_numpy(x).cuda() for x in split_f64_host(p))
    zt = torch.zeros(512, 512, dtype=torch.int16, device="cuda")
    gemv.reset_counters()
    yh, yl = gemv.gemv_fq_symm(q1, zt, zt, s1, s2, s3, ph, pl)
    torch.cuda.synchronize()
    assert gemv.counters()["gemv_fq_symm_bcast"] == 1 and _no_plain_ran()
    zp = torch.zeros_like(q1)
    zh, zl = gemv.gemv_fq_symm(q1, zp, zp, s1, s2, s3, ph, pl)
    assert torch.equal(yh, zh) and torch.equal(yl, zl)
    pp = ph.double() + pl.double()
    # non-zero tiles, and one tile beside a full plane
    for t2, t3 in ((q2[512:1024].clone(), q3[:512].clone()),
                   (q2[:512].clone(), q3)):
        yh, yl = gemv.gemv_fq_symm_bcast(q1, t2, t3, s1, s2, s3, ph, pl)
        tiles = sum(q.double().reshape(-1, 512, 512)[:T]
                    * s[:T].double()[:, None, None]
                    for q, s in ((q1, s1), (t2, s2), (t3, s3)))
        oracle = torch.mv(_dense_of(tiles, nblk), pp)
        assert _rel(yh.double() + yl.double(), oracle) <= 1e-13
        qh, ql = gemv.gemv_fq_symm_bcast_plain(q1, t2, t3, s1, s2, s3, ph,
                                                pl)
        assert _rel(qh.double() + ql.double(), oracle) <= 1e-13
        yh2, yl2 = gemv.gemv_fq_symm_bcast(q1, t2, t3, s1, s2, s3, ph, pl)
        assert torch.equal(yh, yh2) and torch.equal(yl, yl2)


def test_mode_wrappers_refuse_and_have_no_fallback(monkeypatch):
    _, (hi, _), ph, pl = _system(1500, 1536, seed=43)
    sq = torch.zeros(1536, 1536, device="cuda")
    with pytest.raises(ValueError, match="packed hi plane only"):
        gemv.gemv_df64_symm(sq, torch.zeros(512, 512, device="cuda"), ph, pl)
    with pytest.raises(ValueError, match="tb=512"):  # 768 fits 256 tiles
        gemv.gemv_f32_symm(torch.zeros(768, 768, device="cuda"),
                           torch.zeros(768, device="cuda"))
    with pytest.raises(ValueError, match="broadcast"):
        gemv.gemv_df64_symm(hi, torch.zeros(256, 512, device="cuda"), ph, pl)
    from lam_tpu_torch.ops import _build

    def broken():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(_build, "library", broken)
    gemv.reset_counters()
    for call in (lambda: gemv.gemv_f32_symm_square(sq, ph),
                 lambda: gemv.gemv_df64_symm_bcast(
                     hi, torch.zeros(512, 512, device="cuda"), ph, pl)):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    assert _no_plain_ran()


GEN_RUNS = [("df64", "auto", "gemv_df64_symm_bcast"),
            ("ir", "auto", "gemv_df64_symm_bcast"),
            ("f32", "auto", "gemv_f32_symm"),
            ("fq", "auto", "gemv_fq_symm_zero"),
            ("irfq", "auto", "gemv_fq_symm_zero"),
            ("dfq", "auto", "gemv_dfq_symm"),
            ("df64", "pallas_symm", "gemv_df64_symm_square"),
            ("ir", "pallas_symm", "gemv_f32_symm_square"),
            ("df64", "pallas", "gemv_df64")]


@pytest.mark.parametrize("precision,engine,kernel", GEN_RUNS)
def test_generate_mode_solves_on_the_card(precision, engine, kernel):
    """Generate mode at n=3000 (padded to 3072): the device-built
    operator's solve to a TRUE 2e-9 on the host (the O(n) tridiagonal
    matvec; f32: 1e-5, the f32 rounding of x), through its kernel and no
    plain version."""
    from lam_tpu_torch.solver.api import ConjugateGradient
    n = 3000
    cg = ConjugateGradient(precision=precision, engine=engine,
                           device="cuda")
    cg.generate_matrix(n)
    cg.generate_rhs()
    gemv.reset_counters()
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    assert gemv.counters()[kernel] > 0 and _no_plain_ran()
    x = cg.x
    ax = 2 * x
    ax[1:] += x[:-1]
    ax[:-1] += x[1:]
    gate = 1e-5 if precision == "f32" else 2e-9
    assert np.linalg.norm(1 - ax) / np.sqrt(n) <= gate


# -- the broadcast modes of kernels 9, 17, 12 and 19 (generate mode on the
# meshes) ------------------------------------------------------------------

# (n, ranks): a 3-tile walk of a non-multiple n, the band pairs of G=2 and
# the bench size, and G=3 (84 tiles a rank)
BCAST_SLAB_SIZES = [(500, 1), (1500, 2), (10000, 2), (4000, 3)]


def _bcast_counts(name):
    """The launches of `name`'s broadcast mode and of its full-plane
    kernel, and whether any plain version ran."""
    counts = ops.counters()
    return (counts[name + "_bcast"], counts[name],
            any(v for k, v in counts.items() if k.endswith("_plain")))


def _join(o):
    return torch.cat([o[0].double() + o[1].double(),
                      o[2].double() + o[3].double()])


@pytest.mark.parametrize("n,g", BCAST_SLAB_SIZES)
def test_slab_broadcast_tiles(n, g):
    """Kernels 9 and 17 with one (512, 512) tile for lo, or for q2 and/or
    q3, on every rank's walk: a zero tile gives the full-plane kernel's
    bits over a zero plane; non-zero tiles (and one tile beside a full
    plane) against the f64 oracle of the stored values and the plain
    version at 1e-13; bitwise repeats."""
    tb = layout.SYMM_TB
    a, p = _shard_matrix(n, seed=n + 7 * g)
    for c in range(g):
        mesh = pmesh.Mesh(c, g, "cuda")
        hi, lo, it, kt, lt = pcg_symm.SymmShardedOperator.from_dense(
            a, mesh=mesh, packed=True).operand
        fq = pcg_symm.SymmShardedOperator.from_dense(
            a, mesh=mesh, precision="fq")
        ms, T = 2 * fq.m, it.shape[0]
        ph, pl = _cuda_pair(p, fq.n_padded)
        p64 = ph.double() + pl.double()
        walk = (it, kt, lt)

        def oracle(tiles):
            return torch.cat(gemv._slab_parts(tiles, p64, *walk, ms, tb,
                                              True))

        zero = torch.zeros(tb, tb, device="cuda")
        ops.reset_counters()
        out = gemv.gemv_df64_symm_slab(hi, zero, ph, pl, *walk, ms=ms,
                                       packed=True)
        torch.cuda.synchronize()
        assert _bcast_counts("gemv_df64_symm_slab") == (1, 0, False)
        full = gemv.gemv_df64_symm_slab(hi, torch.zeros_like(hi), ph, pl,
                                        *walk, ms=ms, packed=True)
        assert all(torch.equal(u, v) for u, v in zip(out, full))
        tile = lo[:tb].clone() * 3.0
        out = gemv.gemv_df64_symm_slab_bcast(hi, tile, ph, pl, *walk, ms=ms)
        want = oracle(hi.double() + tile.double().repeat(T, 1))
        assert _rel(_join(out), want) <= 1e-13
        assert _rel(_join(gemv.gemv_df64_symm_slab_bcast_plain(
            hi, tile, ph, pl, *walk, ms=ms)), want) <= 1e-13
        again = gemv.gemv_df64_symm_slab_bcast(hi, tile, ph, pl, *walk, ms=ms)
        assert all(torch.equal(u, v) for u, v in zip(out, again))

        q1, q2, q3, s1, s2, s3 = fq.operand[:6]
        zt = torch.zeros(tb, tb, dtype=torch.int16, device="cuda")
        ops.reset_counters()
        out = gemv.gemv_fq_symm_slab(q1, zt, zt, s1, s2, s3, ph, pl, *walk,
                                     ms=ms)
        torch.cuda.synchronize()
        assert _bcast_counts("gemv_fq_symm_slab") == (1, 0, False)
        zp = torch.zeros_like(q1)
        full = gemv.gemv_fq_symm_slab(q1, zp, zp, s1, s2, s3, ph, pl, *walk,
                                      ms=ms)
        assert all(torch.equal(u, v) for u, v in zip(out, full))
        for t2, t3 in ((q2[(T - 1) * tb:].clone(), q3[:tb].clone()),
                       (q2[:tb].clone(), q3)):
            args = (q1, t2, t3, s1, s2, s3, ph, pl, *walk)
            out = gemv.gemv_fq_symm_slab_bcast(*args, ms=ms)
            tiles = sum(gemv._tile_plane(q, q1).double()
                        * s.double().repeat_interleave(tb)[:, None]
                        for q, s in ((q1, s1), (t2, s2), (t3, s3)))
            want = oracle(tiles)
            assert _rel(_join(out), want) <= 1e-13
            assert _rel(_join(gemv.gemv_fq_symm_slab_bcast_plain(
                *args, ms=ms)), want) <= 1e-13
            again = gemv.gemv_fq_symm_slab_bcast(*args, ms=ms)
            assert all(torch.equal(u, v) for u, v in zip(out, again))


@pytest.mark.parametrize("mb,cb", STRIP_RECTS)
def test_dual_broadcast_tiles(mb, cb):
    """Kernels 12 and 19 with one (512, 512) tile for lo, or for q2 and/or
    q3, on rectangles of one tile to 7 x 3 with two garbage pad tiles (3 x
    5 and up stream more 32-row stages than kernel 19's ring of two
    holds): a zero tile gives the full-plane kernel's bits over a zero
    plane; non-zero tiles (and one tile beside a full plane) against the
    f64 oracle of the stored values and the plain version at 1e-13;
    bitwise repeats."""
    tb = layout.SYMM_TB
    ms, n = mb * tb, cb * tb
    packs, vecs = _dual_case(ms, n, 2, seed=300 + 10 * mb + cb)
    hi, lo = packs["df64"]
    p64 = vecs[0].double() + vecs[1].double()
    q64 = vecs[2].double() + vecs[3].double()

    def oracle(planes, scales):
        stored = _stored_rect(planes, scales, ms, n)
        return torch.cat([stored @ p64, stored.T @ q64])

    zero = torch.zeros(tb, tb, device="cuda")
    ops.reset_counters()
    out = gemv.gemv_df64_dual(hi, zero, *vecs)
    torch.cuda.synchronize()
    assert _bcast_counts("gemv_df64_dual") == (1, 0, False)
    full = gemv.gemv_df64_dual(hi, torch.zeros_like(hi), *vecs)
    assert all(torch.equal(u, v) for u, v in zip(out, full))
    tile = lo[:tb].clone() * 3.0
    out = gemv.gemv_df64_dual_bcast(hi, tile, *vecs)
    want = oracle([hi, gemv._tile_plane(tile, hi)], [])
    assert _rel(_join(out), want) <= 1e-13
    assert _rel(_join(gemv.gemv_df64_dual_bcast_plain(hi, tile, *vecs)),
                want) <= 1e-13
    again = gemv.gemv_df64_dual_bcast(hi, tile, *vecs)
    assert all(torch.equal(u, v) for u, v in zip(out, again))

    q1, q2, q3, s1, s2, s3 = packs["fq"]
    zt = torch.zeros(tb, tb, dtype=torch.int16, device="cuda")
    ops.reset_counters()
    out = gemv.gemv_fq_dual(q1, zt, zt, s1, s2, s3, *vecs)
    torch.cuda.synchronize()
    assert _bcast_counts("gemv_fq_dual") == (1, 0, False)
    zp = torch.zeros_like(q1)
    full = gemv.gemv_fq_dual(q1, zp, zp, s1, s2, s3, *vecs)
    assert all(torch.equal(u, v) for u, v in zip(out, full))
    last = (mb * cb - 1) * tb  # the rectangle's last real tile
    for t2, t3 in ((q2[last:last + tb].clone(), q3[:tb].clone()),
                   (q2[:tb].clone(), q3)):
        args = (q1, t2, t3, s1, s2, s3, *vecs)
        out = gemv.gemv_fq_dual_bcast(*args)
        want = oracle([q1, gemv._tile_plane(t2, q1),
                       gemv._tile_plane(t3, q1)], [s1, s2, s3])
        assert _rel(_join(out), want) <= 1e-13
        assert _rel(_join(gemv.gemv_fq_dual_bcast_plain(*args)), want) \
            <= 1e-13
        again = gemv.gemv_fq_dual_bcast(*args)
        assert all(torch.equal(u, v) for u, v in zip(out, again))


def test_broadcast_modes_refuse_and_have_no_fallback(monkeypatch):
    """The slab storage takes no tile (lam_tpu's wording); kernel 19
    refuses misaligned operands and its control the tiles; a broken
    library raises, and no plain version runs."""
    tb = layout.SYMM_TB
    op = pcg_symm.SymmShardedOperator.from_dense(
        _shard_matrix(1500, 1)[0], mesh=pmesh.Mesh(0, 2, "cuda"))
    hi, lo, it, kt, lt = op.operand
    p = torch.zeros(op.n_padded, device="cuda")
    zero = torch.zeros(tb, tb, device="cuda")
    with pytest.raises(ValueError, match="plane shapes differ"):
        gemv.gemv_df64_symm_slab(hi, zero, p, p, it, kt, lt)
    packs, vecs = _dual_case(tb, 2 * tb, 2, seed=400)
    q1, q2, q3, s1, s2, s3 = packs["fq"]
    zt = torch.zeros(tb, tb, dtype=torch.int16, device="cuda")
    ops.reset_counters()
    probe.reset_counters()
    with pytest.raises(ValueError, match="gemv_fq_dual_bcast"):
        probe.gemv_fq_dual_twopass(q1, zt, zt, s1, s2, s3, *vecs)
    off = torch.zeros(2 * tb + 1, device="cuda")[1:]  # 4 bytes in
    with pytest.raises(ValueError, match="aligned"):
        gemv.gemv_fq_dual(q1, zt, zt, s1, s2, s3, off, off, *vecs[2:])
    assert not any(ops.counters().values())
    assert not any(probe.counters().values())
    from lam_tpu_torch.ops import _build

    def broken():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(_build, "library", broken)
    pk = pcg_symm.SymmShardedOperator.from_dense(
        _shard_matrix(1500, 1)[0], mesh=pmesh.Mesh(0, 2, "cuda"),
        packed=True).operand
    for call in (
            lambda: gemv.gemv_df64_symm_slab(pk[0], zero, p, p, *pk[2:],
                                             ms=2 * op.m, packed=True),
            lambda: gemv.gemv_df64_dual(packs["df64"][0], zero, *vecs),
            lambda: gemv.gemv_fq_dual(q1, zt, zt, s1, s2, s3, *vecs)):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    assert not any(v for k, v in ops.counters().items()
                   if k.endswith("_plain"))


# -- the zero-tile walks of kernels 15-bcast and 9-bcast (generate mode's
# tiles, known zero when the operator is built) ---------------------------

def _signed_zeros(x, seed, share=0.25):
    """x (a card tensor) with -0.0 written over a share of its entries
    and +0.0 over as many: the zeros whose sign the dropped terms may
    change, and must not change in a sum."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.rand(x.shape, generator=gen, device="cuda")
    x = x.clone()
    x[u < share] = -0.0
    x[(u >= share) & (u < 2 * share)] = 0.0
    return x


def _odd_scales(s, seed):
    """A scale table with zero, -0.0, negative and positive entries."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pick = torch.randint(0, 4, s.shape, generator=gen, device="cuda")
    vals = torch.tensor([0.0, -0.0, -(2.0 ** -14), 2.0 ** -20],
                        device="cuda")
    return vals[pick].contiguous()


@pytest.mark.parametrize("n,n_p", MODE_SIZES[1:])
def test_fq_zero_tiles_walk(n, n_p):
    """Kernel 15-bcast's kernel for tiles of zeros (gemv_fq_symm_zero: the
    strip walk over q1 alone) equals bit for bit kernel 15 over zero planes
    and its control (the tile-reading walk on zero tiles), with -0.0 and
    +0.0 operand entries, zero entries of q1 and zero, -0.0 and negative
    scales in all three tables; against the f64 oracle at 1e-13; bitwise
    repeats. A non-zero tile keeps the tile-reading walk, at 1e-13 from its
    plain version."""
    bufs, _, p = _fq_system(n, n_p, seed=n + 60)
    nblk = n_p // 512
    T = layout.tri_tile_count(nblk)
    q1, q2, q3, s1, s2, s3 = bufs[:6]
    q1 = q1.clone()
    q1[q1.abs() < 2000] = 0  # e1 = 0 entries against every scale
    s1 = _odd_scales(s1, n) if n_p == 10240 else s1
    s2, s3 = _odd_scales(s2, n + 1), _odd_scales(s3, n + 2)
    ph, pl = (_signed_zeros(torch.from_numpy(x).cuda(), n + k)
              for k, x in enumerate(split_f64_host(p)))
    zt = torch.zeros(512, 512, dtype=torch.int16, device="cuda")
    gemv.reset_counters()
    yh, yl = gemv.gemv_fq_symm_zero(q1, s1, ph, pl)
    torch.cuda.synchronize()
    assert gemv.counters()["gemv_fq_symm_zero"] == 1 and _no_plain_ran()
    zp = torch.zeros_like(q1)
    zh, zl = gemv.gemv_fq_symm(q1, zp, zp, s1, s2, s3, ph, pl)
    assert torch.equal(yh, zh) and torch.equal(yl, zl)
    ch, cl = gemv.gemv_fq_symm_bcast(q1, zt, zt, s1, s2, s3, ph, pl)
    assert torch.equal(yh, ch) and torch.equal(yl, cl)
    yh2, yl2 = gemv.gemv_fq_symm_zero(q1, s1, ph, pl)
    assert torch.equal(yh, yh2) and torch.equal(yl, yl2)
    tiles = (q1.double().reshape(-1, 512, 512)[:T]
             * s1[:T].double()[:, None, None])
    pp = ph.double() + pl.double()
    oracle = torch.mv(_dense_of(tiles, nblk), pp)
    assert _rel(yh.double() + yl.double(), oracle) <= 1e-13
    t2, t3 = q2[512:1024].clone(), q3[:512].clone()
    gemv.reset_counters()
    got = gemv.gemv_fq_symm(q1, t2, t3, s1, s2, s3, ph, pl)
    assert gemv.counters()["gemv_fq_symm_bcast"] == 1
    qh, ql = gemv.gemv_fq_symm_bcast_plain(q1, t2, t3, s1, s2, s3, ph, pl)
    assert _rel(got[0].double() + got[1].double(),
                qh.double() + ql.double()) <= 1e-13


@pytest.mark.parametrize("n,g", BCAST_SLAB_SIZES)
def test_df64_slab_zero_tile_walk(n, g):
    """Kernel 9-bcast's kernel for a lo tile of zeros
    (gemv_df64_symm_slab_zero: the strip walk over hi alone), on every
    rank's walk: equal bit for bit to kernel 9 over a zero lo plane and to
    its control (the tile-reading walk) on a +0.0 and on a -0.0 tile, with
    -0.0 and +0.0 entries in hi and p; against the f64 oracle at 1e-13;
    bitwise repeats. A non-zero tile keeps the tile-reading walk, at 1e-13
    from its plain version."""
    tb = layout.SYMM_TB
    a, p = _shard_matrix(n, seed=n + 9 * g)
    for c in range(g):
        op = pcg_symm.SymmShardedOperator.from_dense(
            a, mesh=pmesh.Mesh(c, g, "cuda"), packed=True)
        hi, lo, it, kt, lt = op.operand
        ms = 2 * op.m
        hi = _signed_zeros(hi, n + c)
        ph, pl = (_signed_zeros(x, n + c + k)
                  for k, x in enumerate(_cuda_pair(p, op.n_padded)))
        walk = (it, kt, lt)
        ops.reset_counters()
        out = gemv.gemv_df64_symm_slab_zero(hi, ph, pl, *walk, ms=ms)
        torch.cuda.synchronize()
        assert ops.counters()["gemv_df64_symm_slab_zero"] == 1
        assert _no_plain_ran()
        full = gemv.gemv_df64_symm_slab(hi, torch.zeros_like(hi), ph, pl,
                                        *walk, ms=ms, packed=True)
        assert all(torch.equal(u, v) for u, v in zip(out, full))
        for fill in (0.0, -0.0):
            ctl = gemv.gemv_df64_symm_slab_bcast(
                hi, torch.full((tb, tb), fill, device="cuda"), ph, pl,
                *walk, ms=ms)
            assert all(torch.equal(u, v) for u, v in zip(out, ctl))
        again = gemv.gemv_df64_symm_slab_zero(hi, ph, pl, *walk, ms=ms)
        assert all(torch.equal(u, v) for u, v in zip(out, again))
        p64 = ph.double() + pl.double()
        want = torch.cat(gemv._slab_parts(hi.double(), p64, *walk, ms, tb,
                                          True))
        assert _rel(_join(out), want) <= 1e-13
        tile = lo[:tb].clone() * 3.0
        ops.reset_counters()
        got = gemv.gemv_df64_symm_slab(hi, tile, ph, pl, *walk, ms=ms,
                                       packed=True)
        assert _bcast_counts("gemv_df64_symm_slab") == (1, 0, False)
        want = _join(gemv.gemv_df64_symm_slab_bcast_plain(
            hi, tile, ph, pl, *walk, ms=ms))
        assert _rel(_join(got), want) <= 1e-13


def test_gen_operators_take_the_zero_tile_walks():
    """Generate mode's operators count their tiles zero when built and
    multiply by the zero-tile kernels alone, never the tile-reading walks:
    one device's fq (gemv_fq_symm_zero) and one rank's packed df64
    (gemv_df64_symm_slab_zero, a mesh of one rank), each equal bit for bit
    to the tile-reading walk's product, no plain version. Handed a tile
    that is not zero, the same constructors keep the tile-reading walk."""
    from lam_tpu_torch import DenseOperator
    from lam_tpu_torch.precision import join_f64, split_f64
    from lam_tpu_torch.solver.api import ConjugateGradient
    cg = ConjugateGradient(precision="fq", device="cuda")
    cg.generate_matrix(3000)
    op = cg.op
    q1, q2, q3, s1, s2, s3, dh, dl = op.operand
    x = torch.rand(op.n_padded, dtype=torch.float64, device="cuda")
    ops.reset_counters()
    y = op.matvec(x)
    torch.cuda.synchronize()
    counts = ops.counters()
    assert counts["gemv_fq_symm_zero"] == 1
    assert counts["gemv_fq_symm_bcast"] == 0 and _no_plain_ran()
    ph, pl = split_f64(x)
    want = (join_f64(*gemv.gemv_fq_symm_bcast(q1, q2, q3, s1, s2, s3, ph,
                                              pl))
            + join_f64(dh, dl) * x)
    assert torch.equal(y, want)
    one = q2.clone()
    one[3, 5] = 1
    other = DenseOperator.from_fq_planes(q1, one, q3, s1, s2, s3, dh, dl,
                                         3000, op.n_padded, device="cuda")
    ops.reset_counters()
    other.matvec(x)
    torch.cuda.synchronize()
    assert ops.counters()["gemv_fq_symm_bcast"] == 1
    assert ops.counters()["gemv_fq_symm_zero"] == 0

    band = pcg_symm.SymmShardedOperator.from_gen_tridiagonal(
        4000, mesh=pmesh.Mesh(0, 1, "cuda"), packed=True)
    hi, lo, it, kt, lt = band.operand
    x = torch.rand(band.n_padded, dtype=torch.float64, device="cuda")
    ops.reset_counters()
    y = band.matvec(x)
    torch.cuda.synchronize()
    counts = ops.counters()
    assert counts["gemv_df64_symm_slab_zero"] == 1
    assert counts["gemv_df64_symm_slab_bcast"] == 0 and _no_plain_ran()
    ph, pl = split_f64(x)
    parts = gemv.gemv_df64_symm_slab_bcast(hi, lo, ph, pl, it, kt, lt,
                                           ms=2 * band.m)
    assert torch.equal(y, pcg_symm._scatter_bands(
        join_f64(*parts[:2]), join_f64(*parts[2:]), 0, 1, band.m))
    tile = lo.clone()
    tile[0, 0] = 2.0 ** -30
    other = pcg_symm.SymmShardedOperator(
        (hi, tile, it, kt, lt), 4000, band.n_padded, band.mesh, band.m, 512,
        "packed")
    ops.reset_counters()
    other.matvec(x)
    torch.cuda.synchronize()
    assert ops.counters()["gemv_df64_symm_slab_bcast"] == 1
    assert ops.counters()["gemv_df64_symm_slab_zero"] == 0


def test_zero_tile_walks_refuse_and_have_no_fallback(monkeypatch):
    """The four zero-tile kernels: misaligned operands raise before a
    launch; a broken library raises, and no plain version runs."""
    bufs, _, p = _fq_system(1500, 1536, seed=61)
    q1, s1 = bufs[0], bufs[3]
    ph, pl = (torch.from_numpy(x).cuda() for x in split_f64_host(p))
    pk = pcg_symm.SymmShardedOperator.from_gen_tridiagonal(
        1500, mesh=pmesh.Mesh(0, 2, "cuda"), packed=True)
    hi, _, it, kt, lt = pk.operand
    v = torch.zeros(pk.n_padded, device="cuda")
    tb = layout.SYMM_TB
    packs, vecs = _dual_case(tb, 2 * tb, 2, seed=501)
    rect = packs["df64"][0]
    fq = pcg_symm.SymmShardedOperator.from_gen_fq(
        1500, mesh=pmesh.Mesh(0, 2, "cuda"))
    bq1, bs1 = fq.operand[0], fq.operand[3]
    gemv.reset_counters()
    off = torch.zeros(1536 + 1, device="cuda")[1:]  # 4 bytes in
    with pytest.raises(ValueError, match="aligned"):
        gemv.gemv_fq_symm_zero(q1, s1, off, off)
    off = torch.zeros(pk.n_padded + 1, device="cuda")[1:]
    with pytest.raises(ValueError, match="aligned"):
        gemv.gemv_df64_symm_slab_zero(hi, off, off, it, kt, lt, ms=2 * pk.m)
    with pytest.raises(ValueError, match="aligned"):
        gemv.gemv_fq_symm_slab_zero(bq1, bs1, off, off, *fq.operand[-3:],
                                    ms=2 * fq.m)
    off = torch.zeros(2 * tb + 1, device="cuda")[1:]
    with pytest.raises(ValueError, match="aligned"):
        gemv.gemv_df64_dual_zero(rect, off, off, *vecs[2:])
    off = torch.zeros(tb + 1, device="cuda")[1:]
    with pytest.raises(ValueError, match="aligned"):
        gemv.gemv_df64_dual_zero(rect, *vecs[:2], off, off)
    assert not any(gemv.counters().values())
    from lam_tpu_torch.ops import _build

    def broken():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(_build, "library", broken)
    for call in (
            lambda: gemv.gemv_fq_symm_zero(q1, s1, ph, pl),
            lambda: gemv.gemv_df64_symm_slab_zero(hi, v, v, it, kt, lt,
                                                  ms=2 * pk.m),
            lambda: gemv.gemv_fq_symm_slab_zero(bq1, bs1, v, v,
                                                *fq.operand[-3:],
                                                ms=2 * fq.m),
            lambda: gemv.gemv_df64_dual_zero(rect, *vecs)):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    assert _no_plain_ran()


# -- the zero-tile walks of kernels 12-bcast and 17-bcast ------------------

@pytest.mark.parametrize("mb,cb", STRIP_RECTS)
def test_df64_dual_zero_tile_walk(mb, cb):
    """Kernel 12-bcast's kernel for a lo tile of zeros
    (gemv_df64_dual_zero: the strip walk over the hi rectangle alone) on
    rectangles of one tile to 7 x 3 with two garbage pad tiles: equal bit
    for bit to kernel 12 over a zero lo plane and to its control (the
    tile-reading walk) on a +0.0 and on a -0.0 tile, with -0.0 and +0.0
    entries in hi, p and q; against the f64 oracle at 1e-13; bitwise
    repeats."""
    tb = layout.SYMM_TB
    ms, n = mb * tb, cb * tb
    packs, vecs = _dual_case(ms, n, 2, seed=500 + 10 * mb + cb)
    hi = _signed_zeros(packs["df64"][0], mb * cb)
    vecs = tuple(_signed_zeros(v, mb + cb + k) for k, v in enumerate(vecs))
    ops.reset_counters()
    out = gemv.gemv_df64_dual_zero(hi, *vecs)
    torch.cuda.synchronize()
    assert ops.counters()["gemv_df64_dual_zero"] == 1 and _no_plain_ran()
    full = gemv.gemv_df64_dual(hi, torch.zeros_like(hi), *vecs)
    assert all(torch.equal(u, v) for u, v in zip(out, full))
    for fill in (0.0, -0.0):
        ctl = gemv.gemv_df64_dual_bcast(
            hi, torch.full((tb, tb), fill, device="cuda"), *vecs)
        assert all(torch.equal(u, v) for u, v in zip(out, ctl))
    again = gemv.gemv_df64_dual_zero(hi, *vecs)
    assert all(torch.equal(u, v) for u, v in zip(out, again))
    stored = _stored_rect([hi], [], ms, n)
    p64 = vecs[0].double() + vecs[1].double()
    q64 = vecs[2].double() + vecs[3].double()
    want = torch.cat([stored @ p64, stored.T @ q64])
    assert _rel(_join(out), want) <= 1e-13
    assert _rel(_join(gemv.gemv_df64_dual_zero_plain(hi, *vecs)), want) \
        <= 1e-13


@pytest.mark.parametrize("n,g", BCAST_SLAB_SIZES)
def test_fq_slab_zero_tiles_walk(n, g):
    """Kernel 17-bcast's kernel for q2/q3 tiles of zeros
    (gemv_fq_symm_slab_zero: the strip walk over q1 alone, its scales per
    walk position), on every rank's walk: equal bit for bit to kernel 17
    over zero planes and to its control (the tile-reading walk on zero
    tiles), with -0.0 and +0.0 operand entries, zero entries of q1 and
    zero, -0.0 and negative scales in all three tables (rank 0; the
    pack's own s1 on the others); against the f64 oracle at 1e-13;
    bitwise repeats."""
    tb = layout.SYMM_TB
    a, p = _shard_matrix(n, seed=n + 17 * g)
    for c in range(g):
        fq = pcg_symm.SymmShardedOperator.from_dense(
            a, mesh=pmesh.Mesh(c, g, "cuda"), precision="fq")
        q1, _, _, s1, s2, s3 = fq.operand[:6]
        it, kt, lt = fq.operand[-3:]
        walk, ms = (it, kt, lt), 2 * fq.m
        q1 = q1.clone()
        q1[q1.abs() < 2000] = 0  # e1 = 0 entries against every scale
        s1 = _odd_scales(s1, n + c) if c == 0 else s1
        s2, s3 = _odd_scales(s2, n + c + 1), _odd_scales(s3, n + c + 2)
        ph, pl = (_signed_zeros(x, n + c + k)
                  for k, x in enumerate(_cuda_pair(p, fq.n_padded)))
        ops.reset_counters()
        out = gemv.gemv_fq_symm_slab_zero(q1, s1, ph, pl, *walk, ms=ms)
        torch.cuda.synchronize()
        assert ops.counters()["gemv_fq_symm_slab_zero"] == 1
        assert _no_plain_ran()
        zp = torch.zeros_like(q1)
        full = gemv.gemv_fq_symm_slab(q1, zp, zp, s1, s2, s3, ph, pl, *walk,
                                      ms=ms)
        assert all(torch.equal(u, v) for u, v in zip(out, full))
        zt = torch.zeros(tb, tb, dtype=torch.int16, device="cuda")
        ctl = gemv.gemv_fq_symm_slab_bcast(q1, zt, zt, s1, s2, s3, ph, pl,
                                           *walk, ms=ms)
        assert all(torch.equal(u, v) for u, v in zip(out, ctl))
        again = gemv.gemv_fq_symm_slab_zero(q1, s1, ph, pl, *walk, ms=ms)
        assert all(torch.equal(u, v) for u, v in zip(out, again))
        tiles = q1.double() * s1.double().repeat_interleave(tb)[:, None]
        want = torch.cat(gemv._slab_parts(tiles, ph.double() + pl.double(),
                                          *walk, ms, tb, True))
        plain = _join(gemv.gemv_fq_symm_slab_zero_plain(q1, s1, ph, pl,
                                                        *walk, ms=ms))
        if want.abs().max() > 0:
            assert _rel(_join(out), want) <= 1e-13
            assert _rel(plain, want) <= 1e-13
        else:
            assert not _join(out).any() and not plain.any()


def test_mesh_gen_operators_take_the_zero_tile_walks():
    """The symmetric grid's off-diagonal rank (1, 0) at df64 and one
    rank's packed fq band pair, built by generate mode's constructors,
    count their tiles zero when built and multiply by
    gemv_df64_dual_zero or gemv_fq_symm_slab_zero alone, never the
    tile-reading walks, each equal bit for bit to the tile-reading walk's
    product, no plain version. Handed a tile that is not zero, the same
    operators keep the tile-reading walk."""
    from lam_tpu_torch.parallel import pcg2d_symm
    from lam_tpu_torch.precision import join_f64, split_f64
    grid = pcg2d_symm.Symm2DOperator.from_gen_tridiagonal(
        4000, mesh=pmesh.Mesh2D(2, 2, "cuda"))
    hi, lo = grid.operand
    m = grid.m
    gen = torch.Generator(device="cuda").manual_seed(17)
    p_own, p_recv = (torch.rand(m, dtype=torch.float64, device="cuda",
                                generator=gen) for _ in range(2))
    ops.reset_counters()
    own, payload = grid.mv_pair(grid.operand, p_own, p_recv)
    torch.cuda.synchronize()
    counts = ops.counters()
    assert counts["gemv_df64_dual_zero"] == 1
    assert counts["gemv_df64_dual_bcast"] == 0 and _no_plain_ran()
    parts = gemv.gemv_df64_dual_bcast(hi, lo, *split_f64(p_recv),
                                      *split_f64(p_own[:m // 2]))
    assert torch.equal(own[:m // 2], join_f64(*parts[:2]))
    assert not own[m // 2:].any()
    assert torch.equal(payload, join_f64(*parts[2:]))
    tile = lo.clone()
    tile[0, 0] = 2.0 ** -30
    other = pcg2d_symm.Symm2DOperator((hi, tile), 4000, grid.n_padded,
                                      grid.mesh, 512)
    ops.reset_counters()
    other.mv_pair(other.operand, p_own, p_recv)
    torch.cuda.synchronize()
    assert ops.counters()["gemv_df64_dual_bcast"] == 1
    assert ops.counters()["gemv_df64_dual_zero"] == 0

    band = pcg_symm.SymmShardedOperator.from_gen_fq(
        4000, mesh=pmesh.Mesh(0, 1, "cuda"))
    q1, q2, q3, s1, s2, s3, dh, dl, it, kt, lt = band.operand
    x = torch.rand(band.n_padded, dtype=torch.float64, device="cuda",
                   generator=gen)
    ops.reset_counters()
    y = band.matvec(x)
    torch.cuda.synchronize()
    counts = ops.counters()
    assert counts["gemv_fq_symm_slab_zero"] == 1
    assert counts["gemv_fq_symm_slab_bcast"] == 0 and _no_plain_ran()
    ph, pl = split_f64(x)
    parts = gemv.gemv_fq_symm_slab_bcast(q1, q2, q3, s1, s2, s3, ph, pl, it,
                                         kt, lt, ms=2 * band.m)
    yd = join_f64(*parts[:2]) + join_f64(dh, dl) * pcg_symm._own_rows(
        x, 0, 1, band.m)
    assert torch.equal(y, pcg_symm._scatter_bands(
        yd, join_f64(*parts[2:]), 0, 1, band.m))
    one = q2.clone()
    one[3, 5] = 1
    other = pcg_symm.SymmShardedOperator(
        (q1, one, q3, s1, s2, s3, dh, dl, it, kt, lt), 4000, band.n_padded,
        band.mesh, band.m, 512, "fq")
    ops.reset_counters()
    other.matvec(x)
    torch.cuda.synchronize()
    assert ops.counters()["gemv_fq_symm_slab_bcast"] == 1
    assert ops.counters()["gemv_fq_symm_slab_zero"] == 0


# -- the zero-tile walk of kernel 19-bcast and probe P5s on the strip walk -

@pytest.mark.parametrize("mb,cb", STRIP_RECTS)
def test_fq_dual_zero_tiles_walk(mb, cb):
    """Kernel 19-bcast's kernel for q2/q3 tiles of zeros
    (gemv_fq_dual_zero: the strip walk over the q1 rectangle alone) on
    rectangles of one tile to 7 x 3 with two garbage pad tiles: equal bit
    for bit to kernel 19 over zero planes and to its control (the
    tile-reading walk on zero tiles), with -0.0 and +0.0 entries in p and
    q, zero entries of q1 and zero, -0.0 and negative scales in all three
    tables; against the f64 oracle at 1e-13; bitwise repeats."""
    tb = layout.SYMM_TB
    ms, n = mb * tb, cb * tb
    packs, vecs = _dual_case(ms, n, 2, seed=600 + 10 * mb + cb)
    q1, _, _, s1, s2, s3 = packs["fq"]
    q1 = q1.clone()
    q1[q1.abs() < 2000] = 0  # e1 = 0 entries against every scale
    s1 = _odd_scales(s1, mb + cb) if mb > 1 else s1
    s2, s3 = _odd_scales(s2, mb + cb + 1), _odd_scales(s3, mb + cb + 2)
    vecs = tuple(_signed_zeros(v, mb + cb + k) for k, v in enumerate(vecs))
    ops.reset_counters()
    out = gemv.gemv_fq_dual_zero(q1, s1, *vecs)
    torch.cuda.synchronize()
    assert ops.counters()["gemv_fq_dual_zero"] == 1 and _no_plain_ran()
    zp = torch.zeros_like(q1)
    full = gemv.gemv_fq_dual(q1, zp, zp, s1, s2, s3, *vecs)
    assert all(torch.equal(u, v) for u, v in zip(out, full))
    zt = torch.zeros(tb, tb, dtype=torch.int16, device="cuda")
    ctl = gemv.gemv_fq_dual_bcast(q1, zt, zt, s1, s2, s3, *vecs)
    assert all(torch.equal(u, v) for u, v in zip(out, ctl))
    again = gemv.gemv_fq_dual_zero(q1, s1, *vecs)
    assert all(torch.equal(u, v) for u, v in zip(out, again))
    stored = _stored_rect([q1], [s1], ms, n)
    p64 = vecs[0].double() + vecs[1].double()
    q64 = vecs[2].double() + vecs[3].double()
    want = torch.cat([stored @ p64, stored.T @ q64])
    plain = _join(gemv.gemv_fq_dual_zero_plain(q1, s1, *vecs))
    if want.abs().max() > 0:
        assert _rel(_join(out), want) <= 1e-13
        assert _rel(plain, want) <= 1e-13
    else:
        assert not _join(out).any() and not plain.any()


@pytest.mark.parametrize("n", [512, 2048, 10240])
def test_split_strip_walk_equals_its_control(n):
    """Probe P5s (split) on the strip walk with tensor-core consumers over
    the packed triangle gives its two-pass control's bits (q16_bf16_pass1
    and symm_pass2), repeats bitwise and agrees with its plain version at
    PROBE_TOL; one tile, 10 and 210 tiles."""
    q1, sc, p = _probe_plane(512, n, seed=70 + n)
    probe.reset_counters()
    y = probe.gemv_q16_symm_split(q1, sc, p)
    torch.cuda.synchronize()
    counts = probe.counters()
    assert counts.pop("gemv_q16_symm_split") == 1
    assert set(counts.values()) == {0}
    assert torch.equal(y, probe.gemv_q16_symm_split_twopass(q1, sc, p))
    assert torch.equal(y, probe.gemv_q16_symm_split(q1, sc, p))
    assert _rel(y, probe.gemv_q16_symm_split_plain(q1, sc, p)) \
        <= PROBE_TOL["split"]


def test_fq_dual_zero_and_split_refuse_misaligned_operands():
    """gemv_fq_dual_zero and the split walk (and its control) refuse an
    operand that starts 4 bytes into its buffer (the strip walk's bulk
    copies), before any launch."""
    tb = layout.SYMM_TB
    packs, vecs = _dual_case(tb, 2 * tb, 2, seed=610)
    q1, s1 = packs["fq"][0], packs["fq"][3]

    def off(x):
        buf = torch.zeros(x.numel() + 4, dtype=x.dtype, device="cuda")
        buf[1:1 + x.numel()].copy_(x.flatten())
        return buf[1:1 + x.numel()].view(x.shape)

    ops.reset_counters()
    probe.reset_counters()
    for k in range(4):
        bad = list(vecs)
        bad[k] = off(vecs[k])
        with pytest.raises(ValueError, match="aligned"):
            gemv.gemv_fq_dual_zero(q1, s1, *bad)
    with pytest.raises(ValueError, match="aligned"):
        gemv.gemv_fq_dual_zero(off(q1), s1, *vecs)
    pq, psc, pp = _probe_plane(512, 2048, seed=611)
    for fn in (probe.gemv_q16_symm_split, probe.gemv_q16_symm_split_twopass):
        with pytest.raises(ValueError, match="aligned"):
            fn(pq, psc, off(pp))
        with pytest.raises(ValueError, match="aligned"):
            fn(off(pq), psc, pp)
    assert not any(ops.counters().values())
    assert not any(probe.counters().values())


def test_fq_dual_zero_and_split_walks_do_not_spill():
    """ptxas' report of three strip-walk instantiations (kernel
    19-bcast's zero-tile walk, StripQ1Planes on RectWalk; P5s's
    strip_mma_pass1 over the triangle; P4s's strip_pass1 over the
    triangle, StripPlanes<1> on TriangleWalk) shows no spill and no stack
    frame at the walk's 9 warps; the split walk's SASS holds bulk copies
    and tensor-core products."""
    import re

    from lam_tpu_torch.ops import _build
    log = open(f"{_build.build()[0]}.log").read()
    name, report = None, {}
    for line in log.splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line)
        if head:
            k = head.group(1)
            split = _build.mma_engine(k) == 1 and "TriangleWalk" in k
            name = ("zero" if "strip_pass1" in k and "StripQ1Planes" in k
                    and "RectWalk" in k else "split" if split else
                    "sub8" if "strip_pass1" in k
                    and "StripPlanesILi1E" in k and "TriangleWalk" in k
                    else None)
        elif name and ("registers" in line or "spill" in line):
            report.setdefault(name, []).append(line)
    assert sorted(report) == ["split", "sub8", "zero"]
    for lines in report.values():
        assert ("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                "loads") in " ".join(lines)
    kernels = _build.sass()
    split = [k for k in kernels
             if _build.mma_engine(k) == 1 and "TriangleWalk" in k]
    assert len(split) == 1
    assert any("UBLKCP" in line for line in kernels[split[0]])
    assert any("HMMA" in line for line in kernels[split[0]])


TC_WALKS = {"hi": 2, "hybrid": 3}  # the walks of this section, by engine


@pytest.mark.parametrize("walk", list(TC_WALKS))
@pytest.mark.parametrize("n", [512, 2048, 10240])
def test_hi_hybrid_strip_walks_equal_their_controls(walk, n):
    """Probes P5h (hi) and P5y (hybrid) on the strip walk with tensor-core
    consumers over the packed triangle give their two-pass controls' bits
    (q16_bf16_pass1 and symm_pass2), repeat bitwise, launch once and no
    plain version, and agree with their plain versions at PROBE_TOL; one
    tile, 10 and 210 tiles of a random plane."""
    kernel = getattr(probe, f"gemv_q16_symm_{walk}")
    control = getattr(probe, f"gemv_q16_symm_{walk}_twopass")
    q1, sc, p = _probe_plane(512, n, seed=80 + n)
    probe.reset_counters()
    y = kernel(q1, sc, p)
    torch.cuda.synchronize()
    counts = probe.counters()
    assert counts.pop(kernel.__name__) == 1
    assert set(counts.values()) == {0}
    assert torch.equal(y, control(q1, sc, p))
    assert torch.equal(y, kernel(q1, sc, p))
    plain = getattr(probe, f"gemv_q16_symm_{walk}_plain")
    assert _rel(y, plain(q1, sc, p)) <= PROBE_TOL[walk]


@pytest.mark.parametrize("walk", list(TC_WALKS))
def test_hi_hybrid_strip_walks_on_a_padded_plane(walk):
    """On the probe tool's tridiagonal plane at n=10240 with its tile
    count padded to 8 (pad tiles of scale 0 past the walk's 210), each
    walk gives its control's bits on a random p and the closed form on p
    = 1: y + 2p = 4, and 3 at both ends, exactly."""
    kernel = getattr(probe, f"gemv_q16_symm_{walk}")
    control = getattr(probe, f"gemv_q16_symm_{walk}_twopass")
    n = 10240
    q1, sc, _, _ = probe.tridiag_q1(n, 512, pad_to=8, device="cuda")
    assert q1.shape[0] // 512 > layout.tri_tile_count(n // 512)
    p = torch.from_numpy(
        np.random.default_rng(85).standard_normal(n).astype(np.float32)
    ).cuda()
    y = kernel(q1, sc, p)
    assert torch.equal(y, control(q1, sc, p))
    assert torch.equal(y, kernel(q1, sc, p))
    ones = torch.ones(n, device="cuda")
    expect = torch.full_like(ones, 4.0)
    expect[0] = expect[-1] = 3.0
    assert torch.equal(kernel(q1, sc, ones) + 2.0 * ones, expect)


def test_hi_hybrid_walks_and_controls_refuse_misaligned_operands():
    """hi and hybrid and their two-pass controls refuse a p or a plane
    that starts 4 bytes into its buffer (the strip walk's bulk copies),
    before any launch."""
    def off(x):
        buf = torch.zeros(x.numel() + 4, dtype=x.dtype, device="cuda")
        buf[1:1 + x.numel()].copy_(x.flatten())
        return buf[1:1 + x.numel()].view(x.shape)

    q1, sc, p = _probe_plane(512, 2048, seed=612)
    probe.reset_counters()
    for walk in TC_WALKS:
        for name in (walk, f"{walk}_twopass"):
            fn = getattr(probe, f"gemv_q16_symm_{name}")
            with pytest.raises(ValueError, match="aligned"):
                fn(q1, sc, off(p))
            with pytest.raises(ValueError, match="aligned"):
                fn(off(q1), sc, p)
    assert not any(probe.counters().values())


def test_hi_hybrid_strip_walks_do_not_spill():
    """ptxas' report of the hi and hybrid strip walks (strip_mma_pass1 over
    the triangle, engines 2 and 3) shows no spill and no stack frame; their
    SASS holds bulk copies and tensor-core products, their controls'
    (q16_bf16_pass1) tensor-core products and no bulk copy."""
    import re

    from lam_tpu_torch.ops import _build
    log = open(f"{_build.build()[0]}.log").read()
    engine, report = None, {}
    for line in log.splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line)
        if head:
            k = head.group(1)
            engine = _build.mma_engine(k) if "TriangleWalk" in k else None
        elif engine in TC_WALKS.values() and ("registers" in line
                                              or "spill" in line):
            report.setdefault(engine, []).append(line)
    assert sorted(report) == sorted(TC_WALKS.values())
    for lines in report.values():
        assert ("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                "loads") in " ".join(lines)
    kernels = _build.sass()
    for engine in TC_WALKS.values():
        walk = [k for k in kernels
                if _build.mma_engine(k) == engine and "TriangleWalk" in k]
        ctl = [k for k in kernels
               if f"q16_bf16_pass1ILi{engine}E" in k and "TriangleWalk" in k]
        assert len(walk) == 1 and len(ctl) == 1
        assert any("UBLKCP" in line for line in kernels[walk[0]])
        assert any("HMMA" in line for line in kernels[walk[0]])
        assert any("HMMA" in line for line in kernels[ctl[0]])
        assert not any("UBLKCP" in line for line in kernels[ctl[0]])


# -- probe P4s (sub8) on the strip walk's summing consumers -------------------

@pytest.mark.parametrize("n", [512, 2048, 10240])
def test_sub8_strip_walk_equals_its_control(n):
    """Probe P4s (sub8) on the strip walk over the packed triangle, each
    consumer warp storing its own transpose row, gives its two-pass
    control's bits (symm_pass1 with 8 rows a strip, symm_pass2 over 64 a
    tile), repeats bitwise, launches once and no plain version, and agrees
    with its plain version at PROBE_TOL: one tile (no off-diagonal tile,
    part_t never read), 10 tiles (80 strips, fewer than the SMs) and 210
    tiles of a random plane."""
    q1, sc, p = _probe_plane(512, n, seed=90 + n)
    probe.reset_counters()
    y = probe.gemv_q16_symm_sub8(q1, sc, p)
    torch.cuda.synchronize()
    counts = probe.counters()
    assert counts.pop("gemv_q16_symm_sub8") == 1
    assert set(counts.values()) == {0}
    assert torch.equal(y, probe.gemv_q16_symm_sub8_twopass(q1, sc, p))
    assert torch.equal(y, probe.gemv_q16_symm_sub8(q1, sc, p))
    assert _rel(y, probe.gemv_q16_symm_sub8_plain(q1, sc, p)) \
        <= PROBE_TOL["sub8"]


def test_sub8_strip_walk_on_a_padded_plane():
    """On the probe tool's tridiagonal plane at n=10240 with its tile count
    padded to 8 (pad tiles of scale 0 past the walk's 210), the walk gives
    its control's bits on a random p and the closed form on p = 1: y + 2p
    = 4, and 3 at both ends, exactly."""
    n = 10240
    q1, sc, _, _ = probe.tridiag_q1(n, 512, pad_to=8, device="cuda")
    assert q1.shape[0] // 512 > layout.tri_tile_count(n // 512)
    p = torch.from_numpy(
        np.random.default_rng(95).standard_normal(n).astype(np.float32)
    ).cuda()
    y = probe.gemv_q16_symm_sub8(q1, sc, p)
    assert torch.equal(y, probe.gemv_q16_symm_sub8_twopass(q1, sc, p))
    assert torch.equal(y, probe.gemv_q16_symm_sub8(q1, sc, p))
    ones = torch.ones(n, device="cuda")
    expect = torch.full_like(ones, 4.0)
    expect[0] = expect[-1] = 3.0
    assert torch.equal(probe.gemv_q16_symm_sub8(q1, sc, ones) + 2.0 * ones,
                       expect)


def test_sub8_walk_and_control_refuse_misaligned_operands():
    """The sub8 walk and its two-pass control refuse a p or a plane that
    starts 4 bytes into its buffer (the strip walk's bulk copies), before
    any launch."""
    def off(x):
        buf = torch.zeros(x.numel() + 4, dtype=x.dtype, device="cuda")
        buf[1:1 + x.numel()].copy_(x.flatten())
        return buf[1:1 + x.numel()].view(x.shape)

    q1, sc, p = _probe_plane(512, 2048, seed=613)
    probe.reset_counters()
    for fn in (probe.gemv_q16_symm_sub8, probe.gemv_q16_symm_sub8_twopass):
        with pytest.raises(ValueError, match="aligned"):
            fn(q1, sc, off(p))
        with pytest.raises(ValueError, match="aligned"):
            fn(off(q1), sc, p)
    assert not any(probe.counters().values())


# -- staged uploads and the q1-only operator (ops/transfer.py) -------------

def _host_plane(rows, cols, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int16:
        return rng.integers(-32767, 32768, (rows, cols)).astype(np.int16)
    return rng.standard_normal((rows, cols)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.float64])
def test_pinned_uploads_equal_a_plain_copy(tmp_path, dtype):
    """to_device, stream_file_to_device and Folder through the pinned ring
    give `.to("cuda")`'s bits on a plane of many more chunks than the
    ring has slots (1 MB slots, ~24 MB plane, the last chunk short), and
    at the default 64 MB slots on a plane larger than the whole ring."""
    from lam_tpu_torch.ops import transfer
    host = _host_plane(23 * 1024 + 77, 512, dtype, seed=701)
    ref = torch.from_numpy(host).to("cuda")
    cb = 1 << 20
    assert host.nbytes > 7 * transfer.RING_DEPTH * cb
    up = transfer.to_device(host, "cuda", chunk_bytes=cb)
    path = tmp_path / "plane.bin"
    with open(path, "wb") as fh:
        fh.write(b"\0" * 16)
        host.tofile(fh)
    streamed = transfer.stream_file_to_device(str(path), 16, dtype,
                                              host.shape, "cuda",
                                              chunk_bytes=cb)
    fill = np.zeros_like(host)
    folder = transfer.Folder(host.shape, dtype, "cuda", chunk_bytes=cb)
    for avail in (0, 3000, 3001, 12000, host.shape[0] - 1, host.shape[0]):
        fill[:avail] = host[:avail]
        folder.advance(fill, avail)
        fill[avail:] = 7     # rows not final yet: must not have been sent
    for out in (up, streamed, folder.result()):
        assert out.is_cuda and out.dtype == ref.dtype
        assert torch.equal(out, ref)
    rows = transfer.RING_DEPTH * transfer.CHUNK_BYTES // 2048 + 999
    big = _host_plane(rows, 1024, np.int16, seed=702)   # 2 KB rows
    assert big.nbytes > transfer.RING_DEPTH * transfer.CHUNK_BYTES
    assert torch.equal(transfer.to_device(big, "cuda"),
                       torch.from_numpy(big).to("cuda"))


def _fq_file(tmp_path, n, seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, size=(n, n))
    a = m + m.T + n * np.eye(n)
    path = str(tmp_path / "A.bin")
    from lam_tpu_torch import io as tio
    tio.write_matrix(path, a)
    return path, a


def test_q1_only_operator_cold_warm_and_its_one_kernel(tmp_path):
    """from_file_fq_q1 cold (native pack, four buffers uploaded) and warm
    (the partial cache read) give equal device buffers, the full fq
    operator's; the device grows by those buffers alone; the inner
    matvec launches gemv_q16_symm and nothing else; the accurate one
    launches nothing and raises."""
    from lam_tpu_torch.solver.operators import DenseOperator
    path, a = _fq_file(tmp_path, 10000, seed=703)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cold = DenseOperator.from_file_fq_q1(path, pack_cache=True,
                                         device="cuda")
    grown = torch.cuda.memory_allocated() - before
    need = sum(cold.operand[i].numel() * cold.operand[i].element_size()
               for i in (0, 3, 6, 7))
    assert need <= grown <= 1.05 * need
    warm = DenseOperator.from_file_fq_q1(path, pack_cache=True,
                                         device="cuda")
    full = DenseOperator.from_file_fq(path, pack_cache=True, device="cuda")
    for i in (0, 3, 6, 7):
        assert torch.equal(cold.operand[i], warm.operand[i])
        assert torch.equal(warm.operand[i], full.operand[i])
    p = warm.prepare_b(np.random.default_rng(704).uniform(-1, 1, 10000))
    p32 = p.to(torch.float32)
    ops.reset_counters()
    y = warm.as_f32().matvec(p32)
    torch.cuda.synchronize()
    counts = ops.counters()
    assert counts["gemv_q16_symm"] == 1
    assert {k for k, v in counts.items() if v} == {"gemv_q16_symm"}
    assert torch.equal(y, full.as_f32().matvec(p32))
    ops.reset_counters()
    with pytest.raises(NotImplementedError, match="q1-only"):
        warm.matvec(p)
    assert not any(ops.counters().values())


# -- the row-sharded heat path and Jacobi PCG --------------------------------


@pytest.mark.parametrize("g,nyi,nxi", [(4, 998, 1198), (4, 34, 120),
                                       (3, 50, 100)])
def test_laplace5_halo_shards_match_plain(g, nyi, nxi):
    """The stencil on each of G row shards, its edges the neighbour rows
    the halo exchange delivers (zeros past the mesh's edges): each shard
    bit for bit its plain version, the shards' y the one-device y."""
    from lam_tpu_torch.apps import heat
    H, W, tbr = stencil.padded_hw(nyi, nxi, row_groups=g)
    hs = H // g
    rng = np.random.default_rng(g * 1000 + nyi)
    p = torch.zeros(H, W, device="cuda")
    p[:nyi, :nxi] = torch.from_numpy(
        rng.standard_normal((nyi, nxi)).astype(np.float32)).cuda()
    zero = torch.zeros(1, W, device="cuda")
    y1, _ = stencil.laplace5_f32_halo(p, zero, zero, nyi, nxi=nxi, tbr=tbr)
    ys = []
    for c in range(g):
        shard = p[c * hs:(c + 1) * hs]
        up = p[c * hs - 1:c * hs] if c else zero
        dn = p[(c + 1) * hs:(c + 1) * hs + 1] if c < g - 1 else zero
        nrows = min(max(nyi - c * hs, 0), hs)
        _check_stencil_kernel(shard, up, dn, nrows, nxi, tbr)

        class _Mesh:  # the rows the exchange delivers to rank c
            rank, size = c, g

            @staticmethod
            def halo(first, last):
                return up[0].clone(), dn[0].clone()

        apply32_dot, _ = heat._sharded_stencil_applies(_Mesh, nyi, nxi, hs,
                                                       W, tbr)
        ops.reset_counters()
        y, _ = apply32_dot(None, shard.reshape(-1))
        torch.cuda.synchronize()
        assert ops.counters()["laplace5_f32_halo"] == 1
        ys.append(y.reshape(hs, W))
    assert torch.equal(torch.cat(ys), y1)


@pytest.mark.parametrize("precision", ["df64", "irfq"])
def test_jacobi_pcg_launches_the_kernels_of_cg(precision):
    """Local Jacobi PCG on the card: the kernels of the same run without a
    preconditioner, no plain version, fewer iterations on a badly scaled
    system, a TRUE residual <= 1e-9."""
    from lam_tpu_torch import DenseOperator, cg_solve, cg_solve_ir, generate
    from lam_tpu_torch.solver.cg import default_inner_floor
    n = 2000
    s = np.exp(np.linspace(0.0, 1.0, n))
    a = generate.random_spd_matrix_fast(n, seed=6) * np.outer(s, s)
    b = generate.random_rhs(n, seed=16)
    kernels = {"df64": ("gemv_df64_symm",),
               "irfq": ("gemv_q16_symm", "gemv_fq_symm")}[precision]
    if precision == "df64":
        op = DenseOperator.from_dense(a, precision="df64", device="cuda")

        def solve(pre):
            return cg_solve(op, b, max_iters=20000, rel_error=5e-10,
                            preconditioner=pre)
    else:
        op = DenseOperator.from_dense_fq(a, device="cuda")

        def solve(pre):
            return cg_solve_ir(op.as_f32(), op, b, max_iters=20000,
                               rel_error=5e-10,
                               inner_floor=default_inner_floor("irfq"),
                               preconditioner=pre)
    launched = []
    for pre in (None, "jacobi"):
        ops.reset_counters()
        res = solve(pre)
        torch.cuda.synchronize()
        counts = ops.counters()
        launched.append({k for k, v in counts.items() if v})
        assert bool(res.converged)
        x = res.x.cpu().numpy()
        assert np.linalg.norm(b - a @ x) <= 1e-9 * np.linalg.norm(b)
        for k in kernels:
            assert counts[k] > 0, (pre, k)
        assert not any(counts[fn.__name__] for fn in ops.PLAIN)
        if pre is None:
            plain_iters = int(res.num_iters)
    assert launched[0] == launched[1]
    assert int(res.num_iters) < plain_iters


@pytest.mark.parametrize("precision", ["df64", "irfq"])
def test_checkpoint_round_trip_on_the_card(tmp_path, precision):
    """A resumable solve on the card stopped (df64 after 40 iterations,
    irfq after one refinement cycle) with its state on disk and resumed:
    bitwise the uninterrupted resumable run, which is bitwise cg_solve's
    (df64) or the fused cg_solve_ir's (irfq), through the kernels of the
    path and no plain version."""
    from lam_tpu_torch import DenseOperator, cg_solve, cg_solve_ir, generate
    from lam_tpu_torch.solver import checkpoint as ckpt
    from lam_tpu_torch.solver.cg import default_inner_floor
    n = 2000
    a = generate.random_spd_matrix_fast(n, seed=8)
    b = generate.random_rhs(n, seed=18)
    ck = str(tmp_path / "ck")
    ops.reset_counters()
    if precision == "df64":
        op = DenseOperator.from_dense(a, precision="df64", device="cuda")
        kw = dict(max_iters=10000, rel_error=1e-9)
        full, _ = ckpt.cg_solve_resumable(op, b, segment=100, **kw)
        ckpt.cg_solve_resumable(op, b, max_iters=40, rel_error=1e-9,
                                segment=15, checkpoint_path=ck)
        res, _ = ckpt.cg_solve_resumable(op, b, checkpoint_path=ck,
                                         resume=True, **kw)
        ref = cg_solve(op, b, **kw)
        kernels = ("gemv_df64_symm",)
    else:
        op = DenseOperator.from_dense_fq(a, device="cuda")
        kw = dict(max_iters=10000, rel_error=1e-9,
                  inner_floor=default_inner_floor("irfq"))
        full, _ = ckpt.cg_solve_ir_resumable(op.as_f32(), op, b, **kw)
        ckpt.cg_solve_ir_resumable(op.as_f32(), op, b, max_cycles=1,
                                   checkpoint_path=ck, **kw)
        res, _ = ckpt.cg_solve_ir_resumable(op.as_f32(), op, b,
                                            checkpoint_path=ck, resume=True,
                                            **kw)
        ref = cg_solve_ir(op.as_f32(), op, b, **kw)
        kernels = ("gemv_q16_symm", "gemv_fq_symm")
    torch.cuda.synchronize()
    counts = ops.counters()
    assert bool(res.converged) and torch.equal(res.x, full.x)
    assert torch.equal(full.x, ref.x)
    assert int(res.num_iters) == int(full.num_iters) == int(ref.num_iters)
    x = res.x.cpu().numpy()
    assert np.linalg.norm(b - a @ x) <= 2e-9 * np.linalg.norm(b)
    for k in kernels:
        assert counts[k] > 0
    assert not any(counts[fn.__name__] for fn in ops.PLAIN)


def test_xla_df64_matvec_against_the_f64_oracle():
    """Engine xla on the card: the (hi, lo) squares cast to f64 at the
    call, against the f64 square's product, at 1e-13; no kernel."""
    from lam_tpu_torch import DenseOperator, generate
    n = 10000
    a = generate.random_spd_matrix_fast(n, seed=9)
    p = np.random.default_rng(19).standard_normal(n)
    ops.reset_counters()
    op = DenseOperator.from_dense(a, precision="df64", engine="xla",
                                  device="cuda")
    oracle = DenseOperator.from_dense(a, precision="f64", device="cuda")
    assert (op.engine, oracle.engine, op.n_padded) == ("xla", "xla", n)
    y = op.matvec(op.prepare_b(p))
    ref = oracle.matvec(oracle.prepare_b(p))
    rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
    assert rel <= 1e-13, rel
    torch.cuda.synchronize()
    assert not any(ops.counters().values())


def test_block_cg_on_the_card():
    """cg_solve_block over 4 right-hand sides on the packed df64 operator
    (the triangle's block walk, plain torch) and on the xla f64 square:
    each column's TRUE residual on the host, no kernel launched."""
    from lam_tpu_torch import DenseOperator, cg_solve_block, generate
    n = 3000
    a = generate.random_spd_matrix_fast(n, seed=10)
    bb = np.random.default_rng(20).uniform(-1, 1, (n, 4))
    ops.reset_counters()
    for op in (DenseOperator.from_dense(a, precision="df64", device="cuda"),
               DenseOperator.from_dense(a, precision="f64", device="cuda")):
        res = cg_solve_block(op, bb, max_iters=10000, rel_error=1e-9)
        assert bool(res.converged.all()) and res.x.shape == (n, 4)
        x = res.x.cpu().numpy()
        for j in range(4):
            assert (np.linalg.norm(bb[:, j] - a @ x[:, j])
                    <= 2e-9 * np.linalg.norm(bb[:, j])), j
    torch.cuda.synchronize()
    assert not any(ops.counters().values())


def test_entry_launches_kernel_4():
    """dryrun.entry() on the card: 20 iterations of the df64 CG loop over
    kernel 4 (`gemv_df64`), no plain version, x within 1e-10 relative of
    the f64 oracle's after 20 iterations."""
    from lam_tpu_torch import dryrun, generate
    from lam_tpu_torch.solver import oracle_cg
    fn, args = dryrun.entry()
    assert all(t.device.type == "cuda" for t in args)
    ops.reset_counters()
    x = fn(*args)
    torch.cuda.synchronize()
    counts = ops.counters()
    assert counts["gemv_df64"] >= 20 and counts["gemv_df64_plain"] == 0
    a, b = generate.tridiagonal_matrix(512), generate.ones_rhs(512)
    xo = oracle_cg(a, b, max_iters=20)[0]
    x = x.cpu().numpy()
    assert np.linalg.norm(x - xo) / np.linalg.norm(xo) < 1e-10


def test_dryrun_multichip_two_ranks_on_the_card():
    """dryrun_multichip(2): two rank processes share the card over gloo;
    every leg passes against the oracle, launches the kernels of its
    KERNELS_OF row and no plain version (the function raises otherwise)."""
    from lam_tpu_torch import dryrun
    recs = dryrun.dryrun_multichip(2, device="cuda")
    assert [r["leg"] for r in recs] == dryrun.legs_of(2)
    for rec in recs:
        assert rec["plain"] == {}, rec
        assert all(rec["kernels"].get(k) for k in dryrun.KERNELS_OF[
            rec["leg"]]), rec


@pytest.mark.parametrize("mode,n,precision,kernels", [
    ("gen", 4096, "auto", ("gemv_df64_symm_bcast",)),
    ("spd", 1024, "df64", ("gemv_df64_symm",)),
    ("spd", 1024, "ir", ("gemv_f32_symm", "gemv_df64_symm")),
    ("spd", 1024, "irfq", ("gemv_q16_symm", "gemv_fq_symm"))])
def test_bench_run_one_launches_its_kernels(mode, n, precision, kernels):
    """lam_tpu_torch.bench.runner.run_one on the card: gen mode's capped
    probe (num_iter 16) and spd mode's in-memory build through the
    facade's _build_operator, each launching its storage's kernels and no
    plain version."""
    from lam_tpu_torch.bench import runner
    ops.reset_counters()
    row = runner.run_one(n, mode, 15 if mode == "gen" else 10000, 1e-9,
                         "local", precision, "auto", None, device="cuda")
    torch.cuda.synchronize()
    counts = ops.counters()
    f = row.split(",")
    assert len(f) == 9 and f[:3] == [str(n), "1", "1"]
    if mode == "gen":
        assert f[6] == "16"
    else:
        assert int(f[6]) < 10000 and float(f[7]) < 1e-9
    assert all(float(x) > 0 for x in (f[3], f[4], f[5], f[8]))
    assert all(counts[k] > 0 for k in kernels), counts
    assert not any(counts[fn.__name__] for fn in ops.PLAIN), counts
