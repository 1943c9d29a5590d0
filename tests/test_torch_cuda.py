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
matrix that is not symmetric.
"""

import numpy as np
import pytest
import torch

from lam_tpu_torch.ops import gemv, layout
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
