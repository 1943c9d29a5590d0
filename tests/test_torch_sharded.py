"""The port's 1-D sharded backends (lam_tpu_torch/parallel) against
lam_tpu's, on the CPU.

Kernels, at tb=128 and n <= 1024: the plain column-block matvecs and slab
walks against lam_tpu's Pallas kernels in interpret mode (the f32 ones to
1e-6; the df64 ones to 1e-6 only, since XLA:CPU defeats their in-kernel
compensation) and against an f64 numpy oracle (1e-13), for every rank's
walk tables of g = 1, 2, 3 ranks. Storage: the walk tables and every
rank's slab, packed and row-block buffers byte-equal to lam_tpu's shards on
the conftest's 8-device virtual mesh, built here rank by rank without a
process group; the ranks' parts summed equal the port's one-device plain
matvecs. The quantized band-pair storages (dfq, fq) likewise: the plain
q16/fq/dfq slab walks against lam_tpu's kernels (q16 to 1e-6; fq and dfq
to the f64 oracle of the stored values at 1e-13 and to lam_tpu's pairs at
1e-6), every rank's planes, scales and diagonal pair byte-equal to
lam_tpu's shards, the ranks' parts plus the owners' diagonal terms summed
equal to the one-device dfq/fq/q16 matvecs at the same tile width.

Solves run in gloo CPU clusters of 2 and 4 rank processes
(tests/torch_sharded_worker.py), one launch per rank count, each running
the whole job list; the tests assert on the records. Against lam_tpu's
sharded solves on a virtual mesh of as many devices (f64 engine 'xla' for
df64, its 'ir' for ir, f32 'xla' for f32): df64 iterations within 2 of
lam_tpu's sharded count or of its one-device f64 count (the two part by 3
at G=4 on this system), ir within 2%, f32 (to 1e-5) within 2%, x within 1e-6 (f32: 1e-3) of lam_tpu's
and identical on every rank, TRUE residual <= 1e-8 (f32: 1e-4). The
quantized solves (dfq and fq: the df64 class; irq and irfq: the refinement
class) against lam_tpu's band-pair dfq/fq operators the same way; the CLI
with --pack-cache writes one shard file per rank, and a second run reads
them: same iterations, bitwise the same x.
"""

import contextlib
import io
import json
import math
import os

import numpy as np
import pytest
import torch

import lam_tpu
from lam_tpu import generate as jgen
from lam_tpu.ops import gemv as jgemv
from lam_tpu.parallel import pcg_symm as jpcg_symm
from lam_tpu.parallel.mesh import make_mesh as jmake_mesh
from lam_tpu.parallel.pcg import ShardedDenseOperator as JDense
from lam_tpu.solver import cg as jcg
from lam_tpu.solver.oracle import oracle_cg as lam_oracle_cg
from lam_tpu_torch import ConjugateGradient, DenseOperator, cg_solve_ir
from lam_tpu_torch import cli as tcli
from lam_tpu_torch import io as tio
from lam_tpu_torch.ops import gemv
from lam_tpu_torch.parallel import mesh as pmesh
from lam_tpu_torch.parallel import pcg, pcg_symm
from lam_tpu_torch.ops import layout
from lam_tpu_torch.precision import split_f64_host
from torch_sharded_worker import launch_cluster

N, SEED = 500, 41
TB = 128
RANKS = (2, 4)
# a guard against a hung cluster, not a speed claim: a 4-rank cluster of
# ~30 jobs takes about a minute alone and several beside other test workers
CLUSTER_TIMEOUT_S = 420
DENSE_PRECISIONS = ("f32", "df64", "ir")
# Jacobi-preconditioned solves, by mesh operator: (op, precision, the
# operator's "comm" or "packed"); they stop at half the TRUE gate of 1e-9
JACOBI = {"gather": ("dense", "df64", "gather"),
          "ring": ("dense", "ir", "ring"),
          "slab": ("symm", "df64", False),
          "packed": ("symm", "ir", True)}
JACOBI_REL = 5e-10
# the diagonals held against lam_tpu's: (op, precision, comm or packed)
DIAGONALS = {"gather": ("dense", "df64", "gather"),
             "ring-f32": ("dense", "f32", "ring"),
             "slab": ("symm", "df64", False),
             "packed": ("symm", "df64", True),
             "dfq": ("symm", "dfq", True), "fq": ("symm", "fq", True)}
QUANT_PRECISIONS = ("dfq", "irq", "fq", "irfq")
F32_REL_ERROR = 1e-5
# the from_file constructors at G=2, each against the operator of per-rank
# reads: (op, precision, comm or packed, the file: "bin" or its .npy twin)
FROM_FILE = {"ff-dense-df64": ("dense", "df64", "gather", "bin"),
             "ff-dense-f32-npy": ("dense", "f32", "ring", "npy"),
             "ff-slab-df64": ("symm", "df64", False, "bin"),
             "ff-packed-df64-npy": ("symm", "df64", True, "npy"),
             "ff-packed-fq": ("symm", "fq", True, "bin"),
             "ff-packed-dfq-npy": ("symm", "dfq", True, "npy")}
# lam-bench-torch over the 2 ranks (tests/test_torch_bench.py's (i)):
# name -> its flags; each runs with --backend sharded and appends to one CSV
BENCH_SIZE = 256
BENCH_JOBS = {
    "bench-gen": ["--mode", "gen", "--sizes", "1024", "-i", "15"],
    "bench-spd": ["--mode", "spd", "--sizes", str(BENCH_SIZE)],
    "bench-spd-irfq": ["--mode", "spd", "--sizes", str(BENCH_SIZE),
                       "--precision", "irfq"],
    "bench-spd-cache": ["--mode", "spd", "--sizes", str(BENCH_SIZE),
                        "--pack-cache"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _symmetric(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, size=(n, n))
    return m + m.T


def _pair(p):
    return tuple(torch.from_numpy(x) for x in split_f64_host(p))


def _rank_op(cls, a, c, g, **kw):
    """Rank c's operator of a g-rank mesh, built without a process group."""
    return cls.from_dense(a, mesh=pmesh.Mesh(c, g, "cpu"), device="cpu",
                          **kw)


def _shards(arr):
    """The per-device pieces of a lam_tpu row-sharded array, in row order."""
    return [np.asarray(s.data) for s in
            sorted(arr.addressable_shards, key=lambda s: s.index[0].start
                   or 0)]


# -- kernels ---------------------------------------------------------------


@pytest.mark.parametrize("blk", range(4))
def test_gemv_f32_cols_plain_matches_lam_tpu(blk):
    rng = np.random.default_rng(blk)
    a = rng.uniform(-1, 1, size=(256, 512)).astype(np.float32)
    p = rng.uniform(-1, 1, size=128).astype(np.float32)
    y = gemv.gemv_f32_cols(torch.from_numpy(a), torch.from_numpy(p), blk)
    ref = np.asarray(jgemv.gemv_f32_cols(a, p, blk))
    assert _rel(y, ref) <= 1e-6
    assert _rel(y, a[:, blk * 128:(blk + 1) * 128].astype(np.float64)
                @ p.astype(np.float64)) <= 1e-6


@pytest.mark.parametrize("blk", range(4))
def test_gemv_df64_cols_plain_matches_f64(blk):
    rng = np.random.default_rng(10 + blk)
    a = rng.uniform(-1, 1, size=(256, 512))
    p = rng.uniform(-1, 1, size=128)
    (ah, al), (ph, pl) = split_f64_host(a), split_f64_host(p)
    yh, yl = gemv.gemv_df64_cols(*(torch.from_numpy(x)
                                   for x in (ah, al, ph, pl)), blk)
    y = yh.double().numpy() + yl.double().numpy()
    cols = slice(blk * 128, (blk + 1) * 128)
    oracle = ((ah[:, cols].astype(np.float64) + al[:, cols])
              @ (ph.astype(np.float64) + pl))
    assert _rel(y, oracle) <= 1e-13
    rh, rl = jgemv.gemv_df64_cols(ah, al, ph, pl, blk)
    assert _rel(y, np.asarray(rh, np.float64) + np.asarray(rl)) <= 1e-6


def test_cols_rejects_a_block_outside_the_row():
    a, p = torch.zeros(128, 256), torch.zeros(128)
    with pytest.raises(ValueError, match="block index"):
        gemv.gemv_f32_cols(a, p, 2)
    with pytest.raises(ValueError, match="not divisible"):
        gemv.gemv_f32_cols(torch.zeros(128, 384), torch.zeros(256), 0)


def _walk_oracle(tiles, p, it, kt, lt, ms):
    """f64 numpy walk: (yd (ms,), yt (n,)) of tiles (T, tb, tb)."""
    tb = tiles.shape[1]
    yd, yt = np.zeros(ms), np.zeros(p.shape[0])
    for t, (i, k, l) in enumerate(zip(it, kt, lt)):
        yd[l * tb:(l + 1) * tb] += tiles[t] @ p[k * tb:(k + 1) * tb]
        if k < i:
            yt[k * tb:(k + 1) * tb] += tiles[t].T @ p[i * tb:(i + 1) * tb]
    return yd, yt


SLAB_CASES = [(g, mt, packed) for g, mt in ((1, 2), (2, 2), (3, 1))
              for packed in (False, True)]


def _slab_ranks(g, mt, packed, seed):
    """(a, p, [(operand, tiles f64) of each rank]) of a g-rank band-pair
    geometry with mt tile-rows per band, built by the port rank by rank."""
    n = 2 * g * mt * TB
    a, p = _symmetric(n, seed), np.random.default_rng(seed).uniform(-1, 1, n)
    out = []
    for c in range(g):
        op = _rank_op(pcg_symm.SymmShardedOperator, a, c, g, tb=TB,
                      packed=packed)
        hi, lo, it, kt, lt = (x.numpy() for x in op.operand)
        if packed:
            tiles = (hi.astype(np.float64) + lo).reshape(-1, TB, TB)
        else:
            s = (hi.astype(np.float64) + lo)
            tiles = np.stack([s[l * TB:(l + 1) * TB, k * TB:(k + 1) * TB]
                              for k, l in zip(kt, lt)])
        out.append((op, tiles))
    return a, p, out


@pytest.mark.parametrize("g,mt,packed", SLAB_CASES)
def test_gemv_f32_symm_slab_plain_matches_lam_tpu(g, mt, packed):
    a, p, ranks = _slab_ranks(g, mt, packed, seed=g * 10 + mt)
    p32 = p.astype(np.float32)
    for op, _ in ranks:
        hi, _, it, kt, lt = op.operand
        ms = 2 * op.m
        yd, yt = gemv.gemv_f32_symm_slab(hi, torch.from_numpy(p32), it, kt,
                                         lt, ms=ms, packed=packed, tb=TB)
        rd, rt = jgemv.gemv_f32_symm_slab(hi.numpy(), p32, it.numpy(),
                                          kt.numpy(), lt.numpy(), tb=TB,
                                          packed=packed,
                                          ms=ms if packed else None)
        assert _rel(yd, np.asarray(rd)) <= 1e-6
        rt = np.asarray(rt)
        assert (_rel(yt, rt) <= 1e-6) if np.any(rt) else not torch.any(yt)


@pytest.mark.parametrize("g,mt,packed", SLAB_CASES)
def test_gemv_df64_symm_slab_plain_matches_f64(g, mt, packed):
    a, p, ranks = _slab_ranks(g, mt, packed, seed=g * 10 + mt + 5)
    ph, pl = _pair(p)
    for op, tiles in ranks:
        hi, lo, it, kt, lt = op.operand
        ms = 2 * op.m
        ydh, ydl, yth, ytl = gemv.gemv_df64_symm_slab(
            hi, lo, ph, pl, it, kt, lt, ms=ms, packed=packed, tb=TB)
        yd = ydh.double().numpy() + ydl.numpy()
        yt = yth.double().numpy() + ytl.numpy()
        od, ot = _walk_oracle(tiles, ph.double().numpy() + pl.numpy(),
                              it.numpy(), kt.numpy(), lt.numpy(), ms)
        assert _rel(yd, od) <= 1e-13
        assert (_rel(yt, ot) <= 1e-13) if np.any(ot) else not np.any(yt)
        # lam_tpu's interpret-mode compensation is defeated by XLA:CPU
        r = jgemv.gemv_df64_symm_slab(
            hi.numpy(), lo.numpy(), ph.numpy(), pl.numpy(), it.numpy(),
            kt.numpy(), lt.numpy(), tb=TB, packed=packed,
            ms=ms if packed else None)
        assert _rel(yd, np.asarray(r[0], np.float64) + r[1]) <= 1e-6
        if np.any(ot):
            assert _rel(yt, np.asarray(r[2], np.float64) + r[3]) <= 1e-6


def test_df64_slab_refuses_the_broadcast_lo_tile():
    """The slab storage takes no lo tile, in lam_tpu's words; the packed
    storage routes one to kernel 9's broadcast mode (its plain version
    here), and a shape that is neither form raises."""
    a = _symmetric(512, 3)
    hi, lo, it, kt, lt = _rank_op(pcg_symm.SymmShardedOperator, a, 0, 2,
                                  tb=TB).operand
    p = torch.zeros(512)
    with pytest.raises(ValueError, match="plane shapes differ"):
        gemv.gemv_df64_symm_slab(hi, lo[:TB, :TB].contiguous(), p, p, it, kt,
                                 lt, tb=TB)
    op = _rank_op(pcg_symm.SymmShardedOperator, a, 0, 2, tb=TB, packed=True)
    hi, lo, it, kt, lt = op.operand
    gemv.reset_counters()
    gemv.gemv_df64_symm_slab(hi, lo[:TB], p, p, it, kt, lt, ms=2 * op.m,
                             packed=True)
    assert gemv.counters()["gemv_df64_symm_slab_bcast_plain"] == 1
    with pytest.raises(ValueError, match="broadcast tile"):
        gemv.gemv_df64_symm_slab(hi, lo[:2 * TB], p, p, it, kt, lt,
                                 ms=2 * op.m, packed=True)


QSLAB_CASES = [(1, 2), (2, 2), (3, 1)]


def _quant_ranks(g, mt, storage, seed):
    """(a, p, [rank operators]) of a g-rank band-pair geometry with mt
    tile-rows per band in a quantized storage, built rank by rank."""
    n = 2 * g * mt * TB
    a, p = _symmetric(n, seed), np.random.default_rng(seed).uniform(-1, 1, n)
    return a, p, [_rank_op(pcg_symm.SymmShardedOperator, a, c, g, tb=TB,
                           precision=storage) for c in range(g)]


def _dequantized(planes, scales):
    """f64 (T, tb, tb) tiles of quantized planes: sum of plane * scale."""
    out = 0.0
    for q, sc in zip(planes, scales):
        out = out + (q.numpy().astype(np.float64).reshape(-1, TB, TB)
                     * sc.numpy().astype(np.float64)[:, None, None])
    return out


def _check_pairs_against(parts, tiles, p, it, kt, lt, ms, ref):
    """(yd, yt) pairs against the f64 walk of the stored values (1e-13)
    and against lam_tpu's pairs (1e-6: XLA:CPU defeats its in-kernel
    compensation)."""
    yd = parts[0].double().numpy() + parts[1].numpy()
    yt = parts[2].double().numpy() + parts[3].numpy()
    od, ot = _walk_oracle(tiles, p, it.numpy(), kt.numpy(), lt.numpy(), ms)
    assert _rel(yd, od) <= 1e-13
    assert (_rel(yt, ot) <= 1e-13) if np.any(ot) else not np.any(yt)
    assert _rel(yd, np.asarray(ref[0], np.float64) + ref[1]) <= 1e-6
    if np.any(ot):
        assert _rel(yt, np.asarray(ref[2], np.float64) + ref[3]) <= 1e-6


@pytest.mark.parametrize("g,mt", QSLAB_CASES)
def test_gemv_q16_symm_slab_plain_matches_lam_tpu(g, mt):
    a, p, ranks = _quant_ranks(g, mt, "fq", seed=g * 10 + mt + 1)
    p32 = p.astype(np.float32)
    for op in ranks:
        q1, s1 = op.operand[0], op.operand[3]
        it, kt, lt = op.operand[-3:]
        ms = 2 * op.m
        yd, yt = gemv.gemv_q16_symm_slab(q1, s1, torch.from_numpy(p32), it,
                                         kt, lt, ms=ms)
        rd, rt = jgemv.gemv_q16_symm_slab(q1.numpy(), s1.numpy(), p32,
                                          it.numpy(), kt.numpy(), lt.numpy(),
                                          ms=ms)
        assert _rel(yd, np.asarray(rd)) <= 1e-6
        rt = np.asarray(rt)
        assert (_rel(yt, rt) <= 1e-6) if np.any(rt) else not torch.any(yt)
        od, ot = _walk_oracle(_dequantized([q1], [s1]), p32.astype(np.float64),
                              it.numpy(), kt.numpy(), lt.numpy(), ms)
        assert _rel(yd, od) <= 1e-6


@pytest.mark.parametrize("g,mt", QSLAB_CASES)
def test_gemv_fq_symm_slab_plain_matches_f64(g, mt):
    a, p, ranks = _quant_ranks(g, mt, "fq", seed=g * 10 + mt + 2)
    ph, pl = _pair(p)
    for op in ranks:
        planes, scales = op.operand[:3], op.operand[3:6]
        it, kt, lt = op.operand[-3:]
        ms = 2 * op.m
        parts = gemv.gemv_fq_symm_slab(*planes, *scales, ph, pl, it, kt, lt,
                                       ms=ms)
        ref = jgemv.gemv_fq_symm_slab(
            *(x.numpy() for x in (*planes, *scales, ph, pl, it, kt, lt)),
            ms=ms)
        _check_pairs_against(parts, _dequantized(planes, scales),
                             ph.double().numpy() + pl.numpy(), it, kt, lt,
                             ms, ref)


@pytest.mark.parametrize("g,mt", QSLAB_CASES)
def test_gemv_dfq_symm_slab_plain_matches_f64(g, mt):
    a, p, ranks = _quant_ranks(g, mt, "dfq", seed=g * 10 + mt + 3)
    ph, pl = _pair(p)
    for op in ranks:
        hi, loq, sc = op.operand[:3]
        it, kt, lt = op.operand[-3:]
        ms = 2 * op.m
        parts = gemv.gemv_dfq_symm_slab(hi, loq, sc, ph, pl, it, kt, lt,
                                        ms=ms)
        ref = jgemv.gemv_dfq_symm_slab(
            *(x.numpy() for x in (hi, loq, sc, ph, pl, it, kt, lt)), ms=ms)
        tiles = (hi.numpy().astype(np.float64).reshape(-1, TB, TB)
                 + _dequantized([loq], [sc]))
        _check_pairs_against(parts, tiles, ph.double().numpy() + pl.numpy(),
                             it, kt, lt, ms, ref)


def test_quantized_slab_walks_refuse_what_lam_tpu_refuses():
    op = _rank_op(pcg_symm.SymmShardedOperator, _symmetric(512, 4), 0, 2,
                  tb=TB, precision="fq")
    q1, q2, q3, s1, s2, s3, _, _, it, kt, lt = op.operand
    p, ms = torch.zeros(512), 2 * op.m
    with pytest.raises(ValueError, match="plane shape"):
        gemv.gemv_fq_symm_slab(q1, q2[:2 * TB], q3, s1, s2, s3, p, p, it, kt,
                               lt, ms=ms)
    with pytest.raises(ValueError, match="table shape"):
        gemv.gemv_q16_symm_slab(q1, s1[:-1], p, it, kt, lt, ms=ms)
    with pytest.raises(ValueError, match="walk table has"):
        gemv.gemv_q16_symm_slab(q1, s1, p, it[:-1], kt[:-1], lt[:-1], ms=ms)
    with pytest.raises(ValueError, match="needs ms"):
        gemv.gemv_fq_symm_slab(q1, q2, q3, s1, s2, s3, p, p, it, kt, lt,
                               ms=None)
    dfq = _rank_op(pcg_symm.SymmShardedOperator, _symmetric(512, 4), 0, 2,
                   tb=TB, precision="dfq")
    hi, loq, sc = dfq.operand[:3]
    with pytest.raises(ValueError, match="quantized lo plane shape"):
        gemv.gemv_dfq_symm_slab(hi, loq[:TB], sc, p, p, it, kt, lt, ms=ms)
    with pytest.raises(ValueError, match="comp="):
        gemv.gemv_dfq_symm_slab(hi, loq, sc, p, p, it, kt, lt, ms=ms,
                                comp="defer")


# -- storage ---------------------------------------------------------------


@pytest.mark.parametrize("g,mt,tb", [(1, 1, 128), (2, 2, 128), (3, 1, 256),
                                     (4, 3, 512)])
def test_band_tables_equal_lam_tpu(g, mt, tb):
    mine, ref = pcg_symm._band_tables(g, mt, tb), \
        jpcg_symm._band_tables(g, mt, tb)
    for x, y in zip(mine, ref):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_band_shards_byte_equal_lam_tpu(g, packed):
    a = _symmetric(700, g)
    ref = jpcg_symm.SymmShardedOperator.from_dense(
        a, mesh=jmake_mesh(g), tb=TB, packed=packed)
    ref_shards = [_shards(x) for x in ref.operand]
    for c in range(g):
        op = _rank_op(pcg_symm.SymmShardedOperator, a, c, g, tb=TB,
                      packed=packed)
        assert op.n_padded == ref.n_padded
        for mine, shards in zip(op.operand, ref_shards):
            want = shards[c].reshape(mine.shape)  # tables: (1, T) shards
            assert mine.numpy().dtype == want.dtype
            assert np.array_equal(mine.numpy(), want)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_row_shards_byte_equal_lam_tpu(g):
    a = jgen.random_spd_matrix(700, seed=g)
    ref = JDense.from_dense(a, mesh=jmake_mesh(g), precision="df64",
                            engine="pallas")
    for c in range(g):
        op = _rank_op(pcg.ShardedDenseOperator, a, c, g, precision="df64")
        assert (op.n_padded, op.m) == (ref.n_padded, ref.n_padded // g)
        for mine, plane in zip(op.operand, ref.operand):
            assert np.array_equal(mine.numpy(), _shards(plane)[c])


@pytest.mark.parametrize("g", [1, 2, 4])
def test_ring_parts_sum_to_the_one_device_matvec(g):
    a = _symmetric(900, g)
    rng = np.random.default_rng(g)
    ops_ = [_rank_op(pcg.ShardedDenseOperator, a, c, g, precision="df64")
            for c in range(g)]
    n_p, m = ops_[0].n_padded, ops_[0].m
    p = np.zeros(n_p)
    p[:900] = rng.uniform(-1, 1, 900)
    ph, pl = _pair(p)
    y32, y64 = [], []
    for c, op in enumerate(ops_):
        hi, lo = op.operand
        acc32, acc64 = torch.zeros(m), torch.zeros(m, dtype=torch.float64)
        for s in range(g):  # the ring's order: own block first
            blk = (c + s) % g
            cols = slice(blk * m, (blk + 1) * m)
            acc32 += gemv.gemv_f32_cols(hi, ph[cols], blk)
            acc64 += sum(x.double() for x in gemv.gemv_df64_cols(
                hi, lo, ph[cols], pl[cols], blk))
        y32.append(acc32)
        y64.append(acc64)
    hi_sq = torch.cat([op.operand[0] for op in ops_])
    lo_sq = torch.cat([op.operand[1] for op in ops_])
    assert _rel(torch.cat(y32), gemv.gemv_f32(hi_sq, ph)) <= 1e-6
    one = gemv.gemv_df64(hi_sq, lo_sq, ph, pl)
    assert _rel(torch.cat(y64), one[0].double() + one[1].double()) <= 1e-13
    a_p = np.zeros((n_p, n_p))
    a_p[:900, :900] = a
    assert _rel(torch.cat(y64), a_p @ p) <= 1e-13


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("g", [1, 2, 3, 4])
def test_band_parts_sum_to_the_one_device_matvec(g, packed):
    n = 900
    a = _symmetric(n, 30 + g)
    ops_ = [_rank_op(pcg_symm.SymmShardedOperator, a, c, g, tb=TB,
                     packed=packed) for c in range(g)]
    n_p, m = ops_[0].n_padded, ops_[0].m
    p = np.zeros(n_p)
    p[:n] = np.random.default_rng(g).uniform(-1, 1, n)
    ph, pl = _pair(p)
    y32 = torch.zeros(n_p)
    y64 = torch.zeros(n_p, dtype=torch.float64)
    for c, op in enumerate(ops_):
        hi, lo, it, kt, lt = op.operand
        yd, yt = gemv.gemv_f32_symm_slab(hi, ph, it, kt, lt, ms=2 * m,
                                         packed=packed, tb=TB)
        y32 += pcg_symm._scatter_bands(yd, yt, c, g, m)
        ydh, ydl, yth, ytl = gemv.gemv_df64_symm_slab(
            hi, lo, ph, pl, it, kt, lt, ms=2 * m, packed=packed, tb=TB)
        y64 += pcg_symm._scatter_bands(ydh.double() + ydl.double(),
                                       yth.double() + ytl.double(), c, g, m)
    # the whole triangle, packed for the one-device kernels at n_p
    one = DenseOperator.from_dense(a, precision="df64", device="cpu")
    n1 = one.n_padded  # <= n_p for every g here
    assert _rel(y32[:n1], gemv.gemv_f32_symm_plain(one.operand[0],
                                                   ph[:n1])) <= 1e-6
    yh, yl = gemv.gemv_df64_symm_plain(*one.operand, ph[:n1], pl[:n1])
    assert _rel(y64[:n1], yh.double() + yl.double()) <= 1e-13
    a_p = np.zeros((n_p, n_p))
    a_p[:n, :n] = a
    assert _rel(y64, a_p @ p) <= 1e-13
    assert not torch.any(y32[n:]) and not torch.any(y64[n:])


@pytest.mark.parametrize("storage", ["dfq", "fq"])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_quantized_band_shards_byte_equal_lam_tpu(g, storage):
    """Rank c's operand is rank c's part of lam_tpu's global arrays:
    planes (g*L, tb) -> rows [c*L, (c+1)*L), scales (g, T) -> row c,
    dh/dl (n_p,) -> [c*2m, (c+1)*2m), tables (g, T) -> row c."""
    a = _symmetric(700, 20 + g)
    ref = jpcg_symm.SymmShardedOperator.from_dense(
        a, mesh=jmake_mesh(g), tb=TB, precision=storage)
    ref_shards = [_shards(x) for x in ref.operand]
    for c in range(g):
        op = _rank_op(pcg_symm.SymmShardedOperator, a, c, g, tb=TB,
                      precision=storage)
        assert (op.n_padded, op.precision) == (ref.n_padded, storage)
        assert op.engine == ref.engine == "pallas_symm_packed"
        assert len(op.operand) == len(ref.operand)
        for mine, shards in zip(op.operand, ref_shards):
            want = shards[c].reshape(mine.shape)
            assert mine.numpy().dtype == want.dtype
            assert np.array_equal(mine.numpy(), want)
        assert op.as_f32().operand is op.operand
        assert op.as_f32().precision == "f32"


@pytest.mark.parametrize("storage", ["dfq", "fq"])
@pytest.mark.parametrize("g", [1, 2, 3, 4])
def test_quantized_band_parts_sum_to_the_one_device_matvec(g, storage,
                                                           monkeypatch):
    """At one tile width the band-pair walk stores the one-device packed
    triangle's tiles (per-tile quantization is order-free), so the ranks'
    parts plus the owners' diagonal terms are the one-device matvec."""
    monkeypatch.setattr(layout, "SYMM_TB", TB)
    n = 900
    a = _symmetric(n, 40 + g) + np.diag(np.full(n, 30.0))
    ops_ = [_rank_op(pcg_symm.SymmShardedOperator, a, c, g, tb=TB,
                     precision=storage) for c in range(g)]
    n_p, m = ops_[0].n_padded, ops_[0].m
    p = np.zeros(n_p)
    p[:n] = np.random.default_rng(g).uniform(-1, 1, n)
    ph, pl = _pair(p)
    p64 = torch.from_numpy(p)
    y32 = torch.zeros(n_p)
    y64 = torch.zeros(n_p, dtype=torch.float64)
    for c, op in enumerate(ops_):
        it, kt, lt = op.operand[-3:]
        dh, dl = op.operand[-5], op.operand[-4]
        if storage == "fq":
            yd, yt = gemv.gemv_q16_symm_slab(op.operand[0], op.operand[3],
                                             ph, it, kt, lt, ms=2 * m)
            parts = gemv.gemv_fq_symm_slab(*op.operand[:6], ph, pl, it, kt,
                                           lt, ms=2 * m)
        else:
            yd, yt = gemv.gemv_f32_symm_slab(op.operand[0], ph, it, kt, lt,
                                             ms=2 * m, packed=True)
            parts = gemv.gemv_dfq_symm_slab(*op.operand[:3], ph, pl, it, kt,
                                            lt, ms=2 * m)
        yd = yd + dh * pcg_symm._own_rows(ph, c, g, m)
        y32 += pcg_symm._scatter_bands(yd, yt, c, g, m)
        yd64 = (parts[0].double() + parts[1].double()
                + (dh.double() + dl.double())
                * pcg_symm._own_rows(p64, c, g, m))
        y64 += pcg_symm._scatter_bands(
            yd64, parts[2].double() + parts[3].double(), c, g, m)
    one = DenseOperator.from_dense(a, precision=storage, device="cpu")
    n1 = one.n_padded  # <= n_p for every g here
    assert one.operand[0].shape[1] == TB
    ref64 = one.matvec(one.prepare_b(p[:n]))
    assert _rel(y64[:n1], ref64) <= 1e-13
    o32 = one.as_f32()
    ref32 = o32.matvec(o32.prepare_b(p[:n].astype(np.float32)))
    assert _rel(y32[:n1], ref32) <= 1e-6
    a_p = np.zeros((n_p, n_p))
    a_p[:n, :n] = a
    assert _rel(y64, a_p @ p) <= (1e-12 if storage == "fq" else 1e-11)
    assert not torch.any(y32[n:]) and not torch.any(y64[n:])


@pytest.mark.parametrize("storage", ["dfq", "fq"])
def test_quantized_diagonal_of_one_rank(storage):
    a = _symmetric(300, 7) + np.diag(np.linspace(3.0, 90.0, 300))
    op = _rank_op(pcg_symm.SymmShardedOperator, a, 0, 1, tb=TB,
                  precision=storage)
    d = op.diagonal().numpy()
    # an f32 pair carries an f64 value to 2^-49 relative
    np.testing.assert_allclose(d[:300], np.diag(a), rtol=2.0 ** -48, atol=0)
    assert not d[300:].any()
    # the df64 storages give theirs too (the Jacobi preconditioner), from
    # the (hi, lo) pair of each diagonal element
    for packed in (False, True):
        op = _rank_op(pcg_symm.SymmShardedOperator, a, 0, 1, tb=TB,
                      packed=packed)
        d = op.diagonal().numpy()
        np.testing.assert_allclose(d[:300], np.diag(a), rtol=2.0 ** -48,
                                   atol=0)
        assert not d[300:].any()


def test_scatter_bands_is_the_dual_of_own_rows():
    g, m = 3, 4
    v = torch.arange(2 * g * m, dtype=torch.float64)
    total = torch.zeros_like(v)
    for c in range(g):
        own = pcg_symm._own_rows(v, c, g, m)
        total += pcg_symm._scatter_bands(own, torch.zeros_like(v), c, g, m)
    assert torch.equal(total, v)


# -- one rank, no process group --------------------------------------------


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    # the benchmark's generator (eigenvalues exp(3.5 U(-1, 1))) at n=500
    a = jgen.random_spd_matrix_fast(N, seed=SEED)
    b = jgen.random_rhs(N, seed=SEED + 10)
    d = tmp_path_factory.mktemp("sharded_system")
    tio.write_matrix(d / "A.bin", a)
    tio.write_matrix(d / "b.bin", b)
    return a, b, str(d / "A.bin"), str(d / "b.bin")


def _true_rel(a, b, x):
    return np.linalg.norm(b - a @ x) / np.linalg.norm(b)


@pytest.mark.parametrize("engine,comm", [("auto", "gather"),
                                         ("pallas", "ring"),
                                         ("pallas_symm", "gather"),
                                         ("pallas_symm_packed", "gather")])
def test_one_rank_sharded_solve(system, engine, comm, capsys):
    """A mesh of one rank (no process group): every collective is the
    identity and the ring falls back to gather."""
    a, b, a_path, b_path = system
    cg = ConjugateGradient(backend="sharded", precision="ir", engine=engine,
                           comm=comm, device="cpu", pack_cache=True)
    assert cg.mesh.size == 1 and cg.mesh.backend is None
    assert cg.used_devices() == 1 and cg.rank == 0
    cg.load_matrix_from_file(a_path)
    assert "--pack-cache only accelerates" in capsys.readouterr().err
    cg.load_rhs_from_file(b_path)
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    assert _true_rel(a, b, cg.x) <= 1e-8
    assert cg.measure_gemv(repeats=2) > 0


# -- rank processes --------------------------------------------------------


def _launch(g, jobs, out):
    """Run the jobs in a gloo CPU cluster of g worker processes; returns
    each rank's records. Every rank is killed at the timeout."""
    return launch_cluster(g, jobs, out, CLUSTER_TIMEOUT_S)


def _jobs(g, a_path, b_path, p_path, out):
    jobs = []
    for comm in ("gather", "ring"):
        for precision in DENSE_PRECISIONS:
            jobs.append({"kind": "solve", "name": f"dense-{comm}-{precision}",
                         "op": "dense", "precision": precision,
                         "comm": comm, "matrix": a_path, "rhs": b_path,
                         "rel_error": (F32_REL_ERROR if precision == "f32"
                                       else 1e-9)})
        jobs.append({"kind": "matvec", "name": f"mv-dense-{comm}",
                     "op": "dense", "precision": "df64", "comm": comm,
                     "matrix": a_path, "p": p_path})
    for packed in (False, True):
        storage = "packed" if packed else "slab"
        for precision in ("df64", "ir"):
            jobs.append({"kind": "solve", "name": f"{storage}-{precision}",
                         "op": "symm", "precision": precision,
                         "packed": packed, "tb": TB, "matrix": a_path,
                         "rhs": b_path, "rel_error": 1e-9})
        jobs.append({"kind": "matvec", "name": f"mv-{storage}",
                     "op": "symm", "precision": "df64", "packed": packed,
                     "tb": TB, "matrix": a_path, "p": p_path})
    for precision in QUANT_PRECISIONS:
        jobs.append({"kind": "solve", "name": f"packed-{precision}",
                     "op": "symm", "precision": precision, "tb": TB,
                     "matrix": a_path, "rhs": b_path, "rel_error": 1e-9})
    for storage in ("dfq", "fq"):
        jobs.append({"kind": "matvec", "name": f"mv-{storage}", "op": "symm",
                     "precision": storage, "tb": TB, "matrix": a_path,
                     "p": p_path})
    for label, (op, precision, how) in DIAGONALS.items():
        jobs.append({"kind": "diagonal", "name": f"diag-{label}", "op": op,
                     "precision": precision, "comm": how, "packed": how,
                     "tb": TB, "matrix": a_path})
    for label, (op, precision, how) in JACOBI.items():
        jobs.append({"kind": "solve", "name": f"jacobi-{label}", "op": op,
                     "precision": precision, "comm": how, "packed": how,
                     "tb": TB, "matrix": a_path, "rhs": b_path,
                     "rel_error": JACOBI_REL, "preconditioner": "jacobi"})
    if g == 2:
        jobs.append({"kind": "cli", "name": "cli-ir", "argv": [
            "-A", a_path, "-b", b_path, "-o", os.path.join(out, "x_cli.bin"),
            "--backend", "sharded", "--precision", "ir", "--comm", "ring"]})
        # tests/test_cli.py:244-270's sharded run, df64 for lam_tpu's f64,
        # with a trace of each rank's solve
        jobs.append({"kind": "cli", "name": "cli-jacobi", "argv": [
            "-A", a_path, "-b", b_path, "-o",
            os.path.join(out, "x_cli_jacobi.bin"), "--backend", "sharded",
            "--precision", "df64", "--preconditioner", "jacobi", "-e",
            str(JACOBI_REL), "--profile", os.path.join(out, "profile")]})
        # resumable solves: the row shards on engine xla (f64) and the
        # packed band pairs' ir, each stopped, checkpointed and resumed;
        # and the CLI's --checkpoint then --resume on the row shards
        for name, op, precision, how in (
                ("ck-dense-xla", "dense", "f64", "gather"),
                ("ck-packed-ir", "symm", "ir", True)):
            jobs.append({"kind": "checkpoint", "name": name, "op": op,
                         "precision": precision, "engine": "xla",
                         "comm": how, "packed": how, "tb": TB,
                         "matrix": a_path, "rhs": b_path, "rel_error": 1e-9,
                         "dir": os.path.join(out, name)})
        ck_argv = ["-A", a_path, "-b", b_path, "--backend", "sharded",
                   "--precision", "df64", "--checkpoint",
                   os.path.join(out, "cli-ck")]
        jobs.append({"kind": "cli", "name": "cli-ck", "argv": ck_argv + [
            "-o", os.path.join(out, "x_ck.bin"), "-i", "30",
            "--checkpoint-every", "10"]})
        jobs.append({"kind": "cli", "name": "cli-resume", "argv": ck_argv + [
            "-o", os.path.join(out, "x_resume.bin"), "--resume"]})
        npy = os.path.join(os.path.dirname(p_path), "A.npy")
        for name, (op, precision, how, kind) in FROM_FILE.items():
            jobs.append({"kind": "from_file", "name": name, "op": op,
                         "precision": precision, "comm": how, "packed": how,
                         "tb": TB, "matrix": a_path if kind == "bin"
                         else npy})
        for name, flags in BENCH_JOBS.items():
            jobs.append({"kind": "bench", "name": name, "argv": flags + [
                "--backend", "sharded", "-o", os.path.join(out,
                                                           "bench.csv")],
                "env": {"LAM_BENCH_CACHE_DIR": os.path.join(out, "cache")}})
        # block CG over the row shards, the dense kernels' storage and xla
        for engine in ("auto", "xla"):
            jobs.append({"kind": "block", "name": f"block-dense-{engine}",
                         "op": "dense", "precision": "df64",
                         "engine": engine, "comm": "gather",
                         "matrix": a_path, "rhs_block": p_path[:-4]
                         + "_block.npy", "rel_error": 1e-9})
    # the facade's routing (engine auto -> the packed walk) at the CLI's
    # tile width; irfq twice with --pack-cache: cold writes the shard
    # files, warm reads them
    for name, precision, extra in (
            ("cli-irfq-cold", "irfq", ["--pack-cache"]),
            ("cli-irfq-warm", "irfq", ["--pack-cache"]),
            ("cli-irq", "irq", []), ("cli-fq", "fq", []),
            ("cli-dfq", "dfq", ["--engine", "pallas_symm_packed"])):
        jobs.append({"kind": "cli", "name": name, "argv": [
            "-A", a_path, "-b", b_path, "-o",
            os.path.join(out, f"x_{name}.bin"), "--backend", "sharded",
            "--precision", precision] + extra})
    return jobs


@pytest.fixture(scope="module")
def clusters(system, tmp_path_factory):
    """{g: (records of each rank, output directory)} of one cluster launch
    per rank count."""
    a, b, a_path, b_path = system
    d = tmp_path_factory.mktemp("clusters")
    p_path = str(d / "p.npy")
    np.save(p_path, np.random.default_rng(5).uniform(-1, 1, N))
    np.save(str(d / "p_block.npy"), _rhs_block())
    np.save(str(d / "A.npy"), a)
    out = {}
    for g in RANKS:
        run_dir = str(d / f"g{g}")
        out[g] = (_launch(g, _jobs(g, a_path, b_path, p_path, run_dir),
                          run_dir), run_dir)
    return out


@pytest.fixture(scope="module")
def lam_ref(system):
    """lam_tpu's sharded solves on virtual meshes of 2 and 4 devices, and
    its one-device f64 solve (g=1): {(g, kind): (iterations, x)}."""
    a, b = system[:2]
    out = {(1, "df64"): lam_tpu.cg_solve(
        lam_tpu.DenseOperator.from_dense(a, precision="f64"), b,
        max_iters=10000, rel_error=1e-9)}
    for g in RANKS:
        mesh = jmake_mesh(g)
        f64 = JDense.from_dense(a, mesh=mesh, precision="f64", engine="xla")
        res = lam_tpu.cg_solve(f64, b, max_iters=10000, rel_error=1e-9)
        out[g, "df64"] = res
        df64 = JDense.from_dense(a, mesh=mesh, precision="df64",
                                 engine="xla")
        out[g, "ir"] = lam_tpu.cg_solve_ir(df64.as_f32(), df64, b,
                                           max_iters=10000, rel_error=1e-9)
        f32 = JDense.from_dense(a, mesh=mesh, precision="f32", engine="xla")
        out[g, "f32"] = lam_tpu.cg_solve(f32, b, max_iters=10000,
                                         rel_error=F32_REL_ERROR)
        symm = jpcg_symm.SymmShardedOperator.from_dense(a, mesh=mesh, tb=TB)
        out[g, "symm-df64"] = lam_tpu.cg_solve(symm, b, max_iters=10000,
                                               rel_error=1e-9)
        out[g, "symm-ir"] = lam_tpu.cg_solve_ir(symm.as_f32(), symm, b,
                                                max_iters=10000,
                                                rel_error=1e-9)
        for storage, ir in (("dfq", "irq"), ("fq", "irfq")):
            quant = jpcg_symm.SymmShardedOperator.from_dense(
                a, mesh=mesh, tb=TB, precision=storage)
            out[g, f"symm-{storage}"] = lam_tpu.cg_solve(
                quant, b, max_iters=10000, rel_error=1e-9)
            out[g, f"symm-{ir}"] = lam_tpu.cg_solve_ir(
                quant.as_f32(), quant, b, max_iters=10000, rel_error=1e-9,
                inner_floor=jcg.default_inner_floor(ir))
    out[1, "jacobi-df64"] = lam_tpu.cg_solve(
        lam_tpu.DenseOperator.from_dense(a, precision="f64"), b,
        max_iters=10000, rel_error=JACOBI_REL, preconditioner="jacobi")
    for g in RANKS:
        mesh = jmake_mesh(g)
        f64 = JDense.from_dense(a, mesh=mesh, precision="f64", engine="xla")
        out[g, "jacobi-df64"] = lam_tpu.cg_solve(
            f64, b, max_iters=10000, rel_error=JACOBI_REL,
            preconditioner="jacobi")
        df64 = JDense.from_dense(a, mesh=mesh, precision="df64",
                                 engine="xla")
        out[g, "jacobi-ir"] = lam_tpu.cg_solve_ir(
            df64.as_f32(), df64, b, max_iters=10000, rel_error=JACOBI_REL,
            preconditioner="jacobi")
    for key, res in out.items():
        assert bool(res.converged), key
    return {k: (int(r.num_iters), np.asarray(r.x)) for k, r in out.items()}


@pytest.fixture(scope="module")
def lam_diag(system):
    """lam_tpu's diagonal() and _inv_diag_f32 of its sharded operators on
    the virtual meshes: {(g, label): (d, inv)}."""
    a = system[0]
    out = {}
    for g in RANKS:
        mesh = jmake_mesh(g)
        for label, (op, precision, how) in DIAGONALS.items():
            if op == "dense":
                jop = JDense.from_dense(a, mesh=mesh, precision=precision,
                                        engine="xla")
            else:
                jop = jpcg_symm.SymmShardedOperator.from_dense(
                    a, mesh=mesh, tb=TB, packed=how,
                    **({} if precision == "df64" else
                       {"precision": precision}))
            out[g, label] = (np.asarray(jop.diagonal()),
                             np.asarray(jcg._inv_diag_f32(jop)))
    return out


def _rank_xs(run_dir, name, g):
    return [np.load(os.path.join(run_dir, f"{name}.r{r}.npy"))
            for r in range(g)]


def _check_solve(system, clusters, lam_ref, g, name, ref_key, precision,
                 kernels, also=(), one_device=(1, "df64")):
    a, b = system[:2]
    records, run_dir = clusters[g]
    recs = [rank[name] for rank in records]
    ref_iters, ref_x = lam_ref[g, ref_key]
    xs = _rank_xs(run_dir, name, g)
    for rec, x in zip(recs, xs):
        assert rec["converged"] and rec["size"] == g
        assert rec["backend"] == "gloo" and rec["device"] == "cpu"
        assert rec["iters"] == recs[0]["iters"]
        assert np.array_equal(x, xs[0])  # every rank holds the same x
        for k in kernels:  # every rank walked its own part
            assert rec["counts"][k + "_plain"] > 0, (k, rec["counts"])
    iters = recs[0]["iters"]
    if precision == "df64":
        # lam_tpu's own f64 counts part by 3 between one device and G=4
        # here: within 2 of either
        # (`also`: further lam_tpu counts of the same class)
        refs = [ref_iters, lam_ref[one_device][0],
                *(lam_ref[key][0] for key in also)]
        assert min(abs(iters - r) for r in refs) <= 2, (iters, refs)
    else:
        assert abs(iters - ref_iters) <= math.ceil(0.02 * ref_iters), \
            (iters, ref_iters)
    if precision == "f32":
        assert _rel(xs[0], ref_x) <= 1e-3
        assert _true_rel(a, b, xs[0]) <= 1e-4
    else:
        assert _rel(xs[0], ref_x) <= 1e-6
        assert _true_rel(a, b, xs[0]) <= 1e-8


_DENSE_KERNELS = {"gather": {"f32": ["gemv_f32"], "df64": ["gemv_df64"],
                             "ir": ["gemv_f32", "gemv_df64"]},
                  "ring": {"f32": ["gemv_f32_cols"],
                           "df64": ["gemv_df64_cols"],
                           "ir": ["gemv_f32_cols", "gemv_df64_cols"]}}


@pytest.mark.parametrize("precision", DENSE_PRECISIONS)
@pytest.mark.parametrize("comm", ["gather", "ring"])
@pytest.mark.parametrize("g", RANKS)
def test_row_sharded_solve_matches_lam_tpu(system, clusters, lam_ref, g,
                                           comm, precision):
    _check_solve(system, clusters, lam_ref, g, f"dense-{comm}-{precision}",
                 precision, precision, _DENSE_KERNELS[comm][precision])


@pytest.mark.parametrize("precision", ["df64", "ir"])
@pytest.mark.parametrize("storage", ["slab", "packed"])
@pytest.mark.parametrize("g", RANKS)
def test_band_pair_solve_matches_lam_tpu(system, clusters, lam_ref, g,
                                         storage, precision):
    kernels = ["gemv_df64_symm_slab"] + (
        ["gemv_f32_symm_slab"] if precision == "ir" else [])
    _check_solve(system, clusters, lam_ref, g, f"{storage}-{precision}",
                 f"symm-{precision}", precision, kernels)


_QUANT_KERNELS = {"dfq": ["gemv_dfq_symm_slab"],
                  "irq": ["gemv_f32_symm_slab", "gemv_dfq_symm_slab"],
                  "fq": ["gemv_fq_symm_slab"],
                  "irfq": ["gemv_q16_symm_slab", "gemv_fq_symm_slab"]}


@pytest.mark.parametrize("precision", QUANT_PRECISIONS)
@pytest.mark.parametrize("g", RANKS)
def test_quantized_band_pair_solve_matches_lam_tpu(system, clusters, lam_ref,
                                                   g, precision):
    klass = "df64" if precision in ("dfq", "fq") else "ir"
    # lam_tpu's own df64-class counts on this system spread over 320..324
    # (f64 row shards at 4 ranks 320, at 2 ranks and on one device 323,
    # its dfq/fq band pairs 324): within 2 of one of them
    _check_solve(system, clusters, lam_ref, g, f"packed-{precision}",
                 f"symm-{precision}", klass, _QUANT_KERNELS[precision],
                 also=[(r, "df64") for r in RANKS])
    counts = clusters[g][0][0][f"packed-{precision}"]["counts"]
    if precision == "irfq":  # the inner loop read the 2-byte plane only
        assert counts["gemv_f32_symm_slab_plain"] == 0
    assert counts["gemv_df64_symm_slab_plain"] == 0


@pytest.mark.parametrize("storage,bound", [("dfq", 1e-11), ("fq", 1e-12)])
@pytest.mark.parametrize("g", RANKS)
def test_quantized_sharded_matvec_within_the_storage_bound(system, clusters,
                                                           g, storage,
                                                           bound):
    a = system[0]
    p = np.random.default_rng(5).uniform(-1, 1, N)
    ys = _rank_xs(clusters[g][1], f"mv-{storage}", g)
    for y in ys:
        assert _rel(y, a @ p) <= bound
        assert np.array_equal(y, ys[0])


@pytest.mark.parametrize("storage", ["dfq", "fq"])
@pytest.mark.parametrize("g", RANKS)
def test_quantized_sharded_diagonal(system, clusters, g, storage):
    for d in _rank_xs(clusters[g][1], f"diag-{storage}", g):
        np.testing.assert_allclose(d, np.diag(system[0]), rtol=2.0 ** -48,
                                   atol=0)


@pytest.mark.parametrize("label", list(DIAGONALS))
@pytest.mark.parametrize("g", RANKS)
def test_mesh_diagonal_matches_lam_tpu(clusters, lam_diag, g, label):
    """Every rank's whole diagonal() and the preconditioner's f32 inverse
    diagonal, bit for bit lam_tpu's (the row shards' with no
    communication, the band pairs' all-reduced)."""
    ref_d, ref_inv = lam_diag[g, label]
    run_dir = clusters[g][1]
    for d, inv in zip(_rank_xs(run_dir, f"diag-{label}", g),
                      _rank_xs(run_dir, f"diag-{label}.inv", g)):
        assert d.dtype == ref_d.dtype and inv.dtype == np.float32
        np.testing.assert_array_equal(d, ref_d[:N])
        np.testing.assert_array_equal(inv, ref_inv[:N])


_JACOBI_KERNELS = {"gather": ["gemv_df64"],
                   "ring": ["gemv_f32_cols", "gemv_df64_cols"],
                   "slab": ["gemv_df64_symm_slab"],
                   "packed": ["gemv_f32_symm_slab", "gemv_df64_symm_slab"]}


@pytest.mark.parametrize("label", list(JACOBI))
@pytest.mark.parametrize("g", RANKS)
def test_mesh_jacobi_solve_matches_lam_tpu(system, clusters, lam_ref, g,
                                           label):
    """Jacobi PCG (plain, or in ir's inner loop) on the row shards and the
    band pairs: every rank the same count and x, lam_tpu's count (df64
    class: within 2 of its one-device or G-device f64 count; ir: 2%)."""
    precision = JACOBI[label][1]
    name = f"jacobi-{label}"
    _check_solve(system, clusters, lam_ref, g, name, f"jacobi-{precision}",
                 precision, _JACOBI_KERNELS[label],
                 one_device=(1, "jacobi-df64"))
    x = _rank_xs(clusters[g][1], name, g)[0]
    assert _true_rel(*system[:2], x) < 1e-9


def test_cli_jacobi_across_two_ranks(system, clusters, lam_ref):
    a, b = system[:2]
    records, run_dir = clusters[2]
    recs = [rank["cli-jacobi"] for rank in records]
    assert [rec["rc"] for rec in recs] == [0, 0]
    assert not recs[1]["stdout"].strip()
    fields = recs[0]["stdout"].strip().split(",")
    assert (int(fields[0]), int(fields[1])) == (N, 2)
    assert float(fields[7]) < JACOBI_REL
    refs = [lam_ref[k][0] for k in ((1, "jacobi-df64"),
                                    (2, "jacobi-df64"))]
    assert min(abs(int(fields[6]) - r) for r in refs) <= 2, (fields, refs)
    x = tio.read_vector(os.path.join(run_dir, "x_cli_jacobi.bin"))
    assert _true_rel(a, b, x) < 1e-9
    # --profile: one trace per rank
    prof = os.path.join(run_dir, "profile")
    assert sorted(os.listdir(prof)) == ["lam-cg.rank0.json",
                                        "lam-cg.rank1.json"]
    for name in os.listdir(prof):
        with open(os.path.join(prof, name)) as f:
            assert json.load(f)["traceEvents"]


def _csv(rec):
    lines = rec["stdout"].strip().splitlines()
    assert len(lines) == 1, rec["stdout"]
    return lines[0].split(",")


@pytest.mark.parametrize("g", RANKS)
def test_cli_quantized_precisions_and_shard_cache(system, clusters, lam_ref,
                                                  g):
    a, b, a_path, b_path = system
    records, run_dir = clusters[g]
    xs = {}
    for name, ref_key, kernels in (
            ("cli-irfq-cold", "symm-irfq", _QUANT_KERNELS["irfq"]),
            ("cli-irfq-warm", "symm-irfq", _QUANT_KERNELS["irfq"]),
            ("cli-irq", "symm-irq", _QUANT_KERNELS["irq"]),
            ("cli-fq", "symm-fq", _QUANT_KERNELS["fq"]),
            ("cli-dfq", "symm-dfq", _QUANT_KERNELS["dfq"])):
        recs = [rank[name] for rank in records]
        assert [rec["rc"] for rec in recs] == [0] * g
        assert not any(rec["stdout"].strip() for rec in recs[1:])
        fields = _csv(recs[0])
        assert (int(fields[0]), int(fields[1])) == (N, g)
        iters, ref_iters = int(fields[6]), lam_ref[g, ref_key][0]
        # the CLI's 512-wide tiles quantize another operator than the
        # reference's 128-wide ones: 2% for every class here
        assert abs(iters - ref_iters) <= math.ceil(0.02 * ref_iters), \
            (name, iters, ref_iters)
        xs[name] = tio.read_vector(os.path.join(run_dir, f"x_{name}.bin"))
        assert _true_rel(a, b, xs[name]) <= 1e-8
        assert _rel(xs[name], lam_ref[g, ref_key][1]) <= 1e-6
        for rec in recs:
            for k in kernels:
                assert rec["counts"][k + "_plain"] > 0, (name, k)
    # cold wrote one shard file per rank, warm read them: same
    # iterations, bitwise the same x
    for c in range(g):
        assert os.path.exists(f"{a_path}.shardpack/fq.g{g}.s{c}")
    assert not os.path.exists(f"{a_path}.shardpack/dfq.g{g}.s0")
    cold, warm = (_csv(records[0][n]) for n in ("cli-irfq-cold",
                                                "cli-irfq-warm"))
    assert cold[6] == warm[6]
    assert np.array_equal(xs["cli-irfq-cold"], xs["cli-irfq-warm"])


@pytest.mark.parametrize("name", ["mv-dense-gather", "mv-dense-ring",
                                  "mv-slab", "mv-packed"])
@pytest.mark.parametrize("g", RANKS)
def test_sharded_matvec_matches_f64(system, clusters, g, name):
    a = system[0]
    p = np.random.default_rng(5).uniform(-1, 1, N)
    for y in _rank_xs(clusters[g][1], name, g):
        assert _rel(y, a @ p) <= 1e-13


def _rhs_block():
    return np.random.default_rng(6).uniform(-1, 1, (N, 3))


@pytest.mark.parametrize("name", ["ck-dense-xla", "ck-packed-ir"])
def test_checkpoint_resume_across_two_ranks(system, clusters, lam_ref,
                                            name):
    """A resumable solve stopped with its state on disk and resumed lands
    bitwise on the uninterrupted one (CG also on cg_solve's x), on every
    rank; the refinement run is bitwise the fused cg_solve_ir's."""
    a, b = system[:2]
    records, run_dir = clusters[2]
    recs = [rank[name] for rank in records]
    xs = _rank_xs(run_dir, name, 2)
    for rec in recs:
        assert rec["converged"] and rec["bitwise"]
        assert not rec["part_converged"]
        assert rec["resumed_iters"] == rec["iters"] == recs[0]["iters"]
        assert rec["mono_bitwise"] in (None, True)
    assert np.array_equal(xs[0], xs[1])
    assert _true_rel(a, b, xs[0]) <= 1e-8
    if name == "ck-packed-ir":
        assert recs[0]["part_iters"] < recs[0]["iters"]
        assert np.array_equal(xs[0], _rank_xs(run_dir, "packed-ir", 2)[0])
        assert recs[0]["iters"] == records[0]["packed-ir"]["iters"]
        assert recs[0]["counts"]["gemv_f32_symm_slab_plain"] > 0
    else:
        assert recs[0]["part_iters"] == 30
        # lam_tpu's f64 row shards on the virtual 2-device mesh
        assert abs(recs[0]["iters"] - lam_ref[2, "df64"][0]) <= 2
        assert _rel(xs[0], lam_ref[2, "df64"][1]) <= 1e-6
        assert not any(recs[0]["counts"].values())  # no kernel: xla


def test_cli_checkpoint_across_two_ranks(system, clusters):
    """--checkpoint -i 30 then --resume on the row shards: rank 0 alone
    prints, the stopped run's CSV says 31 (max_iters + 1), the resumed
    one the uninterrupted count and x of the same operator's solve."""
    a, b = system[:2]
    records, run_dir = clusters[2]
    rows = {}
    for name in ("cli-ck", "cli-resume"):
        recs = [rank[name] for rank in records]
        assert [rec["rc"] for rec in recs] == [0, 0]
        assert not recs[1]["stdout"].strip()
        rows[name] = recs[0]["stdout"].strip().split(",")
    assert rows["cli-ck"][6] == "31"
    assert int(rows["cli-resume"][6]) == records[0]["dense-gather-df64"][
        "iters"]
    x = tio.read_vector(os.path.join(run_dir, "x_resume.bin"))
    np.testing.assert_array_equal(
        x, _rank_xs(run_dir, "dense-gather-df64", 2)[0])
    with open(os.path.join(run_dir, "cli-ck", "state.json")) as f:
        meta = json.load(f)
    assert (meta["n"], meta["n_padded"]) == (
        N, pcg.ShardedDenseOperator.shard_padded_size(N, 2))


@pytest.mark.parametrize("engine", ["auto", "xla"])
def test_block_cg_across_two_ranks(system, clusters, engine):
    a = system[0]
    records, run_dir = clusters[2]
    bb = _rhs_block()
    xs = _rank_xs(run_dir, f"block-dense-{engine}", 2)
    assert np.array_equal(xs[0], xs[1])
    iters = records[0][f"block-dense-{engine}"]["iters"]
    ref = lam_tpu.cg_solve_block(
        lam_tpu.DenseOperator.from_dense(a, precision="f64"), bb,
        max_iters=10000, rel_error=1e-9)
    for j in range(3):
        # f64 recurrences that sum in other orders part by up to ~2% on
        # this spectrum near 1e-9 (tests/test_torch_block.py holds the
        # counts to 2 on a steeper one)
        ref_j = int(ref.num_iters[j])
        assert abs(iters[j] - ref_j) <= math.ceil(0.02 * ref_j)
        assert _true_rel(a, bb[:, j], xs[0][:, j]) <= 1e-8
    assert records[1][f"block-dense-{engine}"]["iters"] == iters


def test_cli_across_two_ranks(system, clusters):
    a, b, a_path, b_path = system
    records, run_dir = clusters[2]
    recs = [rank["cli-ir"] for rank in records]
    assert [rec["rc"] for rec in recs] == [0, 0]
    lines = recs[0]["stdout"].strip().splitlines()
    assert len(lines) == 1 and not recs[1]["stdout"].strip()
    fields = lines[0].split(",")
    assert (int(fields[0]), int(fields[1])) == (N, 2)
    x = tio.read_vector(os.path.join(run_dir, "x_cli.bin"))
    local = DenseOperator.from_dense(a, precision="df64", device="cpu")
    x_local = cg_solve_ir(local.as_f32(), local, b, max_iters=10000,
                          rel_error=1e-9).x.numpy()
    assert _rel(x, x_local) <= 1e-6
    for rec in recs:  # both ranks walked their column blocks
        assert rec["counts"]["gemv_f32_cols_plain"] > 0


@pytest.mark.parametrize("name", list(FROM_FILE))
def test_from_file_equals_the_per_rank_reads(clusters, name):
    """ShardedDenseOperator.from_file and SymmShardedOperator.from_file
    (lam_tpu/parallel/pcg.py:514, pcg_symm.py:779) on every rank of G=2:
    the operand byte-equal to the operator built from the same rows by
    from_row_block_fn, on the binary file and on its .npy twin."""
    records, _ = clusters[2]
    op = FROM_FILE[name][0]
    for rank in records:
        rec = rank[name]
        assert rec["equal"] and rec["tensors"] >= 1
        assert rec["types"][0] == rec["types"][1] == (
            "ShardedDenseOperator" if op == "dense" else
            "SymmShardedOperator")
        assert rec["sizes"][0] == rec["sizes"][1]
        assert rec["sizes"][0][0] == N


@pytest.mark.parametrize("cls,lam_cls", [
    ("pcg.ShardedDenseOperator", "pcg.ShardedDenseOperator"),
    ("pcg_symm.SymmShardedOperator", "pcg_symm.SymmShardedOperator"),
    ("pcg2d.Sharded2DOperator", "pcg2d.Sharded2DOperator"),
    ("pcg2d_symm.Symm2DOperator", "pcg2d_symm.Symm2DOperator")])
def test_from_file_takes_lam_tpus_arguments(cls, lam_cls):
    """The four from_file constructors take lam_tpu's arguments in its
    order (less the row shards' `axis`, a JAX mesh axis; plus the port's
    `device`, and on the symmetric storages the facade's `pack_cache_src`,
    None by default), with the port's documented precision default: df64,
    where lam_tpu's row shards and dense grid default to 'auto'
    (ROADMAP.md, "Observed differences")."""
    import importlib
    import inspect
    sigs = []
    for pkg in ("lam_tpu_torch", "lam_tpu"):
        mod, name = (cls if pkg == "lam_tpu_torch" else lam_cls).split(".")
        fn = getattr(importlib.import_module(f"{pkg}.parallel.{mod}"),
                     name).from_file
        sigs.append(inspect.signature(fn).parameters)
    port, ref = sigs
    assert [k for k in port if k not in ("device", "pack_cache_src")] == [
        k for k in ref if k != "axis"]
    assert ("pack_cache_src" in port) == ("symm" in cls)
    if "symm" in cls:
        assert port["pack_cache_src"].default is None
    assert port["device"].default == "cuda"
    assert port["precision"].default == "df64"
    assert ref["precision"].default in ("df64", "auto")
    for k in ref:
        if k not in ("axis", "precision"):
            assert port[k].default == ref[k].default


def test_from_file_refuses_a_matrix_that_is_not_square(tmp_path):
    path = str(tmp_path / "A.bin")
    tio.write_matrix(path, np.ones((6, 4)))
    mesh = pmesh.Mesh(0, 1, "cpu")
    for build in (
            lambda: pcg.ShardedDenseOperator.from_file(path, mesh=mesh),
            lambda: pcg_symm.SymmShardedOperator.from_file(path,
                                                           mesh=mesh)):
        with pytest.raises(ValueError,
                           match=r"matrix must be square \(6x4\)"):
            build()


def _bench_rows(clusters):
    """Rank 0's one printed row of each bench job, checked: both ranks
    exited 0 and rank 1 printed nothing."""
    records, _ = clusters[2]
    rows = {}
    for name in BENCH_JOBS:
        recs = [rank[name] for rank in records]
        assert [rec["rc"] for rec in recs] == [0, 0], recs[0]["stderr"]
        assert not recs[1]["stdout"]
        (line,) = recs[0]["stdout"].strip().splitlines()
        rows[name] = line.split(",")
        assert len(rows[name]) == 9
        assert rows[name][1:3] == ["2", "1"]  # procs = the ranks
    return rows


@pytest.mark.parametrize("name", list(BENCH_JOBS))
def test_bench_sweep_across_two_ranks(clusters, name):
    """lam-bench-torch --backend sharded --device cpu on both ranks:
    rank 0 alone prints its row, procs 2, and appends it; gen mode at
    N=1024 -i 15 (num_iter 16), spd mode at n=256 in memory (f64 and irfq:
    each rank builds its own part through the facade's _build_operator)
    and through the .npy cache, which rank 0 alone publishes."""
    records, _ = clusters[2]
    f = _bench_rows(clusters)[name]
    if name == "bench-gen":
        assert f[0] == "1024" and f[6] == "16"
        return
    a = jgen.random_spd_matrix(BENCH_SIZE, seed=2024)
    b = jgen.random_rhs(BENCH_SIZE, seed=2034)
    k = lam_oracle_cg(a, b, max_iters=10000)[1]
    assert f[0] == str(BENCH_SIZE) and float(f[7]) < 1e-9
    assert int(f[6]) <= 10000
    if name == "bench-spd-irfq":
        for rank in records:  # the quantized band pairs on every rank
            counts = rank[name]["counts"]
            assert counts["gemv_q16_symm_slab_plain"] > 0
            assert counts["gemv_fq_symm_slab_plain"] > 0
    else:
        # f64 sums in other orders: within 2% of the oracle's count
        assert abs(int(f[6]) - k) <= math.ceil(0.02 * k)


def test_bench_sweep_appends_rank_0s_rows_and_caches_once(clusters):
    records, run_dir = clusters[2]
    rows = _bench_rows(clusters)
    with open(os.path.join(run_dir, "bench.csv")) as f:
        lines = f.read().splitlines()
    assert [line.split(",") for line in lines] == list(rows.values())
    # the cached system gives the in-memory one's solve
    assert rows["bench-spd-cache"][6:8] == rows["bench-spd"][6:8]
    assert os.listdir(os.path.join(run_dir, "cache")) == [
        f"lam_bench_spd_N{BENCH_SIZE}_s2024.npy"]


# -- what the backends refuse ----------------------------------------------


def _tiny_matrix_file():
    import tempfile
    path = os.path.join(tempfile.mkdtemp(), "A.bin")
    tio.write_matrix(path, _symmetric(64, 1))
    return path


def test_sharded_configurations_refused():
    with pytest.raises(ValueError, match="supports precision df64/ir"):
        ConjugateGradient(backend="sharded", precision="f32",
                          engine="pallas_symm", device="cpu")
    for precision in QUANT_PRECISIONS:
        # quantized storage is packed: engine auto routes there, another
        # engine is refused with lam_tpu's messages
        cg = ConjugateGradient(backend="sharded", precision=precision,
                               device="cpu")
        assert cg._sharded_engine == "pallas_symm_packed"
        with pytest.raises(ValueError, match="implies packed storage"):
            ConjugateGradient(backend="sharded", precision=precision,
                              engine="pallas_symm", device="cpu")
        with pytest.raises(ValueError, match="f32' or 'df64"):
            ConjugateGradient(backend="sharded", precision=precision,
                              engine="pallas", device="cpu"
                              ).load_matrix_from_file(_tiny_matrix_file())
        cg = ConjugateGradient(backend="sharded2d", precision=precision,
                               device="cpu")  # auto: the symmetric grid
        assert cg._sharded_engine == "pallas_symm_packed"
        with pytest.raises(ValueError, match="only on the symmetric grid"):
            ConjugateGradient(backend="sharded2d", precision=precision,
                              engine="pallas", device="cpu")
    # engine xla: the row shards with plain torch products; f64 forces it
    for precision in ("df64", "f64"):
        cg = ConjugateGradient(backend="sharded", engine="xla",
                               precision=precision, device="cpu")
        cg.load_matrix_from_file(_tiny_matrix_file())
        assert (cg.op.engine, cg.op.precision, cg.op.n_padded) == (
            "xla", precision, 64)
    with pytest.raises(NotImplementedError, match="rebuild with df64"):
        cg.op.as_f32()  # f64: lam_tpu's words, ir runs on the df64 pair
    with pytest.raises(ValueError, match="comm"):
        ConjugateGradient(backend="sharded", comm="tree", device="cpu")
    with pytest.raises(ValueError, match="requested 2 devices"):
        ConjugateGradient(backend="sharded", n_devices=2, device="cpu")
    for engine in ("pallas_symm", "pallas_symm_packed"):
        cg = ConjugateGradient(backend="sharded2d", engine=engine,
                               precision="df64",
                               device="cpu")  # the symmetric 2-D grid
        assert cg._sharded_engine == engine
        with pytest.raises(ValueError, match="supports precision df64/ir"):
            ConjugateGradient(backend="sharded2d", engine=engine,
                              precision="f32", device="cpu")
    cg = ConjugateGradient(backend="sharded2d", engine="xla", device="cpu")
    assert cg._sharded_engine == "xla"  # the dense grid
    # backend auto: one process is one rank, so local; more ranks asked
    # for than the group has is sharded's refusal
    assert ConjugateGradient(backend="auto", device="cpu").backend == "local"
    with pytest.raises(ValueError, match="requested 2 devices"):
        ConjugateGradient(backend="auto", n_devices=2, device="cpu")
    if not torch.cuda.is_available():  # cuda is the default; no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            ConjugateGradient(backend="sharded")
    with pytest.raises(ValueError, match="'df64', 'dfq' or 'fq'"):
        pcg_symm.SymmShardedOperator.from_dense(_symmetric(256, 1),
                                                precision="f32",
                                                device="cpu")
    for name in ("from_gen_tridiagonal", "from_gen_fq"):  # generate mode
        with pytest.raises(ValueError, match="power-of-two"):
            getattr(pcg_symm.SymmShardedOperator, name)(
                256, mesh=pmesh.Mesh(0, 1, "cpu"), tb=192, device="cpu")
    with pytest.raises(ValueError, match="symmetric"):
        pcg_symm.SymmShardedOperator.from_dense(
            np.triu(_symmetric(256, 1)), device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        pcg_symm.SymmShardedOperator.from_dense(_symmetric(256, 1), tb=192,
                                                device="cpu")
    with pytest.raises(ValueError, match="f32' or 'df64"):
        pcg.ShardedDenseOperator.from_dense(_symmetric(256, 1),
                                            precision="fq", device="cpu")
    # f64 forces engine xla, as in lam_tpu
    assert pcg.ShardedDenseOperator.from_dense(
        _symmetric(256, 1), precision="f64", device="cpu").engine == "xla"


def test_sharded_cli_flags_refused(capsys):
    for argv, msg in ((["--local-devices", "2"], "no counterpart"),
                      (["--num-processes", "2"], "need --coordinator"),
                      (["--process-id", "0"], "need --coordinator")):
        assert tcli.main(argv + ["--device", "cpu"]) == 1
        assert msg in capsys.readouterr().err
    assert tcli.main(["--backend", "sharded2d", "--precision", "f32",
                      "--engine", "pallas_symm_packed", "--device",
                      "cpu"]) == 1  # the symmetric 2-D grid stores a pair
    assert "supports precision df64/ir" in capsys.readouterr().err
    assert tcli.main(["-s", "100", "-A", "A.bin", "--backend", "sharded",
                      "--precision", "irfq", "--device", "cpu"]) == 1
    assert "cannot be used with -s" in capsys.readouterr().err
    assert tcli.main(["--backend", "sharded", "--precision", "dfq",
                      "--engine", "pallas_symm", "--device", "cpu"]) == 1
    assert "implies packed storage" in capsys.readouterr().err
    with pytest.raises(ValueError, match="outside"):
        pmesh.distributed_init("127.0.0.1:1", 2, 2, device="cpu")


def test_mesh_of_one_rank_is_the_identity():
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, None)
    x = torch.arange(4.0)
    assert mesh.all_reduce(x) is x and mesh.all_gather(x) is x
    assert mesh.ppermute_prev(x) is x
    assert float(mesh.dot(x, x)) == 14.0
    assert pmesh.choose_backend("cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="requested 3 devices"):
        pmesh.make_mesh(3, device="cpu")


def test_backend_and_device_follow_the_local_layout(monkeypatch):
    """2 hosts x 4 cards x 4 ranks each: every rank has a card of its own,
    so the group runs NCCL and a rank sits on the card of its LOCAL rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    # no launcher variables: all ranks are taken to share this host
    assert pmesh.choose_backend("cuda", 4) == "nccl"
    assert pmesh.choose_backend("cuda", 8) == "gloo"
    assert pmesh._rank_device("cuda", 6) == torch.device("cuda", 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pmesh.choose_backend("cuda", 8) == "nccl"
    assert pmesh._rank_device("cuda", 5) == torch.device("cuda", 1)
    assert pmesh.choose_backend("cpu", 8) == "gloo"
    assert pmesh._rank_device("cpu", 5) == torch.device("cpu")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")  # two ranks per card
    assert pmesh.choose_backend("cuda", 8) == "gloo"


def test_help_names_the_sharded_flags():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main(["-h"]) == 0
    assert "--backend local|sharded|sharded2d" in out.getvalue()
    assert "--coordinator" in out.getvalue()
