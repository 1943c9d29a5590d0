#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the CUDA kernels
   from lam_tpu_torch/csrc (nvcc, sm_90a, one nvcc per source).
2. Holds each of the twelve kernels against its plain PyTorch version at
   the main path's shapes. The eight one-device kernels at N=10000 padded
   to 10240 (20 row tiles of 512, 210 packed tiles; the fq planes stored
   padded to 216), on one random symmetric matrix:
   - gemv_f32_symm, gemv_q16_symm and the dense gemv_f32 (the full
     10240^2 f32 square) and their plain versions agree to a relative
     l2 of 1e-5 and match a float64 oracle of their stored values to
     1e-5;
   - gemv_df64_symm, gemv_fq_symm, gemv_dfq_symm and the dense gemv_df64
     (the full hi/lo squares) and their plain versions match the f64
     oracle of their stored values to 1e-13; fq matches the original
     matrix to 1e-12 and dfq to 1e-11 (their storage bounds);
   - padding rows of y are exactly 0; the dense and dfq kernels repeat
     bitwise.
   The fq and dfq planes are the port's own packs of the matrix with its
   diagonal zeroed. The four kernels of the sharded backends at the
   shards of another random symmetric N=10000 matrix, each rank's part
   built by the port's own operators without a process group: the ring's
   gemv_f32_cols/gemv_df64_cols at G=2 (m=5120 rows of 10240, every block
   of nb=5120), the band-pair gemv_f32_symm_slab/gemv_df64_symm_slab at
   G=2 (tb=512, T=105 tiles a rank, ms=5120) and G=4 (n=12288, T=75),
   slab and packed, every rank's tables; f32 to 1e-5, df64 to an f64
   oracle at 1e-13, bitwise repeats; and the shards' parts summed (ring
   blocks into rows; the slab parts placed by _scatter_bands) against the
   one-device kernels gemv_f32/gemv_df64/gemv_f32_symm/gemv_df64_symm on
   the same matrix, padding rows exactly 0. Prints each kernel's median
   time per call, its plain version's and, where one PyTorch call
   computes the same function (torch.mv on the full f32 or f64 square, or
   on the strided column view for the ring's kernels; for the slab walks,
   for scale only, torch.mv over the rank's (2m, n) slab of full rows,
   twice the bytes), that call's (CUDA events around batches of
   back-to-back calls, taken in turns and enqueued behind a device-side
   spin so the host's launch rate cannot gap them), the GB/s of the bytes
   moved and the bound: the larger of those bytes at 3.35 TB/s and the
   flops at the H100's f32 or f64 peak.
3. Writes the benchmark system (random_spd_matrix_fast(10000,
   seed=2024), random_rhs(10000, seed=2034)) in the binary format to a
   temporary directory and solves it through the port's CLI, in
   process: --precision ir, df64, irfq --pack-cache twice (cold: packs
   and writes A.bin.fqpack; warm: reads it, and must give the same
   iterations and a bitwise-equal x), fq, irq --pack-cache twice (the
   same with A.bin.dfqpack), dfq, and ir and df64 with --engine pallas
   (the full square, which must launch no symmetric kernel). Each
   solution is read back and its TRUE relative residual |b - A x| / |b|
   computed in f64 on the host must be <= 2e-9 (the benchmark's gate),
   converged. The launch counters are zeroed just before each run and
   read just after: each run's kernels must have launched, and no plain
   version may have run.
   Phase 2 also holds the stencil kernel laplace5_f32_halo against its
   plain version on the heat demo's padded grid (1024 x 1280, zero edges)
   and on that grid as one shard of a row-sharded grid (non-zero edge
   rows, a row limit below H and at H, columns cut below W): y bitwise
   equal, padding exactly 0, p . y within 1e-6 relative of the plain
   version and of a float64 oracle, bitwise repeats. It times it there
   and at 4096 x 4096 (streamed from HBM) beside torch's conv2d with the
   same 5-point weights (stencil only: no mask, no p . y).
4. Runs the heat-equation demo through the port's `lam-heat` CLI, in
   process, at its documented 1200 x 1000 plate: --precision ir (the
   stencil kernel must launch, no gemv kernel and no plain version) and
   --precision f64 (no stencil kernel, no plain version), each to a TRUE
   relative residual of the 5-point system <= 2e-10 computed in f64 on
   the host, the two grids within IR_F64_ATOL; Jacobi at 120 x 100, whose
   sweep count and grid must equal a literal numpy loop; and the
   `lam-heat-to-bmp` converter on the ir grid, a (1000, 1200, 3) image.
5. Solves the benchmark system through the port's CLI with --backend
   sharded, G rank processes of this script (`--rank r ...`, started with
   subprocess, each killed if its cluster outlives CLUSTER_TIMEOUT_S)
   sharing the one card over gloo, each running lam_tpu_torch.cli.main in
   process: ring-ir, gather-df64, slab-ir and packed-ir at G=2, ring-ir-4
   and packed-ir-4 at G=4 (SHARDED_RUNS). Each run must converge with a
   TRUE relative residual <= 2e-9 on the host from rank 0's solution
   file, x within 1e-6 relative of phase 3's one-device ir x, its kernels
   launched and the others not in every rank, no plain version, one CSV
   row (rank 0's) with procs = G, and the mesh must report gloo with every
   rank on cuda:0. G ranks on one card measure the sharded program, not
   multi-GPU scaling.

Prints {"kernels": [...]} on the line before the last (each kernel's
launches summed over the runs of phases 3-5, every rank's) and, as the last line,
{"ok": true, "device": {...}}. Any failure raises: exit code != 0 and no
result line. Without a CUDA device it exits 1 at once.
"""

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N = 10000            # the benchmark system's size
SEED_A, SEED_B = 2024, 2034
TIMED_CALLS = 25
BATCH = 10
SPIN_CYCLES = 6_000_000  # ~3 ms at the H100's clock: covers a batch's enqueue
TRUE_GATE = 2e-9     # bench.py's acceptance of the TRUE residual
SYMM_SOURCE = "lam_tpu_torch/csrc/gemv_symm.cu"
DENSE_SOURCE = "lam_tpu_torch/csrc/gemv_dense.cu"
STENCIL_SOURCE = "lam_tpu_torch/csrc/stencil.cu"
HEAT_NX, HEAT_NY = 1200, 1000  # the heat demo's documented plate
JAC_NX, JAC_NY = 120, 100
HEAT_GATE = 2e-10    # TRUE residual of a rel_error=1e-10 heat solve
# ir and f64 stop at a residual of 1e-10 each, and the Laplacian's
# condition number grows as side^2: their grids part by more than the
# 1e-6 of the 30 x 26 test (tests/test_heat.py:90) at 1200 x 1000
# (2.04e-6 on an H100 80GB HBM3 at 700 W)
IR_F64_ATOL = 1e-5
STREAM_NI = 4000     # 4096 x 4096 padded: the stencil streamed from HBM
# the card's least time for a call (bound_ms): H100 SXM data sheet, dense
# rates at the 700 W limit: 3.35 TB/s of HBM, 67 TFLOP/s f32 outside the
# tensor cores, 34 TFLOP/s f64
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
# (run, kernels it must launch, kernels it must not launch)
RUNS = (("ir", ("gemv_f32_symm", "gemv_df64_symm"), ()),
        ("df64", ("gemv_df64_symm",), ()),
        ("irfq-cold", ("gemv_q16_symm", "gemv_fq_symm"), ()),
        ("irfq-warm", ("gemv_q16_symm", "gemv_fq_symm"), ()),
        ("fq", ("gemv_fq_symm",), ()),
        ("irq-cold", ("gemv_f32_symm", "gemv_dfq_symm"), ()),
        ("irq-warm", ("gemv_f32_symm", "gemv_dfq_symm"), ()),
        ("dfq", ("gemv_dfq_symm",), ()),
        ("ir-pallas", ("gemv_f32", "gemv_df64"),
         ("gemv_f32_symm", "gemv_df64_symm")),
        ("df64-pallas", ("gemv_df64",), ("gemv_df64_symm",)))
# precisions run with --pack-cache -> the storage their cache holds
PACK_CACHE = {"irfq": "fq", "irq": "dfq"}
SHARD_G = (2, 4)     # rank counts of the sharded checks and runs
_RING = ("gemv_f32_cols", "gemv_df64_cols")
_SLAB = ("gemv_f32_symm_slab", "gemv_df64_symm_slab")
_TRI = ("gemv_f32_symm", "gemv_df64_symm")
# phase 5: (run, ranks, CLI flags, kernels it must launch, kernels it must
# not launch)
SHARDED_RUNS = (
    ("ring-ir", 2, ["--precision", "ir", "--comm", "ring"], _RING,
     ("gemv_f32", "gemv_df64")),
    ("gather-df64", 2, ["--precision", "df64", "--comm", "gather"],
     ("gemv_df64",), _RING),
    ("slab-ir", 2, ["--precision", "ir", "--engine", "pallas_symm"], _SLAB,
     _TRI),
    ("packed-ir", 2, ["--precision", "ir", "--engine",
                      "pallas_symm_packed"], _SLAB, _TRI),
    ("ring-ir-4", 4, ["--precision", "ir", "--comm", "ring"], _RING,
     ("gemv_f32", "gemv_df64")),
    ("packed-ir-4", 4, ["--precision", "ir", "--engine",
                        "pallas_symm_packed"], _SLAB, _TRI))
CLUSTER_TIMEOUT_S = 300  # a cluster that takes longer is killed: a hang
X_GATE = 1e-6        # a sharded x against the one-device ir x, relative


def _rel(y, ref):
    return float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _median_ms(fns):
    """Median CUDA-event time per call of each fn over TIMED_CALLS samples
    of BATCH back-to-back calls, taken in turns so all see the same card
    state. Each batch is enqueued behind a ~3 ms device-side spin, so the
    card runs it without waiting on the host: a wrapper call can cost the
    host more time than the q16 kernel takes on the card (PERF.md §5)."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(TIMED_CALLS):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            for _ in range(BATCH):
                fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / BATCH)
    return [statistics.median(ts) for ts in times]


def _dense_of(tiles, nblk, layout):
    """Full symmetric matrix of walk-order tiles (T, tb, tb)."""
    tb = tiles.shape[1]
    out = torch.zeros(nblk * tb, nblk * tb, dtype=tiles.dtype,
                      device=tiles.device)
    for t, (i, k) in enumerate(zip(*layout._symm_tables(nblk))):
        out[i * tb:(i + 1) * tb, k * tb:(k + 1) * tb] = tiles[t]
        if k < i:
            out[k * tb:(k + 1) * tb, i * tb:(i + 1) * tb] = tiles[t].T
    return out


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _timed_entry(name, replaces, source, y_err, fns, in_out, flops, kind):
    """The `kernels` line entry of one kernel: its time, its plain
    version's and (where fns[2] is given) one PyTorch library call's,
    taken in turns; its bound from the bytes of `in_out` (each input read
    once, each output written once) and `flops` at the peak of `kind`."""
    kernel, plain, library = fns
    timed = [kernel, plain] + ([library] if library else [])
    times = _median_ms(timed)
    ms, plain_ms = times[:2]
    library_ms = times[2] if library else None
    nbytes = _nbytes(*in_out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    bound_ms = max(t_bytes, t_ops)
    gb = nbytes / 1e9
    lib = ("" if library_ms is None else
           f"  library {library_ms:.4f} ms ({gb / library_ms * 1e3:.0f} GB/s)")
    print(f"{name:<15}kernel {ms:.4f} ms ({gb / ms * 1e3:.0f} GB/s)  "
          f"plain {plain_ms:.4f} ms{lib}  bound {bound_ms:.4f} ms  "
          f"[{gb * 1e3:.1f} MB moved]")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": y_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def kernels_vs_plain(gemv, layout, pack_planes, pack_tri, split_f64_host):
    """Phase 2: every kernel against its plain version at N=10240."""
    n_p = layout.padded_size(N)
    rng = np.random.default_rng(7)
    m = rng.uniform(-1, 1, size=(N, N))
    a = np.zeros((n_p, n_p))
    a[:N, :N] = m + m.T
    del m
    m0 = a[:N, :N].copy()
    np.fill_diagonal(m0, 0.0)
    packs = {}
    for storage in ("fq", "dfq"):
        t0 = time.perf_counter()
        packs[storage] = [torch.from_numpy(x).cuda()
                          for x in pack_tri(m0, storage, layout.SYMM_TB)]
        print(f"{storage} pack of the N={N} test matrix: "
              f"{time.perf_counter() - t0:.2f} s")
    del m0
    p = np.zeros(n_p)
    p[:N] = rng.uniform(-1, 1, size=N)
    dev = torch.device("cuda")
    hi, lo = (torch.from_numpy(x).to(dev)
              for x in pack_planes(a, "df64", layout.SYMM_TB))
    ph, pl = (torch.from_numpy(x).to(dev) for x in split_f64_host(p))
    a_dev = torch.from_numpy(a).to(dev)
    del a
    p64 = ph.double() + pl.double()
    a32 = a_dev.float()  # the full f32 square: torch.mv's yardstick
    flops = 2 * n_p * n_p
    out = []

    # f32 kernel: exact f32 products, f32 sums in another order
    y = gemv.gemv_f32_symm(hi, ph)
    y_plain = gemv.gemv_f32_symm_plain(hi, ph)
    oracle = torch.mv(a32.double(), ph.double())
    torch.cuda.synchronize()
    errs = (_rel(y, y_plain), _rel(y.double(), oracle),
            _rel(y_plain.double(), oracle))
    print(f"gemv_f32_symm  rel l2: kernel-plain {errs[0]:.3e}  "
          f"kernel-f64 {errs[1]:.3e}  plain-f64 {errs[2]:.3e}  (<= 1e-5)")
    _check(max(errs) <= 1e-5, "gemv_f32_symm disagrees")
    _check(int(torch.count_nonzero(y[N:])) == 0, "f32 padding rows != 0")
    del oracle
    out.append(_timed_entry(
        "gemv_f32_symm", "lam_tpu/ops/gemv.py:455", SYMM_SOURCE,
        float((y - y_plain).abs().max()),
        (lambda: gemv.gemv_f32_symm(hi, ph),
         lambda: gemv.gemv_f32_symm_plain(hi, ph),
         lambda: torch.mv(a32, ph)), (hi, ph, y), flops, "f32"))

    # df64 kernel: native f64 accumulation over the (hi, lo) pair
    yh, yl = gemv.gemv_df64_symm(hi, lo, ph, pl)
    qh, ql = gemv.gemv_df64_symm_plain(hi, lo, ph, pl)
    y = yh.double() + yl.double()
    y_plain = qh.double() + ql.double()
    oracle = torch.mv(a_dev, p64)
    torch.cuda.synchronize()
    errs = (_rel(y, y_plain), _rel(y, oracle), _rel(y_plain, oracle))
    print(f"gemv_df64_symm rel l2: kernel-plain {errs[0]:.3e}  "
          f"kernel-f64 {errs[1]:.3e}  plain-f64 {errs[2]:.3e}  (<= 1e-13)")
    _check(max(errs) <= 1e-13, "gemv_df64_symm disagrees")
    _check(int(torch.count_nonzero(yh[N:])) == 0
           and int(torch.count_nonzero(yl[N:])) == 0,
           "df64 padding rows != 0")
    del oracle
    out.append(_timed_entry(
        "gemv_df64_symm", "lam_tpu/ops/gemv.py:1008", SYMM_SOURCE,
        float((y - y_plain).abs().max()),
        (lambda: gemv.gemv_df64_symm(hi, lo, ph, pl),
         lambda: gemv.gemv_df64_symm_plain(hi, lo, ph, pl),
         lambda: torch.mv(a_dev, p64)), (hi, lo, ph, pl, yh, yl), flops,
        "f64"))
    del hi, lo
    torch.cuda.empty_cache()
    out += dense_kernels_vs_plain(gemv, a_dev, a32, ph, pl)
    del a32
    torch.cuda.empty_cache()
    out += fq_kernels_vs_plain(gemv, layout, packs["fq"], a_dev, ph, pl)
    out.append(dfq_kernel_vs_plain(gemv, layout, packs["dfq"], a_dev, ph,
                                   pl))
    torch.cuda.synchronize()
    return out


def dense_kernels_vs_plain(gemv, a_dev, a32, ph, pl):
    """Phase 2, the full-square engine: the dense f32 and df64 kernels on
    the 10240^2 square."""
    n_p = a_dev.shape[0]
    flops = 2 * n_p * n_p
    p64 = ph.double() + pl.double()
    out = []

    # dense f32 kernel: exact f32 products, f32 sums in another order
    y = gemv.gemv_f32(a32, ph)
    y_plain = gemv.gemv_f32_plain(a32, ph)
    oracle = torch.mv(a32.double(), ph.double())
    torch.cuda.synchronize()
    errs = (_rel(y, y_plain), _rel(y.double(), oracle),
            _rel(y_plain.double(), oracle))
    print(f"gemv_f32       rel l2: kernel-plain {errs[0]:.3e}  "
          f"kernel-f64 {errs[1]:.3e}  plain-f64 {errs[2]:.3e}  (<= 1e-5)")
    _check(max(errs) <= 1e-5, "gemv_f32 disagrees")
    _check(int(torch.count_nonzero(y[N:])) == 0,
           "dense f32 padding rows != 0")
    _check(torch.equal(y, gemv.gemv_f32(a32, ph)), "gemv_f32 not repeatable")
    del oracle
    out.append(_timed_entry(
        "gemv_f32", "lam_tpu/ops/gemv.py:143", DENSE_SOURCE,
        float((y - y_plain).abs().max()),
        (lambda: gemv.gemv_f32(a32, ph),
         lambda: gemv.gemv_f32_plain(a32, ph),
         lambda: torch.mv(a32, ph)), (a32, ph, y), flops, "f32"))

    # dense df64 kernel: hi + lo formed and accumulated in f64
    ah = a_dev.float()
    al = (a_dev - ah.double()).float()
    yh, yl = gemv.gemv_df64(ah, al, ph, pl)
    qh, ql = gemv.gemv_df64_plain(ah, al, ph, pl)
    y = yh.double() + yl.double()
    y_plain = qh.double() + ql.double()
    oracle = torch.mv(a_dev, p64)
    torch.cuda.synchronize()
    errs = (_rel(y, y_plain), _rel(y, oracle), _rel(y_plain, oracle))
    print(f"gemv_df64      rel l2: kernel-plain {errs[0]:.3e}  "
          f"kernel-f64 {errs[1]:.3e}  plain-f64 {errs[2]:.3e}  (<= 1e-13)")
    _check(max(errs) <= 1e-13, "gemv_df64 disagrees")
    _check(int(torch.count_nonzero(yh[N:])) == 0
           and int(torch.count_nonzero(yl[N:])) == 0,
           "dense df64 padding rows != 0")
    zh, zl = gemv.gemv_df64(ah, al, ph, pl)
    _check(torch.equal(yh, zh) and torch.equal(yl, zl),
           "gemv_df64 not repeatable")
    del oracle
    out.append(_timed_entry(
        "gemv_df64", "lam_tpu/ops/gemv.py:812", DENSE_SOURCE,
        float((y - y_plain).abs().max()),
        (lambda: gemv.gemv_df64(ah, al, ph, pl),
         lambda: gemv.gemv_df64_plain(ah, al, ph, pl),
         lambda: torch.mv(a_dev, p64)), (ah, al, ph, pl, yh, yl), flops,
        "f64"))
    return out


def fq_kernels_vs_plain(gemv, layout, fq, a_dev, ph, pl):
    """Phase 2, the fq planes: the q16 and fq kernels at N=10240."""
    tb = layout.SYMM_TB
    nblk = layout.padded_size(N, tb) // tb
    T = layout.tri_tile_count(nblk)
    q1, s1 = fq[0], fq[3]
    flops = 2 * (nblk * tb) ** 2
    out = []

    # q16 kernel: int16 -> f32 exact, scale folded into p, f32 sums
    y = gemv.gemv_q16_symm(q1, s1, ph)
    y_plain = gemv.gemv_q16_symm_plain(q1, s1, ph)
    tiles = (q1[:T * tb].double().reshape(T, tb, tb)
             * s1[:T].double()[:, None, None])
    oracle = torch.mv(_dense_of(tiles, nblk, layout), ph.double())
    del tiles
    torch.cuda.synchronize()
    errs = (_rel(y, y_plain), _rel(y.double(), oracle),
            _rel(y_plain.double(), oracle))
    print(f"gemv_q16_symm  rel l2: kernel-plain {errs[0]:.3e}  "
          f"kernel-f64 {errs[1]:.3e}  plain-f64 {errs[2]:.3e}  (<= 1e-5)")
    _check(max(errs) <= 1e-5, "gemv_q16_symm disagrees")
    _check(int(torch.count_nonzero(y[N:])) == 0, "q16 padding rows != 0")
    del oracle
    # the bytes of the T real tiles (the kernel never reads the pad tiles)
    out.append(_timed_entry(
        "gemv_q16_symm", "lam_tpu/ops/gemv.py:2065", SYMM_SOURCE,
        float((y - y_plain).abs().max()),
        (lambda: gemv.gemv_q16_symm(q1, s1, ph),
         lambda: gemv.gemv_q16_symm_plain(q1, s1, ph), None),
        (q1[:T * tb], s1[:T], ph, y), flops, "f32"))

    # fq kernel: the three-plane cascade formed and accumulated in f64
    yh, yl = gemv.gemv_fq_symm(*fq[:6], ph, pl)
    qh, ql = gemv.gemv_fq_symm_plain(*fq[:6], ph, pl)
    y = yh.double() + yl.double()
    y_plain = qh.double() + ql.double()
    p = ph.double() + pl.double()
    tiles = sum(q[:T * tb].double().reshape(T, tb, tb)
                * s[:T].double()[:, None, None]
                for q, s in zip(fq[:3], fq[3:6]))
    oracle = torch.mv(_dense_of(tiles, nblk, layout), p)
    del tiles
    a_dev.fill_diagonal_(0.0)  # the fq planes hold the zero-diagonal matrix
    original = torch.mv(a_dev, p)
    torch.cuda.synchronize()
    errs = (_rel(y, y_plain), _rel(y, oracle), _rel(y_plain, oracle))
    err_a = _rel(y, original)
    print(f"gemv_fq_symm   rel l2: kernel-plain {errs[0]:.3e}  "
          f"kernel-f64 {errs[1]:.3e}  plain-f64 {errs[2]:.3e}  (<= 1e-13)  "
          f"kernel-original {err_a:.3e}  (<= 1e-12)")
    _check(max(errs) <= 1e-13, "gemv_fq_symm disagrees")
    _check(err_a <= 1e-12, "gemv_fq_symm misses the storage bound")
    _check(int(torch.count_nonzero(yh[N:])) == 0
           and int(torch.count_nonzero(yl[N:])) == 0,
           "fq padding rows != 0")
    del oracle
    out.append(_timed_entry(
        "gemv_fq_symm", "lam_tpu/ops/gemv.py:2164", SYMM_SOURCE,
        float((y - y_plain).abs().max()),
        (lambda: gemv.gemv_fq_symm(*fq[:6], ph, pl),
         lambda: gemv.gemv_fq_symm_plain(*fq[:6], ph, pl), None),
        (*(q[:T * tb] for q in fq[:3]), *(s[:T] for s in fq[3:6]), ph, pl,
         yh, yl), flops, "f64"))
    return out


def dfq_kernel_vs_plain(gemv, layout, dfq, a_dev, ph, pl):
    """Phase 2, the dfq planes: the dfq kernel at N=10240 on the port's
    own dfq pack of the zero-diagonal matrix (`a_dev` holds it now)."""
    tb = layout.SYMM_TB
    nblk = layout.padded_size(N, tb) // tb
    T = layout.tri_tile_count(nblk)
    hi, loq, sc = dfq[:3]
    _check(hi.shape[0] == T * tb, "the dfq planes are not T tiles")
    # dfq kernel: hi + loq * sc formed and accumulated in f64
    yh, yl = gemv.gemv_dfq_symm(hi, loq, sc, ph, pl)
    qh, ql = gemv.gemv_dfq_symm_plain(hi, loq, sc, ph, pl)
    y = yh.double() + yl.double()
    y_plain = qh.double() + ql.double()
    p = ph.double() + pl.double()
    tiles = (hi.double().reshape(T, tb, tb)
             + loq.double().reshape(T, tb, tb) * sc.double()[:, None, None])
    oracle = torch.mv(_dense_of(tiles, nblk, layout), p)
    del tiles
    original = torch.mv(a_dev, p)
    torch.cuda.synchronize()
    errs = (_rel(y, y_plain), _rel(y, oracle), _rel(y_plain, oracle))
    err_a = _rel(y, original)
    print(f"gemv_dfq_symm  rel l2: kernel-plain {errs[0]:.3e}  "
          f"kernel-f64 {errs[1]:.3e}  plain-f64 {errs[2]:.3e}  (<= 1e-13)  "
          f"kernel-original {err_a:.3e}  (<= 1e-11)")
    _check(max(errs) <= 1e-13, "gemv_dfq_symm disagrees")
    _check(err_a <= 1e-11, "gemv_dfq_symm misses the storage bound")
    _check(int(torch.count_nonzero(yh[N:])) == 0
           and int(torch.count_nonzero(yl[N:])) == 0,
           "dfq padding rows != 0")
    zh, zl = gemv.gemv_dfq_symm(hi, loq, sc, ph, pl)
    _check(torch.equal(yh, zh) and torch.equal(yl, zl),
           "gemv_dfq_symm not repeatable")
    del oracle
    return _timed_entry(
        "gemv_dfq_symm", "lam_tpu/ops/gemv.py:1172", SYMM_SOURCE,
        float((y - y_plain).abs().max()),
        (lambda: gemv.gemv_dfq_symm(hi, loq, sc, ph, pl),
         lambda: gemv.gemv_dfq_symm_plain(hi, loq, sc, ph, pl), None),
        (hi, loq, sc, ph, pl, yh, yl), 2 * (nblk * tb) ** 2, "f64")


def _shard_system():
    """The matrix of the shard kernels' checks: a random symmetric N x N
    f64 matrix and an operand vector p, from a numpy seed."""
    rng = np.random.default_rng(13)
    m = rng.uniform(-1, 1, size=(N, N))
    a = m + m.T
    del m
    return a, rng.uniform(-1, 1, size=N)


def _pair(p, n_p):
    """p zero-padded to n_p, on the card: (hi, lo, hi + lo in f64)."""
    v = np.zeros(n_p)
    v[:p.shape[0]] = p
    hi = torch.from_numpy(v.astype(np.float32)).cuda()
    lo = torch.from_numpy((v - hi.cpu().numpy()).astype(np.float32)).cuda()
    return hi, lo, hi.double() + lo.double()


def cols_kernels_vs_plain(gemv, pcg, Mesh, a, p):
    """Phase 2, the ring's column-block kernels at the row shards of G=2
    on the N=10000 system (m=5120 rows of n=10240, blocks of nb=5120):
    every rank's rows against every block, then each rank's blocks summed
    in the ring's order, which must give the single-device dense kernels'
    matvec of the whole square."""
    g = SHARD_G[0]
    shards = [pcg.ShardedDenseOperator.from_row_block_fn(
        lambda s, k: a[s:s + k], N, mesh=Mesh(c, g, "cuda"),
        precision="df64") for c in range(g)]
    n_p, m = shards[0].n_padded, shards[0].m
    ph, pl, p64 = _pair(p, n_p)
    ring32 = torch.empty(n_p, device="cuda")
    ring64 = torch.empty(n_p, dtype=torch.float64, device="cuda")
    errs32, errs64, diff32, diff64 = [], [], 0.0, 0.0
    for c, op in enumerate(shards):
        hi, lo = op.operand
        a64 = hi.double() + lo.double()
        acc32 = torch.zeros(m, device="cuda")
        acc64 = torch.zeros(m, dtype=torch.float64, device="cuda")
        for s in range(g):
            blk = (c + s) % g
            cols = slice(blk * m, (blk + 1) * m)
            y = gemv.gemv_f32_cols(hi, ph[cols], blk)
            y_plain = gemv.gemv_f32_cols_plain(hi, ph[cols], blk)
            oracle = torch.mv(hi[:, cols].double(), ph[cols].double())
            _check(torch.equal(y, gemv.gemv_f32_cols(hi, ph[cols], blk)),
                   "gemv_f32_cols not repeatable")
            errs32 += [_rel(y, y_plain), _rel(y.double(), oracle)]
            diff32 = max(diff32, float((y - y_plain).abs().max()))
            yh, yl = gemv.gemv_df64_cols(hi, lo, ph[cols], pl[cols], blk)
            qh, ql = gemv.gemv_df64_cols_plain(hi, lo, ph[cols], pl[cols],
                                               blk)
            y64 = yh.double() + yl.double()
            q64 = qh.double() + ql.double()
            zh, zl = gemv.gemv_df64_cols(hi, lo, ph[cols], pl[cols], blk)
            _check(torch.equal(yh, zh) and torch.equal(yl, zl),
                   "gemv_df64_cols not repeatable")
            errs64 += [_rel(y64, q64),
                       _rel(y64, torch.mv(a64[:, cols], p64[cols]))]
            diff64 = max(diff64, float((y64 - q64).abs().max()))
            acc32 += y
            acc64 += y64
        ring32[c * m:(c + 1) * m] = acc32
        ring64[c * m:(c + 1) * m] = acc64
        del a64
    print(f"gemv_f32_cols  G={g}, {g} ranks x {g} blocks of ({m}, {m}) in "
          f"({m}, {n_p}): rel l2 kernel-plain / kernel-f64 max "
          f"{max(errs32):.3e} (<= 1e-5)")
    print(f"gemv_df64_cols G={g}: rel l2 kernel-plain / kernel-f64 max "
          f"{max(errs64):.3e} (<= 1e-13)")
    _check(max(errs32) <= 1e-5, "gemv_f32_cols disagrees")
    _check(max(errs64) <= 1e-13, "gemv_df64_cols disagrees")
    # the ranks' ring sums against the one-device kernels on the square
    hi_sq = torch.cat([op.operand[0] for op in shards])
    lo_sq = torch.cat([op.operand[1] for op in shards])
    y_one = gemv.gemv_f32(hi_sq, ph)
    yh, yl = gemv.gemv_df64(hi_sq, lo_sq, ph, pl)
    del lo_sq
    e32, e64 = _rel(ring32, y_one), _rel(ring64, yh.double() + yl.double())
    print(f"ring sums of the G={g} shards vs the one-device kernels: "
          f"gemv_f32 rel l2 {e32:.3e} (<= 1e-5), gemv_df64 {e64:.3e} "
          "(<= 1e-13)")
    _check(e32 <= 1e-5 and e64 <= 1e-13,
           "the ring's column blocks do not add up to the dense matvec")
    _check(int(torch.count_nonzero(ring32[N:])) == 0
           and int(torch.count_nonzero(ring64[N:])) == 0,
           "ring padding rows != 0")
    del hi_sq
    # timed: rank 0's rows against block 1, beside torch.mv on the same
    # strided column view
    hi, lo = shards[0].operand
    cols = slice(m, 2 * m)
    p_blk, pl_blk = ph[cols].clone(), pl[cols].clone()
    y = gemv.gemv_f32_cols(hi, p_blk, 1)
    out = [_timed_entry(
        "gemv_f32_cols", "lam_tpu/ops/gemv.py:216", DENSE_SOURCE, diff32,
        (lambda: gemv.gemv_f32_cols(hi, p_blk, 1),
         lambda: gemv.gemv_f32_cols_plain(hi, p_blk, 1),
         lambda: torch.mv(hi[:, cols], p_blk)),
        (hi[:, cols], p_blk, y), 2 * m * m, "f32")]
    a64 = hi.double() + lo.double()
    p64_blk = p_blk.double() + pl_blk.double()
    yh, yl = gemv.gemv_df64_cols(hi, lo, p_blk, pl_blk, 1)
    out.append(_timed_entry(
        "gemv_df64_cols", "lam_tpu/ops/gemv.py:761", DENSE_SOURCE, diff64,
        (lambda: gemv.gemv_df64_cols(hi, lo, p_blk, pl_blk, 1),
         lambda: gemv.gemv_df64_cols_plain(hi, lo, p_blk, pl_blk, 1),
         lambda: torch.mv(a64[:, cols], p64_blk)),
        (hi[:, cols], lo[:, cols], p_blk, pl_blk, yh, yl), 2 * m * m,
        "f64"))
    return out


def _slab_case(gemv, pcg_symm, ops_, ph, pl, p64, one):
    """The slab kernels over every rank's walk of one band-pair geometry
    against their plain versions and an f64 oracle, and the ranks' parts
    placed and summed against the one-device triangle kernels' results
    `one` (f32 y, f64 y) on the whole triangle. Returns the largest
    kernel-plain differences (f32, df64)."""
    g, m, tb, packed = ops_[0].mesh.size, ops_[0].m, ops_[0].tb, \
        ops_[0].packed
    label = f"G={g} {'packed' if packed else 'slab'}"
    sum32 = torch.zeros_like(ph)
    sum64 = torch.zeros_like(p64)
    errs32, errs64, diff32, diff64 = [], [], 0.0, 0.0
    for c, op in enumerate(ops_):
        hi, lo, it, kt, lt = op.operand
        yd, yt = gemv.gemv_f32_symm_slab(hi, ph, it, kt, lt, ms=2 * m,
                                         packed=packed)
        qd, qt = gemv.gemv_f32_symm_slab_plain(hi, ph, it, kt, lt,
                                               ms=2 * m, packed=packed)
        od, ot = gemv._slab_parts(hi.double(), ph.double(), it, kt, lt,
                                  2 * m, tb, packed)
        y, q = torch.cat([yd, yt]), torch.cat([qd, qt])
        errs32 += [_rel(y, q), _rel(y.double(), torch.cat([od, ot]))]
        diff32 = max(diff32, float((y - q).abs().max()))
        zd, zt = gemv.gemv_f32_symm_slab(hi, ph, it, kt, lt, ms=2 * m,
                                         packed=packed)
        _check(torch.equal(yd, zd) and torch.equal(yt, zt),
               f"gemv_f32_symm_slab {label} not repeatable")
        sum32 += pcg_symm._scatter_bands(yd, yt, c, g, m)
        outs = gemv.gemv_df64_symm_slab(hi, lo, ph, pl, it, kt, lt,
                                        ms=2 * m, packed=packed)
        plain = gemv.gemv_df64_symm_slab_plain(hi, lo, ph, pl, it, kt, lt,
                                               ms=2 * m, packed=packed)
        od, ot = gemv._slab_parts(hi.double() + lo.double(), p64, it, kt,
                                  lt, 2 * m, tb, packed)
        y = torch.cat([outs[0].double() + outs[1].double(),
                       outs[2].double() + outs[3].double()])
        q = torch.cat([plain[0].double() + plain[1].double(),
                       plain[2].double() + plain[3].double()])
        errs64 += [_rel(y, q), _rel(y, torch.cat([od, ot]))]
        diff64 = max(diff64, float((y - q).abs().max()))
        again = gemv.gemv_df64_symm_slab(hi, lo, ph, pl, it, kt, lt,
                                         ms=2 * m, packed=packed)
        _check(all(torch.equal(u, v) for u, v in zip(outs, again)),
               f"gemv_df64_symm_slab {label} not repeatable")
        sum64 += pcg_symm._scatter_bands(y[:2 * m], y[2 * m:], c, g, m)
    n1 = one[0].shape[0]
    e32, e64 = _rel(sum32[:n1], one[0]), _rel(sum64[:n1], one[1])
    print(f"slab walk {label} (tb={tb}, ms={2 * m}, n={ph.shape[0]}, "
          f"T={ops_[0].operand[2].shape[0]} tiles a rank): rel l2 "
          f"kernel-plain / kernel-f64 max f32 {max(errs32):.3e} (<= 1e-5), "
          f"df64 {max(errs64):.3e} (<= 1e-13); ranks' parts summed vs the "
          f"one-device kernels: gemv_f32_symm {e32:.3e} (<= 1e-5), "
          f"gemv_df64_symm {e64:.3e} (<= 1e-13)")
    _check(max(errs32) <= 1e-5, f"gemv_f32_symm_slab {label} disagrees")
    _check(max(errs64) <= 1e-13, f"gemv_df64_symm_slab {label} disagrees")
    _check(e32 <= 1e-5 and e64 <= 1e-13,
           f"{label}: the ranks' parts do not add up to the matvec")
    _check(int(torch.count_nonzero(sum32[N:])) == 0
           and int(torch.count_nonzero(sum64[N:])) == 0,
           f"{label}: padding rows != 0")
    return diff32, diff64


def slab_kernels_vs_plain(gemv, layout, pcg_symm, Mesh, pack_planes, a, p):
    """Phase 2, the band-pair walk kernels at the shards of G=2 (tb=512,
    mt=5, T=105 tiles a rank, ms=5120, n=10240) and G=4 (n=12288, T=75),
    slab and packed, every rank's tables."""
    tb = layout.SYMM_TB
    n1 = layout.padded_size(N, tb)
    tri_hi, tri_lo = (torch.from_numpy(x).cuda()
                      for x in pack_planes(a, "df64", tb))
    ph1, pl1, _ = _pair(p, n1)
    yh, yl = gemv.gemv_df64_symm(tri_hi, tri_lo, ph1, pl1)
    one = (gemv.gemv_f32_symm(tri_hi, ph1), yh.double() + yl.double())
    del tri_lo
    del tri_hi
    diffs = [0.0, 0.0]
    timed = {}
    for g in SHARD_G:
        for packed in (False, True):
            ops_ = [pcg_symm.SymmShardedOperator.from_row_block_fn(
                lambda s, k: a[s:s + k], N, mesh=Mesh(c, g, "cuda"),
                packed=packed) for c in range(g)]
            ph, pl, p64 = _pair(p, ops_[0].n_padded)
            d32, d64 = _slab_case(gemv, pcg_symm, ops_, ph, pl, p64, one)
            diffs = [max(diffs[0], d32), max(diffs[1], d64)]
            if g == SHARD_G[0]:
                timed[packed] = (ops_[0], ph, pl, p64)
            del ops_
            torch.cuda.empty_cache()
    # timed: rank 0 of G=2, packed (the entry) and slab; beside torch.mv
    # over the rank's (2m, n) slab of full rows, twice the bytes
    op, ph, pl, p64 = timed[True]
    slab = timed[False][0]
    hi, lo, it, kt, lt = op.operand
    ms = 2 * op.m
    T = it.shape[0]
    flops = 2 * tb * tb * (T + int((kt < it).sum()))
    sh, sl = slab.operand[:2]
    s64 = sh.double() + sl.double()
    yd, yt = gemv.gemv_f32_symm_slab(hi, ph, it, kt, lt, ms=ms, packed=True)
    out = [_timed_entry(
        "gemv_f32_symm_slab", "lam_tpu/ops/gemv.py:552", SYMM_SOURCE,
        diffs[0],
        (lambda: gemv.gemv_f32_symm_slab(hi, ph, it, kt, lt, ms=ms,
                                         packed=True),
         lambda: gemv.gemv_f32_symm_slab_plain(hi, ph, it, kt, lt, ms=ms,
                                               packed=True),
         lambda: torch.mv(sh, ph)), (hi, ph, it, kt, lt, yd, yt), flops,
        "f32")]
    outs = gemv.gemv_df64_symm_slab(hi, lo, ph, pl, it, kt, lt, ms=ms,
                                    packed=True)
    out.append(_timed_entry(
        "gemv_df64_symm_slab", "lam_tpu/ops/gemv.py:1267", SYMM_SOURCE,
        diffs[1],
        (lambda: gemv.gemv_df64_symm_slab(hi, lo, ph, pl, it, kt, lt, ms=ms,
                                          packed=True),
         lambda: gemv.gemv_df64_symm_slab_plain(hi, lo, ph, pl, it, kt, lt,
                                                ms=ms, packed=True),
         lambda: torch.mv(s64, p64)), (hi, lo, ph, pl, it, kt, lt, *outs),
        flops, "f64"))
    # the slab storage walks the same tiles in place (no library call)
    sit, skt, slt = slab.operand[2:]
    _timed_entry(
        "f32 slab walk", "lam_tpu/ops/gemv.py:552", SYMM_SOURCE, diffs[0],
        (lambda: gemv.gemv_f32_symm_slab(sh, ph, sit, skt, slt, ms=ms),
         lambda: gemv.gemv_f32_symm_slab_plain(sh, ph, sit, skt, slt,
                                               ms=ms), None),
        (hi, ph, it, kt, lt, yd, yt), flops, "f32")
    _timed_entry(
        "df64 slab walk", "lam_tpu/ops/gemv.py:1267", SYMM_SOURCE, diffs[1],
        (lambda: gemv.gemv_df64_symm_slab(sh, sl, ph, pl, sit, skt, slt,
                                          ms=ms),
         lambda: gemv.gemv_df64_symm_slab_plain(sh, sl, ph, pl, sit, skt,
                                                slt, ms=ms), None),
        (hi, lo, ph, pl, it, kt, lt, *outs), flops, "f64")
    return out


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


def _stencil_case(stencil, label, p, up, dn, nrows, nxi, tbr):
    """One stencil case against its plain version; returns y's largest
    difference from the plain version (0: they must be bitwise equal)."""
    y, d = stencil.laplace5_f32_halo(p, up, dn, nrows, nxi=nxi, tbr=tbr)
    y_plain, d_plain = stencil.laplace5_f32_halo_plain(p, up, dn, nrows,
                                                       nxi=nxi)
    y64, d64 = _stencil_oracle(p, up, dn, nrows, nxi)
    y2, d2 = stencil.laplace5_f32_halo(p, up, dn, nrows, nxi=nxi, tbr=tbr)
    torch.cuda.synchronize()
    d, d_plain = float(d), float(d_plain)
    errs = (abs(d - d_plain) / abs(d_plain), abs(d - d64) / abs(d64))
    y_err = float((y - y_plain).abs().max())
    print(f"laplace5 {label}: y-plain max {y_err:.3e} (== 0), y-f64 max "
          f"{float((y.double() - y64).abs().max()):.3e}, p.y rel: "
          f"kernel-plain {errs[0]:.3e} kernel-f64 {errs[1]:.3e} (<= 1e-6)")
    _check(torch.equal(y, y_plain), f"laplace5 {label}: y != plain version")
    _check(int(torch.count_nonzero(y[nrows:])) == 0
           and int(torch.count_nonzero(y[:, nxi:])) == 0,
           f"laplace5 {label}: padding != 0")
    _check(max(errs) <= 1e-6, f"laplace5 {label}: p.y disagrees")
    _check(torch.equal(y, y2) and float(d2) == d,
           f"laplace5 {label}: not repeatable")
    return y_err


def _stencil_timed(stencil, name, p, zero, nyi, nxi, tbr, y_err):
    """_timed_entry of the zero-edge stencil on grid p, with torch's
    conv2d (5-point weights, padding 1; no mask, no p.y) as the library
    call."""
    H, W = p.shape
    y, d = stencil.laplace5_f32(p, nyi=nyi, nxi=nxi, tbr=tbr)
    weights = torch.tensor([[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0],
                            [0.0, -1.0, 0.0]], device=p.device)
    weights = weights.view(1, 1, 3, 3)
    p4 = p.view(1, 1, H, W)
    # 5 operations a valid cell for the stencil, 2 for the dot
    return _timed_entry(
        name, "lam_tpu/ops/stencil.py:92", STENCIL_SOURCE, y_err,
        (lambda: stencil.laplace5_f32_halo(p, zero, zero, nyi, nxi=nxi,
                                           tbr=tbr),
         lambda: stencil.laplace5_f32_halo_plain(p, zero, zero, nyi,
                                                 nxi=nxi),
         lambda: torch.nn.functional.conv2d(p4, weights, padding=1)),
        (p, zero, zero, y, d), 7 * nyi * nxi, "f32")


def stencil_vs_plain(stencil):
    """Phase 2, the stencil: laplace5_f32_halo against its plain version
    on the heat demo's grid, zero-edged and as a halo shard; timed there
    (the `kernels` line's entry) and at 4096 x 4096."""
    rng = np.random.default_rng(11)
    nyi, nxi = HEAT_NY - 2, HEAT_NX - 2
    H, W, tbr = stencil.padded_hw(nyi, nxi)

    def grid(h, w, rows, cols):
        p = torch.zeros(h, w, device="cuda")
        p[:rows, :cols] = torch.from_numpy(
            rng.standard_normal((rows, cols)).astype(np.float32)).cuda()
        return p

    p = grid(H, W, nyi, nxi)
    zero = torch.zeros(1, W, device="cuda")
    y_err = _stencil_case(stencil, f"{H}x{W} zero edges", p, zero, zero,
                          nyi, nxi, tbr)
    full = grid(H, W, H, W)
    up, dn = grid(1, W, 1, W), grid(1, W, 1, W)
    for nrows, cols in ((H - 24, W - 82), (H, W - 82)):
        y_err = max(y_err, _stencil_case(
            stencil, f"{H}x{W} halo rows, nrows {nrows}, nxi {cols}",
            full, up, dn, nrows, cols, tbr))
    entry = _stencil_timed(stencil, "laplace5_f32_halo", p, zero, nyi, nxi,
                           tbr, y_err)
    del full
    big_i = STREAM_NI
    Hb, Wb, tbr_b = stencil.padded_hw(big_i, big_i)
    pb = grid(Hb, Wb, big_i, big_i)
    zb = torch.zeros(1, Wb, device="cuda")
    yb_err = _stencil_case(stencil, f"{Hb}x{Wb} zero edges", pb, zb, zb,
                           big_i, big_i, tbr_b)
    big = _stencil_timed(stencil, f"laplace5 {Hb}x{Wb}", pb, zb, big_i,
                         big_i, tbr_b, yb_err)
    print("laplace5_f32_halo at the streaming shape: "
          + json.dumps({k: big[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "library_ms")}))
    return entry


def _heat_true_rel(grid):
    """TRUE relative residual |b - A u| / |b| of the 5-point system whose
    unknowns are the plate's interior, in float64 (b from the boundary,
    as lam_tpu/apps/heat.py:340-344)."""
    u = grid[1:-1, 1:-1]
    b = np.zeros_like(u)
    b[0, :] += grid[0, 1:-1]
    b[-1, :] += grid[-1, 1:-1]
    b[:, 0] += grid[1:-1, 0]
    b[:, -1] += grid[1:-1, -1]
    au = 4 * u
    au[:-1] -= u[1:]
    au[1:] -= u[:-1]
    au[:, :-1] -= u[:, 1:]
    au[:, 1:] -= u[:, :-1]
    return float(np.linalg.norm(b - au) / np.linalg.norm(b))


def _numpy_jacobi(grid, max_iters, eps):
    """Literal numpy loop of the reference's solve_heat (as
    tests/test_heat.py:8-19)."""
    g = grid.copy()
    for k in range(1, max_iters + 1):
        new = g.copy()
        new[1:-1, 1:-1] = (g[2:, 1:-1] + g[:-2, 1:-1]
                           + g[1:-1, :-2] + g[1:-1, 2:]) / 4.0
        diff = np.max(np.abs(new[1:-1, 1:-1] - g[1:-1, 1:-1]))
        g = new
        if diff < eps:
            return g, k
    return g, max_iters


def heat_demo(ops, heat, heat_cli, bmp_cli, bmp, lio):
    """Phase 4: the heat demo through the port's CLIs. Returns the kernel
    launches summed over its runs."""
    stencil_k, stencil_p = "laplace5_f32_halo", "laplace5_f32_halo_plain"
    gemv_k = [fn.__name__ for fn in ops.KERNELS if fn.__name__ != stencil_k]
    # (run, argv tail, kernels it must launch, kernels it must not launch)
    runs = (("heat-ir", ["--precision", "ir"], (stencil_k,), gemv_k),
            ("heat-f64", ["--precision", "f64"], (), [stencil_k]),
            ("jacobi", ["--solver", "jacobi"], (), [stencil_k]))
    total = {fn.__name__: 0 for fn in ops.KERNELS}
    grids = {}
    with tempfile.TemporaryDirectory() as tmp:
        for run, extra, kernels, not_kernels in runs:
            nx, ny, iters_max = ((JAC_NX, JAC_NY, "1000000")
                                 if run == "jacobi"
                                 else (HEAT_NX, HEAT_NY, "100000"))
            path = os.path.join(tmp, f"{run}.bin")
            out = io.StringIO()
            ops.reset_counters()
            with contextlib.redirect_stdout(out):
                rc = heat_cli.main([str(nx), str(ny), path, iters_max,
                                    *extra, "--device", "cuda"])
            torch.cuda.synchronize()
            counts = ops.counters()
            text = out.getvalue()
            _check(rc == 0, f"{run}: lam-heat exited {rc}")
            m = re.search(r"Iterations converged in (\d+) iterations with "
                          r"(\w+)=(\S+)", text)
            _check(m is not None, f"{run} did not converge:\n{text}")
            iters = int(m.group(1))
            solve_s = float(re.search(r"Time elapsed: (\S+) s",
                                      text).group(1))
            warm_s = float(re.search(r"Warm-up \(compile \+ construction\) "
                                     r"time: (\S+) s", text).group(1))
            grid = lio.read_matrix(path)
            _check(grid.shape == (ny, nx), f"{run}: grid {grid.shape}")
            grids[run] = grid
            launched = {k: v for k, v in counts.items() if v}
            line = (f"{run} {nx}x{ny}: {iters} iterations, "
                    f"{m.group(2)} {m.group(3)}, solve {solve_s:.4f} s, "
                    f"warm-up {warm_s:.4f} s")
            if run == "jacobi":
                ref, k_ref = _numpy_jacobi(heat.initial_grid(nx, ny),
                                           int(iters_max), 1e-3)
                print(f"{line}, numpy loop {k_ref} sweeps, grid max abs "
                      f"diff {float(np.abs(grid - ref).max()):.3e}, "
                      f"launches {launched}")
                _check(iters == k_ref, f"jacobi: {iters} sweeps, the numpy "
                       f"loop {k_ref}")
                np.testing.assert_allclose(grid, ref, rtol=1e-12)
            else:
                true_rel = _heat_true_rel(grid)
                print(f"{line}, TRUE rel residual {true_rel:.3e} "
                      f"(<= {HEAT_GATE:g}), launches {launched}")
                _check(true_rel <= HEAT_GATE, f"{run} TRUE residual "
                       f"{true_rel:.3e} above {HEAT_GATE:g}")
            for k in kernels:
                _check(counts[k] > 0, f"{run} never launched {k}")
            for k in not_kernels:
                _check(counts[k] == 0, f"{run} launched {k}")
            _check(all(counts[fn.__name__] == 0 for fn in ops.PLAIN),
                   f"a plain version ran on the {run} path")
            for k in total:
                total[k] += counts[k]
        gap = float(np.abs(grids["heat-ir"] - grids["heat-f64"]).max())
        print(f"heat ir vs f64 grids: max abs diff {gap:.3e} "
              f"(<= {IR_F64_ATOL:g})")
        _check(gap <= IR_F64_ATOL, "the ir and f64 heat grids disagree")
        bmp_path = os.path.join(tmp, "heat.bmp")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = bmp_cli.main([os.path.join(tmp, "heat-ir.bin"), bmp_path])
        _check(rc == 0, f"lam-heat-to-bmp exited {rc}")
        img = bmp.read_bmp(bmp_path)
        print(f"lam-heat-to-bmp: image {img.shape}")
        _check(img.shape == (HEAT_NY, HEAT_NX, 3), "BMP has the wrong shape")
    print(f"heat demo launches, summed over the runs: {total}")
    return total


def bench_system(generate, lio, tmp):
    """The benchmark system, written in the binary format into tmp:
    (a, b, A.bin path, b.bin path)."""
    t0 = time.perf_counter()
    a = generate.random_spd_matrix_fast(N, seed=SEED_A)
    b = generate.random_rhs(N, seed=SEED_B)
    print(f"bench system N={N} generated in {time.perf_counter() - t0:.1f} s")
    a_path, b_path = os.path.join(tmp, "A.bin"), os.path.join(tmp, "b.bin")
    lio.write_matrix(a_path, a)
    lio.write_matrix(b_path, b)
    return a, b, a_path, b_path


def solve_slice(ops, lio, cli, system, tmp):
    """Phase 3: the bench system through the port's CLI, one run per
    entry of RUNS. Returns the kernel launches summed over the runs and
    the solution of the ir run."""
    a, b, a_path, b_path = system
    bnorm = np.linalg.norm(b)
    total = {fn.__name__: 0 for fn in ops.KERNELS}
    xs, iters_of = {}, {}
    for run, kernels, not_kernels in RUNS:
        precision = run.split("-")[0]
        x_path = os.path.join(tmp, f"x_{run}.bin")
        argv = ["-A", a_path, "-b", b_path, "-o", x_path,
                "--precision", precision, "--device", "cuda"]
        if precision in PACK_CACHE:
            argv.append("--pack-cache")
        if run.endswith("-pallas"):
            argv += ["--engine", "pallas"]
        csv = io.StringIO()
        ops.reset_counters()
        with contextlib.redirect_stdout(csv):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        counts = ops.counters()
        line = csv.getvalue().strip()
        print(f"{run} CSV (N,procs,threads,load_s,avg_gemv_s,"
              f"avg_iter_s,num_iter,err,total_cg_s): {line}")
        _check(rc == 0, f"CLI --precision {precision} exited {rc}")
        fields = line.split(",")
        load_s, iters, solve_s = (float(fields[3]), int(fields[6]),
                                  float(fields[8]))
        x = lio.read_vector(x_path)
        true_rel = float(np.linalg.norm(b - a @ x) / bnorm)
        launched = {k: v for k, v in counts.items() if v}
        print(f"{run}: load {load_s:.3f} s, {iters} iterations, solve "
              f"{solve_s:.4f} s, TRUE rel residual {true_rel:.3e} "
              f"(<= {TRUE_GATE:g}), launches {launched}")
        _check(iters <= 10000, f"{run} did not converge")
        _check(true_rel <= TRUE_GATE, f"{run} TRUE residual "
               f"{true_rel:.3e} above {TRUE_GATE:g}")
        for k in kernels:
            _check(counts[k] > 0, f"{run} never launched {k}")
        for k in not_kernels:
            _check(counts[k] == 0, f"{run} launched {k}: the engine "
                   "was not honoured")
        _check(all(counts[fn.__name__] == 0 for fn in ops.PLAIN),
               f"a plain version ran on the {run} path")
        for k in total:
            total[k] += counts[k]
        xs[run], iters_of[run] = x, iters
    for precision, storage in PACK_CACHE.items():
        _check(os.path.exists(f"{a_path}.{storage}pack"),
               f"{precision} --pack-cache wrote no A.bin.{storage}pack")
    for precision in PACK_CACHE:
        warm, cold = f"{precision}-warm", f"{precision}-cold"
        _check(iters_of[warm] == iters_of[cold]
               and np.array_equal(xs[warm], xs[cold]),
               f"{precision} from the cache differs from {precision} after "
               "a fresh pack")
    print(f"main path launches, summed over the runs: {total}")
    return total, xs["ir"]


def rank_main(argv):
    """One rank of a phase-5 cluster (`chip_smoke.py --rank r --ranks G
    --port P --jobs J --out D`): joins the process group, runs every job
    of J through the port's CLI in process with --backend sharded, and
    writes D/rank<r>.json with each job's exit code, output, launch
    counts and the mesh's backend and device."""
    import argparse

    import torch.distributed as dist

    from lam_tpu_torch import cli, ops
    from lam_tpu_torch.parallel import mesh as pmesh

    p = argparse.ArgumentParser()
    for flag in ("--rank", "--ranks", "--port"):
        p.add_argument(flag, type=int, required=True)
    p.add_argument("--jobs", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    address = f"127.0.0.1:{args.port}"
    pmesh.distributed_init(address, args.ranks, args.rank, device="cuda",
                           timeout_s=CLUSTER_TIMEOUT_S)
    mesh = pmesh.make_mesh(device="cuda")
    with open(args.jobs) as f:
        jobs = json.load(f)
    results = []
    for job in jobs:
        out = io.StringIO()
        ops.reset_counters()
        with contextlib.redirect_stdout(out):
            rc = cli.main(job["argv"] + [
                "--backend", "sharded", "--device", "cuda", "--init-col",
                "--coordinator", address, "--num-processes",
                str(args.ranks), "--process-id", str(args.rank)])
        torch.cuda.synchronize()
        results.append({"run": job["run"], "rc": rc, "stdout": out.getvalue(),
                        "counts": ops.counters(), "backend": mesh.backend,
                        "device": str(mesh.device)})
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cluster(g, jobs, tmp):
    """Run the jobs in a cluster of g rank processes of this script on the
    one card; returns each rank's records. Kills every rank and fails when
    one fails or the cluster outlives CLUSTER_TIMEOUT_S."""
    out = os.path.join(tmp, f"cluster{g}")
    os.makedirs(out, exist_ok=True)
    jobs_path = os.path.join(out, "jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    port = _free_port()
    logs = [open(os.path.join(out, f"rank{r}.log"), "w") for r in range(g)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--ranks", str(g), "--port", str(port), "--jobs", jobs_path,
         "--out", out], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(g)]
    deadline = time.monotonic() + CLUSTER_TIMEOUT_S
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    codes = [proc.returncode for proc in procs]
    if any(codes):
        for r in range(g):
            with open(os.path.join(out, f"rank{r}.log")) as f:
                print(f"--- rank {r} of {g} (exit {codes[r]}):\n"
                      + f.read()[-3000:])
        raise AssertionError(f"the {g}-rank cluster failed: exit codes "
                             f"{codes}")
    records = []
    for r in range(g):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            records.append(json.load(f))
    return records


def sharded_runs(ops, lio, system, x_local, tmp):
    """Phase 5: the bench system through the port's CLI with --backend
    sharded, G rank processes on the one card over gloo, one cluster per
    G running its entries of SHARDED_RUNS in order. Returns the kernel
    launches summed over the runs and ranks."""
    a, b, a_path, b_path = system
    bnorm = np.linalg.norm(b)
    total = {fn.__name__: 0 for fn in ops.KERNELS}
    plain = [fn.__name__ for fn in ops.PLAIN]
    for g in SHARD_G:
        runs = [r for r in SHARDED_RUNS if r[1] == g]
        jobs = [{"run": run, "argv": ["-A", a_path, "-b", b_path, "-o",
                                      os.path.join(tmp, f"x_{run}.bin"),
                                      *flags]}
                for run, _, flags, _, _ in runs]
        t0 = time.perf_counter()
        records = _cluster(g, jobs, tmp)
        print(f"{g}-rank cluster: {len(runs)} runs in "
              f"{time.perf_counter() - t0:.1f} s of wall time")
        for j, (run, _, flags, kernels, not_kernels) in enumerate(runs):
            recs = [rank_recs[j] for rank_recs in records]
            _check(all(rec["run"] == run and rec["rc"] == 0 for rec in recs),
                   f"{run}: a rank's CLI failed: "
                   f"{[rec['rc'] for rec in recs]}")
            line = recs[0]["stdout"].strip()
            _check(all(not rec["stdout"].strip() for rec in recs[1:]),
                   f"{run}: a rank other than 0 printed")
            print(f"{run} CSV (N,procs,threads,load_s,init_s,avg_gemv_s,"
                  f"avg_iter_s,num_iter,err,total_cg_s): {line}")
            fields = line.split(",")
            _check(int(fields[1]) == g, f"{run}: procs {fields[1]} != {g}")
            load_s, init_s, iters, solve_s = (
                float(fields[3]), float(fields[4]), int(fields[7]),
                float(fields[9]))
            x = lio.read_vector(os.path.join(tmp, f"x_{run}.bin"))
            true_rel = float(np.linalg.norm(b - a @ x) / bnorm)
            x_rel = float(np.linalg.norm(x - x_local)
                          / np.linalg.norm(x_local))
            meshes = sorted({(rec["backend"], rec["device"]) for rec in recs})
            print(f"{run}: {g} ranks on {meshes}, load {load_s:.3f} s, "
                  f"init {init_s:.3f} s, {iters} iterations, solve "
                  f"{solve_s:.4f} s, TRUE rel residual {true_rel:.3e} "
                  f"(<= {TRUE_GATE:g}), x vs one-device ir {x_rel:.3e} "
                  f"(<= {X_GATE:g}), launches rank 0 "
                  f"{ {k: v for k, v in recs[0]['counts'].items() if v} }")
            _check(iters <= 10000, f"{run} did not converge")
            _check(true_rel <= TRUE_GATE, f"{run} TRUE residual "
                   f"{true_rel:.3e} above {TRUE_GATE:g}")
            _check(x_rel <= X_GATE, f"{run}: x differs from the one-device "
                   f"ir solve by {x_rel:.3e}")
            _check(meshes == [("gloo", "cuda:0")],
                   f"{run}: the mesh is {meshes}, not gloo on cuda:0")
            for r, rec in enumerate(recs):
                counts = rec["counts"]
                for k in kernels:
                    _check(counts[k] > 0, f"{run}: rank {r} never launched "
                           f"{k}")
                for k in not_kernels:
                    _check(counts[k] == 0, f"{run}: rank {r} launched {k}")
                _check(all(counts[k] == 0 for k in plain),
                       f"{run}: a plain version ran on rank {r}")
                for k in total:
                    total[k] += counts[k]
    print(f"sharded launches, summed over the runs and ranks: {total}")
    return total


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from lam_tpu_torch import cli, generate, ops
    from lam_tpu_torch import io as lio
    from lam_tpu_torch.apps import bmp, bmp_cli, heat, heat_cli
    from lam_tpu_torch.ops import _build, gemv, layout, stencil
    from lam_tpu_torch.parallel import pcg, pcg_symm
    from lam_tpu_torch.parallel.mesh import Mesh
    from lam_tpu_torch.precision import split_f64_host
    from lam_tpu_torch.solver.operators import (_host_pack_planes,
                                                _host_pack_tri)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False  # oracles in full f32/f64
    torch.backends.cudnn.allow_tf32 = False  # conv2d's yardstick in full f32

    path, seconds, built = _build.build()
    _build.library()
    print(f"kernels {'built' if built else 'reused'} in {seconds:.1f} s: "
          f"{os.path.relpath(path)}")

    results = kernels_vs_plain(gemv, layout, _host_pack_planes,
                               _host_pack_tri, split_f64_host)
    torch.cuda.empty_cache()
    results.append(stencil_vs_plain(stencil))
    torch.cuda.empty_cache()
    a, p = _shard_system()
    results += cols_kernels_vs_plain(gemv, pcg, Mesh, a, p)
    torch.cuda.empty_cache()
    results += slab_kernels_vs_plain(gemv, layout, pcg_symm, Mesh,
                                     _host_pack_planes, a, p)
    del a
    _check(sorted(r["name"] for r in results)
           == sorted(fn.__name__ for fn in ops.KERNELS),
           "phase 2 did not hold every kernel against its plain version")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        system = bench_system(generate, lio, tmp)
        counts, x_ir = solve_slice(ops, lio, cli, system, tmp)
        torch.cuda.empty_cache()
        heat_counts = heat_demo(ops, heat, heat_cli, bmp_cli, bmp, lio)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        shard_counts = sharded_runs(ops, lio, system, x_ir, tmp)
        print(f"phase 5: {time.perf_counter() - t0:.1f} s")
    for r in results:
        r["launches"] = (counts[r["name"]] + heat_counts[r["name"]]
                         + shard_counts[r["name"]])
        _check(r["launches"] > 0, f"{r['name']} never launched on the "
               "main path")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]) if "--rank" in sys.argv else main())
