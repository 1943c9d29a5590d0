#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the CUDA kernels
   from lam_tpu_torch/csrc (nvcc, sm_90a, one nvcc per source).
2. Holds each of the seven kernels against its plain PyTorch version at
   the main path's shape, N=10000 padded to 10240 (20 row tiles of 512,
   210 packed tiles; the fq planes stored padded to 216), on one random
   symmetric matrix:
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
   diagonal zeroed. Prints each kernel's median time per call, its plain
   version's and, where one PyTorch call computes the same function
   (torch.mv on the full f32 or f64 square), that call's (CUDA events
   around batches of back-to-back calls, taken in turns and enqueued
   behind a device-side spin so the host's launch rate cannot gap them),
   the GB/s of the bytes moved and the bound: the larger of those bytes
   at 3.35 TB/s and the flops at the H100's f32 or f64 peak.
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

Prints {"kernels": [...]} on the line before the last (each kernel's
launches summed over the phase-3 and phase-4 runs) and, as the last line,
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


def solve_slice(ops, generate, lio, cli):
    """Phase 3: the bench system through the port's CLI, one run per
    entry of RUNS. Returns the kernel launches summed over the runs."""
    t0 = time.perf_counter()
    a = generate.random_spd_matrix_fast(N, seed=SEED_A)
    b = generate.random_rhs(N, seed=SEED_B)
    print(f"bench system N={N} generated in {time.perf_counter() - t0:.1f} s")
    bnorm = np.linalg.norm(b)
    with tempfile.TemporaryDirectory() as tmp:
        a_path, b_path = os.path.join(tmp, "A.bin"), os.path.join(tmp, "b.bin")
        lio.write_matrix(a_path, a)
        lio.write_matrix(b_path, b)
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
    _check(sorted(r["name"] for r in results)
           == sorted(fn.__name__ for fn in ops.KERNELS),
           "phase 2 did not hold every kernel against its plain version")
    torch.cuda.empty_cache()
    counts = solve_slice(ops, generate, lio, cli)
    torch.cuda.empty_cache()
    heat_counts = heat_demo(ops, heat, heat_cli, bmp_cli, bmp, lio)
    for r in results:
        r["launches"] = counts[r["name"]] + heat_counts[r["name"]]
        _check(r["launches"] > 0, f"{r['name']} never launched on the "
               "main path")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
