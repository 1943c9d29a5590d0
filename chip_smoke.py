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

Prints {"kernels": [...]} on the line before the last (each kernel's
launches summed over the phase-3 runs) and, as the last line,
{"ok": true, "device": {...}}. Any failure raises: exit code != 0 and no
result line. Without a CUDA device it exits 1 at once.
"""

import contextlib
import io
import json
import os
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


def solve_slice(gemv, generate, lio, cli):
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
        total = {fn.__name__: 0 for fn in gemv.KERNELS}
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
            gemv.reset_counters()
            with contextlib.redirect_stdout(csv):
                rc = cli.main(argv)
            torch.cuda.synchronize()
            counts = gemv.counters()
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
            _check(all(counts[fn.__name__] == 0 for fn in gemv.PLAIN),
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
    from lam_tpu_torch import cli, generate
    from lam_tpu_torch import io as lio
    from lam_tpu_torch.ops import _build, gemv, layout
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

    path, seconds, built = _build.build()
    _build.library()
    print(f"kernels {'built' if built else 'reused'} in {seconds:.1f} s: "
          f"{os.path.relpath(path)}")

    results = kernels_vs_plain(gemv, layout, _host_pack_planes,
                               _host_pack_tri, split_f64_host)
    _check(sorted(r["name"] for r in results)
           == sorted(fn.__name__ for fn in gemv.KERNELS),
           "phase 2 did not hold every kernel against its plain version")
    torch.cuda.empty_cache()
    counts = solve_slice(gemv, generate, lio, cli)
    for r in results:
        r["launches"] = counts[r["name"]]
        _check(r["launches"] > 0, f"{r['name']} never launched on the "
               "main path")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
