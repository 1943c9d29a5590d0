#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the CUDA kernels
   from lam_tpu_torch/csrc (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch version at the main
   path's shape, N=10000 padded to 10240 (20 row tiles of 512, 210
   packed tiles; the fq planes stored padded to 216): the f32 and q16
   kernels and their plain versions agree to a relative l2 of 1e-5 and
   match a float64 oracle of their stored tiles to 1e-5; the df64 and fq
   kernels and their plain versions match the f64 oracle of their stored
   tiles to 1e-13, and fq the original f64 matrix to 1e-12 (its storage
   bound); padding rows of y are exactly 0. The fq planes are the port's
   own pack of the same random matrix with its diagonal zeroed. Prints
   each one's median time per call (CUDA events around batches of
   back-to-back calls, enqueued behind a device-side spin so the host's
   launch rate cannot gap them) and the GB/s of stored bytes read.
3. Writes the benchmark system (random_spd_matrix_fast(10000,
   seed=2024), random_rhs(10000, seed=2034)) in the binary format to a
   temporary directory and solves it through the port's CLI, in
   process: --precision ir, df64, irfq --pack-cache twice (cold: packs
   and writes A.bin.fqpack; warm: reads it, and must give the same
   iterations and a bitwise-equal x), and fq. Each solution is read
   back and its TRUE relative residual |b - A x| / |b| computed in f64
   on the host must be <= 2e-9 (the benchmark's gate), converged. The
   launch counters are zeroed just before each run and read just after:
   each run's kernels must have launched, and no plain version may have
   run.

Prints {"kernels": [...]} on the line before the last and, as the last
line, {"ok": true, "device": {...}}. Any failure raises: exit code != 0
and no result line. Without a CUDA device it exits 1 at once.
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
SOURCE = "lam_tpu_torch/csrc/gemv_symm.cu"
# the kernels each CLI run must launch
RUNS = (("ir", ("gemv_f32_symm", "gemv_df64_symm")),
        ("df64", ("gemv_df64_symm",)),
        ("irfq-cold", ("gemv_q16_symm", "gemv_fq_symm")),
        ("irfq-warm", ("gemv_q16_symm", "gemv_fq_symm")),
        ("fq", ("gemv_fq_symm",)))


def _rel(y, ref):
    return float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _median_ms(fns):
    """Median CUDA-event time per call of each fn over TIMED_CALLS samples
    of BATCH back-to-back calls, taken in turns so both see the same card
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


def kernels_vs_plain(gemv, layout, pack_planes, pack_tri, split_f64_host):
    """Phase 2: every kernel against its plain version at N=10240."""
    n_p = layout.padded_size(N)
    rng = np.random.default_rng(7)
    m = rng.uniform(-1, 1, size=(N, N))
    a = np.zeros((n_p, n_p))
    a[:N, :N] = m + m.T
    del m
    t0 = time.perf_counter()
    m0 = a[:N, :N].copy()
    np.fill_diagonal(m0, 0.0)
    fq = [torch.from_numpy(x).cuda() for x in pack_tri(m0, "fq",
                                                       layout.SYMM_TB)]
    print(f"fq pack of the N={N} test matrix: "
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
    out = []

    # f32 kernel: exact f32 products, f32 sums in another order
    y = gemv.gemv_f32_symm(hi, ph)
    y_plain = gemv.gemv_f32_symm_plain(hi, ph)
    oracle = torch.mv(a_dev.float().double(), ph.double())
    torch.cuda.synchronize()
    errs = (_rel(y, y_plain), _rel(y.double(), oracle),
            _rel(y_plain.double(), oracle))
    print(f"gemv_f32_symm  rel l2: kernel-plain {errs[0]:.3e}  "
          f"kernel-f64 {errs[1]:.3e}  plain-f64 {errs[2]:.3e}  (<= 1e-5)")
    _check(max(errs) <= 1e-5, "gemv_f32_symm disagrees")
    _check(int(torch.count_nonzero(y[N:])) == 0, "f32 padding rows != 0")
    ms, plain_ms = _median_ms([lambda: gemv.gemv_f32_symm(hi, ph),
                               lambda: gemv.gemv_f32_symm_plain(hi, ph)])
    gb = hi.numel() * 4 / 1e9
    print(f"gemv_f32_symm  kernel {ms:.4f} ms ({gb / ms * 1e3:.0f} GB/s)  "
          f"plain {plain_ms:.4f} ms ({gb / plain_ms * 1e3:.0f} GB/s)  "
          f"[{gb * 1e3:.1f} MB stored]")
    out.append({"name": "gemv_f32_symm", "route": "cuda", "source": SOURCE,
                "replaces": "lam_tpu/ops/gemv.py:455",
                "max_abs_err": float((y - y_plain).abs().max()),
                "ms": ms, "plain_ms": plain_ms})
    del oracle

    # df64 kernel: native f64 accumulation over the (hi, lo) pair
    yh, yl = gemv.gemv_df64_symm(hi, lo, ph, pl)
    qh, ql = gemv.gemv_df64_symm_plain(hi, lo, ph, pl)
    y = yh.double() + yl.double()
    y_plain = qh.double() + ql.double()
    oracle = torch.mv(a_dev, ph.double() + pl.double())
    torch.cuda.synchronize()
    errs = (_rel(y, y_plain), _rel(y, oracle), _rel(y_plain, oracle))
    print(f"gemv_df64_symm rel l2: kernel-plain {errs[0]:.3e}  "
          f"kernel-f64 {errs[1]:.3e}  plain-f64 {errs[2]:.3e}  (<= 1e-13)")
    _check(max(errs) <= 1e-13, "gemv_df64_symm disagrees")
    _check(int(torch.count_nonzero(yh[N:])) == 0
           and int(torch.count_nonzero(yl[N:])) == 0,
           "df64 padding rows != 0")
    ms, plain_ms = _median_ms([
        lambda: gemv.gemv_df64_symm(hi, lo, ph, pl),
        lambda: gemv.gemv_df64_symm_plain(hi, lo, ph, pl)])
    gb = 2 * hi.numel() * 4 / 1e9
    print(f"gemv_df64_symm kernel {ms:.4f} ms ({gb / ms * 1e3:.0f} GB/s)  "
          f"plain {plain_ms:.4f} ms ({gb / plain_ms * 1e3:.0f} GB/s)  "
          f"[{gb * 1e3:.1f} MB stored]")
    out.append({"name": "gemv_df64_symm", "route": "cuda", "source": SOURCE,
                "replaces": "lam_tpu/ops/gemv.py:1008",
                "max_abs_err": float((y - y_plain).abs().max()),
                "ms": ms, "plain_ms": plain_ms})
    del oracle, hi, lo
    torch.cuda.empty_cache()
    out += fq_kernels_vs_plain(gemv, layout, fq, a_dev, ph, pl)
    torch.cuda.synchronize()
    return out


def fq_kernels_vs_plain(gemv, layout, fq, a_dev, ph, pl):
    """Phase 2, the fq planes: the q16 and fq kernels at N=10240."""
    tb = layout.SYMM_TB
    nblk = layout.padded_size(N, tb) // tb
    T = layout.tri_tile_count(nblk)
    q1, s1 = fq[0], fq[3]
    elems = T * tb * tb  # real-tile elements read per matvec
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
    ms, plain_ms = _median_ms([lambda: gemv.gemv_q16_symm(q1, s1, ph),
                               lambda: gemv.gemv_q16_symm_plain(q1, s1, ph)])
    gb = elems * 2 / 1e9
    print(f"gemv_q16_symm  kernel {ms:.4f} ms ({gb / ms * 1e3:.0f} GB/s)  "
          f"plain {plain_ms:.4f} ms ({gb / plain_ms * 1e3:.0f} GB/s)  "
          f"[{gb * 1e3:.1f} MB stored]")
    out.append({"name": "gemv_q16_symm", "route": "cuda", "source": SOURCE,
                "replaces": "lam_tpu/ops/gemv.py:2065",
                "max_abs_err": float((y - y_plain).abs().max()),
                "ms": ms, "plain_ms": plain_ms})
    del oracle

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
    ms, plain_ms = _median_ms([
        lambda: gemv.gemv_fq_symm(*fq[:6], ph, pl),
        lambda: gemv.gemv_fq_symm_plain(*fq[:6], ph, pl)])
    gb = elems * 6 / 1e9
    print(f"gemv_fq_symm   kernel {ms:.4f} ms ({gb / ms * 1e3:.0f} GB/s)  "
          f"plain {plain_ms:.4f} ms ({gb / plain_ms * 1e3:.0f} GB/s)  "
          f"[{gb * 1e3:.1f} MB stored]")
    out.append({"name": "gemv_fq_symm", "route": "cuda", "source": SOURCE,
                "replaces": "lam_tpu/ops/gemv.py:2164",
                "max_abs_err": float((y - y_plain).abs().max()),
                "ms": ms, "plain_ms": plain_ms})
    return out


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
        for run, kernels in RUNS:
            precision = run.split("-")[0]
            x_path = os.path.join(tmp, f"x_{run}.bin")
            argv = ["-A", a_path, "-b", b_path, "-o", x_path,
                    "--precision", precision, "--device", "cuda"]
            if precision == "irfq":
                argv.append("--pack-cache")
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
            _check(all(counts[fn.__name__] == 0 for fn in gemv.PLAIN),
                   f"a plain version ran on the {run} path")
            for k in total:
                total[k] += counts[k]
            xs[run], iters_of[run] = x, iters
        _check(os.path.exists(a_path + ".fqpack"),
               "irfq --pack-cache wrote no A.bin.fqpack")
    _check(iters_of["irfq-warm"] == iters_of["irfq-cold"]
           and np.array_equal(xs["irfq-warm"], xs["irfq-cold"]),
           "irfq from the cache differs from irfq after a fresh pack")
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
