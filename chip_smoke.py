#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the CUDA kernels
   from lam_tpu_torch/csrc (nvcc, sm_90a, one nvcc per source).
2. Holds each of the thirty-one kernels (the solver's twenty-three and
   the eight q16 probes) against its plain PyTorch
   version at the main path's shapes. The eight one-device kernels at N=10000 padded
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
     bitwise;
   - kernels 4 and 5 (gemv_df64, gemv_f32_cols) run the dense_stream walk
     of csrc/gemv_dense.cu: their SASS holds the TMA bulk copy (UBLKCP)
     and that of kernels 3 and 6 (dense_rows) none; each gives the bits of
     the dense_rows walk on the same bytes (gemv_df64_cols with one block
     of the full width; gemv_f32 on a contiguous copy of the column
     block); each is timed against its library call LIBRARY_REPEATS more
     times in turns, dense_rows beside, printing the spread of the
     kernel/library ratio; kernel 5 also at rank 0's column block of G=4
     (printed only).
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
   the same matrix, padding rows exactly 0. The three band-pair walks of
   the quantized storages (gemv_q16_symm_slab, gemv_fq_symm_slab,
   gemv_dfq_symm_slab) at the same shards, G=2 and G=4, every rank's
   tables and scales, each rank's dfq and fq pack built by the port's own
   operator without a process group: q16 to 1e-5, fq and dfq to the f64
   oracle of the stored values at 1e-13, bitwise repeats, and the ranks'
   parts plus the owners' diagonal terms summed against the one-device
   kernels gemv_q16_symm, gemv_fq_symm and gemv_dfq_symm on the same
   matrix; timed at rank 0 of G=2 (the `kernels` entries) and of G=4
   (printed), the q16 walk over three copies of its plane taken in turn,
   because one 55.1 or 39.3 MB plane would stay in the 50 MB L2 between
   calls. The five dual kernels of the symmetric 2 x 2 grid (gemv_f32_dual,
   gemv_df64_dual, gemv_dfq_dual, gemv_q16_dual, gemv_fq_dual) at the
   half-slabs of the same matrix (n_p=10240, m=5120: a (2560, 5120)
   rectangle of 50 real tiles plus 5 pad tiles a rank), every rank's df64,
   dfq and fq pack built by the port's own operator with Mesh2D(rank, 2,
   "cuda") and no process group: on both off-diagonal ranks against plain
   and the f64 oracle of the stored values (f32, q16 1e-5; the others
   1e-13), bitwise repeats, pad tiles and pad scales filled with garbage
   and the result unchanged; the four ranks' (own, payload) exchanged by
   hand and summed against the one-device kernels, padding rows exactly 0;
   timed at rank (1, 0), the f32 and q16 kernels over three copies of their
   plane in turn, beside two torch.mv calls over the dense rectangle (S p,
   S^T q) for the f32 and df64 ones. Prints each kernel's median
   time per call, its plain version's and, where one PyTorch call
   computes the same function (torch.mv on the full f32 or f64 square, or
   on the strided column view for the ring's kernels; for the slab walks,
   for scale only, torch.mv over the rank's (2m, n) slab of full rows,
   twice the bytes), that call's (CUDA events around batches of
   back-to-back calls, taken in turns and enqueued behind a device-side
   spin so the host's launch rate cannot gap them), the GB/s of the bytes
   moved and the bound: the larger of those bytes at 3.35 TB/s and the
   flops at the H100's f32, f64 or bf16 peak.
   The bf16 product engine of the three q16 kernels (lam_tpu's
   LAM_Q16_IMPL "mxu"; "auto" picks it at n >= 16384), each with the engine
   forced where its phase-2 shape is below that: gemv_q16_symm_bf16 at
   N=10240 on the fq pack, gemv_q16_symm_slab_bf16 at every rank's tables
   and scales of G=2 and G=4, gemv_q16_dual_bf16 on both off-diagonal
   ranks of the 2 x 2 grid with garbage pad tiles and pad scales: the
   public wrapper routes to the bf16 kernel, which agrees with its plain
   version to 1e-5, stands apart from the exact kernel (above 1e-5, within
   1e-2), repeats bitwise, equals the f64 oracle bit for bit on
   small-integer tiles (-3..3), scales 0.5/0.25 and operands -3..3, and the
   ranks' parts summed agree to 1e-5 with the one-device bf16 kernel (the
   band pairs) or, for the grid with the engine forced on every rank, with
   one device's exact diagonal blocks plus bf16 off-diagonal blocks (its
   diagonal ranks' exact-count triangles take the exact body, as in
   lam_tpu). The bf16 triangle walk is
   timed at N=20480 (820 tiles, a 432 MB plane) and the bf16 slab walk at
   rank 0 of G=2, n=20480 (410 tiles), where phase 6 runs them, each beside
   the exact body in turns. lam_stream_i16 (lam_tpu_torch/ops/probe.py), a
   read-only stream of an int16 plane with a checksum, gives the card's
   measured read floor of the q16 planes of kernels 14 (N=10240 and
   20480), 16 and 18, printed beside each kernel's data-sheet bound.
   The q16 probes (lam_tpu_torch/ops/probe.py, csrc/q16_probe.cu and
   csrc/probe.cu; lam_tpu's scripts/q16_probe*.py) at N=10240: the walks
   gemv_q16_symm_magic, _sub8, _split, _hi and _hybrid on kernel 14's
   plane (the fq pack's q1) against their plain versions (1e-5; hi and
   hybrid 1e-6, beside the bf16 engine's gap), padding rows 0, bitwise
   repeats, magic equal to kernel 14 bit for bit and its SASS free of
   int -> f32 conversions (cuobjdump); gemv_q16_symm_tb1024 on a random
   int16 plane of 1024-wide tiles against random power-of-two scales
   (1e-5); stream_i16 (checksum = the plain one) and convert_f32_sum
   (within its per-thread f32 rounding bound) on kernel 14's plane, both
   exact on the probes' tridiagonal plane; each timed beside its plain
   version (and, for the streams, torch.sum with an int64 or f64
   accumulator).
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
   and packed-ir-4 at G=4; the quantized band-pair storages packed-irfq
   twice with --pack-cache (cold writes A.bin.shardpack/fq.g2.s<rank>,
   warm reads them: same iterations, bitwise-equal x), packed-irq,
   packed-fq, packed-dfq at G=2 and packed-irfq-4 at G=4; and grid-ir-4,
   --backend sharded2d --precision ir on the 2 x 2 grid of four ranks
   and the symmetric 2 x 2 grid in the same four rank processes:
   symgrid-ir-4 and symgrid-df64-4 (--engine pallas_symm_packed),
   symgrid-irfq twice with --pack-cache (cold writes
   A.bin.shardpack/fq.r2.s0..s3, warm reads them: same iterations,
   bitwise-equal x), symgrid-fq-4, symgrid-irq-4, symgrid-dfq-4: a diagonal
   rank must launch its triangle kernels and no dual one, an off-diagonal
   rank its dual kernels and no triangle one, and no rank anything else
   (SHARDED_RUNS); and symgrid-irfq-mxu-4, the same grid in four new rank
   processes started with LAM_Q16_IMPL=mxu in their environment (MXU_RUNS:
   the off-diagonal ranks launch gemv_q16_dual_bf16 and gemv_fq_dual, the
   diagonal ranks gemv_q16_symm's exact body and gemv_fq_symm, since their
   exact-count triangles take lam_tpu's one-tile grid, nothing else; x
   within 5e-6 of the ir x, since its inner engine differs). Each run must converge with a
   TRUE relative residual <= 2e-9 on the host from rank 0's solution
   file, x within 1e-6 relative of phase 3's one-device ir x, its kernels
   launched and the others not in every rank (irfq: the q16 and fq walks
   and neither the f32 nor the df64 one; irq: the f32 and dfq walks; the
   grid: the dense kernels and no symmetric one), no plain version, its
   iteration count printed beside the one-device run's, one CSV
   row (rank 0's) with procs = G, and the mesh must report gloo with every
   rank on cuda:0. G ranks on one card measure the sharded program, not
   multi-GPU scaling. No earlier phase was shortened for these.
6. Writes bench.py's system at its second size (random_spd_matrix_fast(
   20000, seed=2024), random_rhs(20000, seed=2034), 3.2 GB) to a new
   temporary directory, phase 3's freed, and solves it through the port's
   CLI: irfq --pack-cache cold and warm under "auto" (gemv_q16_symm_bf16
   and gemv_fq_symm, not the exact q16 body; warm: the same count and a
   bitwise-equal x), irfq with the engine set to "vpu" (the exact body,
   not the bf16 one), and packed-irfq with --backend sharded in a 2-rank
   cluster (every rank gemv_q16_symm_slab_bf16 and gemv_fq_symm_slab, and
   nothing else). Each must converge with TRUE <= 2e-9 on the host and x
   within 5e-6 of the "vpu" run's x, no plain version; prints the bf16 and
   exact runs' inner iterations side by side and the phase's seconds.

7. Runs the q16 probe tool (lam_tpu_torch.tools.q16_probe) in process:
   probes 1-4 of scripts/q16_probe{,2,3,4}.py at their sizes (N=40960 at
   tb=512 and 1024; N=114688 padded; N=57344; N=114688 at tb=1024), every
   variant held to the closed form of the tridiagonal plane exactly, then
   timed in turns with the read floor; prints each row and the phase's
   seconds. The probe kernels' counters are zeroed just before it: each
   must launch, and no plain version may run.

Prints {"kernels": [...]} on the line before the last (each solver
kernel's launches summed over the runs of phases 3-6, every rank's; each
probe's over phase 7) and, as the last
line, {"ok": true, "device": {...}}. Any failure raises: exit code != 0 and
no result line. Without a CUDA device it exits 1 at once.
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
PROBE_SOURCE = "lam_tpu_torch/csrc/q16_probe.cu"
STREAM_SOURCE = "lam_tpu_torch/csrc/probe.cu"
# the q16 probes (lam_tpu_torch/ops/probe.py): the TPU kernel each replaces,
# and the relative l2 to which the kernel agrees with its plain version (the
# exact f32 walks and split: f32 sums in another order; hi and hybrid:
# tensor-core products held to f32 rounding)
PROBE_REPLACES = {"stream_i16": "scripts/q16_probe.py:91",
                  "convert_f32_sum": "scripts/q16_probe.py:110",
                  "gemv_q16_symm_magic": "scripts/q16_probe.py:169",
                  "gemv_q16_symm_tb1024": "scripts/q16_probe.py:342",
                  "gemv_q16_symm_sub8": "scripts/q16_probe2.py:157",
                  "gemv_q16_symm_split": "scripts/q16_probe4.py:63",
                  "gemv_q16_symm_hi": "scripts/q16_probe4.py:63",
                  "gemv_q16_symm_hybrid": "scripts/q16_probe4.py:63"}
PROBE_TOL = {"magic": 1e-5, "sub8": 1e-5, "split": 1e-5, "hi": 1e-6,
             "hybrid": 1e-6, "tb1024": 1e-5}
# tensor-core products per stored element and term (hybrid: its direct
# term's f32 FMAs bound it instead)
MMA_PRODUCTS = {"split": 2, "hi": 5}
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
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12, "bf16": 989e12}
# the bf16 product engine of the q16 kernels (lam_tpu's LAM_Q16_IMPL
# "mxu"), which "auto" picks at n >= 16384
_BF16 = ("gemv_q16_symm_bf16", "gemv_q16_symm_slab_bf16",
         "gemv_q16_dual_bf16")
BF16_REPLACES = {"gemv_q16_symm_bf16": "lam_tpu/ops/gemv.py:1955",
                 "gemv_q16_symm_slab_bf16": "lam_tpu/ops/gemv.py:2266",
                 "gemv_q16_dual_bf16": "lam_tpu/ops/gemv.py:2502"}
N_LARGE = 20000      # bench.py's DEFAULT_SIZES[1]: 'auto' picks bf16 there
# two solves to 1e-9 of a system of condition number up to e^7 ~ 1100 can
# part by ~2.2e-6 in x: the bound for runs whose inner engine differs
X_ENGINE_GATE = 5e-6
# (run, kernels it must launch, kernels it must not launch)
RUNS = (("ir", ("gemv_f32_symm", "gemv_df64_symm"), ()),
        ("df64", ("gemv_df64_symm",), ()),
        ("irfq-cold", ("gemv_q16_symm", "gemv_fq_symm"), _BF16),
        ("irfq-warm", ("gemv_q16_symm", "gemv_fq_symm"), _BF16),
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
_QFQ = ("gemv_q16_symm_slab", "gemv_fq_symm_slab")
_LOCAL_Q = ("gemv_q16_symm", "gemv_fq_symm", "gemv_dfq_symm")
_SYMGRID = ["--backend", "sharded2d"]
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
                        "pallas_symm_packed"], _SLAB, _TRI),
    # the quantized band-pair storages: engine auto -> the packed walk
    ("packed-irfq-cold", 2, ["--precision", "irfq", "--pack-cache"], _QFQ,
     _SLAB + _TRI + _LOCAL_Q + _BF16),
    ("packed-irfq-warm", 2, ["--precision", "irfq", "--pack-cache"], _QFQ,
     _SLAB + _TRI + _LOCAL_Q + _BF16),
    ("packed-irq", 2, ["--precision", "irq"],
     ("gemv_f32_symm_slab", "gemv_dfq_symm_slab"),
     ("gemv_df64_symm_slab",) + _TRI + _LOCAL_Q),
    ("packed-fq", 2, ["--precision", "fq"], ("gemv_fq_symm_slab",),
     ("gemv_q16_symm_slab",) + _SLAB + _TRI + _LOCAL_Q),
    ("packed-dfq", 2, ["--precision", "dfq"], ("gemv_dfq_symm_slab",),
     _SLAB + _TRI + _LOCAL_Q),
    ("packed-irfq-4", 4, ["--precision", "irfq"], _QFQ,
     _SLAB + _TRI + _LOCAL_Q + _BF16),
    # the dense 2-D grid, R=2: the dense kernels on each rank's block
    ("grid-ir-4", 4, ["--backend", "sharded2d", "--precision", "ir"],
     ("gemv_f32", "gemv_df64"),
     _RING + _SLAB + _TRI + _LOCAL_Q + _QFQ + ("gemv_dfq_symm_slab",)),
    # the symmetric 2-D grid, R=2: (the diagonal ranks' kernels, the
    # off-diagonal ranks'); every other kernel must stay at 0 on every rank
    ("symgrid-ir-4", 4, _SYMGRID + ["--precision", "ir", "--engine",
                                    "pallas_symm_packed"],
     (_TRI, ("gemv_f32_dual", "gemv_df64_dual")), ()),
    ("symgrid-df64-4", 4, _SYMGRID + ["--precision", "df64", "--engine",
                                      "pallas_symm_packed"],
     (("gemv_df64_symm",), ("gemv_df64_dual",)), ()),
    ("symgrid-irfq-cold-4", 4, _SYMGRID + ["--precision", "irfq",
                                           "--pack-cache"],
     (("gemv_q16_symm", "gemv_fq_symm"),
      ("gemv_q16_dual", "gemv_fq_dual")), ()),
    ("symgrid-irfq-warm-4", 4, _SYMGRID + ["--precision", "irfq",
                                           "--pack-cache"],
     (("gemv_q16_symm", "gemv_fq_symm"),
      ("gemv_q16_dual", "gemv_fq_dual")), ()),
    ("symgrid-fq-4", 4, _SYMGRID + ["--precision", "fq"],
     (("gemv_fq_symm",), ("gemv_fq_dual",)), ()),
    ("symgrid-irq-4", 4, _SYMGRID + ["--precision", "irq"],
     (("gemv_f32_symm", "gemv_dfq_symm"),
      ("gemv_f32_dual", "gemv_dfq_dual")), ()),
    ("symgrid-dfq-4", 4, _SYMGRID + ["--precision", "dfq"],
     (("gemv_dfq_symm",), ("gemv_dfq_dual",)), ()))
# the same 4 rank processes' layout started with LAM_Q16_IMPL=mxu in their
# environment (lam_tpu's documented explicit value): the grid's half-slabs
# (5120 and 10240 wide at N=20000) stay below 16384 under "auto". The
# diagonal ranks hold exact-count triangles (55 tiles, not a multiple of
# Q16_P), which lam_tpu walks on its one-tile grid with the exact body
# under any engine (lam_tpu/ops/gemv.py:2089-2136): the off-diagonal ranks
# carry the bf16 engine
MXU_ENV = {"LAM_Q16_IMPL": "mxu"}
MXU_RUNS = (
    ("symgrid-irfq-mxu-4", 4, _SYMGRID + ["--precision", "irfq",
                                          "--pack-cache"],
     (("gemv_q16_symm", "gemv_fq_symm"),
      ("gemv_q16_dual_bf16", "gemv_fq_dual")), ()),)
# run -> the one-device run of phase 3 whose iteration count it should show
ONE_DEVICE_OF = {"packed-irfq-cold": "irfq-cold",
                 "packed-irfq-warm": "irfq-warm", "packed-irq": "irq-cold",
                 "packed-fq": "fq", "packed-dfq": "dfq",
                 "packed-irfq-4": "irfq-cold", "grid-ir-4": "ir",
                 "symgrid-ir-4": "ir", "symgrid-df64-4": "df64",
                 "symgrid-irfq-cold-4": "irfq-cold",
                 "symgrid-irfq-warm-4": "irfq-warm", "symgrid-fq-4": "fq",
                 "symgrid-irq-4": "irq-cold", "symgrid-dfq-4": "dfq",
                 "symgrid-irfq-mxu-4": "irfq-cold"}
# the runs through kernels 4 and 5 (gemv_df64, gemv_f32_cols: the
# dense_stream walk) -> the iteration count every earlier chip run of their
# precision gave (PERF.md section 2), printed beside this run's
STREAM_RUN_ITERS = {"ir-pallas": 365, "df64-pallas": 358, "ring-ir": 365,
                    "gather-df64": 358, "ring-ir-4": 365, "grid-ir-4": 365}
LIBRARY_REPEATS = 3  # kernel-vs-library timings of kernels 4 and 5
CLUSTER_TIMEOUT_S = 450  # a cluster that takes longer is killed: a hang
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
    print(f"{name:<19} kernel {ms:.4f} ms ({gb / ms * 1e3:.0f} GB/s)  "
          f"plain {plain_ms:.4f} ms{lib}  bound {bound_ms:.4f} ms  "
          f"[{gb * 1e3:.1f} MB moved]")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": y_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def _against_library(name, kernel, library, earlier, earlier_label):
    """Kernel against its library call, with the earlier dense_rows walk
    on the same bytes beside them, timed in turns LIBRARY_REPEATS times
    in this run: the spread of the kernel/library ratio says how far one
    timing can be trusted (a few % drift between runs, PERF.md §6)."""
    ratios = []
    for r in range(LIBRARY_REPEATS):
        ms, lib_ms, old_ms = _median_ms([kernel, library, earlier])
        ratios.append(ms / lib_ms)
        print(f"{name} repeat {r + 1}: kernel {ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, kernel/library {ms / lib_ms:.4f}; "
              f"{earlier_label} {old_ms:.4f} ms (/library "
              f"{old_ms / lib_ms:.4f})")
    print(f"{name} kernel/library over {LIBRARY_REPEATS} repeats: min "
          f"{min(ratios):.4f}, max {max(ratios):.4f}, spread "
          f"{max(ratios) - min(ratios):.4f}")


def stream_sass(build):
    """The SASS of the dense_stream kernels (4 and 5) holds the TMA bulk
    copy (UBLKCP); that of the dense_rows kernels (3 and 6) none."""
    kernels = build.sass()
    walks = {"dense_stream": [], "dense_rows": []}
    for k, lines in kernels.items():
        for walk, found in walks.items():
            if walk in k:
                found.append(sum("UBLKCP" in line for line in lines))
    print(f"SASS bulk copies (UBLKCP) per kernel: {walks}")
    _check(len(walks["dense_stream"]) == 2
           and all(walks["dense_stream"]),
           "a dense_stream kernel issues no TMA bulk copy")
    _check(len(walks["dense_rows"]) == 2 and not any(walks["dense_rows"]),
           "a dense_rows kernel issues a TMA bulk copy")


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
    # the earlier walk on the same square: gemv_df64_cols (dense_rows)
    # with one column block of the full width gives the same bits
    zh, zl = gemv.gemv_df64_cols(ah, al, ph, pl, 0)
    _check(torch.equal(yh, zh) and torch.equal(yl, zl),
           "gemv_df64 (dense_stream) != the dense_rows walk")
    del oracle
    out.append(_timed_entry(
        "gemv_df64", "lam_tpu/ops/gemv.py:812", DENSE_SOURCE,
        float((y - y_plain).abs().max()),
        (lambda: gemv.gemv_df64(ah, al, ph, pl),
         lambda: gemv.gemv_df64_plain(ah, al, ph, pl),
         lambda: torch.mv(a_dev, p64)), (ah, al, ph, pl, yh, yl), flops,
        "f64"))
    _against_library("gemv_df64", lambda: gemv.gemv_df64(ah, al, ph, pl),
                     lambda: torch.mv(a_dev, p64),
                     lambda: gemv.gemv_df64_cols(ah, al, ph, pl, 0),
                     "dense_rows (gemv_df64_cols, one block)")
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
    bf16_symm_vs_plain(gemv, layout, q1, s1, ph)
    _floor_line(f"kernel 14's q1 plane at N={nblk * tb}", [q1[:T * tb]],
                {"gemv_q16_symm": lambda: gemv.gemv_q16_symm(q1, s1, ph),
                 "gemv_q16_symm_bf16":
                 lambda: gemv.gemv_q16_symm_bf16(q1, s1, ph)},
                _nbytes(q1[:T * tb], s1[:T], ph, y))
    out += probe_kernels_vs_plain(gemv, layout, q1, s1, ph, y)

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


def probe_kernels_vs_plain(gemv, layout, q1, s1, ph, exact):
    """Phase 2, the q16 probes (lam_tpu_torch/ops/probe.py) at N=10240: the
    walks magic, sub8, split, hi and hybrid on kernel 14's plane (the fq
    pack's q1) against their plain versions (PROBE_TOL), padding rows 0,
    bitwise repeats; magic equal to kernel 14's exact result `exact` bit
    for bit and its SASS free of int -> f32 conversions; hi and hybrid
    printed beside the bf16 engine's gap; tb1024 on a random int16 plane
    of 1024-wide tiles against random power-of-two scales; the two streams
    on kernel 14's plane (stream_i16's checksum equal to the plain one,
    convert_f32_sum's within its per-thread f32 rounding bound) and on the
    probes' tridiagonal plane (both exact). Returns their `kernels`
    entries, each timed in turns with its plain version."""
    from lam_tpu_torch.ops import _build, probe
    tb = layout.SYMM_TB
    nblk = ph.shape[0] // tb
    T = layout.tri_tile_count(nblk)
    n = nblk * tb
    out = []
    plane = q1[:T * tb]

    kernels = _build.sass()
    magic = [k for k in kernels if "symm_pass1" in k and "Q16MagicPlane" in k]
    plain_q16 = [k for k in kernels if "symm_pass1" in k and "8Q16Plane" in k]
    conv = {k: probe.f32_conversions(kernels[k]) for k in magic + plain_q16}
    ops_ = sorted({line.split("*/", 1)[1].split()[0]
                   for k in plain_q16 for line in conv[k]})
    print(f"SASS: {len(magic)} magic pass-1 kernel(s) with "
          f"{[len(conv[k]) for k in magic]} int -> f32 conversions; "
          f"{len(plain_q16)} exact q16 pass-1 kernels with "
          f"{[len(conv[k]) for k in plain_q16]} ({', '.join(ops_)})")
    _check(magic and all(not conv[k] for k in magic),
           "the magic walk's SASS converts an integer to f32")
    _check(plain_q16 and all(len(conv[k]) >= 8 for k in plain_q16),
           "the exact q16 walk's SASS shows no int -> f32 conversion")

    def entry(name, q, s, p, real):
        kernel = getattr(probe, f"gemv_q16_symm_{name}")
        plain = getattr(probe, f"gemv_q16_symm_{name}_plain")

        def call():
            return kernel(q, s, p)

        def call_plain():
            return plain(q, s, p)

        y = call()
        y_plain = call_plain()
        torch.cuda.synchronize()
        err = _rel(y, y_plain)
        line = (f"gemv_q16_symm_{name} N={p.shape[0]} tb={q.shape[1]}: rel l2 "
                f"kernel-plain {err:.3e} (<= {PROBE_TOL[name]:g})")
        if name == "magic":
            line += f", == kernel 14 bitwise: {torch.equal(y, exact)}"
            _check(torch.equal(y, exact), "the magic walk != kernel 14")
        if name in ("hi", "hybrid", "split"):
            line += (", bf16 engine-plain "
                     f"{_rel(gemv.gemv_q16_symm_bf16(q, s, p), y_plain):.3e}")
        print(line)
        _check(err <= PROBE_TOL[name], f"{kernel.__name__} disagrees")
        _check(torch.equal(y, call()), f"{kernel.__name__} not repeatable")
        if q is q1:
            _check(int(torch.count_nonzero(y[N:])) == 0,
                   f"{kernel.__name__} padding rows != 0")
        m = p.shape[0]
        flops, kind = ((2 * m * m * MMA_PRODUCTS[name], "bf16")
                       if name in MMA_PRODUCTS else (2 * m * m, "f32"))
        return _timed_entry(
            kernel.__name__, PROBE_REPLACES[kernel.__name__], PROBE_SOURCE,
            float((y - y_plain).abs().max()), (call, call_plain, None),
            (real, s[:real.shape[0] // q.shape[1]], p, y), flops, kind)

    for name in ("magic", "sub8", "split", "hi", "hybrid"):
        out.append(entry(name, q1, s1, ph, plane))

    nblk_k = n // 1024
    T_k = layout.tri_tile_count(nblk_k)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    qk = torch.randint(-32767, 32768, (T_k * 1024, 1024), generator=gen,
                       device="cuda", dtype=torch.int16)
    sk = 2.0 ** -torch.randint(8, 20, (T_k,), generator=gen, device="cuda"
                               ).float()
    pk = torch.randn(n, generator=gen, device="cuda")
    out.append(entry("tb1024", qk, sk, pk, qk))
    del qk, sk, pk

    tri = probe.tridiag_q1(n, tb, device="cuda")[0]
    closed = 16384 * (nblk * 2 * (tb - 1) + nblk - 1)
    total = int(probe.stream_i16(plane))
    conv_sum = float(probe.convert_f32_sum(plane))
    vecs = -(-plane.numel() // 8 // probe.convert_threads(plane.device))
    bound = 8 * vecs * 2.0 ** -24 * float(plane.double().abs().sum())
    conv_err = abs(conv_sum - float(probe.convert_f32_sum_plain(plane)))
    print(f"streams on kernel 14's plane: stream_i16 == plain: "
          f"{total == int(probe.stream_i16_plain(plane))}; convert_f32_sum "
          f"- f64 sum {conv_err:.3e} (<= {bound:.3e}); on the tridiagonal "
          f"plane both == {closed}: {int(probe.stream_i16(tri)) == closed}, "
          f"{float(probe.convert_f32_sum(tri)) == closed}")
    _check(total == int(probe.stream_i16_plain(plane)),
           "stream_i16's checksum is wrong")
    _check(conv_err <= bound, "convert_f32_sum is off its rounding bound")
    _check(int(probe.stream_i16(tri)) == closed
           and float(probe.convert_f32_sum(tri)) == closed,
           "the streams miss the tridiagonal plane's closed form")
    _check(conv_sum == float(probe.convert_f32_sum(plane)),
           "convert_f32_sum not repeatable")
    del tri
    for fn, plain, library, source, err in (
            (probe.stream_i16, probe.stream_i16_plain,
             lambda: torch.sum(plane, dtype=torch.int64), STREAM_SOURCE, 0.0),
            (probe.convert_f32_sum, probe.convert_f32_sum_plain,
             lambda: torch.sum(plane, dtype=torch.float64), STREAM_SOURCE,
             conv_err)):
        result = fn(plane)
        out.append(_timed_entry(
            fn.__name__, PROBE_REPLACES[fn.__name__], source, err,
            (lambda fn=fn: fn(plane), lambda plain=plain: plain(plane),
             library), (plane, result), plane.numel(), "f32"))
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


@contextlib.contextmanager
def _engine(gemv, impl):
    """The q16 product engine forced to `impl` (the module attribute that
    lam_tpu_torch/ops/gemv.py reads at every call)."""
    old = gemv._Q16_IMPL
    gemv._Q16_IMPL = impl
    try:
        yield
    finally:
        gemv._Q16_IMPL = old


def _launched(*names):
    """{name: launches} of the kernels named, from the counter registry."""
    from lam_tpu_torch import ops
    counts = ops.counters()
    return {name: counts[name] for name in names}


def _small_q16(shape, real_rows, real_tiles, gen):
    """Small-integer int16 tiles (-3..3) in the first real_rows rows (zeros
    after), scales 0.5/0.25 on the first real_tiles entries (zeros after):
    bf16 holds every value, so products and sums are exact."""
    q = torch.zeros(shape, dtype=torch.int16, device="cuda")
    q[:real_rows] = torch.randint(-3, 4, (real_rows, shape[1]), generator=gen,
                                  device="cuda", dtype=torch.int16)
    sc = torch.zeros(shape[0] // shape[1], device="cuda")
    sc[:real_tiles] = torch.where(
        torch.arange(real_tiles, device="cuda") % 2 == 1, 0.25, 0.5)
    return q, sc


def _small_vec(n, gen):
    return torch.randint(-3, 4, (n,), generator=gen, device="cuda").float()


def _floor_line(label, planes, kernels, nbytes):
    """The card's measured read floor of a q16 plane: lam_stream_i16 over
    `planes` (copies taken in turn where one plane would stay in the 50 MB
    L2), timed in turns with its plain version, one PyTorch call that
    computes the same checksum (torch.sum with an int64 accumulator) and
    the kernels {name: fn} that read the plane, its checksum held against
    the plain sum; printed beside the data-sheet bound of the kernel's
    `nbytes` (each input read once, each output written once)."""
    from lam_tpu_torch.ops import probe
    for q in planes:
        _check(int(probe.stream_i16(q)) == int(probe.stream_i16_plain(q)),
               f"lam_stream_i16's checksum is wrong on {label}")
    names = ["lam_stream_i16", "plain", "torch.sum"] + list(kernels)
    fns = [_rotating(fn, planes) for fn in (
        probe.stream_i16, probe.stream_i16_plain,
        lambda q: torch.sum(q, dtype=torch.int64))]
    times = _median_ms(fns + [kernels[k] for k in names[3:]])
    plane = _nbytes(planes[0])
    parts = ", ".join(
        f"{k} {t:.4f} ms ({(plane if i < 3 else nbytes) / t / 1e6:.0f} "
        "GB/s)" for i, (k, t) in enumerate(zip(names, times)))
    print(f"read floor, {label} ({plane / 1e6:.1f} MB; the kernel's "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s: "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms): {parts}")
    return times


def bf16_symm_vs_plain(gemv, layout, q1, s1, ph):
    """Phase 2, kernel 14's bf16 engine at N=10240 on the port's fq pack,
    the engine forced: gemv_q16_symm routes to gemv_q16_symm_bf16, which
    agrees with its plain version to 1e-5 (the same bf16 operands and
    exact products, f32 sums in another order), repeats bitwise, keeps the
    padding rows 0 and stands visibly apart from the exact kernel (above
    1e-5, within 1e-2); on small-integer tiles, scales 0.5/0.25 and
    operands -3..3 it equals the f64 oracle bit for bit."""
    from lam_tpu_torch import ops
    tb = layout.SYMM_TB
    nblk = ph.shape[0] // tb
    T = layout.tri_tile_count(nblk)
    ops.reset_counters()
    with _engine(gemv, "mxu"):
        y = gemv.gemv_q16_symm(q1, s1, ph)
    torch.cuda.synchronize()
    _check(_launched("gemv_q16_symm_bf16", "gemv_q16_symm")
           == {"gemv_q16_symm_bf16": 1, "gemv_q16_symm": 0},
           "mxu did not route gemv_q16_symm to its bf16 kernel")
    y_plain = gemv.gemv_q16_symm_bf16_plain(q1, s1, ph)
    err, gap = _rel(y, y_plain), _rel(y, gemv.gemv_q16_symm(q1, s1, ph))
    _check(torch.equal(y, gemv.gemv_q16_symm_bf16(q1, s1, ph)),
           "gemv_q16_symm_bf16 not repeatable")
    _check(int(torch.count_nonzero(y[N:])) == 0, "bf16 padding rows != 0")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    qs, ss = _small_q16(tuple(q1.shape), T * tb, T, gen)
    ps = _small_vec(nblk * tb, gen)
    ys = gemv.gemv_q16_symm_bf16(qs, ss, ps)
    tiles = qs[:T * tb].double().reshape(T, tb, tb) * ss[:T].double()[
        :, None, None]
    exact = torch.equal(ys.double(), torch.mv(_dense_of(tiles, nblk, layout),
                                              ps.double()))
    del tiles
    print(f"gemv_q16_symm_bf16 N={nblk * tb}: rel l2 kernel-plain {err:.3e} "
          f"(<= 1e-5), kernel-exact kernel {gap:.3e} (in (1e-5, 1e-2]), "
          f"small-integer data == f64 oracle: {exact}")
    _check(err <= 1e-5, "gemv_q16_symm_bf16 disagrees with its plain version")
    _check(1e-5 < gap <= 1e-2, "gemv_q16_symm_bf16 is not in the bf16 class")
    _check(exact, "gemv_q16_symm_bf16 != the f64 oracle on exact data")


def bf16_symm_large(gemv, layout):
    """Phase 2, kernel 14 at N=20480 (bench.py's N=20000 padded: 40 row
    tiles, 820 of 824 stored tiles, a 432 MB q1 plane from HBM), where
    'auto' picks the bf16 engine: random int16 tiles within +-30000 against
    2^-15 and a Gaussian p. gemv_q16_symm routes to gemv_q16_symm_bf16,
    which agrees with its plain version to 1e-5; the exact and the bf16
    bodies and the read floor are timed in turns. Returns the bf16
    kernel's `kernels` entry."""
    from lam_tpu_torch import ops
    tb = layout.SYMM_TB
    n = layout.padded_size(N_LARGE, tb)
    nblk = n // tb
    T, Ts = layout.tri_tile_count(nblk), layout.padded_tri_tile_count(nblk)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    q1 = torch.zeros(Ts * tb, tb, dtype=torch.int16, device="cuda")
    q1[:T * tb] = torch.randint(-30000, 30001, (T * tb, tb), generator=gen,
                                device="cuda", dtype=torch.int16)
    s1 = torch.zeros(Ts, device="cuda")
    s1[:T] = 2.0 ** -15
    p = torch.randn(n, generator=gen, device="cuda")
    ops.reset_counters()
    y = gemv.gemv_q16_symm(q1, s1, p)
    torch.cuda.synchronize()
    _check(_launched("gemv_q16_symm_bf16", "gemv_q16_symm")
           == {"gemv_q16_symm_bf16": 1, "gemv_q16_symm": 0},
           f"'auto' did not pick the bf16 kernel at n={n}")
    y_plain = gemv.gemv_q16_symm_bf16_plain(q1, s1, p)
    with _engine(gemv, "vpu"):
        gap = _rel(y, gemv.gemv_q16_symm(q1, s1, p))
    err = _rel(y, y_plain)
    print(f"gemv_q16_symm_bf16 N={n} ({T} tiles): rel l2 kernel-plain "
          f"{err:.3e} (<= 1e-5), kernel-exact kernel {gap:.3e}")
    _check(err <= 1e-5, f"gemv_q16_symm_bf16 disagrees at n={n}")
    _check(1e-5 < gap <= 1e-2, f"gemv_q16_symm_bf16 at n={n} is not in the "
           "bf16 class")
    _check(torch.equal(y, gemv.gemv_q16_symm_bf16(q1, s1, p)),
           f"gemv_q16_symm_bf16 not repeatable at n={n}")

    def exact():
        with _engine(gemv, "vpu"):
            return gemv.gemv_q16_symm(q1, s1, p)

    nbytes = _nbytes(q1[:T * tb], s1[:T], p, y)
    _floor_line(f"kernel 14's q1 plane at N={n}", [q1[:T * tb]],
                {"gemv_q16_symm (exact)": exact,
                 "gemv_q16_symm_bf16": lambda: gemv.gemv_q16_symm_bf16(
                     q1, s1, p)}, nbytes)
    return _timed_entry(
        "gemv_q16_symm_bf16", BF16_REPLACES["gemv_q16_symm_bf16"],
        SYMM_SOURCE, float((y - y_plain).abs().max()),
        (lambda: gemv.gemv_q16_symm_bf16(q1, s1, p),
         lambda: gemv.gemv_q16_symm_bf16_plain(q1, s1, p), None),
        (q1[:T * tb], s1[:T], p, y), 2 * n * n, "bf16")


def bf16_slab_large(gemv, layout, pcg_symm):
    """Phase 2, kernel 16's bf16 engine where phase 6 runs it: rank 0 of
    the G=2 band pairs at n=20480 (mt=10 tile-rows a band, T=410 tiles, a
    215 MB q1 plane from HBM), random int16 tiles within +-30000 against
    2^-15 and a Gaussian p; 'auto' routes there; against its plain version
    (1e-5) and apart from the exact walk; the exact and bf16 walks and the
    read floor timed in turns. Returns the bf16 walk's `kernels` entry."""
    from lam_tpu_torch import ops
    tb, g = layout.SYMM_TB, SHARD_G[0]
    n = layout.padded_size(N_LARGE, 2 * g * tb)
    mt = n // tb // (2 * g)
    it, kt, lt = (torch.from_numpy(np.asarray(x[0], np.int32)).cuda()
                  for x in pcg_symm._band_tables(g, mt, tb))
    T, ms = it.shape[0], 2 * mt * tb
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    q1 = torch.randint(-30000, 30001, (T * tb, tb), generator=gen,
                       device="cuda", dtype=torch.int16)
    sc = torch.full((T,), 2.0 ** -15, device="cuda")
    p = torch.randn(n, generator=gen, device="cuda")
    ops.reset_counters()
    yd, yt = gemv.gemv_q16_symm_slab(q1, sc, p, it, kt, lt, ms=ms)
    torch.cuda.synchronize()
    _check(_launched("gemv_q16_symm_slab_bf16", "gemv_q16_symm_slab")
           == {"gemv_q16_symm_slab_bf16": 1, "gemv_q16_symm_slab": 0},
           f"'auto' did not pick the bf16 slab walk at n={n}")
    y = torch.cat([yd, yt])
    q = torch.cat(gemv.gemv_q16_symm_slab_bf16_plain(q1, sc, p, it, kt, lt,
                                                      ms=ms))
    with _engine(gemv, "vpu"):
        gap = _rel(y, torch.cat(gemv.gemv_q16_symm_slab(q1, sc, p, it, kt,
                                                         lt, ms=ms)))
    err = _rel(y, q)
    print(f"gemv_q16_symm_slab_bf16 G={g} n={n} rank 0 ({T} tiles): rel l2 "
          f"kernel-plain {err:.3e} (<= 1e-5), kernel-exact walk {gap:.3e}")
    _check(err <= 1e-5, f"gemv_q16_symm_slab_bf16 disagrees at n={n}")
    _check(1e-5 < gap <= 1e-2, "gemv_q16_symm_slab_bf16 is not in the bf16 "
           "class")

    def exact():
        with _engine(gemv, "vpu"):
            return gemv.gemv_q16_symm_slab(q1, sc, p, it, kt, lt, ms=ms)

    nbytes = _nbytes(q1, sc, p, it, kt, lt, yd, yt)
    flops = 2 * tb * tb * (T + int((kt < it).sum()))
    _floor_line(f"kernel 16's q1 plane at rank 0 of G={g}, n={n}", [q1],
                {"gemv_q16_symm_slab (exact)": exact,
                 "gemv_q16_symm_slab_bf16":
                 lambda: gemv.gemv_q16_symm_slab_bf16(q1, sc, p, it, kt, lt,
                                                      ms=ms)}, nbytes)
    return _timed_entry(
        "gemv_q16_symm_slab_bf16", BF16_REPLACES["gemv_q16_symm_slab_bf16"],
        SYMM_SOURCE, float((y - q).abs().max()),
        (lambda: gemv.gemv_q16_symm_slab_bf16(q1, sc, p, it, kt, lt, ms=ms),
         lambda: gemv.gemv_q16_symm_slab_bf16_plain(q1, sc, p, it, kt, lt,
                                                    ms=ms), None),
        (q1, sc, p, it, kt, lt, yd, yt), flops, "bf16")


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
            _check(torch.equal(y, gemv.gemv_f32(hi[:, cols].contiguous(),
                                                ph[cols])),
                   "gemv_f32_cols (dense_stream) != the dense_rows walk")
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
    block = hi[:, cols].contiguous()
    _against_library("gemv_f32_cols",
                     lambda: gemv.gemv_f32_cols(hi, p_blk, 1),
                     lambda: torch.mv(hi[:, cols], p_blk),
                     lambda: gemv.gemv_f32(block, p_blk),
                     "dense_rows (gemv_f32 on a contiguous copy)")
    del block
    cols_g4(gemv, pcg, Mesh, a, p)
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


def cols_g4(gemv, pcg, Mesh, a, p):
    """Kernel 5 at rank 0's column block 1 of the G=4 row shards (the
    ring-ir-4 step): against its plain version, then timed beside torch.mv
    on the strided view and dense_rows on a contiguous copy; printed
    only."""
    g = SHARD_G[1]
    op = pcg.ShardedDenseOperator.from_row_block_fn(
        lambda s, k: a[s:s + k], N, mesh=Mesh(0, g, "cuda"),
        precision="df64")
    hi, m = op.operand[0], op.m
    cols = slice(m, 2 * m)
    p_blk = _pair(p, op.n_padded)[0][cols].clone()
    y = gemv.gemv_f32_cols(hi, p_blk, 1)
    err = _rel(y, gemv.gemv_f32_cols_plain(hi, p_blk, 1))
    print(f"gemv_f32_cols G={g}: ({m}, {m}) block of ({m}, {op.n_padded}), "
          f"rel l2 kernel-plain {err:.3e} (<= 1e-5)")
    _check(err <= 1e-5, "gemv_f32_cols disagrees at G=4")
    block = hi[:, cols].contiguous()
    ms, lib_ms, old_ms = _median_ms([
        lambda: gemv.gemv_f32_cols(hi, p_blk, 1),
        lambda: torch.mv(hi[:, cols], p_blk),
        lambda: gemv.gemv_f32(block, p_blk)])
    gb = _nbytes(hi[:, cols], p_blk, y) / 1e9
    print(f"gemv_f32_cols G={g} [{gb * 1e3:.1f} MB]: kernel {ms:.4f} ms "
          f"({gb / ms * 1e3:.0f} GB/s), library {lib_ms:.4f} ms, "
          f"kernel/library {ms / lib_ms:.4f}; dense_rows (contiguous copy) "
          f"{old_ms:.4f} ms; bound {gb / HBM_BYTES_PER_S * 1e12:.4f} ms")


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


def one_device_matvecs(gemv, layout, pack_planes, pack_tri, a, p):
    """The one-device kernels' matvecs of the shard checks' matrix, which
    every sharded layout's parts must add up to: {storage: (the f32 view's
    y, the accurate y in f64)} over the 10240-padded triangle: 'df64'
    gemv_f32_symm and gemv_df64_symm, 'fq' gemv_q16_symm and gemv_fq_symm,
    'dfq' gemv_f32_symm on the dfq hi plane and gemv_dfq_symm, the
    quantized ones with their diagonal terms; 'fq-bf16', the f32 view of
    fq through gemv_q16_symm_bf16; and 'fq-grid-mxu', the engines the 2 x 2
    symmetric grid runs under 'mxu' (lam_tpu's routing: a diagonal rank's
    exact-count triangle takes the exact body, the off-diagonal rectangles
    the bf16 one), as one-device matvecs of the plane with the other
    blocks' tiles zeroed: gemv_q16_symm over the diagonal blocks plus
    gemv_q16_symm_bf16 over the off-diagonal ones."""
    from lam_tpu_torch.parallel.pcg2d_symm import sym2d_padded_size
    tb = layout.SYMM_TB
    n_p = layout.padded_size(N, tb)
    _check(sym2d_padded_size(N, 2, tb) == n_p,
           "the 2 x 2 grid's blocks do not align with the one-device tiles")
    ph, pl, p64 = _pair(p, n_p)
    hi, lo = (torch.from_numpy(x).cuda() for x in pack_planes(a, "df64", tb))
    yh, yl = gemv.gemv_df64_symm(hi, lo, ph, pl)
    one = {"df64": (gemv.gemv_f32_symm(hi, ph), yh.double() + yl.double())}
    del hi, lo
    for storage in ("fq", "dfq"):
        bufs = [torch.from_numpy(x).cuda() for x in pack_tri(a, storage, tb)]
        dh, dl = bufs[-2], bufs[-1]
        if storage == "fq":
            y32 = gemv.gemv_q16_symm(bufs[0], bufs[3], ph)
            yh, yl = gemv.gemv_fq_symm(*bufs[:6], ph, pl)
            one["fq-bf16"] = gemv.gemv_q16_symm_bf16(bufs[0], bufs[3],
                                                     ph) + dh * ph
            nblk, half = n_p // tb, n_p // 2 // tb
            it, kt = (torch.from_numpy(np.asarray(x)).cuda()
                      for x in layout._symm_tables(nblk))
            diag = torch.zeros(bufs[0].shape[0] // tb, dtype=torch.bool,
                               device="cuda")
            diag[:it.shape[0]] = it // half == kt // half
            tiles = bufs[0].view(-1, tb, tb)
            q_diag = (tiles * diag[:, None, None]).view(bufs[0].shape)
            q_off = (tiles * ~diag[:, None, None]).view(bufs[0].shape)
            with _engine(gemv, "vpu"):
                y_diag = gemv.gemv_q16_symm(q_diag, bufs[3], ph)
            one["fq-grid-mxu"] = (y_diag + gemv.gemv_q16_symm_bf16(
                q_off, bufs[3], ph) + dh * ph)
            del q_diag, q_off
        else:
            y32 = gemv.gemv_f32_symm(bufs[0], ph)
            yh, yl = gemv.gemv_dfq_symm(*bufs[:3], ph, pl)
        one[storage] = (y32 + dh * ph, yh.double() + yl.double()
                        + (dh.double() + dl.double()) * p64)
        del bufs
    torch.cuda.empty_cache()
    return one


def slab_kernels_vs_plain(gemv, layout, pcg_symm, Mesh, one, a, p):
    """Phase 2, the band-pair walk kernels at the shards of G=2 (tb=512,
    mt=5, T=105 tiles a rank, ms=5120, n=10240) and G=4 (n=12288, T=75),
    slab and packed, every rank's tables; `one` is the one-device df64
    entry of `one_device_matvecs`."""
    tb = layout.SYMM_TB
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


def _quant_walks(gemv, op, ph, pl, plain=False):
    """The two walks of a quantized band-pair operand: the inner f32 walk
    (q16 on the fq storage's q1 plane; the f32 walk of the dfq hi plane)
    and the accurate one (fq or dfq), kernels or their plain versions:
    ((yd, yt) f32, (yd, yt) f64)."""
    sfx = "_plain" if plain else ""
    it, kt, lt = op.operand[-3:]
    ms = 2 * op.m
    if op.storage == "fq":
        inner = getattr(gemv, "gemv_q16_symm_slab" + sfx)(
            op.operand[0], op.operand[3], ph, it, kt, lt, ms=ms)
        acc = getattr(gemv, "gemv_fq_symm_slab" + sfx)(
            *op.operand[:6], ph, pl, it, kt, lt, ms=ms)
    else:
        inner = getattr(gemv, "gemv_f32_symm_slab" + sfx)(
            op.operand[0], ph, it, kt, lt, ms=ms, packed=True)
        acc = getattr(gemv, "gemv_dfq_symm_slab" + sfx)(
            *op.operand[:3], ph, pl, it, kt, lt, ms=ms)
    return inner, (acc[0].double() + acc[1].double(),
                   acc[2].double() + acc[3].double())


def _stored_tiles(op):
    """(inner plane's stored values, the storage's stored values) of a
    quantized band-pair operand as f64 (T*tb, tb) buffers."""
    tb = op.tb
    if op.storage == "fq":
        terms = [q.double() * s.double().repeat_interleave(tb)[:, None]
                 for q, s in zip(op.operand[:3], op.operand[3:6])]
        return terms[0], terms[0] + terms[1] + terms[2]
    hi, loq, sc = op.operand[:3]
    return hi.double(), (hi.double() + loq.double()
                         * sc.double().repeat_interleave(tb)[:, None])


def _quant_case(gemv, pcg_symm, ops_, ph, pl, p64, one):
    """The quantized slab kernels over every rank's walk of one band-pair
    geometry against their plain versions and the f64 oracle of the stored
    values, and the ranks' parts plus the owners' diagonal terms summed
    against the one-device kernels' matvecs `one` (inner f32 y, f64 y) of
    the same storage. Returns the largest kernel-plain differences (inner,
    accurate)."""
    g, m, tb, storage = (ops_[0].mesh.size, ops_[0].m, ops_[0].tb,
                         ops_[0].storage)
    inner_name = "gemv_q16_symm_slab" if storage == "fq" else \
        "gemv_f32_symm_slab (dfq hi plane)"
    label = f"G={g} {storage}"
    sum32 = torch.zeros_like(ph)
    sum64 = torch.zeros_like(p64)
    errs32, errs64, diff32, diff64 = [], [], 0.0, 0.0
    for c, op in enumerate(ops_):
        it, kt, lt = op.operand[-3:]
        dh, dl = op.operand[-5], op.operand[-4]
        (yd, yt), (ad, at) = _quant_walks(gemv, op, ph, pl)
        (qd, qt), (bd, bt) = _quant_walks(gemv, op, ph, pl, plain=True)
        (zd, zt), (cd, ct) = _quant_walks(gemv, op, ph, pl)
        _check(torch.equal(yd, zd) and torch.equal(yt, zt)
               and torch.equal(ad, cd) and torch.equal(at, ct),
               f"{label}: a quantized slab kernel is not repeatable")
        inner_t, acc_t = _stored_tiles(op)
        od, ot = gemv._slab_parts(inner_t, ph.double(), it, kt, lt, 2 * m,
                                  tb, True)
        del inner_t
        y, q = torch.cat([yd, yt]), torch.cat([qd, qt])
        errs32 += [_rel(y, q), _rel(y.double(), torch.cat([od, ot]))]
        diff32 = max(diff32, float((y - q).abs().max()))
        od, ot = gemv._slab_parts(acc_t, p64, it, kt, lt, 2 * m, tb, True)
        del acc_t
        y, q = torch.cat([ad, at]), torch.cat([bd, bt])
        errs64 += [_rel(y, q), _rel(y, torch.cat([od, ot]))]
        diff64 = max(diff64, float((y - q).abs().max()))
        # the owner's diagonal terms, as the operator adds them
        own32 = pcg_symm._own_rows(ph, c, g, m)
        own64 = pcg_symm._own_rows(p64, c, g, m)
        sum32 += pcg_symm._scatter_bands(yd + dh * own32, yt, c, g, m)
        sum64 += pcg_symm._scatter_bands(
            ad + (dh.double() + dl.double()) * own64, at, c, g, m)
    n1 = one[0].shape[0]
    e32, e64 = _rel(sum32[:n1], one[0]), _rel(sum64[:n1], one[1])
    print(f"quantized slab walk {label} (tb={tb}, ms={2 * m}, "
          f"n={ph.shape[0]}, T={ops_[0].operand[-1].shape[0]} tiles a rank): "
          f"rel l2 kernel-plain / kernel-f64 max {inner_name} "
          f"{max(errs32):.3e} (<= 1e-5), gemv_{storage}_symm_slab "
          f"{max(errs64):.3e} (<= 1e-13); ranks' parts + diagonal terms "
          f"summed vs the one-device kernels: inner {e32:.3e} (<= 1e-5), "
          f"gemv_{storage}_symm {e64:.3e} (<= 1e-13)")
    _check(max(errs32) <= 1e-5, f"{inner_name} {label} disagrees")
    _check(max(errs64) <= 1e-13, f"gemv_{storage}_symm_slab {label} "
           "disagrees")
    _check(e32 <= 1e-5 and e64 <= 1e-13,
           f"{label}: the ranks' parts do not add up to the matvec")
    _check(int(torch.count_nonzero(sum32[N:])) == 0
           and int(torch.count_nonzero(sum64[N:])) == 0,
           f"{label}: padding rows != 0")
    return diff32, diff64


def _bf16_slab_case(gemv, pcg_symm, ops_, ph, one_bf16):
    """Kernel 16's bf16 engine over every rank's walk, tables and scales of
    one band-pair geometry of the fq storage, the engine forced: routed to
    gemv_q16_symm_slab_bf16, against its plain version (1e-5), bitwise
    repeats; on small-integer tiles, scales 0.5/0.25 and operands -3..3 at
    the rank's own tables, bitwise equal to the f64 oracle; the ranks'
    parts plus the owners' diagonal terms against the one-device bf16
    kernel's matvec (1e-5: the same bf16 operands, f32 sums in another
    order)."""
    from lam_tpu_torch import ops
    g, m, tb = ops_[0].mesh.size, ops_[0].m, ops_[0].tb
    ms = 2 * m
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29 + g)
    total = torch.zeros_like(ph)
    errs, exact = [], True
    for c, op in enumerate(ops_):
        q1, s1 = op.operand[0], op.operand[3]
        it, kt, lt = op.operand[-3:]
        ops.reset_counters()
        with _engine(gemv, "mxu"):
            yd, yt = gemv.gemv_q16_symm_slab(q1, s1, ph, it, kt, lt, ms=ms)
        torch.cuda.synchronize()
        _check(_launched("gemv_q16_symm_slab_bf16", "gemv_q16_symm_slab")
               == {"gemv_q16_symm_slab_bf16": 1, "gemv_q16_symm_slab": 0},
               f"G={g} rank {c}: mxu did not route to the bf16 slab walk")
        qd, qt = gemv.gemv_q16_symm_slab_bf16_plain(q1, s1, ph, it, kt, lt,
                                                    ms=ms)
        errs.append(_rel(torch.cat([yd, yt]), torch.cat([qd, qt])))
        zd, zt = gemv.gemv_q16_symm_slab_bf16(q1, s1, ph, it, kt, lt, ms=ms)
        _check(torch.equal(yd, zd) and torch.equal(yt, zt),
               f"gemv_q16_symm_slab_bf16 G={g} rank {c} not repeatable")
        dh = op.operand[-5]
        total += pcg_symm._scatter_bands(
            yd + dh * pcg_symm._own_rows(ph, c, g, m), yt, c, g, m)
        T = it.shape[0]
        qs, ss = _small_q16(tuple(q1.shape), T * tb, T, gen)
        ps = _small_vec(ph.shape[0], gen)
        sd, st = gemv.gemv_q16_symm_slab_bf16(qs, ss, ps, it, kt, lt, ms=ms)
        od, ot = gemv._slab_parts(
            qs.double() * ss.double().repeat_interleave(tb)[:, None],
            ps.double(), it, kt, lt, ms, tb, True)
        exact = exact and torch.equal(sd.double(), od) and torch.equal(
            st.double(), ot)
    n1 = one_bf16.shape[0]
    e_sum = _rel(total[:n1], one_bf16)
    print(f"gemv_q16_symm_slab_bf16 G={g} (n={ph.shape[0]}, every rank): rel "
          f"l2 kernel-plain max {max(errs):.3e} (<= 1e-5); small-integer data "
          f"== f64 oracle: {exact}; ranks' parts + diagonal terms vs "
          f"gemv_q16_symm_bf16 {e_sum:.3e} (<= 1e-5)")
    _check(max(errs) <= 1e-5, f"gemv_q16_symm_slab_bf16 G={g} disagrees")
    _check(exact, f"gemv_q16_symm_slab_bf16 G={g} != the f64 oracle on exact "
           "data")
    _check(e_sum <= 1e-5, f"G={g}: the bf16 slab parts do not add up to the "
           "one-device bf16 matvec")
    _check(int(torch.count_nonzero(total[N:])) == 0,
           f"G={g}: bf16 padding rows != 0")


def _rotating(fn, copies):
    """fn(copy) over `copies` taken in turn, one per call: a plane that
    fits the 50 MB L2 is read from HBM again when two other copies went
    through the cache since its last read."""
    state = [0]

    def call():
        state[0] = (state[0] + 1) % len(copies)
        return fn(copies[state[0]])

    return call


def quant_slab_kernels_vs_plain(gemv, layout, pcg_symm, Mesh, one, a, p):
    """Phase 2, the band-pair walks of the quantized storages
    (gemv_q16_symm_slab, gemv_fq_symm_slab, gemv_dfq_symm_slab) at the
    shards of G=2 (tb=512, T=105 tiles a rank, ms=5120, n=10240) and G=4
    (n=12288, T=75), every rank's tables and scales, built by the port's
    own operator without a process group; the ranks' parts plus the
    owners' diagonal terms against the one-device kernels gemv_q16_symm,
    gemv_fq_symm and gemv_dfq_symm on the same matrix (`one`, from
    `one_device_matvecs`). Timed at rank 0 of
    G=2 (the `kernels` entries) and of G=4 (printed); the q16 walk over
    three copies of its plane taken in turn, so its GB/s is an HBM figure
    (one 55.1 or 39.3 MB plane would stay in the 50 MB L2)."""
    tb = layout.SYMM_TB
    diffs = {}
    timed = {}
    for g in SHARD_G:
        for storage in ("fq", "dfq"):
            t0 = time.perf_counter()
            ops_ = [pcg_symm.SymmShardedOperator.from_row_block_fn(
                lambda s, k: a[s:s + k], N, mesh=Mesh(c, g, "cuda"),
                precision=storage) for c in range(g)]
            pack_s = time.perf_counter() - t0
            ph, pl, p64 = _pair(p, ops_[0].n_padded)
            d = _quant_case(gemv, pcg_symm, ops_, ph, pl, p64, one[storage])
            if storage == "fq":
                _bf16_slab_case(gemv, pcg_symm, ops_, ph, one["fq-bf16"])
            print(f"  ({g} rank packs of {storage} in {pack_s:.2f} s)")
            old = diffs.get(storage, (0.0, 0.0))
            diffs[storage] = (max(old[0], d[0]), max(old[1], d[1]))
            timed[g, storage] = (ops_[0], ph, pl, p64)
            del ops_
            torch.cuda.empty_cache()
    out = []
    for g in SHARD_G:
        fq, ph, pl, p64 = timed[g, "fq"]
        dfq = timed[g, "dfq"][0]
        # for scale only: torch.mv over the rank's (2m, n) slab of full rows
        slab = pcg_symm.SymmShardedOperator.from_row_block_fn(
            lambda s, k: a[s:s + k], N, mesh=Mesh(0, g, "cuda"))
        sh = slab.operand[0]
        s64 = sh.double() + slab.operand[1].double()
        del slab
        it, kt, lt = fq.operand[-3:]
        ms, T = 2 * fq.m, it.shape[0]
        flops = 2 * tb * tb * (T + int((kt < it).sum()))
        q1, s1 = fq.operand[0], fq.operand[3]
        copies = [q1, q1.clone(), q1.clone()]
        yd, yt = gemv.gemv_q16_symm_slab(q1, s1, ph, it, kt, lt, ms=ms)
        entries = [_timed_entry(
            "gemv_q16_symm_slab" if g == SHARD_G[0] else f"q16 slab G={g}",
            "lam_tpu/ops/gemv.py:2310", SYMM_SOURCE, diffs["fq"][0],
            (_rotating(lambda q: gemv.gemv_q16_symm_slab(
                q, s1, ph, it, kt, lt, ms=ms), copies),
             _rotating(lambda q: gemv.gemv_q16_symm_slab_plain(
                 q, s1, ph, it, kt, lt, ms=ms), copies),
             lambda: torch.mv(sh, ph)), (q1, s1, ph, it, kt, lt, yd, yt),
            flops, "f32")]
        if g == SHARD_G[0]:
            _floor_line(
                f"kernel 16's q1 plane at rank 0 of G={g}, n={ph.shape[0]}, "
                "three copies in turn", copies,
                {"gemv_q16_symm_slab": _rotating(
                    lambda q: gemv.gemv_q16_symm_slab(q, s1, ph, it, kt, lt,
                                                      ms=ms), copies),
                 "gemv_q16_symm_slab_bf16": _rotating(
                     lambda q: gemv.gemv_q16_symm_slab_bf16(
                         q, s1, ph, it, kt, lt, ms=ms), copies)},
                _nbytes(q1, s1, ph, it, kt, lt, yd, yt))
        del copies
        outs = gemv.gemv_fq_symm_slab(*fq.operand[:6], ph, pl, it, kt, lt,
                                      ms=ms)
        entries.append(_timed_entry(
            "gemv_fq_symm_slab" if g == SHARD_G[0] else f"fq slab G={g}",
            "lam_tpu/ops/gemv.py:2405", SYMM_SOURCE, diffs["fq"][1],
            (lambda: gemv.gemv_fq_symm_slab(*fq.operand[:6], ph, pl, it, kt,
                                            lt, ms=ms),
             lambda: gemv.gemv_fq_symm_slab_plain(*fq.operand[:6], ph, pl,
                                                  it, kt, lt, ms=ms),
             lambda: torch.mv(s64, p64)),
            (*fq.operand[:6], ph, pl, it, kt, lt, *outs), flops, "f64"))
        dit, dkt, dlt = dfq.operand[-3:]
        outs = gemv.gemv_dfq_symm_slab(*dfq.operand[:3], ph, pl, dit, dkt,
                                       dlt, ms=ms)
        entries.append(_timed_entry(
            "gemv_dfq_symm_slab" if g == SHARD_G[0] else f"dfq slab G={g}",
            "lam_tpu/ops/gemv.py:1386", SYMM_SOURCE, diffs["dfq"][1],
            (lambda: gemv.gemv_dfq_symm_slab(*dfq.operand[:3], ph, pl, dit,
                                             dkt, dlt, ms=ms),
             lambda: gemv.gemv_dfq_symm_slab_plain(*dfq.operand[:3], ph, pl,
                                                   dit, dkt, dlt, ms=ms),
             lambda: torch.mv(s64, p64)),
            (*dfq.operand[:3], ph, pl, dit, dkt, dlt, *outs), flops, "f64"))
        if g == SHARD_G[0]:
            out = entries
        else:
            print(f"quantized slab kernels at rank 0 of G={g}: " + json.dumps(
                [{k: e[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                                    "library_ms")} for e in entries]))
        del sh, s64
        torch.cuda.empty_cache()
    return out


# storage -> (inner dual kernel, accurate dual kernel, the operand entries
# each reads): what lam_tpu_torch/parallel/pcg2d_symm.py runs on an
# off-diagonal rank
DUAL_KERNELS = {"df64": ("gemv_f32_dual", (0,), "gemv_df64_dual", (0, 1)),
                "dfq": ("gemv_f32_dual", (0,), "gemv_dfq_dual", (0, 1, 2)),
                "fq": ("gemv_q16_dual", (0, 3), "gemv_fq_dual",
                       (0, 1, 2, 3, 4, 5))}
DUAL_REPLACES = {"gemv_f32_dual": 1556, "gemv_df64_dual": 1682,
                 "gemv_dfq_dual": 1763, "gemv_q16_dual": 2544,
                 "gemv_fq_dual": 2624, "gemv_q16_dual_bf16": 2502}


def _stored_rect(bufs, mb, cb, tb):
    """The f64 (mb*tb, cb*tb) rectangle that the real tiles of a dual
    kernel's buffers hold: f32 planes summed, int16 planes against the
    scale tables that follow them."""
    rows, nt = mb * cb * tb, mb * cb
    planes = [x for x in bufs if x.dim() == 2]
    scales = [x for x in bufs if x.dim() == 1]
    quant = [x for x in planes if x.dtype == torch.int16]
    buf = sum(x[:rows].double() for x in planes if x.dtype != torch.int16)
    buf = buf + sum(q[:rows].double()
                    * sc[:nt].double().repeat_interleave(tb)[:, None]
                    for q, sc in zip(quant, scales))
    return buf.reshape(mb, cb, tb, tb).permute(0, 2, 1, 3).reshape(
        mb * tb, cb * tb)


def _with_garbage_pads(bufs, real_tiles, tb):
    """Copies of a dual kernel's buffers whose pad tiles and pad scales
    hold finite garbage: the kernel must not read them."""
    out = []
    for x in bufs:
        y = x.clone()
        if y.dim() == 2:
            y[real_tiles * tb:] = 7
        else:
            y[real_tiles:] = 3.0
        out.append(y)
    return out


def _cat_parts(parts):
    """(yd, yt) or (yd_hi, yd_lo, yt_hi, yt_lo) as one vector [yd, yt]."""
    if len(parts) == 2:
        return torch.cat(parts)
    return torch.cat([parts[0].double() + parts[1].double(),
                      parts[2].double() + parts[3].double()])


def dual_kernels_vs_plain(gemv, layout, pcg2d_symm, Mesh2D, one, a, p):
    """Phase 2, the five dual kernels (gemv_f32_dual, gemv_df64_dual,
    gemv_dfq_dual, gemv_q16_dual, gemv_fq_dual) at the half-slabs of the
    2 x 2 symmetric grid on the N=10000 system (n_p=10240, m=5120: a (2560,
    5120) rectangle of 5 x 10 real tiles plus 5 pad tiles a rank), every
    rank's df64, dfq and fq pack built by the port's own operator with
    Mesh2D(rank, 2, "cuda") and no process group. On both off-diagonal
    ranks, with the operands the routing gives them: kernel against plain
    and the f64 oracle of the stored values (f32, q16 1e-5; df64, dfq, fq
    1e-13), bitwise repeats, pad tiles and pad scales inert. Then the four
    ranks' (own, payload) exchanged by hand and summed against the
    one-device kernels' matvecs `one` of the same matrix, padding rows
    exactly 0. Timed at rank (1, 0); the f32 and q16 kernels over three
    copies of their plane in turn (the q1 half-slab's 26.2 MB would stay in
    the 50 MB L2, and most of the f32 one's 52.4 MB); beside the f32 and
    df64 kernels two torch.mv calls over the dense rectangle (S p and
    S^T q)."""
    tb, r = layout.SYMM_TB, 2
    diffs, timed = {}, {}
    for storage, (inner, inner_idx, acc, acc_idx) in DUAL_KERNELS.items():
        t0 = time.perf_counter()
        ops_ = [pcg2d_symm.Symm2DOperator.from_block_fn(
            lambda r0, c0, h, w: a[r0:r0 + h, c0:c0 + w], N,
            mesh=Mesh2D(k, r, "cuda"), precision=storage)
            for k in range(r * r)]
        pack_s = time.perf_counter() - t0
        n_p, m = ops_[0].n_padded, ops_[0].m
        m2, cb = m // 2, m // tb
        mb = cb // 2
        ph, pl, p64 = _pair(p, n_p)
        errs = {inner: [], acc: []}
        for k in (1, 2):  # the off-diagonal ranks (0, 1) and (1, 0)
            i, j = divmod(k, r)
            own, recv = slice(i * m, (i + 1) * m), slice(j * m, (j + 1) * m)
            # the operands the routing hands the dual kernel
            if i > j:
                pv, qv = recv, slice(i * m, i * m + m2)
            else:
                pv, qv = own, slice(j * m + m2, (j + 1) * m)
            for name, idx, vecs in (
                    (inner, inner_idx, (ph[pv], ph[qv])),
                    (acc, acc_idx, (ph[pv], pl[pv], ph[qv], pl[qv]))):
                bufs = [ops_[k].operand[x] for x in idx]
                kernel = getattr(gemv, name)
                y = _cat_parts(kernel(*bufs, *vecs))
                q = _cat_parts(getattr(gemv, name + "_plain")(*bufs, *vecs))
                stored = _stored_rect(bufs, mb, cb, tb)
                wide = name == acc
                pd, qd = ((p64[pv], p64[qv]) if wide
                          else (ph[pv].double(), ph[qv].double()))
                oracle = torch.cat([stored @ pd, stored.T @ qd])
                del stored
                errs[name] += [_rel(y, q), _rel(y.double(), oracle)]
                diffs[name] = max(diffs.get(name, 0.0),
                                  float((y - q).abs().max()))
                _check(torch.equal(y, _cat_parts(kernel(*bufs, *vecs))),
                       f"{name} rank {k} not repeatable")
                _check(torch.equal(y, _cat_parts(kernel(
                    *_with_garbage_pads(bufs, mb * cb, tb), *vecs))),
                    f"{name} rank {k} read a pad tile or a pad scale")
        # the four ranks' parts, exchanged by hand, against one device
        sums = []
        for view in (lambda op: op.as_f32(), lambda op: op):
            views = [view(op) for op in ops_]
            vec = ph if views[0].vector_dtype == torch.float32 else p64
            blk = [vec[(k // r) * m:(k // r + 1) * m] for k in range(r * r)]
            pairs = [v.mv_pair(v.operand, blk[k], blk[(k % r) * r + k // r])
                     for k, v in enumerate(views)]
            sums.append(torch.cat([
                sum(pairs[i * r + j][0] + pairs[j * r + i][1]
                    for j in range(r)) for i in range(r)]))
        n1 = one[storage][0].shape[0]
        e32 = _rel(sums[0][:n1], one[storage][0])
        e64 = _rel(sums[1][:n1], one[storage][1])
        print(f"dual kernels, 2x2 grid {storage} (tb={tb}, half-slab ({m2}, "
              f"{m}), {mb * cb} real + {mb} pad tiles a rank; 4 rank packs in "
              f"{pack_s:.2f} s): rel l2 kernel-plain / kernel-f64 max {inner} "
              f"{max(errs[inner]):.3e} (<= 1e-5), {acc} {max(errs[acc]):.3e} "
              f"(<= 1e-13); ranks' (own, payload) summed vs the one-device "
              f"kernels: inner {e32:.3e} (<= 1e-5), accurate {e64:.3e} "
              f"(<= 1e-13)")
        _check(max(errs[inner]) <= 1e-5, f"{inner} ({storage}) disagrees")
        _check(max(errs[acc]) <= 1e-13, f"{acc} disagrees")
        _check(e32 <= 1e-5 and e64 <= 1e-13,
               f"2x2 grid {storage}: the ranks' parts do not add up to the "
               "matvec")
        _check(all(int(torch.count_nonzero(y[N:])) == 0 for y in sums),
               f"2x2 grid {storage}: padding rows != 0")
        if storage == "fq":
            diffs["gemv_q16_dual_bf16"] = _bf16_dual_case(
                gemv, ops_, ph, one["fq-grid-mxu"], mb, cb, m, tb)
        timed[storage] = (ops_[2], ph, pl, p64)  # rank (1, 0)
        del ops_
        torch.cuda.empty_cache()

    # timed at rank (1, 0): p = block 0, q = the top half of block 1
    op, ph, pl, p64 = timed["df64"]
    m = op.m
    m2, cb = m // 2, m // tb
    mb = cb // 2
    real = mb * cb
    pv, qv = slice(0, m), slice(m, m + m2)
    vec32 = (ph[pv].clone(), ph[qv].clone())
    vec64 = (ph[pv].clone(), pl[pv].clone(), ph[qv].clone(), pl[qv].clone())
    hi, lo = op.operand
    dense64 = _stored_rect([hi, lo], mb, cb, tb)
    dense32 = dense64.float()
    pd, qd = p64[pv].clone(), p64[qv].clone()
    flops = 4 * m2 * m  # both products
    entries = {}

    def entry(name, bufs, vecs, library, kind, rotate=False):
        idx = [k for k, x in enumerate(bufs) if x.dim() == 2]
        kernel, plain = getattr(gemv, name), getattr(gemv, name + "_plain")
        if rotate:
            copies = [bufs, [x.clone() for x in bufs],
                      [x.clone() for x in bufs]]
            fns = (_rotating(lambda b: kernel(*b, *vecs), copies),
                   _rotating(lambda b: plain(*b, *vecs), copies), library)
        else:
            fns = (lambda: kernel(*bufs, *vecs),
                   lambda: plain(*bufs, *vecs), library)
        outs = kernel(*bufs, *vecs)
        moved = [x[:real * tb] if k in idx else x[:real]
                 for k, x in enumerate(bufs)]
        entries[name] = _timed_entry(
            name, f"lam_tpu/ops/gemv.py:{DUAL_REPLACES[name]}", SYMM_SOURCE,
            diffs[name], fns, (*moved, *vecs, *outs), flops, kind)

    entry("gemv_f32_dual", [hi], vec32,
          lambda: (torch.mv(dense32, vec32[0]), torch.mv(dense32.T, vec32[1])),
          "f32", rotate=True)
    entry("gemv_df64_dual", [hi, lo], vec64,
          lambda: (torch.mv(dense64, pd), torch.mv(dense64.T, qd)), "f64")
    del dense32, dense64
    dfq, fq = timed["dfq"][0], timed["fq"][0]
    entry("gemv_dfq_dual", list(dfq.operand[:3]), vec64, None, "f64")
    entry("gemv_q16_dual", [fq.operand[0], fq.operand[3]], vec32, None,
          "f32", rotate=True)
    entry("gemv_q16_dual_bf16", [fq.operand[0], fq.operand[3]], vec32, None,
          "bf16", rotate=True)
    q1 = fq.operand[0][:real * tb]
    copies = [q1, q1.clone(), q1.clone()]
    bufs = [fq.operand[0], fq.operand[3]]
    _floor_line(
        f"kernel 18's q1 half-slab at rank (1, 0), ({m2}, {m}), three copies "
        "in turn", copies,
        {name: _rotating(lambda q, fn=getattr(gemv, name): fn(
            q, bufs[1][:real], *vec32), copies)
         for name in ("gemv_q16_dual", "gemv_q16_dual_bf16")},
        _nbytes(q1, bufs[1][:real], *vec32, *gemv.gemv_q16_dual(*bufs,
                                                                 *vec32)))
    entry("gemv_fq_dual", list(fq.operand[:6]), vec64, None, "f64")
    return [entries[name] for name in DUAL_REPLACES]


def _bf16_dual_case(gemv, ops_, ph, one_mxu, mb, cb, m, tb):
    """Kernel 18's bf16 engine on both off-diagonal ranks of the 2 x 2
    grid, with the operands the routing gives them and the engine forced:
    routed to gemv_q16_dual_bf16, against its plain version (1e-5), bitwise
    repeats, garbage pad tiles and pad scales inert; on small-integer tiles
    (-3..3, garbage pads), scales 0.5/0.25 and operands -3..3, bitwise
    equal to the f64 oracle; the four ranks' (own, payload), exchanged by
    hand with the engine forced on every rank, against the one-device
    matvecs of the same engines (`one_mxu`): the diagonal ranks' exact-count
    triangles take gemv_q16_symm's exact body, as lam_tpu's one-tile grid
    does. Returns the largest kernel-plain difference."""
    from lam_tpu_torch import ops
    r, m2 = 2, m // 2
    real = mb * cb
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    errs, exact, diff = [], True, 0.0
    for k in (1, 2):  # the off-diagonal ranks (0, 1) and (1, 0)
        i, j = divmod(k, r)
        if i > j:
            pv, qv = slice(j * m, (j + 1) * m), slice(i * m, i * m + m2)
        else:
            pv, qv = slice(i * m, (i + 1) * m), slice(j * m + m2, (j + 1) * m)
        bufs = [ops_[k].operand[0], ops_[k].operand[3]]
        ops.reset_counters()
        with _engine(gemv, "mxu"):
            y = torch.cat(gemv.gemv_q16_dual(*bufs, ph[pv], ph[qv]))
        torch.cuda.synchronize()
        _check(_launched("gemv_q16_dual_bf16", "gemv_q16_dual")
               == {"gemv_q16_dual_bf16": 1, "gemv_q16_dual": 0},
               f"rank {k}: mxu did not route to the bf16 dual kernel")
        q = torch.cat(gemv.gemv_q16_dual_bf16_plain(*bufs, ph[pv], ph[qv]))
        errs.append(_rel(y, q))
        diff = max(diff, float((y - q).abs().max()))
        _check(torch.equal(y, torch.cat(gemv.gemv_q16_dual_bf16(
            *bufs, ph[pv], ph[qv]))), f"gemv_q16_dual_bf16 rank {k} not "
            "repeatable")
        _check(torch.equal(y, torch.cat(gemv.gemv_q16_dual_bf16(
            *_with_garbage_pads(bufs, real, tb), ph[pv], ph[qv]))),
            f"gemv_q16_dual_bf16 rank {k} read a pad tile or a pad scale")
        qs, ss = _small_q16(tuple(bufs[0].shape), real * tb, real, gen)
        qs, ss = _with_garbage_pads([qs, ss], real, tb)
        pvs, qvs = _small_vec(m, gen), _small_vec(m2, gen)
        stored = _stored_rect([qs, ss], mb, cb, tb)
        got = torch.cat(gemv.gemv_q16_dual_bf16(qs, ss, pvs, qvs)).double()
        exact = exact and torch.equal(got, torch.cat(
            [stored @ pvs.double(), stored.T @ qvs.double()]))
        del stored
    blk = [ph[(k // r) * m:(k // r + 1) * m] for k in range(r * r)]
    views = [op.as_f32() for op in ops_]
    ops.reset_counters()
    with _engine(gemv, "mxu"):
        pairs = [v.mv_pair(v.operand, blk[k], blk[(k % r) * r + k // r])
                 for k, v in enumerate(views)]
    torch.cuda.synchronize()
    launched = {k for k, v in ops.counters().items() if v}
    total = torch.cat([sum(pairs[i * r + j][0] + pairs[j * r + i][1]
                           for j in range(r)) for i in range(r)])
    n1 = one_mxu.shape[0]
    e_sum = _rel(total[:n1], one_mxu)
    print(f"gemv_q16_dual_bf16, 2x2 grid (half-slab ({m2}, {m}), {real} real "
          f"tiles + garbage pads): rel l2 kernel-plain max {max(errs):.3e} "
          f"(<= 1e-5); small-integer data == f64 oracle: {exact}; four ranks' "
          f"(own, payload) under mxu vs one device's exact diagonal blocks "
          f"+ bf16 off-diagonal blocks {e_sum:.3e} "
          f"(<= 1e-5), launched {sorted(launched)}")
    _check(max(errs) <= 1e-5, "gemv_q16_dual_bf16 disagrees")
    _check(exact, "gemv_q16_dual_bf16 != the f64 oracle on exact data")
    _check(e_sum <= 1e-5, "the grid's parts under mxu do not add up to the "
           "one-device matvec of the same engines")
    _check(launched == {"gemv_q16_symm", "gemv_q16_dual_bf16"},
           f"the grid's f32 view under mxu launched {sorted(launched)}")
    _check(int(torch.count_nonzero(total[N:])) == 0,
           "bf16 grid padding rows != 0")
    return diff


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
        if run in STREAM_RUN_ITERS:
            print(f"{run}: {iters} iterations through the dense_stream "
                  f"walk; {STREAM_RUN_ITERS[run]} before it")
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
    return total, xs["ir"], iters_of


def rank_main(argv):
    """One rank of a phase-5 cluster (`chip_smoke.py --rank r --ranks G
    --port P --jobs J --out D`): joins the process group, runs every job
    of J through the port's CLI in process with --backend sharded (or the
    job's own --backend), and
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
            backend = ([] if "--backend" in job["argv"]
                       else ["--backend", "sharded"])
            rc = cli.main(job["argv"] + backend + [
                "--device", "cuda", "--init-col",
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


def _cluster(g, jobs, tmp, env=None, label=None):
    """Run the jobs in a cluster of g rank processes of this script on the
    one card, with `env` added to their environment; returns each rank's
    records. Kills every rank and fails when one fails or the cluster
    outlives CLUSTER_TIMEOUT_S."""
    out = os.path.join(tmp, label or f"cluster{g}")
    os.makedirs(out, exist_ok=True)
    jobs_path = os.path.join(out, "jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    port = _free_port()
    logs = [open(os.path.join(out, f"rank{r}.log"), "w") for r in range(g)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--ranks", str(g), "--port", str(port), "--jobs", jobs_path,
         "--out", out], stdout=logs[r], stderr=subprocess.STDOUT,
        env=None if env is None else {**os.environ, **env})
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


def sharded_runs(ops, lio, system, x_local, local_iters, tmp):
    """Phase 5: the bench system through the port's CLI with --backend
    sharded, G rank processes on the one card over gloo, one cluster per
    G running its entries of SHARDED_RUNS in order. Returns the kernel
    launches summed over the runs and ranks."""
    a, b, a_path, b_path = system
    bnorm = np.linalg.norm(b)
    total = {fn.__name__: 0 for fn in ops.KERNELS}
    plain = [fn.__name__ for fn in ops.PLAIN]
    xs, iters_of = {}, {}
    clusters = [(g, [r for r in SHARDED_RUNS if r[1] == g], None)
                for g in SHARD_G] + [(4, MXU_RUNS, MXU_ENV)]
    for g, runs, env in clusters:
        jobs = [{"run": run, "argv": ["-A", a_path, "-b", b_path, "-o",
                                      os.path.join(tmp, f"x_{run}.bin"),
                                      *flags]}
                for run, _, flags, _, _ in runs]
        t0 = time.perf_counter()
        records = _cluster(g, jobs, tmp, env,
                           f"cluster{g}" + ("-mxu" if env else ""))
        print(f"{g}-rank cluster{' with ' + str(env) if env else ''}: "
              f"{len(runs)} runs in {time.perf_counter() - t0:.1f} s of wall "
              "time")
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
            load_s, init_s, gemv_s, iters, solve_s = (
                float(fields[3]), float(fields[4]), float(fields[5]),
                int(fields[7]), float(fields[9]))
            x = lio.read_vector(os.path.join(tmp, f"x_{run}.bin"))
            true_rel = float(np.linalg.norm(b - a @ x) / bnorm)
            x_rel = float(np.linalg.norm(x - x_local)
                          / np.linalg.norm(x_local))
            x_gate = X_ENGINE_GATE if env else X_GATE
            meshes = sorted({(rec["backend"], rec["device"]) for rec in recs})
            print(f"{run}: {g} ranks on {meshes}, load {load_s:.3f} s, "
                  f"init {init_s:.3f} s, {iters} iterations, solve "
                  f"{solve_s:.4f} s, avg gemv {gemv_s * 1e3:.3f} ms, TRUE "
                  f"rel residual {true_rel:.3e} "
                  f"(<= {TRUE_GATE:g}), x vs one-device ir {x_rel:.3e} "
                  f"(<= {x_gate:g}), launches rank 0 "
                  f"{ {k: v for k, v in recs[0]['counts'].items() if v} }")
            if run in ONE_DEVICE_OF:
                print(f"{run}: {iters} iterations; the one-device "
                      f"{ONE_DEVICE_OF[run]} run took "
                      f"{local_iters[ONE_DEVICE_OF[run]]}")
            if run in STREAM_RUN_ITERS:
                print(f"{run}: {iters} iterations through the dense_stream "
                      f"walk; {STREAM_RUN_ITERS[run]} before it")
            xs[run], iters_of[run] = x, iters
            _check(iters <= 10000, f"{run} did not converge")
            _check(true_rel <= TRUE_GATE, f"{run} TRUE residual "
                   f"{true_rel:.3e} above {TRUE_GATE:g}")
            _check(x_rel <= x_gate, f"{run}: x differs from the one-device "
                   f"ir solve by {x_rel:.3e}")
            _check(meshes == [("gloo", "cuda:0")],
                   f"{run}: the mesh is {meshes}, not gloo on cuda:0")
            for r, rec in enumerate(recs):
                counts = rec["counts"]
                ran, idle = kernels, not_kernels
                if run.startswith("symgrid-"):
                    # rank (i, j) of the 2 x 2 grid: a diagonal rank walks
                    # its triangle, the others their half-slab, and nothing
                    # else launches anywhere
                    ran = kernels[r not in (0, 3)]
                    idle = [k for k in total if k not in ran]
                for k in ran:
                    _check(counts[k] > 0, f"{run}: rank {r} never launched "
                           f"{k}")
                for k in idle:
                    _check(counts[k] == 0, f"{run}: rank {r} launched {k}")
                _check(all(counts[k] == 0 for k in plain),
                       f"{run}: a plain version ran on rank {r}")
                for k in total:
                    total[k] += counts[k]
    # --pack-cache: cold wrote one shard file per rank, warm read them
    for c in range(2):
        _check(os.path.exists(f"{a_path}.shardpack/fq.g2.s{c}"),
               f"packed-irfq --pack-cache wrote no shard file of rank {c}")
    _check(iters_of["packed-irfq-warm"] == iters_of["packed-irfq-cold"]
           and np.array_equal(xs["packed-irfq-warm"],
                              xs["packed-irfq-cold"]),
           "sharded irfq from the shard cache differs from a fresh pack")
    for k in range(4):
        _check(os.path.exists(f"{a_path}.shardpack/fq.r2.s{k}"),
               f"symgrid-irfq --pack-cache wrote no shard file of rank {k}")
    _check(iters_of["symgrid-irfq-warm-4"] == iters_of["symgrid-irfq-cold-4"]
           and np.array_equal(xs["symgrid-irfq-warm-4"],
                              xs["symgrid-irfq-cold-4"]),
           "the symmetric grid's irfq from the shard cache differs from a "
           "fresh pack")
    print(f"sharded launches, summed over the runs and ranks: {total}")
    return total


def large_system_runs(ops, gemv, generate, lio, cli, tmp):
    """Phase 6: bench.py's system at its second size, N=20000 (padded to
    20480: 'auto' picks the bf16 engine of the q16 kernels there), through
    the port's CLI: irfq --pack-cache cold and warm under 'auto' (the bf16
    triangle walk and the fq walk, not the exact q16 body; warm gives the
    same count and a bitwise-equal x), irfq with the engine set to 'vpu'
    (the exact body, not the bf16 one), and packed-irfq at G=2 (--backend
    sharded, p the full 20480 vector: every rank the bf16 slab walk and the
    fq slab walk, nothing else). Each converged, TRUE <= 2e-9 on the host,
    x within X_ENGINE_GATE of the 'vpu' run's x, no plain version. Returns
    the kernel launches summed over the runs and ranks."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    a = generate.random_spd_matrix_fast(N_LARGE, seed=SEED_A)
    b = generate.random_rhs(N_LARGE, seed=SEED_B)
    a_path, b_path = os.path.join(tmp, "A.bin"), os.path.join(tmp, "b.bin")
    lio.write_matrix(a_path, a)
    lio.write_matrix(b_path, b)
    print(f"bench system N={N_LARGE} generated and written in "
          f"{time.perf_counter() - t0:.1f} s")
    bnorm = np.linalg.norm(b)
    total = {fn.__name__: 0 for fn in ops.KERNELS}
    plain = [fn.__name__ for fn in ops.PLAIN]
    bf16_run = (("gemv_q16_symm_bf16", "gemv_fq_symm"), ("gemv_q16_symm",))
    runs = (("irfq-cold", "auto") + bf16_run, ("irfq-warm", "auto") + bf16_run,
            ("irfq-vpu", "vpu", ("gemv_q16_symm", "gemv_fq_symm"),
             ("gemv_q16_symm_bf16",)))
    xs, iters_of = {}, {}

    def gate(run, iters, err, x):
        true_rel = float(np.linalg.norm(b - a @ x) / bnorm)
        _check(iters <= 10000 and err <= 1e-9, f"N={N_LARGE} {run} did not "
               f"converge: {iters} iterations, residual {err:g}")
        _check(true_rel <= TRUE_GATE, f"N={N_LARGE} {run} TRUE residual "
               f"{true_rel:.3e} above {TRUE_GATE:g}")
        return true_rel

    for run, impl, kernels, not_kernels in runs:
        x_path = os.path.join(tmp, f"x_{run}.bin")
        csv = io.StringIO()
        ops.reset_counters()
        with _engine(gemv, impl), contextlib.redirect_stdout(csv):
            rc = cli.main(["-A", a_path, "-b", b_path, "-o", x_path,
                           "--precision", "irfq", "--device", "cuda",
                           "--pack-cache"])
        torch.cuda.synchronize()
        counts = ops.counters()
        _check(rc == 0, f"N={N_LARGE} {run}: the CLI exited {rc}")
        fields = csv.getvalue().strip().split(",")
        load_s, gemv_s, iters, err, solve_s = (
            float(fields[3]), float(fields[4]), int(fields[6]),
            float(fields[7]), float(fields[8]))
        x = lio.read_vector(x_path)
        true_rel = gate(run, iters, err, x)
        print(f"N={N_LARGE} {run} (engine {impl}): load {load_s:.3f} s, "
              f"{iters} inner iterations, solve {solve_s:.4f} s, avg gemv "
              f"{gemv_s * 1e3:.3f} ms, TRUE rel residual {true_rel:.3e}, "
              f"launches {({k: v for k, v in counts.items() if v})}")
        for k in kernels:
            _check(counts[k] > 0, f"N={N_LARGE} {run} never launched {k}")
        for k in not_kernels:
            _check(counts[k] == 0, f"N={N_LARGE} {run} launched {k}")
        _check(all(counts[k] == 0 for k in plain),
               f"a plain version ran on the N={N_LARGE} {run} path")
        for k in total:
            total[k] += counts[k]
        xs[run], iters_of[run] = x, iters
    _check(os.path.exists(f"{a_path}.fqpack"), "irfq --pack-cache wrote no "
           f"A.bin.fqpack at N={N_LARGE}")
    _check(iters_of["irfq-warm"] == iters_of["irfq-cold"]
           and np.array_equal(xs["irfq-warm"], xs["irfq-cold"]),
           f"N={N_LARGE} irfq from the cache differs from a fresh pack")

    run, g = "packed-irfq", SHARD_G[0]
    t0 = time.perf_counter()
    records = _cluster(g, [{"run": run, "argv": [
        "-A", a_path, "-b", b_path, "-o", os.path.join(tmp, f"x_{run}.bin"),
        "--precision", "irfq"]}], tmp, None, f"cluster{g}-n{N_LARGE}")
    recs = [rank_recs[0] for rank_recs in records]
    _check(all(rec["rc"] == 0 for rec in recs), f"N={N_LARGE} {run}: a "
           f"rank's CLI failed: {[rec['rc'] for rec in recs]}")
    fields = recs[0]["stdout"].strip().split(",")
    _check(int(fields[1]) == g, f"N={N_LARGE} {run}: procs {fields[1]}")
    load_s, iters, err, solve_s = (float(fields[3]), int(fields[7]),
                                   float(fields[8]), float(fields[9]))
    x = lio.read_vector(os.path.join(tmp, f"x_{run}.bin"))
    true_rel = gate(run, iters, err, x)
    xs[run], iters_of[run] = x, iters
    print(f"N={N_LARGE} {run}-{g} ({time.perf_counter() - t0:.1f} s of wall "
          f"time): load {load_s:.3f} s, {iters} inner iterations, solve "
          f"{solve_s:.4f} s, TRUE rel residual {true_rel:.3e}, launches "
          f"rank 0 {({k: v for k, v in recs[0]['counts'].items() if v})}")
    walks = ("gemv_q16_symm_slab_bf16", "gemv_fq_symm_slab")
    for r, rec in enumerate(recs):
        counts = rec["counts"]
        for k in total:
            _check((counts[k] > 0) == (k in walks),
                   f"N={N_LARGE} {run}: rank {r} launched {k} "
                   f"{counts[k]} times")
            total[k] += counts[k]
        _check(all(counts[k] == 0 for k in plain),
               f"N={N_LARGE} {run}: a plain version ran on rank {r}")
    for run, x in xs.items():
        x_rel = float(np.linalg.norm(x - xs["irfq-vpu"])
                      / np.linalg.norm(xs["irfq-vpu"]))
        print(f"N={N_LARGE} {run}: x vs the 'vpu' run's x {x_rel:.3e} "
              f"(<= {X_ENGINE_GATE:g})")
        _check(x_rel <= X_ENGINE_GATE, f"N={N_LARGE} {run}: x differs from "
               f"the exact engine's by {x_rel:.3e}")
    print(f"N={N_LARGE} inner iterations, bf16 engine against exact "
          f"products: irfq {iters_of['irfq-cold']} (bf16) vs "
          f"{iters_of['irfq-vpu']} (exact); packed-irfq G={g} "
          f"{iters_of['packed-irfq']} (bf16)")
    print(f"phase 6: {time.perf_counter() - t_phase:.1f} s")
    return total


def probe_tool(q16_probe):
    """Phase 7: the q16 probe tool (lam_tpu_torch.tools.q16_probe) in
    process, probes 1-4 at the scripts' sizes: every variant validated
    exactly, then timed in turns with the read floor. Returns the probe
    kernels' launches in this run (each must be > 0, no plain version)."""
    from lam_tpu_torch.ops import probe
    t0 = time.perf_counter()
    probe.reset_counters()
    q16_probe.run((1, 2, 3, 4), device="cuda")
    counts = probe.counters()
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")
    _check(not any(counts[fn.__name__] for fn in probe.PROBES_PLAIN),
           "phase 7 ran a probe's plain version")
    return {fn.__name__: counts[fn.__name__] for fn in probe.PROBES}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from lam_tpu_torch import cli, generate, ops
    from lam_tpu_torch import io as lio
    from lam_tpu_torch.apps import bmp, bmp_cli, heat, heat_cli
    from lam_tpu_torch.ops import _build, gemv, layout, probe, stencil
    from lam_tpu_torch.parallel import pcg, pcg2d_symm, pcg_symm
    from lam_tpu_torch.parallel.mesh import Mesh, Mesh2D
    from lam_tpu_torch.precision import split_f64_host
    from lam_tpu_torch.solver.operators import (_host_pack_planes,
                                                _host_pack_tri)
    from lam_tpu_torch.tools import q16_probe

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
    stream_sass(_build)

    results = kernels_vs_plain(gemv, layout, _host_pack_planes,
                               _host_pack_tri, split_f64_host)
    torch.cuda.empty_cache()
    results.append(stencil_vs_plain(stencil))
    torch.cuda.empty_cache()
    a, p = _shard_system()
    results += cols_kernels_vs_plain(gemv, pcg, Mesh, a, p)
    torch.cuda.empty_cache()
    one = one_device_matvecs(gemv, layout, _host_pack_planes, _host_pack_tri,
                             a, p)
    results += slab_kernels_vs_plain(gemv, layout, pcg_symm, Mesh,
                                     one["df64"], a, p)
    torch.cuda.empty_cache()
    results += quant_slab_kernels_vs_plain(gemv, layout, pcg_symm, Mesh, one,
                                           a, p)
    torch.cuda.empty_cache()
    results += dual_kernels_vs_plain(gemv, layout, pcg2d_symm, Mesh2D, one,
                                     a, p)
    del a, one
    torch.cuda.empty_cache()
    results.append(bf16_symm_large(gemv, layout))
    torch.cuda.empty_cache()
    results.append(bf16_slab_large(gemv, layout, pcg_symm))
    _check(sorted(r["name"] for r in results)
           == sorted(fn.__name__ for fn in ops.KERNELS + probe.PROBES),
           "phase 2 did not hold every kernel against its plain version")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        system = bench_system(generate, lio, tmp)
        counts, x_ir, local_iters = solve_slice(ops, lio, cli, system, tmp)
        torch.cuda.empty_cache()
        heat_counts = heat_demo(ops, heat, heat_cli, bmp_cli, bmp, lio)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        shard_counts = sharded_runs(ops, lio, system, x_ir, local_iters,
                                    tmp)
        print(f"phase 5: {time.perf_counter() - t0:.1f} s")
        del system, x_ir
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        large_counts = large_system_runs(ops, gemv, generate, lio, cli, tmp)
    torch.cuda.empty_cache()
    probe_counts = probe_tool(q16_probe)
    for r in results:
        r["launches"] = sum(c.get(r["name"], 0) for c in (
            counts, heat_counts, shard_counts, large_counts, probe_counts))
        _check(r["launches"] > 0, f"{r['name']} never launched on the "
               "main path")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]) if "--rank" in sys.argv else main())
