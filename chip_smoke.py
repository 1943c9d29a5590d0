#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the CUDA kernels
   from lam_tpu_torch/csrc (nvcc, sm_90a, one nvcc per source) and, beside
   them, the native host library from lam_tpu_torch/native/lam_native.cpp
   (g++; its path and g++'s version printed): the file packs, row reads
   and host splits of phases 3-6 take it.
2. Holds each of the forty-four kernels (the solver's thirty-six and
   the eight q16 probes) against its plain PyTorch version at the main
   path's shapes. The eight one-device kernels at N=10000 padded to
   10240 (20 row tiles of 512, 210 packed tiles; the fq planes stored
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
   - the other storage modes of kernels 1, 2 and 15 (generate mode's and
     lam_tpu's packed=False): gemv_f32_symm_square and
     gemv_df64_symm_square on the full 10240^2 (hi, lo) squares, equal
     bit for bit to the packed kernels on the same tiles;
     gemv_df64_symm_bcast on the packed hi plane and one 512 x 512 lo
     tile, and gemv_fq_symm_bcast on the fq pack's q1 and one q2 and one
     q3 tile (and one tile beside a full q3 plane): zero tiles equal bit
     for bit to the full-plane kernels over zero planes, non-zero tiles
     against the plain version and the f64 oracle of the stored values
     (1e-5 f32, 1e-13 the others), bitwise repeats; each timed on zero
     tiles (the square walks on their squares) beside its library call
     (torch.mv over the f32 or f64 square, or over the f64 hi square for
     the df64 broadcast, which computes the same function) and, in turns,
     beside its packed sibling (kernel 1 for the df64 broadcast: the same
     plane streamed; kernels 15 and 14 for the fq broadcast); the fq
     broadcast's kernel for tiles of zeros, gemv_fq_symm_zero (the strip
     walk over q1 alone, csrc/strip_walk.cuh, which generate mode's
     operators take): bit for bit the zero planes' and the tile-reading
     walk's (its control), timed so (its `kernels` entry, bound by the
     bytes of q1, s1 and the vectors) and against the control
     LIBRARY_REPEATS times in turns, kernel 15 over zero planes and
     lam_stream_i16 on q1 beside, failing unless it is below the control
     in every repeat, its passes split by torch.profiler;
   - kernels 4, 5 and 6 (gemv_df64, gemv_f32_cols, gemv_df64_cols) run
     the dense_stream walk of csrc/gemv_dense.cu: their SASS holds the TMA
     bulk copy (UBLKCP) and that of the dense_rows kernels (kernel 3 and
     the df64 control lam_gemv_df64_rows, lam_tpu_torch/ops/probe.py) none;
     each gives the bits of the dense_rows walk on the same bytes
     (gemv_df64_rows on the square and on every block of every G=2 rank;
     gemv_f32 on a contiguous copy of the column block); each is timed
     against its library call LIBRARY_REPEATS more times in turns,
     dense_rows beside, printing the spread of the kernel/library ratio;
     kernels 5 and 6 also at rank 0's column block of G=4 (printed only;
     kernel 6 over three copies in turn);
   - kernels 16, 18, 18-bf16, 19 and 19-bcast (gemv_q16_symm_slab,
     gemv_q16_dual, gemv_q16_dual_bf16, gemv_fq_dual, gemv_fq_dual_bcast),
     the zero-tile kernels of 15-, 9-, 12-, 17- and 19-bcast
     (gemv_fq_symm_zero, gemv_df64_symm_slab_zero, gemv_df64_dual_zero,
     gemv_fq_symm_slab_zero, gemv_fq_dual_zero) and probes P4s, P5s, P5h
     and P5y (gemv_q16_symm_sub8, _split, _hi, _hybrid) run the strip walk
     of csrc/strip_walk.cuh: their SASS holds UBLKCP and that of their
     controls, the two-pass walks gemv_q16_symm_slab_twopass,
     gemv_q16_dual_twopass, gemv_q16_dual_bf16_twopass,
     gemv_fq_dual_twopass, gemv_q16_symm_sub8_twopass, _split_twopass,
     _hi_twopass, _hybrid_twopass and the tile-reading walks of 15-, 9-, 12- and
     17-bcast, none (18-bf16's, P5s's, P5h's and P5y's walks, each keyed
     by its engine and walk, and their controls hold HMMA);
     ptxas reports no spill for them. Kernel
     16's (yd, yt) equal its control's bit for bit on every rank's tables
     of G=2 and G=4, and it is timed against the control LIBRARY_REPEATS
     times in turns, the read floor beside, over three copies of its
     plane, at rank 0 of G=2 and of G=4; kernels 18 and 19 below.
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
   kernels 18 and 19 equal their two-pass controls bit for bit on both
   off-diagonal ranks, garbage pads too;
   timed at rank (1, 0), the f32 and q16 kernels over three copies of their
   plane in turn, beside two torch.mv calls over the dense rectangle (S p,
   S^T q) for the f32 and df64 ones; kernels 18, 18-bf16 and 19 also
   against their controls LIBRARY_REPEATS times in turns, beside the read
   floor of their planes (kernel 19's: q1, q2 and q3 streamed one after
   another), each printed beside its target (KERNEL_TARGET_MS) and whether
   it was below its control in every repeat. Prints each kernel's median
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
   1e-2), repeats bitwise, equals its control (gemv_q16_dual_bf16_twopass,
   the two-pass walk) bit for bit, pads as they are and garbage, equals
   the f64 oracle bit for bit on
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
   int -> f32 conversions (cuobjdump), sub8 (the strip walk, each
   consumer warp's transpose row kept) and split, hi and hybrid (the
   strip walk with tensor-core consumers) each equal to its two-pass
   control (gemv_q16_symm_sub8_twopass, _split_twopass, _hi_twopass,
   _hybrid_twopass) bit for bit and timed against it LIBRARY_REPEATS
   times in turns (failing unless below it in every repeat), the read
   floor beside, its passes split by torch.profiler, its `kernels` entry
   naming the control and its median time in those turns
   ("control", "control_ms"); gemv_q16_symm_tb1024 on a random
   int16 plane of 1024-wide tiles against random power-of-two scales
   (1e-5); stream_i16 (checksum = the plain one) and convert_f32_sum
   (within its per-thread f32 rounding bound) on kernel 14's plane, both
   exact on the probes' tridiagonal plane; each timed beside its plain
   version (and, for the streams, torch.sum with an int64 or f64
   accumulator).
   The broadcast modes of kernels 9, 17 (rank 0 of G=2, 105 tiles) and
   12, 19 (rank (1, 0)'s (2560, 5120) half-slab), generate mode's one
   512 x 512 tile for lo or for q2 and q3 on the meshes: zero tiles equal
   bit for bit to the full-plane kernel over zero planes, non-zero tiles
   (and a tile beside a full plane) against the plain version and the f64
   oracle of the stored values (1e-13), bitwise repeats; timed on zero
   tiles, the q1 planes and the half-slab's hi over three copies in turn,
   in turns with the full-plane kernel and the f32 or q16 walk of the same
   plane; kernel 9's kernel for a lo tile of zeros,
   gemv_df64_symm_slab_zero (the strip walk over hi alone), bit for bit
   the zero plane's and the tile-reading walk's (its control, on +0.0 and
   -0.0 tiles), timed so over three hi copies in turn (its `kernels`
   entry, bound by the bytes of hi, the tables and the vectors) and
   against the control LIBRARY_REPEATS times in turns, kernel 9 over a
   zero plane and lam_stream_i16 over hi's bytes beside, failing unless
   it is below the control in every repeat. Kernels 17's and 12's
   kernels for tiles of zeros, gemv_fq_symm_slab_zero (the strip walk
   over q1 alone, its scales per walk position) and gemv_df64_dual_zero
   (over the hi rectangle alone), each bit for bit the zero planes' and
   the tile-reading walk's (its control; 12's on a +0.0 and a -0.0 tile)
   and within 1e-13 of its plain version, timed so over three q1 or hi
   copies in turn (their `kernels` entries, bound by the bytes of q1 and
   s1 or of hi's real tiles, with the tables and the vectors; 12's beside
   two torch.mv over the f64 hi rectangle) and against the control
   LIBRARY_REPEATS times in turns, their siblings on the same copies
   (kernel 16, kernel 11) and lam_stream_i16 over the plane's bytes
   beside, failing unless each is below its control in every repeat.
   Kernel 19's kernel for tiles of zeros, gemv_fq_dual_zero (the strip
   walk over the q1 rectangle alone), the same way at rank (1, 0): bit
   for bit the zero planes', the tile-reading walk's and its repeat's,
   within 1e-13 of its plain version and the f64 oracle, timed over three
   q1 copies in turn (its `kernels` entry, bound by the bytes of q1's and
   s1's real tiles and the vectors) and against its control
   LIBRARY_REPEATS times in turns, kernel 18 on the same copies and
   lam_stream_i16 over q1 beside, failing unless it is below its control
   in every repeat, its passes split by torch.profiler.
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
   version may have run. The native library's call counters likewise:
   every packing run (ir, df64, fq, dfq and the cold irfq and irq) must
   have packed natively (irfq-cold by the streamed range pack, pinned
   uploads while it packs), the warm runs not at all. Then the cache files
   the native packs wrote, A.bin.fqpack and A.bin.dfqpack, are held byte
   for byte against the files the port's numpy pack writes for the same
   source, each numpy load timed (pack, upload and publish: the cold
   load_s of the numpy pack, printed beside the native one). Then irfq
   --outer host twice on a fresh copy of the file (HOST_RUNS; cold: the
   native pack, published, then only q1, s1, dh and dl uploaded; warm:
   the partial read of the cache): converged, a TRUE residual <= 2e-9 by
   an independent blocked pass a[s:s+blk] @ x over the memory map in
   extended precision, the reported residual equal to it within 1e-6
   relative, gemv_q16_symm and no fq walk, no bf16 body and no plain
   version launched, the device grown across the load by no more than
   1.05 x the four buffers' bytes, warm x bitwise the cold x, the inner
   iterations printed beside irfq-cold's. Then Jacobi-preconditioned CG
   (--preconditioner jacobi, JACOBI_RUNS): df64, ir and irfq on the
   benchmark system, each converged to a TRUE residual <= 2e-9, launching
   the kernels of its run without a preconditioner and no plain version,
   its iterations and solve time printed beside that run's; and a badly
   scaled system (random_spd_matrix_fast(4096, seed=2024) * outer(s, s), s
   = exp(linspace(0, 4, n)), as tests/test_cli.py:244-270 builds it at
   n=96) through df64 without a preconditioner (-i 5000; it may stop
   there) and with Jacobi, which must converge <= 2e-9 in fewer
   iterations.
   Phase 2 also holds the stencil kernel laplace5_f32_halo against its
   plain version on the heat demo's padded grid (1024 x 1280, zero edges)
   and on that grid as one shard of a row-sharded grid (non-zero edge
   rows, a row limit below H and at H, columns cut below W): y bitwise
   equal, padding exactly 0, p . y within 1e-6 relative of the plain
   version and of a float64 oracle, bitwise repeats, and (y, p . y) equal
   to its control's (laplace5_f32_halo_twopass, the two ordinary launches
   the kernel replaced) bit for bit, there and at 4096 x 4096. It times it
   on both grids (4096 x 4096 is streamed from HBM) beside torch's conv2d
   with the same 5-point weights (stencil only: no mask, no p . y), and
   against its control LIBRARY_REPEATS times in turns, conv2d beside:
   the demo grid's times beside its target, 4096 x 4096's ratio to the
   control beside 3%. And on each of the 4 shards of the plate padded for
   a 4-rank row-sharded grid (1024 x 1280, 256 rows a shard, the last 230
   of them valid), its edges the rows the halo exchange delivers (zeros
   past the mesh's edges), held so against its plain version; the shards'
   y concatenated equal the one-device y bit for bit, and their p . y
   partials summed the one-device p . y within 1e-6.
4. Runs the heat-equation demo through the port's `lam-heat` CLI, in
   process, at its documented 1200 x 1000 plate: --precision ir (the
   stencil kernel must launch, no gemv kernel and no plain version) and
   --precision f64 (no stencil kernel, no plain version), each to a TRUE
   relative residual of the 5-point system <= 2e-10 computed in f64 on
   the host, the two grids within IR_F64_ATOL, the ir run's inner
   iterations HEAT_IR_ITERS (4448, every chip run of the ported stencil: the
   stencil keeps its bits); Jacobi at 120 x 100, whose
   sweep count and grid must equal a literal numpy loop; and the
   `lam-heat-to-bmp` converter on the ir grid, a (1000, 1200, 3) image.
   Then the row-sharded heat path at the same plate, through lam-heat
   with --devices 2 and --devices 4 (HEAT_DEVICES), G rank processes of
   this script sharing the card over gloo, as phase 5 starts them, the two
   clusters side by side (each solve time is taken beside the other
   cluster's, so it is contended): each
   converged to a TRUE residual <= 2e-10 on the host from rank 0's grid,
   within IR_F64_ATOL of the f64 grid, every rank launching
   laplace5_f32_halo and nothing else (no gemv kernel, no plain version),
   the mesh reporting gloo with every rank on cuda:0; its inner
   iterations printed beside the one device's 4448 with its solve time.
   G ranks on one card measure the sharded program, not scaling.
5. Solves the benchmark system through the port's CLI with --backend
   sharded, G rank processes of this script (`--rank r ...`, started with
   subprocess, each killed if its cluster outlives CLUSTER_TIMEOUT_S)
   sharing the one card over gloo (the G=2 and G=4 clusters side by side,
   so their load, solve and gemv times are contended, then the mxu
   cluster alone), each running lam_tpu_torch.cli.main in
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
   within 5e-6 of the ir x, since its inner engine differs; 394
   iterations, its count on the card before kernel 18-bf16 moved to the
   strip walk, WALK_RUN_ITERS). Each run must converge with a
   TRUE relative residual <= 2e-9 on the host from rank 0's solution
   file, x within 1e-6 relative of phase 3's one-device ir x, its kernels
   launched and the others not in every rank (irfq: the q16 and fq walks
   and neither the f32 nor the df64 one; irq: the f32 and dfq walks; the
   grid: the dense kernels and no symmetric one), no plain version, its
   iteration count printed beside the one-device run's, one CSV
   row (rank 0's) with procs = G, and the mesh must report gloo with every
   rank on cuda:0. G ranks on one card measure the sharded program, not
   multi-GPU scaling. No earlier phase was shortened for these. Last in
   their clusters, Jacobi-preconditioned runs (--preconditioner jacobi):
   ring-ir-jacobi and packed-irfq-jacobi at G=2, grid-ir-4-jacobi and
   symgrid-ir-4-jacobi at G=4, each held to the gates of its run without
   a preconditioner, its x against phase 3's one-device Jacobi x of the
   same mode (JACOBI_OF), its iterations printed beside that run's.
   Last in the 2-rank cluster, phase 13's sharded row (see there).
6. Writes bench.py's system at its second size (random_spd_matrix_fast(
   20000, seed=2024), random_rhs(20000, seed=2034), 3.2 GB; generated as
   phase 3's is) to a new temporary directory, phase 3's freed, and solves it through the port's
   CLI: irfq --pack-cache cold and warm under "auto" (gemv_q16_symm_bf16
   and gemv_fq_symm, not the exact q16 body; warm: the same count and a
   bitwise-equal x), irfq with the engine set to "vpu" (the exact body,
   not the bf16 one), and packed-irfq with --backend sharded in a 2-rank
   cluster (every rank gemv_q16_symm_slab_bf16 and gemv_fq_symm_slab, and
   nothing else). Each must converge with TRUE <= 2e-9 on the host and x
   within 5e-6 of the "vpu" run's x, no plain version; prints the bf16 and
   exact runs' inner iterations side by side and the phase's seconds.
   Then one cold fq load by the numpy pack, timed beside the native
   one, and irfq --outer host cold (a fresh copy of the file) and warm
   under "auto", held as phase 3's host runs and besides: the bf16 body
   gemv_q16_symm_bf16 and not the exact one, x within 5e-6 of the "vpu"
   run's, inner iterations within 2% of irfq-cold's; load_s, solve_s, the
   cycles and the iterations printed beside the device-outer runs'. Then
   the q1 plane of A.bin.fqpack to the card in turns, through the pinned
   ring and by plain copies, bit for bit equal (upload_turns).

7. Runs the q16 probe tool (lam_tpu_torch.tools.q16_probe) in process:
   probes 1-4 of scripts/q16_probe{,2,3,4}.py at their sizes (N=40960 at
   tb=512 and 1024; N=114688 padded; N=57344; N=114688 at tb=1024), every
   variant held to the closed form of the tridiagonal plane exactly, then
   timed in turns with the read floor; prints each row and the phase's
   seconds. The probe kernels' counters are zeroed just before it: each
   must launch, and no plain version may run.
8. Generate mode (`-s N`, the reference's benchmark system: the dense
   tridiagonal, 2 on the diagonal and 1 beside it, against ones) through
   the port's CLI in process, every operator built on the card: at
   N=10000 with -e 1e-9 (GEN_RUNS) df64, ir, fq, irfq, dfq and irq on the
   packed engine (df64/ir: the packed hi plane and one zero lo tile,
   kernel 2's broadcast mode; fq/irfq: the q1 plane and zero q2/q3 tiles,
   kernel 15's kernel for tiles of zeros, gemv_fq_symm_zero, and never
   its tile-reading walk), df64 and ir with --engine pallas_symm (the
   square walks) and df64 with --engine pallas; each converged with a
   TRUE relative residual <= 2e-9 computed on the host by the O(N)
   tridiagonal product (no N^2 matrix is built on the host), its kernels
   launched and the other storages' not, no plain version, and df64's
   count within 1% of a host f64 CG's on the same system. Then the
   tile-reading walks of kernels 15 and 9 on operators built from
   generate mode's planes at TILES_N with a tile handed in that is not
   zero (TILES_EPS * I), solved by cg_solve to 1e-9: each converged with
   a TRUE residual <= 2e-9 of that system, the tile-reading walk launched
   and the zero-tile kernel not (`handed_tiles_runs`); and kernel 17's on
   the packed fq band pair of a one-rank mesh, q2 = I with s2 =
   TILES_EPS, the same way. Then the
   reference's gen-sweep
   probes at N=150000 (-i 15, CSV num_iter 16), one at a time: df64 (the
   45.16 GB hi plane and one lo tile), ir (kernel 1 on the same plane)
   and irfq (the 22.58 GB q1 plane: kernel 14's bf16 engine, which `auto`
   picks there, and gemv_fq_symm_zero); df64's x within 1e-10 of
   the host f64 CG's after 15 iterations, every probe's residual equal to
   the host's TRUE residual of its x within 1e-6; load_s (the device
   build) and avg_gemv_s printed beside the plane's byte bound; the
   phase's seconds.
9. Generate mode on the meshes. First the four broadcast modes on the
   N=2000 operands that the gen builders make on the card (rank 0 of
   G=2's band walk, rank (1, 0)'s half-slab of R=2): zero tiles equal to
   the full-plane kernels over zero planes bit for bit, the operands and
   non-zero tiles against the plain versions and the f64 oracle at 1e-13,
   bitwise repeats; one device's gen fq operator and the grid's diagonal
   rank (0, 0) multiply by gemv_fq_symm_zero alone, bit for bit the
   tile-reading walk's and the zero planes' product, one rank's gen fq
   band pair by gemv_fq_symm_slab_zero and the grid's rank (1, 0) at df64
   and at fq by gemv_df64_dual_zero and gemv_fq_dual_zero alone, bit for
   bit the tile-reading walks', and
   gemv_df64_symm_slab_zero and gemv_fq_symm_slab_zero on the band walk's
   packed tiles give the tile-reading walk's bits. Then G rank processes
   of this script on the one card over gloo, as in phase 5, through the
   port's CLI. At N=2000
   (-e 1e-9; padded to 2048: one tile a band at G=2, two a block side at
   R=2, so the walks meet the within-rank and cross-block corners and a
   padded edge) MESH_GEN_RUNS: ring-ir, slab-ir, packed-df64,
   packed-ir and packed-irfq at G=2 (kernels 5/6; 8/9; 9's kernel for a
   zero tile; 8 and 9's; 16 and 17's kernel for zero tiles), grid-ir-4
   (3, 4) and, on the symmetric grid, symgrid-df64-4, symgrid-ir-4 and
   symgrid-irfq-4 (diagonal ranks 1 and 2's broadcast mode or 14 and
   15's kernel for zero tiles, off-diagonal ranks 11 and 12's kernel for
   a zero tile or 18 and 19's kernel for zero tiles); each
   converged with a TRUE residual <= 2e-9 on
   the host, procs = G, every rank's kernels launched and no other, no
   plain version, df64's count within 1% of a host f64 CG's. Then, one at
   a time after their cluster's runs, the N=150000 probes (-i 15):
   packed-df64 and packed-irfq at G=2, symgrid-df64-4 and symgrid-irfq-4,
   held as phase 8's probes; load_s, avg_gemv_s and the ranks' plane bytes
   beside their bound, the q16 engine of each rank; no rank launches a
   tile-reading walk of kernels 15, 9, 12, 17 or 19. Last in the 4-rank
   cluster, MESH_TILES_RUNS: tiles-symgrid-df64-4 and tiles-symgrid-fq-4,
   the grid's gen df64 or fq operator at TILES_GRID_N (no padding at R=2)
   rebuilt on every rank with the lo tile TILES_EPS * I or the q2 tile I
   against s2 = TILES_EPS, solved by cg_solve to 1e-9: converged, a TRUE
   residual <= 2e-9 of that system, the tile-reading walks (2- and
   12-bcast, or 15- and 19-bcast) launched and the zero-tile kernels
   not. The phase's seconds.
10. Phase 2's kernel-against-plain checks again, without their timings,
   in FRESH_CHECKS fresh processes of this script started together
   (`chip_smoke.py --fresh-checks`) on this run's library, while phase 12
   runs in this process (they time nothing): each must exit
   0; one that fails prints the library's path (its hash) and the card's
   name, power limit, temperature, SM clock and uncorrected ECC errors,
   and fails the run: a check that held in phase 2 and fails in a fresh
   process is a fault (one earlier chip call saw kernels disagree with
   their plain versions in a fresh process, once, for no cause found).
11. Resumable solves and the plain-torch engines on phase 3's file
   (run after phase 5, while the file is there), through the CLI: df64
   --checkpoint --checkpoint-every 100 -i 200 (CSV 201), then --resume:
   358 iterations in all and x bitwise equal to an uninterrupted
   --checkpoint run's; ir and irfq stopped after their first refinement
   cycle through the API (cg_solve_ir_resumable(max_cycles=1) on the
   operator the CLI builds; a small -i would cut the first cycle's inner
   loop and change the trajectory), then resumed with --resume: 365 and
   375 inner iterations, x bitwise equal to an uninterrupted --checkpoint
   run's; Jacobi df64 -i 20 (CSV 21), then resumed: 39; packed-irfq at
   G=2 (two rank processes, the phase-5 shard cache) stopped after its
   first cycle through the API and resumed with the CLI: phase 5's 375;
   --engine xla df64 and --precision f64, each within 2 of 358; and
   cg_solve_block of 4 right-hand sides on the packed df64 operator. Each
   run prints load_s, solve_s, its launch counts and its TRUE residual
   (<= 2e-9 on the host); the kernel runs launch their kernels and no
   plain version, the xla, f64 and block runs no port kernel and no plain
   version. The phase's seconds. Its launches stay out of the kernels
   line.
12. (Beside phase 10's fresh processes.) The port's compile check and
   multi-rank dry run (lam_tpu_torch.dryrun): `entry()`'s 20 df64 CG iterations on the
   card, kernel 4 launched and no plain version, x within 1e-10 relative
   of oracle_cg's after 20 iterations; then `dryrun_multichip(4)`: four
   rank processes of that module sharing the card over gloo, every
   sharded backend and storage through one converged solve (or one
   matvec) of random_spd_system(4096, seed=2024) held to oracle_cg
   (iterations within max(3, k // 50), TRUE residual < 1e-8), the
   row-sharded heat solve against the one-device f64 grid, each leg's
   kernels launched and no plain version. Prints each leg's line and
   kernels, and the phase's seconds beside the card's name and power
   limit. Its launches stay out of the kernels line.
13. (Run after phase 9.) The sweep runner lam-bench-torch
   (lam_tpu_torch.bench.runner.main) in process, its .npy system cache
   in a temporary directory, the only one it searches (no system of this
   size is found there before the cold run), every run appending
   to one CSV (BENCH_RUNS): --mode gen --sizes 10000 150000 (precision
   auto = df64: the packed hi plane and a zero lo tile, kernel 2's
   broadcast mode), both rows num_iter 16, procs 1, the N=150000 row's
   avg_gemv_s within 10% of phase 8's df64 probe; --mode spd --sizes 10000
   in memory (the facade's _build_operator) with df64 and ir, bench.py's
   system, phase 3's 358 and 365 iterations; and --pack-cache --precision
   irfq twice, cold (generates, publishes the .npy, equal element for
   element to phase 3's matrix, and packs into its .fqpack) and warm (reads
   both, a lower load_s), each 375 iterations, the same err; each spd row's
   err <= 2e-9, each run's kernels launched (1, 2; 14's exact body, 15)
   and no plain version. Phase 5's 2-rank cluster ran the sharded row
   (bench-spd-irfq-sharded: --backend sharded --precision irfq, in memory,
   each rank building its own band pair): procs 2, 375 iterations, rank 0's
   row alone in its CSV, kernels 16 and 17 on each rank and nothing else.
   That row joins the CSV, and lam_tpu_torch.bench.clean.main writes
   BEST_RESULTS: one row per (N, procs), the lowest total_cg_s. Prints
   each row, its launches and the phase's seconds beside the card's name
   and power limit. Its launches stay out of the kernels line.

Prints {"kernels": [...]} on the line before the last (each solver
kernel's launches summed over the runs of phases 3-6, 8 and 9, every
rank's;
each probe's over phase 7) and, as the last
line, {"ok": true, "device": {...}}. Any failure raises: exit code != 0 and
no result line. Without a CUDA device it exits 1 at once.
"""

import contextlib
import filecmp
import gc
import io
import itertools
import json
import os
import re
import shutil
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
# the probe walks on the strip walk's tensor-core consumers, each held to
# its two-pass control (gemv_q16_symm_<name>_twopass), and all the probe
# walks on the strip walk: P4s's summing consumers too
TC_WALKS = ("split", "hi", "hybrid")
STRIP_PROBES = ("sub8", *TC_WALKS)
HEAT_NX, HEAT_NY = 1200, 1000  # the heat demo's documented plate
JAC_NX, JAC_NY = 120, 100
HEAT_SHARDS = 4  # phase 2's shards of the plate, the largest phase-4 mesh
HEAT_DEVICES = (2, 4)  # phase 4's row-sharded runs, rank processes
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
# phase 3's Jacobi runs (--preconditioner jacobi): (run, the run without a
# preconditioner beside it, kernels it must launch, kernels it must not)
JACOBI_RUNS = (("df64-jacobi", "df64", ("gemv_df64_symm",), ()),
               ("ir-jacobi", "ir", ("gemv_f32_symm", "gemv_df64_symm"), ()),
               ("irfq-jacobi", "irfq-warm", ("gemv_q16_symm", "gemv_fq_symm"),
                _BF16))
# phase 3's badly scaled system: a * outer(s, s), s = exp(linspace(0, 4, n))
# (tests/test_cli.py:244-270 at n=96), df64 with and without Jacobi; the
# run without gets this cap and may end there unconverged
SCALED_N, SCALED_SPAN, SCALED_CAP = 4096, 4.0, 5000
# precisions run with --pack-cache -> the storage their cache holds
PACK_CACHE = {"irfq": "fq", "irq": "dfq"}
# phase 3 runs that pack the file -> the native binding that must pack it
# (the full-square runs read the whole file and split it on the host)
NATIVE_PACK_OF = {"ir": "pack_df64", "df64": "pack_df64",
                  "irfq-cold": "pack_fq_range", "fq": "pack_fq_range",
                  "irq-cold": "pack_dfq", "dfq": "pack_dfq",
                  "ir-pallas": "split_f64", "df64-pallas": "split_f64"}
# irfq --outer host on a fresh copy of the file: (run, packs natively)
HOST_RUNS = (("host-cold", True), ("host-warm", False))
HOST_ITERS_GATE = 0.02   # host-outer inner iterations vs irfq-cold's
HOST_MEM_GATE = 1.05     # device growth across the load / q1+s1+dh+dl
HOST_ERR_GATE = 1e-6     # reported residual vs the independent pass
SHARD_G = (2, 4)     # rank counts of the sharded checks and runs
_RING = ("gemv_f32_cols", "gemv_df64_cols")
_SLAB = ("gemv_f32_symm_slab", "gemv_df64_symm_slab")
_SLAB_TILE = ("gemv_df64_symm_slab_bcast", "gemv_df64_symm_slab_zero")
_FQ_SLAB_TILE = ("gemv_fq_symm_slab_bcast", "gemv_fq_symm_slab_zero")
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
     (("gemv_dfq_symm",), ("gemv_dfq_dual",)), ()),
    # Jacobi-preconditioned, last in their clusters: the gates of the same
    # runs without a preconditioner, x against phase 3's one-device Jacobi
    # x of the same mode (JACOBI_OF)
    ("ring-ir-jacobi", 2, ["--precision", "ir", "--comm", "ring",
                           "--preconditioner", "jacobi"], _RING,
     ("gemv_f32", "gemv_df64")),
    ("packed-irfq-jacobi", 2, ["--precision", "irfq", "--preconditioner",
                               "jacobi"], _QFQ,
     _SLAB + _TRI + _LOCAL_Q + _BF16),
    ("grid-ir-4-jacobi", 4, ["--backend", "sharded2d", "--precision", "ir",
                             "--preconditioner", "jacobi"],
     ("gemv_f32", "gemv_df64"),
     _RING + _SLAB + _TRI + _LOCAL_Q + _QFQ + ("gemv_dfq_symm_slab",)),
    ("symgrid-ir-4-jacobi", 4, _SYMGRID + [
        "--precision", "ir", "--engine", "pallas_symm_packed",
        "--preconditioner", "jacobi"],
     (_TRI, ("gemv_f32_dual", "gemv_df64_dual")), ()))
# phase 5's Jacobi runs -> phase 3's one-device Jacobi run of their mode
JACOBI_OF = {"ring-ir-jacobi": "ir-jacobi",
             "packed-irfq-jacobi": "irfq-jacobi",
             "grid-ir-4-jacobi": "ir-jacobi",
             "symgrid-ir-4-jacobi": "ir-jacobi"}
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
                 "symgrid-irfq-mxu-4": "irfq-cold", **JACOBI_OF}
# the runs through kernels 4, 5 and 6 (the dense_stream walk) and 16, 18,
# 18-bf16 and 19 (the strip walk) -> the iteration count every earlier chip
# run of their precision gave (PERF.md section 2; symgrid-irfq-mxu-4: its
# count on the card before kernel 18-bf16 moved): the walks keep the
# bits, so this run's must be the same
WALK_RUN_ITERS = {"ir-pallas": 365, "df64-pallas": 358, "ring-ir": 365,
                  "gather-df64": 358, "ring-ir-4": 365, "grid-ir-4": 365,
                  "packed-irfq-cold": 375, "packed-irfq-warm": 375,
                  "packed-irfq-4": 375, "symgrid-irfq-cold-4": 375,
                  "symgrid-irfq-warm-4": 375, "symgrid-fq-4": 358,
                  "symgrid-irfq-mxu-4": 394}
LIBRARY_REPEATS = 3  # in-turn timings of kernels 4, 5, 6, 16, 18, 19, 20,
# of the zero-tile walks and of probe P5s
TIMED = True  # off in phase 10's fresh processes: checks only, no timing
FRESH_CHECKS = 2  # phase 10: fresh processes that repeat phase 2's checks
FRESH_TIMEOUT_S = 600  # a fresh process that takes longer is killed
HEAT_IR_ITERS = 4448  # heat `ir` at 1200 x 1000, every chip run (PERF.md 5)
CLUSTER_TIMEOUT_S = 450  # a cluster that takes longer is killed: a hang
DRYRUN_RANKS = 4  # phase 12: rank processes of the dry run on the card
# phase 11: the iteration counts of phase 3's runs (PERF.md section 2),
# which a stopped and resumed run must give in all
CKPT_ITERS = {"df64": 358, "ir": 365, "irfq": 375, "df64-jacobi": 39}
CKPT_STOP = {"df64": 200, "df64-jacobi": 20}  # -i of the stopped CG runs
BLOCK_K = 4  # right-hand sides of phase 11's cg_solve_block
X_GATE = 1e-6        # a sharded x against the one-device ir x, relative
GEN_N = 10000        # phase 8: generate mode's converged runs (-i 10000)
GEN_COUNT_GATE = 0.01  # df64's count against the host f64 CG's, relative
GEN_PROBE_N = 150000   # phase 8: the reference's gen sweep size, -i 15
GEN_PROBE_ITERS = 15
GEN_X_GATE = 1e-10   # the df64 probe's x against the host f64 CG's x
GEN_ERR_GATE = 1e-6  # a probe's residual against the host TRUE residual
TILES_N = 10240      # phase 8's operators over a tile handed in: no padding
TILES_EPS = 2.0 ** -8  # their broadcast tile is TILES_EPS * I
TILES_GRID_N = 2048  # phase 9's grid over a tile handed in: no padding at R=2
_SQUARE = ("gemv_f32_symm_square", "gemv_df64_symm_square")
_BCAST = ("gemv_df64_symm_bcast", "gemv_fq_symm_bcast", "gemv_fq_symm_zero")
# the tile-reading walks of kernels 15, 9, 12, 17 and 19, which generate
# mode's tiles (zeros, counted when its operators are built) never take
_TILE_WALKS = ("gemv_fq_symm_bcast", "gemv_df64_symm_slab_bcast",
               "gemv_df64_dual_bcast", "gemv_fq_symm_slab_bcast",
               "gemv_fq_dual_bcast")
# phase 8: (run, CLI flags, kernels it must launch, kernels it must not
# launch): what lam_tpu's _generate_fast builds on its device
GEN_RUNS = (
    ("gen-df64", ["--precision", "df64"], ("gemv_df64_symm_bcast",),
     ("gemv_df64_symm",) + _SQUARE),
    ("gen-ir", ["--precision", "ir"],
     ("gemv_f32_symm", "gemv_df64_symm_bcast"), ("gemv_df64_symm",)
     + _SQUARE),
    ("gen-fq", ["--precision", "fq"], ("gemv_fq_symm_zero",),
     ("gemv_fq_symm", "gemv_fq_symm_bcast")),
    ("gen-irfq", ["--precision", "irfq"],
     ("gemv_q16_symm", "gemv_fq_symm_zero"),
     ("gemv_fq_symm", "gemv_fq_symm_bcast")),
    ("gen-dfq", ["--precision", "dfq"], ("gemv_dfq_symm",), _BCAST),
    ("gen-irq", ["--precision", "irq"], ("gemv_f32_symm", "gemv_dfq_symm"),
     _BCAST),
    ("gen-df64-pallas_symm", ["--precision", "df64", "--engine",
                              "pallas_symm"], ("gemv_df64_symm_square",),
     ("gemv_df64_symm",) + _BCAST),
    ("gen-ir-pallas_symm", ["--precision", "ir", "--engine", "pallas_symm"],
     _SQUARE, ("gemv_f32_symm", "gemv_df64_symm") + _BCAST),
    ("gen-df64-pallas", ["--precision", "df64", "--engine", "pallas"],
     ("gemv_df64",), _TRI + _SQUARE + _BCAST),
)
# the N=150000 probes: (run, precision, kernels it must launch, the plane
# its accurate matvec streams: "hi" f32 or "q1" int16)
GEN_PROBES = (
    ("gen-df64-150k", "df64", ("gemv_df64_symm_bcast",), "hi"),
    ("gen-ir-150k", "ir", ("gemv_f32_symm", "gemv_df64_symm_bcast"), "hi"),
    ("gen-irfq-150k", "irfq", ("gemv_q16_symm_bf16", "gemv_fq_symm_zero"),
     "q1"),
)


# phase 9, generate mode on the meshes: N=2000 pads to 2048, one tile a
# band at G=2 (the band pairs' least, 2 G tiles) and c = 2 tiles a block
# side at R=2, so the walks meet the within-rank and the cross-block corners
# and a padded edge; the tridiagonal's CG takes N/2 iterations, so the
# converged runs stay short
GEN_MESH_N = 2000
_GEN_SYMGRID = _SYMGRID + ["--engine", "pallas_symm_packed"]
# (run, ranks, CLI flags, kernels it must launch, kernels it must not
# launch); a symmetric-grid run gives (the diagonal ranks' kernels, the
# off-diagonal ranks'), and every other kernel stays at 0 on every rank
MESH_GEN_RUNS = (
    ("gen-ring-ir", 2, ["--precision", "ir", "--comm", "ring"], _RING,
     ("gemv_f32", "gemv_df64")),
    ("gen-slab-ir", 2, ["--precision", "ir", "--engine", "pallas_symm"],
     _SLAB, _SLAB_TILE + _TRI),
    ("gen-packed-df64", 2, ["--precision", "df64", "--engine",
                            "pallas_symm_packed"],
     ("gemv_df64_symm_slab_zero",),
     ("gemv_df64_symm_slab", "gemv_df64_symm_slab_bcast")),
    ("gen-packed-ir", 2, ["--precision", "ir", "--engine",
                          "pallas_symm_packed"],
     ("gemv_f32_symm_slab", "gemv_df64_symm_slab_zero"),
     ("gemv_df64_symm_slab", "gemv_df64_symm_slab_bcast")),
    ("gen-packed-irfq", 2, ["--precision", "irfq"],
     ("gemv_q16_symm_slab", "gemv_fq_symm_slab_zero"),
     ("gemv_fq_symm_slab", "gemv_fq_symm_slab_bcast") + _BF16),
    ("gen-grid-ir-4", 4, _SYMGRID + ["--precision", "ir"],
     ("gemv_f32", "gemv_df64"), _RING + _SLAB + _TRI),
    ("gen-symgrid-df64-4", 4, _GEN_SYMGRID + ["--precision", "df64"],
     (("gemv_df64_symm_bcast",), ("gemv_df64_dual_zero",)), ()),
    ("gen-symgrid-ir-4", 4, _GEN_SYMGRID + ["--precision", "ir"],
     (("gemv_f32_symm", "gemv_df64_symm_bcast"),
      ("gemv_f32_dual", "gemv_df64_dual_zero")), ()),
    ("gen-symgrid-irfq-4", 4, _SYMGRID + ["--precision", "irfq"],
     (("gemv_q16_symm", "gemv_fq_symm_zero"),
      ("gemv_q16_dual", "gemv_fq_dual_zero")), ()))
# the N=150000 probes, after their cluster's converged runs, one at a time:
# (run, ranks, CLI flags, kernels it must launch: every rank's, or the
# diagonal ranks' and the off-diagonal ranks'). Under `auto` the q16 walks
# take lam_tpu's engine: bf16 at n >= 16384, except on the diagonal ranks'
# exact-count triangles (11026 tiles, not a multiple of 8)
MESH_GEN_PROBES = (
    ("gen-packed-df64-150k", 2, ["--precision", "df64", "--engine",
                                 "pallas_symm_packed"],
     ("gemv_df64_symm_slab_zero",)),
    ("gen-packed-irfq-150k", 2, ["--precision", "irfq"],
     ("gemv_q16_symm_slab_bf16", "gemv_fq_symm_slab_zero")),
    ("gen-symgrid-df64-4-150k", 4, _GEN_SYMGRID + ["--precision", "df64"],
     (("gemv_df64_symm_bcast",), ("gemv_df64_dual_zero",))),
    ("gen-symgrid-irfq-4-150k", 4, _SYMGRID + ["--precision", "irfq"],
     (("gemv_q16_symm", "gemv_fq_symm_zero"),
      ("gemv_q16_dual_bf16", "gemv_fq_dual_zero"))))
# phase 9's runs over a tile handed in (TILES_EPS * I for lo, or I for q2
# against s2 = TILES_EPS, every rank), after the cluster's probes: (run,
# ranks, N, (the diagonal ranks' kernels, the off-diagonal ranks'), kernels
# no rank may launch)
MESH_TILES_RUNS = (
    ("tiles-symgrid-df64-4", 4, TILES_GRID_N,
     (("gemv_df64_symm_bcast",), ("gemv_df64_dual_bcast",)),
     ("gemv_df64_dual_zero",)),
    ("tiles-symgrid-fq-4", 4, TILES_GRID_N,
     (("gemv_fq_symm_bcast",), ("gemv_fq_dual_bcast",)),
     ("gemv_fq_symm_zero", "gemv_fq_dual_zero")),)
# phase 13, lam-bench-torch in process: (run, its flags, the rows' num_iter,
# kernels it must launch, kernels it must not); spd mode is bench.py's
# system (phase 3's: seed 2024, rhs seed 2034), so its counts are phase 3's
BENCH_RUNS = (
    ("bench-gen", ["--mode", "gen", "--sizes", str(GEN_N), str(GEN_PROBE_N)],
     GEN_PROBE_ITERS + 1, ("gemv_df64_symm_bcast",),
     ("gemv_df64_symm",) + _SQUARE),
    ("bench-spd-df64", ["--mode", "spd", "--sizes", str(N), "--precision",
                        "df64"], 358, ("gemv_df64_symm",),
     ("gemv_df64_symm_bcast", "gemv_f32_symm")),
    ("bench-spd-ir", ["--mode", "spd", "--sizes", str(N), "--precision",
                      "ir"], 365, ("gemv_f32_symm", "gemv_df64_symm"),
     ("gemv_df64_symm_bcast",)),
    ("bench-spd-irfq-cold", ["--mode", "spd", "--sizes", str(N),
                             "--pack-cache", "--precision", "irfq"], 375,
     ("gemv_q16_symm", "gemv_fq_symm"), ("gemv_q16_symm_bf16",)),
    ("bench-spd-irfq-warm", ["--mode", "spd", "--sizes", str(N),
                             "--pack-cache", "--precision", "irfq"], 375,
     ("gemv_q16_symm", "gemv_fq_symm"), ("gemv_q16_symm_bf16",)))
BENCH_GEN_GATE = 0.10  # the N=150000 row's avg_gemv_s against phase 8's
# phase 13's sharded row, a job of phase 5's 2-rank cluster: spd mode in
# memory, each rank building its own band pair; phase 5's packed-irfq count
BENCH_SHARDED_RUN = "bench-spd-irfq-sharded"
BENCH_SHARDED_FLAGS = ["--mode", "spd", "--sizes", str(N), "--backend",
                       "sharded", "--precision", "irfq"]
BENCH_SHARDED_ITERS = 375
# the q16 walks' kernels, by engine: which one each rank ran
_Q16_WALKS = ("gemv_q16_symm", "gemv_q16_symm_bf16", "gemv_q16_symm_slab",
              "gemv_q16_symm_slab_bf16", "gemv_q16_dual",
              "gemv_q16_dual_bf16")


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
    host more time than the q16 kernel takes on the card (PERF.md §5).
    Where TIMED is off (phase 10's fresh processes), each fn runs once and
    every time is nan: no time is taken."""
    for fn in fns:
        fn()
    if not TIMED:
        torch.cuda.synchronize()
        return [float("nan")] * len(fns)
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


def _against_library(name, kernel, library, earlier, earlier_label,
                     library_label="library"):
    """Kernel against its library call (or, where there is none, its
    control: library_label names it), with the earlier walk on the same
    bytes (or the read floor) beside them, timed in turns LIBRARY_REPEATS
    times in this run: the spread of the kernel/library ratio says how far
    one timing can be trusted (a few % drift between runs, PERF.md §6).
    Returns the kernel's times and the library call's (or control's)."""
    ratios, times, lib_times = [], [], []
    for r in range(LIBRARY_REPEATS):
        ms, lib_ms, old_ms = _median_ms([kernel, library, earlier])
        ratios.append(ms / lib_ms)
        times.append(ms)
        lib_times.append(lib_ms)
        print(f"{name} repeat {r + 1}: kernel {ms:.4f} ms, {library_label} "
              f"{lib_ms:.4f} ms, kernel/{library_label} {ms / lib_ms:.4f}; "
              f"{earlier_label} {old_ms:.4f} ms (/{library_label} "
              f"{old_ms / lib_ms:.4f})")
    print(f"{name} kernel/{library_label} over {LIBRARY_REPEATS} repeats: "
          f"min {min(ratios):.4f}, max {max(ratios):.4f}, spread "
          f"{max(ratios) - min(ratios):.4f}")
    return times, lib_times


# the two-pass walks kept as the strip walk's controls: pass 1's
# instantiation (plane, walk) in the mangled names
TWOPASS_CONTROLS = {"kernel 16's": ("8Q16Plane", "TableWalk"),
                    "kernel 18's": ("8Q16Plane", "8RectWalk"),
                    "kernel 19's": ("7FQPlane", "8RectWalk"),
                    "kernel 15-bcast's": ("11FQTilePlane", "TriangleWalk"),
                    "kernel 9-bcast's": ("13DF64TilePlane", "TableWalk"),
                    "kernel 12-bcast's": ("13DF64TilePlane", "8RectWalk"),
                    "kernel 17-bcast's": ("11FQTilePlane", "TableWalk")}
# the strip walk's instantiations (planes, walk) -> their kernel
STRIP_WALKS = {("StripPlanesILi1E", "TableWalk"): "kernel 16",
               ("StripPlanesILi1E", "RectWalk"): "kernel 18",
               ("StripPlanesILi3E", "RectWalk"): "kernel 19",
               ("StripTilePlanes", "RectWalk"): "kernel 19-bcast",
               ("StripQ1Planes", "TriangleWalk"): "kernel 15-bcast",
               ("StripHiPlanes", "TableWalk"): "kernel 9-bcast",
               ("StripHiPlanes", "RectWalk"): "kernel 12-bcast",
               ("StripQ1Planes", "TableWalk"): "kernel 17-bcast",
               ("StripQ1Planes", "RectWalk"): "kernel 19-bcast zero",
               ("StripPlanesILi1E", "TriangleWalk"): "probe P4s"}
# the strip walk with tensor-core consumers (strip_mma_pass1), by (engine,
# walk) -> its kernel, and the mangled (engine, walk) of its two-pass
# control, q16_bf16_pass1<MODE, Walk>; the engine is MmaMode's value, the
# MODE of its StripCfg
MMA_WALKS = {(0, "RectWalk"): ("kernel 18-bf16", ("ILi0E", "RectWalk")),
             (1, "TriangleWalk"): ("probe P5s", ("ILi1E", "TriangleWalk")),
             (2, "TriangleWalk"): ("probe P5h", ("ILi2E", "TriangleWalk")),
             (3, "TriangleWalk"): ("probe P5y", ("ILi3E", "TriangleWalk"))}


def _strip_walk_of(name):
    return next((k for (planes, walk), k in STRIP_WALKS.items()
                 if planes in name and walk in name), None)


def _mma_walk_of(name):
    """The (engine, walk) key of MMA_WALKS of a strip_mma_pass1 kernel."""
    from lam_tpu_torch.ops import _build
    engine = _build.mma_engine(name)
    return next(((m, walk) for m, walk in MMA_WALKS
                 if engine == m and walk in name), None)


def stream_sass(build):
    """The SASS of the dense_stream kernels (4, 5 and 6) and of the strip
    walks of kernels 16, 18, 18-bf16, 19, 19-bcast, the zero-tile walks
    of 15-bcast, 9-bcast, 12-bcast, 17-bcast and 19-bcast and probes P4s,
    P5s, P5h and P5y holds the TMA bulk copy (UBLKCP); that of the
    dense_rows kernels (3 and the df64 control) and of the strip walks'
    controls (the two-pass walk's pass 1) none; the walks with
    tensor-core consumers (strip_mma_pass1: kernel 18-bf16 on the
    rectangle, P5s, P5h and P5y on the triangle, each of its own engine)
    and their controls (q16_bf16_pass1) hold tensor-core products (HMMA).
    Prints each strip walk's registers from ptxas' report in the build
    log, which must show no spill and no stack frame."""
    kernels = build.sass()
    for key, (label, (mode, ctl_walk)) in MMA_WALKS.items():
        mma = [k for k in kernels
               if "strip_mma_pass1" in k and _mma_walk_of(k) == key]
        mma_ctl = [k for k in kernels if "q16_bf16_pass1" + mode in k
                   and ctl_walk in k]
        _check(len(mma) == 1 and len(mma_ctl) == 1,
               f"SASS: {label}'s strip walk or its control is missing")
        hmma = {k: sum("HMMA" in line for line in kernels[k])
                for k in mma + mma_ctl}
        copies = {k: sum("UBLKCP" in line for line in kernels[k])
                  for k in mma + mma_ctl}
        print(f"SASS {label}: strip walk {copies[mma[0]]} UBLKCP, "
              f"{hmma[mma[0]]} HMMA; two-pass control {copies[mma_ctl[0]]} "
              f"UBLKCP, {hmma[mma_ctl[0]]} HMMA")
        _check(copies[mma[0]] > 0 and copies[mma_ctl[0]] == 0
               and all(hmma.values()),
               f"SASS: {label}'s strip walk lacks UBLKCP or HMMA, or its "
               "control issues a bulk copy")
    walks = {"dense_stream": [], "dense_rows": [], "strip_pass1": [],
             "two-pass control": []}
    for k, lines in kernels.items():
        copies = sum("UBLKCP" in line for line in lines)
        for walk, found in walks.items():
            if walk in k:
                found.append(copies)
        if "symm_pass1" in k and any(
                plane in k and walk in k
                for plane, walk in TWOPASS_CONTROLS.values()):
            walks["two-pass control"].append(copies)
    print(f"SASS bulk copies (UBLKCP) per kernel: {walks}")
    _check(len(walks["dense_stream"]) == 3
           and all(walks["dense_stream"]),
           "a dense_stream kernel issues no TMA bulk copy")
    _check(sorted(filter(None, map(_strip_walk_of, (
        k for k in kernels if "strip_pass1" in k))))
           == sorted(STRIP_WALKS.values())
           and len(walks["strip_pass1"]) == len(STRIP_WALKS)
           and all(walks["strip_pass1"]),
           "a strip walk (kernels 16, 18, 19, 19-bcast, 15-, 9-, 12-, 17- "
           "and 19-bcast on zero tiles, probe P4s) is missing or issues no "
           "TMA bulk copy")
    _check(len(walks["dense_rows"]) == 2
           and len(walks["two-pass control"]) == len(TWOPASS_CONTROLS),
           "SASS: a dense_rows kernel or a strip walk's control is missing")
    _check(not any(walks["dense_rows"] + walks["two-pass control"]),
           "a dense_rows kernel or a strip walk's control issues a TMA bulk "
           "copy")
    log = open(f"{build.build()[0]}.log").read()
    name, report = None, {}
    for line in log.splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line)
        if head:
            k = head.group(1)
            name = (MMA_WALKS[_mma_walk_of(k)][0] if "strip_mma_pass1" in k
                    else _strip_walk_of(k) if "strip_pass1" in k else None)
        elif name and ("registers" in line or "spill" in line):
            report.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    print(f"ptxas, the strip walks: {report}")
    _check(sorted(report) == sorted([
        *STRIP_WALKS.values(), *(label for label, _ in MMA_WALKS.values())])
        and all(
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
        in " ".join(lines) for lines in report.values()),
        "a strip walk spills or has a stack frame")


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
    out += mode_kernels_vs_plain(gemv, layout, a_dev, a32, hi, lo, ph, pl)
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


def _in_turns(label, kernel, sibling, sibling_label):
    """A mode kernel timed in turns with its packed sibling, printed."""
    ms, sib_ms = _median_ms([kernel, sibling])
    print(f"{label} {ms:.4f} ms beside {sibling_label} {sib_ms:.4f} ms "
          f"(x{ms / sib_ms:.4f})")


def mode_kernels_vs_plain(gemv, layout, a_dev, a32, hi, lo, ph, pl):
    """Phase 2, the square walk of kernels 1 and 2 (lam_tpu's
    packed=False) on the full 10240^2 square and the broadcast lo tile of
    kernel 2 on the packed hi plane: each against its plain version and
    the f64 oracle of the stored values, bitwise repeats, the square walk
    equal to the packed walk bit for bit, the zero tile equal to the full
    plane of zeros bit for bit, a non-zero tile; timed beside the library
    call and, in turns, its packed sibling."""
    n_p = a_dev.shape[0]
    nblk = n_p // layout.SYMM_TB
    T = layout.tri_tile_count(nblk)
    flops = 2 * n_p * n_p
    p64 = ph.double() + pl.double()
    sq_lo = (a_dev - a32.double()).float()
    out = []

    # 1-square: the f32 walk over the square's lower tiles, in place
    y = gemv.gemv_f32_symm(a32, ph)
    y_plain = gemv.gemv_f32_symm_square_plain(a32, ph)
    oracle = torch.mv(a32.double(), ph.double())
    torch.cuda.synchronize()
    errs = (_rel(y, y_plain), _rel(y.double(), oracle),
            _rel(y_plain.double(), oracle))
    print(f"gemv_f32_symm_square  rel l2: kernel-plain {errs[0]:.3e}  "
          f"kernel-f64 {errs[1]:.3e}  plain-f64 {errs[2]:.3e}  (<= 1e-5)")
    _check(max(errs) <= 1e-5, "gemv_f32_symm_square disagrees")
    _check(_launched("gemv_f32_symm_square")["gemv_f32_symm_square"] > 0,
           "the square did not take the square walk")
    _check(torch.equal(y, gemv.gemv_f32_symm(hi, ph)),
           "square walk != packed walk, bit for bit")
    _check(torch.equal(y, gemv.gemv_f32_symm_square(a32, ph)),
           "gemv_f32_symm_square not repeatable")
    _check(int(torch.count_nonzero(y[N:])) == 0, "square padding rows != 0")
    del oracle
    # the bytes the walk reads: the T lower tiles (the packed plane's)
    out.append(_timed_entry(
        "gemv_f32_symm_square", "lam_tpu/ops/gemv.py:455", SYMM_SOURCE,
        float((y - y_plain).abs().max()),
        (lambda: gemv.gemv_f32_symm_square(a32, ph),
         lambda: gemv.gemv_f32_symm_square_plain(a32, ph),
         lambda: torch.mv(a32, ph)), (hi, ph, y), flops, "f32"))
    _in_turns("gemv_f32_symm_square",
              lambda: gemv.gemv_f32_symm_square(a32, ph),
              lambda: gemv.gemv_f32_symm(hi, ph), "packed gemv_f32_symm")

    # 2-square: the df64 walk over the (hi, lo) squares' lower tiles
    yh, yl = gemv.gemv_df64_symm(a32, sq_lo, ph, pl)
    qh, ql = gemv.gemv_df64_symm_square_plain(a32, sq_lo, ph, pl)
    y, y_plain = yh.double() + yl.double(), qh.double() + ql.double()
    oracle = torch.mv(a_dev, p64)
    torch.cuda.synchronize()
    errs = (_rel(y, y_plain), _rel(y, oracle), _rel(y_plain, oracle))
    print(f"gemv_df64_symm_square rel l2: kernel-plain {errs[0]:.3e}  "
          f"kernel-f64 {errs[1]:.3e}  plain-f64 {errs[2]:.3e}  (<= 1e-13)")
    _check(max(errs) <= 1e-13, "gemv_df64_symm_square disagrees")
    zh, zl = gemv.gemv_df64_symm(hi, lo, ph, pl)
    _check(torch.equal(yh, zh) and torch.equal(yl, zl),
           "df64 square walk != packed walk, bit for bit")
    zh, zl = gemv.gemv_df64_symm_square(a32, sq_lo, ph, pl)
    _check(torch.equal(yh, zh) and torch.equal(yl, zl),
           "gemv_df64_symm_square not repeatable")
    _check(int(torch.count_nonzero(yh[N:])) == 0
           and int(torch.count_nonzero(yl[N:])) == 0,
           "df64 square padding rows != 0")
    del oracle
    out.append(_timed_entry(
        "gemv_df64_symm_square", "lam_tpu/ops/gemv.py:1008", SYMM_SOURCE,
        float((y - y_plain).abs().max()),
        (lambda: gemv.gemv_df64_symm_square(a32, sq_lo, ph, pl),
         lambda: gemv.gemv_df64_symm_square_plain(a32, sq_lo, ph, pl),
         lambda: torch.mv(a_dev, p64)), (hi, lo, ph, pl, yh, yl), flops,
        "f64"))
    _in_turns("gemv_df64_symm_square",
              lambda: gemv.gemv_df64_symm_square(a32, sq_lo, ph, pl),
              lambda: gemv.gemv_df64_symm(hi, lo, ph, pl),
              "packed gemv_df64_symm")
    del sq_lo
    torch.cuda.empty_cache()

    # 2-bcast: the packed hi plane and ONE lo tile, generate mode's zero
    # tile and a non-zero one
    zero = torch.zeros(layout.SYMM_TB, layout.SYMM_TB, device="cuda")
    yh, yl = gemv.gemv_df64_symm(hi, zero, ph, pl)
    _check(_launched("gemv_df64_symm_bcast")["gemv_df64_symm_bcast"] > 0,
           "the lo tile did not take the broadcast mode")
    zh, zl = gemv.gemv_df64_symm(hi, torch.zeros_like(hi), ph, pl)
    _check(torch.equal(yh, zh) and torch.equal(yl, zl),
           "zero-tile broadcast != the zero lo plane, bit for bit")
    tile = (lo[layout.SYMM_TB:2 * layout.SYMM_TB] * 3.0).contiguous()
    yh, yl = gemv.gemv_df64_symm_bcast(hi, tile, ph, pl)
    qh, ql = gemv.gemv_df64_symm_bcast_plain(hi, tile, ph, pl)
    y, y_plain = yh.double() + yl.double(), qh.double() + ql.double()
    tiles = (hi.double().reshape(T, layout.SYMM_TB, layout.SYMM_TB)
             + tile.double()[None])
    oracle = torch.mv(_dense_of(tiles, nblk, layout), p64)
    del tiles
    torch.cuda.synchronize()
    errs = (_rel(y, y_plain), _rel(y, oracle), _rel(y_plain, oracle))
    print(f"gemv_df64_symm_bcast  rel l2 (a non-zero tile): kernel-plain "
          f"{errs[0]:.3e}  kernel-f64 {errs[1]:.3e}  plain-f64 "
          f"{errs[2]:.3e}  (<= 1e-13)")
    _check(max(errs) <= 1e-13, "gemv_df64_symm_bcast disagrees")
    zh, zl = gemv.gemv_df64_symm_bcast(hi, tile, ph, pl)
    _check(torch.equal(yh, zh) and torch.equal(yl, zl),
           "gemv_df64_symm_bcast not repeatable")
    del oracle
    # timed on generate mode's zero tile; torch.mv over the f64 hi square
    # computes the same function (hi + 0) p
    hi64 = a32.double()
    yh, yl = gemv.gemv_df64_symm_bcast(hi, zero, ph, pl)
    qh, ql = gemv.gemv_df64_symm_bcast_plain(hi, zero, ph, pl)
    out.append(_timed_entry(
        "gemv_df64_symm_bcast", "lam_tpu/ops/gemv.py:991", SYMM_SOURCE,
        float((yh.double() + yl.double() - qh.double() - ql.double())
              .abs().max()),
        (lambda: gemv.gemv_df64_symm_bcast(hi, zero, ph, pl),
         lambda: gemv.gemv_df64_symm_bcast_plain(hi, zero, ph, pl),
         lambda: torch.mv(hi64, p64)), (hi, zero, ph, pl, yh, yl), flops,
        "f64"))
    _in_turns("gemv_df64_symm_bcast",
              lambda: gemv.gemv_df64_symm_bcast(hi, zero, ph, pl),
              lambda: gemv.gemv_f32_symm(hi, ph), "packed gemv_f32_symm")
    del hi64
    torch.cuda.empty_cache()
    return out


def _zero_walk_in_turns(name, bound_ms, kernel, control, sibling,
                       sibling_label, floor, floor_label):
    """A zero-tile kernel against its control (the tile-reading walk on
    the same zero tiles) in turns, LIBRARY_REPEATS times, with its
    full-plane sibling over zero planes and the read floor of the plane
    it streams beside them; prints each repeat and fails unless the walk
    is below its control in every repeat. Returns the walk's times."""
    times, below = [], True
    for r in range(LIBRARY_REPEATS):
        ms, ctl, sib, fl = _median_ms([kernel, control, sibling, floor])
        times.append(ms)
        below = below and ms < ctl
        print(f"{name} repeat {r + 1}: zero-tile walk {ms:.4f} ms, "
              f"tile-reading control {ctl:.4f} ms (x{ms / ctl:.4f}), "
              f"{sibling_label} {sib:.4f} ms, {floor_label} {fl:.4f} ms; "
              f"bound {bound_ms:.4f} ms ({bound_ms / ms:.2f} of it)")
    print(f"{name} zero-tile walk over {LIBRARY_REPEATS} repeats: "
          f"{min(times):.4f}-{max(times):.4f} ms; below its control in "
          f"every repeat: {below}")
    _check(below or not TIMED, f"{name}: the zero-tile walk is not faster "
           "than its control in every repeat")
    return times


def fq_bcast_vs_plain(gemv, layout, fq, ph, pl):
    """Phase 2, kernel 15's broadcast q2/q3 tiles on the fq pack's q1: the
    tile-reading walk (gemv_fq_symm_bcast) and the kernel for tiles of
    zeros (gemv_fq_symm_zero, the strip walk over q1 alone). Zero tiles
    equal to the zero planes bit for bit, the zero kernel's too (with the
    pack's own non-zero s2 and s3); non-zero tiles (and one tile beside a
    full plane) against the plain version and the f64 oracle of the stored
    values, bitwise repeats; each timed on generate mode's zero tiles (its
    `kernels` entry), the zero kernel in turns LIBRARY_REPEATS times with
    the tile-reading walk (its control), kernel 15 over zero planes and
    lam_stream_i16 on q1, and once beside kernel 15 (full planes) and
    kernel 14. Returns both entries."""
    from lam_tpu_torch.ops import probe
    tb = layout.SYMM_TB
    nblk = layout.padded_size(N, tb) // tb
    T = layout.tri_tile_count(nblk)
    flops = 2 * (nblk * tb) ** 2
    q1, q2, q3, s1, s2, s3 = fq[:6]
    p = ph.double() + pl.double()
    zt = torch.zeros(tb, tb, dtype=torch.int16, device="cuda")
    yh, yl = gemv.gemv_fq_symm(q1, zt, zt, s1, s2, s3, ph, pl)
    _check(_launched("gemv_fq_symm_bcast")["gemv_fq_symm_bcast"] > 0,
           "the q2/q3 tiles did not take the broadcast mode")
    zp = torch.zeros_like(q1)
    zh, zl = gemv.gemv_fq_symm(q1, zp, zp, s1, s2, s3, ph, pl)
    _check(torch.equal(yh, zh) and torch.equal(yl, zl),
           "zero-tile broadcast != the zero q2/q3 planes, bit for bit")
    wh, wl = gemv.gemv_fq_symm_zero(q1, s1, ph, pl)
    _check(torch.equal(wh, zh) and torch.equal(wl, zl),
           "gemv_fq_symm_zero != the zero q2/q3 planes, bit for bit")
    print("gemv_fq_symm_bcast    zero tiles, and gemv_fq_symm_zero (q1 "
          "alone), == zero planes bit for bit")
    del zp
    for t2, t3 in ((q2[tb:2 * tb].clone(), q3[:tb].clone()),
                   (q2[:tb].clone(), q3)):
        yh, yl = gemv.gemv_fq_symm_bcast(q1, t2, t3, s1, s2, s3, ph, pl)
        qh, ql = gemv.gemv_fq_symm_bcast_plain(q1, t2, t3, s1, s2, s3, ph,
                                                pl)
        y, y_plain = yh.double() + yl.double(), qh.double() + ql.double()
        tiles = sum(q.double().reshape(-1, tb, tb)[:T]
                    * s[:T].double()[:, None, None]
                    for q, s in ((q1, s1), (t2, s2), (t3, s3)))
        oracle = torch.mv(_dense_of(tiles, nblk, layout), p)
        del tiles
        torch.cuda.synchronize()
        errs = (_rel(y, y_plain), _rel(y, oracle), _rel(y_plain, oracle))
        print(f"gemv_fq_symm_bcast    rel l2 (q3 {tuple(t3.shape)}): "
              f"kernel-plain {errs[0]:.3e}  kernel-f64 {errs[1]:.3e}  "
              f"plain-f64 {errs[2]:.3e}  (<= 1e-13)")
        _check(max(errs) <= 1e-13, "gemv_fq_symm_bcast disagrees")
        zh, zl = gemv.gemv_fq_symm_bcast(q1, t2, t3, s1, s2, s3, ph, pl)
        _check(torch.equal(yh, zh) and torch.equal(yl, zl),
               "gemv_fq_symm_bcast not repeatable")
        del oracle
    zero_args = (q1, zt, zt, s1, s2, s3, ph, pl)
    yh, yl = gemv.gemv_fq_symm_bcast(*zero_args)
    qh, ql = gemv.gemv_fq_symm_bcast_plain(*zero_args)
    out = [_timed_entry(
        "gemv_fq_symm_bcast", "lam_tpu/ops/gemv.py:2164", SYMM_SOURCE,
        float((yh.double() + yl.double() - qh.double() - ql.double())
              .abs().max()),
        (lambda: gemv.gemv_fq_symm_bcast(*zero_args),
         lambda: gemv.gemv_fq_symm_bcast_plain(*zero_args), None),
        (q1[:T * tb], zt, zt, *(s[:T] for s in (s1, s2, s3)), ph, pl, yh,
         yl), flops, "f64")]
    wh, wl = gemv.gemv_fq_symm_zero(q1, s1, ph, pl)
    qh, ql = gemv.gemv_fq_symm_zero_plain(q1, s1, ph, pl)
    out.append(_timed_entry(
        "gemv_fq_symm_zero", "lam_tpu/ops/gemv.py:2164",
        "lam_tpu_torch/csrc/strip_walk.cuh",
        float((wh.double() + wl.double() - qh.double() - ql.double())
              .abs().max()),
        (lambda: gemv.gemv_fq_symm_zero(q1, s1, ph, pl),
         lambda: gemv.gemv_fq_symm_zero_plain(q1, s1, ph, pl), None),
        (q1[:T * tb], s1[:T], ph, pl, wh, wl), flops, "f64"))
    zp = torch.zeros_like(q1)
    _zero_walk_in_turns(
        "gemv_fq_symm_zero", out[-1]["bound_ms"],
        lambda: gemv.gemv_fq_symm_zero(q1, s1, ph, pl),
        lambda: gemv.gemv_fq_symm_bcast(*zero_args),
        lambda: gemv.gemv_fq_symm(q1, zp, zp, s1, s2, s3, ph, pl),
        "gemv_fq_symm over zero planes",
        lambda: probe.stream_i16(q1[:T * tb]), "lam_stream_i16 on q1")
    del zp
    _pass_split("gemv_fq_symm_zero and its control (gemv_fq_symm_bcast on "
                "zero tiles)", {
                    "walk": lambda: gemv.gemv_fq_symm_zero(q1, s1, ph, pl),
                    "control": lambda: gemv.gemv_fq_symm_bcast(*zero_args)})
    _in_turns("gemv_fq_symm_zero",
              lambda: gemv.gemv_fq_symm_zero(q1, s1, ph, pl),
              lambda: gemv.gemv_fq_symm(*fq[:6], ph, pl),
              "gemv_fq_symm (full planes)")
    _in_turns("gemv_fq_symm_zero",
              lambda: gemv.gemv_fq_symm_zero(q1, s1, ph, pl),
              lambda: gemv.gemv_q16_symm(q1, s1, ph), "gemv_q16_symm")
    return out


def dense_kernels_vs_plain(gemv, a_dev, a32, ph, pl):
    """Phase 2, the full-square engine: the dense f32 and df64 kernels on
    the 10240^2 square."""
    from lam_tpu_torch.ops import probe
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
    # the earlier walk on the same square: the df64 control (dense_rows)
    # with one column block of the full width gives the same bits
    zh, zl = probe.gemv_df64_rows(ah, al, ph, pl, 0)
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
                     lambda: probe.gemv_df64_rows(ah, al, ph, pl, 0),
                     "dense_rows (gemv_df64_rows, one block)")
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
    out += fq_bcast_vs_plain(gemv, layout, fq, ph, pl)
    return out


def probe_kernels_vs_plain(gemv, layout, q1, s1, ph, exact):
    """Phase 2, the q16 probes (lam_tpu_torch/ops/probe.py) at N=10240: the
    walks magic, sub8, split, hi and hybrid on kernel 14's plane (the fq
    pack's q1) against their plain versions (PROBE_TOL), padding rows 0,
    bitwise repeats; magic equal to kernel 14's exact result `exact` bit
    for bit and its SASS free of int -> f32 conversions; sub8 (the strip
    walk's summing consumers, each warp's transpose row kept) and split,
    hi and hybrid (its tensor-core consumers, printed beside the bf16
    engine's gap) equal to their two-pass controls bit for bit and timed
    against them in turns with the read floor, their passes split by
    torch.profiler, each failing unless below its control in every
    repeat; tb1024 on a random int16 plane
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
        if name in TC_WALKS:
            line += (", bf16 engine-plain "
                     f"{_rel(gemv.gemv_q16_symm_bf16(q, s, p), y_plain):.3e}")
        if name in STRIP_PROBES:  # the strip walk: its control's bits
            control = getattr(probe, f"gemv_q16_symm_{name}_twopass")
            same = torch.equal(y, control(q, s, p))
            line += f", == its two-pass control bitwise: {same}"
            _check(same, f"the {name} walk != its two-pass control")
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

    for name in ("magic", *STRIP_PROBES):
        out.append(entry(name, q1, s1, ph, plane))
    for name in STRIP_PROBES:
        walk = getattr(probe, f"gemv_q16_symm_{name}")
        control = getattr(probe, f"gemv_q16_symm_{name}_twopass")
        e = next(e for e in out if e["name"] == walk.__name__)
        consumers = ("tensor-core consumers" if name in TC_WALKS else
                     "each warp's transpose row kept")
        times, ctl = _walk_against_control(
            walk.__name__, e["bound_ms"], lambda w=walk: w(q1, s1, ph),
            lambda c=control: c(q1, s1, ph),
            lambda: probe.stream_i16(plane), "read floor (lam_stream_i16)",
            where=f"(strip walk, {consumers}) at N=10240")
        _check(all(t < c for t, c in zip(times, ctl)) or not TIMED,
               f"{walk.__name__}: the strip walk is not faster than its "
               "two-pass control in every repeat")
        e["control"] = control.__name__
        e["control_ms"] = statistics.median(ctl)
        _pass_split(f"{walk.__name__} and its two-pass control", {
            "walk": lambda w=walk: w(q1, s1, ph),
            "control": lambda c=control: c(q1, s1, ph)})

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
    matvec of the whole square; kernels 5 and 6 (dense_stream) bit for bit
    equal to the dense_rows walk on every block."""
    from lam_tpu_torch.ops import probe
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
            zh, zl = probe.gemv_df64_rows(hi, lo, ph[cols], pl[cols], blk)
            _check(torch.equal(yh, zh) and torch.equal(yl, zl),
                   "gemv_df64_cols (dense_stream) != the dense_rows walk")
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
          f"{max(errs64):.3e} (<= 1e-13); bits == dense_rows "
          "(gemv_df64_rows) on every block")
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
    _against_library("gemv_df64_cols",
                     lambda: gemv.gemv_df64_cols(hi, lo, p_blk, pl_blk, 1),
                     lambda: torch.mv(a64[:, cols], p64_blk),
                     lambda: probe.gemv_df64_rows(hi, lo, p_blk, pl_blk, 1),
                     "dense_rows (gemv_df64_rows)")
    return out


def cols_g4(gemv, pcg, Mesh, a, p):
    """Kernels 5 and 6 at rank 0's column block 1 of the G=4 row shards
    (the ring-ir-4 step): against their plain versions (kernel 6 also bit
    for bit against dense_rows), then timed beside torch.mv on the strided
    view and dense_rows (kernel 5: on a contiguous copy); kernel 6 over
    three copies of the shard taken in turn (its 52.4 MB block would stay
    in the 50 MB L2). Printed only."""
    from lam_tpu_torch.ops import probe
    g = SHARD_G[1]
    op = pcg.ShardedDenseOperator.from_row_block_fn(
        lambda s, k: a[s:s + k], N, mesh=Mesh(0, g, "cuda"),
        precision="df64")
    hi, m = op.operand[0], op.m
    cols = slice(m, 2 * m)
    ph, pl, _ = _pair(p, op.n_padded)
    p_blk, pl_blk = ph[cols].clone(), pl[cols].clone()
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
    del block
    lo = op.operand[1]
    yh, yl = gemv.gemv_df64_cols(hi, lo, p_blk, pl_blk, 1)
    qh, ql = gemv.gemv_df64_cols_plain(hi, lo, p_blk, pl_blk, 1)
    err = _rel(yh.double() + yl.double(), qh.double() + ql.double())
    zh, zl = probe.gemv_df64_rows(hi, lo, p_blk, pl_blk, 1)
    print(f"gemv_df64_cols G={g}: rel l2 kernel-plain {err:.3e} (<= 1e-13), "
          f"bits == dense_rows: {torch.equal(yh, zh) and torch.equal(yl, zl)}")
    _check(err <= 1e-13, "gemv_df64_cols disagrees at G=4")
    _check(torch.equal(yh, zh) and torch.equal(yl, zl),
           "gemv_df64_cols (dense_stream) != the dense_rows walk at G=4")
    p64_blk = p_blk.double() + pl_blk.double()
    copies = [(h, l, h.double() + l.double()) for h, l in
              [(hi, lo)] + [(hi.clone(), lo.clone()) for _ in range(2)]]
    gb = _nbytes(hi[:, cols], lo[:, cols], p_blk, pl_blk, yh, yl) / 1e9
    print(f"gemv_df64_cols G={g} [{gb * 1e3:.1f} MB, three copies in turn; "
          f"bound {gb / HBM_BYTES_PER_S * 1e12:.4f} ms]:")
    _against_library(
        f"gemv_df64_cols G={g}",
        _rotating(lambda c: gemv.gemv_df64_cols(c[0], c[1], p_blk, pl_blk, 1),
                  copies),
        _rotating(lambda c: torch.mv(c[2][:, cols], p64_blk), copies),
        _rotating(lambda c: probe.gemv_df64_rows(c[0], c[1], p_blk, pl_blk,
                                                 1), copies),
        "dense_rows (gemv_df64_rows)")


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
    accurate). Kernel 16 (the fq storage's inner walk) is also held bit for
    bit to its control, the two-pass walk, on every rank's tables."""
    from lam_tpu_torch.ops import probe
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
        if storage == "fq":  # kernel 16's strip walk against its control
            zd, zt = probe.gemv_q16_symm_slab_twopass(
                op.operand[0], op.operand[3], ph, it, kt, lt, ms=2 * m)
            _check(torch.equal(yd, zd) and torch.equal(yt, zt),
                   f"{label} rank {c}: gemv_q16_symm_slab (strip walk) != "
                   "the two-pass walk")
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
          f"{max(errs32):.3e} (<= 1e-5"
          f"{'; bits == the two-pass walk' if storage == 'fq' else ''}), "
          f"gemv_{storage}_symm_slab "
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
    (one 55.1 or 39.3 MB plane would stay in the 50 MB L2), and against its
    control, the two-pass walk, in turns with the read floor."""
    from lam_tpu_torch.ops import probe
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
                 "gemv_q16_symm_slab_twopass": _rotating(
                     lambda q: probe.gemv_q16_symm_slab_twopass(
                         q, s1, ph, it, kt, lt, ms=ms), copies),
                 "gemv_q16_symm_slab_bf16": _rotating(
                     lambda q: gemv.gemv_q16_symm_slab_bf16(
                         q, s1, ph, it, kt, lt, ms=ms), copies)},
                _nbytes(q1, s1, ph, it, kt, lt, yd, yt))
        print(f"gemv_q16_symm_slab (strip walk) at rank 0 of G={g} "
              f"(T={T}), three copies in turn; bound "
              f"{entries[0]['bound_ms']:.4f} ms:")
        _against_library(
            f"gemv_q16_symm_slab G={g}",
            _rotating(lambda q: gemv.gemv_q16_symm_slab(
                q, s1, ph, it, kt, lt, ms=ms), copies),
            _rotating(lambda q: probe.gemv_q16_symm_slab_twopass(
                q, s1, ph, it, kt, lt, ms=ms), copies),
            _rotating(probe.stream_i16, copies), "read floor (lam_stream_i16)",
            library_label="two-pass")
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
# the dual kernels on the strip walk -> their controls (ops/probe.py)
DUAL_CONTROLS = {"gemv_q16_dual": "gemv_q16_dual_twopass",
                 "gemv_fq_dual": "gemv_fq_dual_twopass",
                 "gemv_q16_dual_bf16": "gemv_q16_dual_bf16_twopass"}
KERNEL_TARGET_MS = {"gemv_q16_dual": 0.0156, "gemv_fq_dual": 0.0470,
                    "gemv_q16_dual_bf16": 0.0156, "laplace5_f32_halo": 0.0062}
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
    S^T q). Kernels 18 and 19 (gemv_q16_dual, gemv_fq_dual) run the strip
    walk: on both off-diagonal ranks, with the pads as they are and with
    garbage pads, their outputs equal their controls' (the two-pass walk,
    ops/probe.py DUAL_CONTROLS) bit for bit; at rank (1, 0) each is timed
    against its control in turns LIBRARY_REPEATS times, kernel 18 over the
    three copies beside the read floor of its plane, kernel 19 beside the
    read floor of its three planes (lam_stream_i16 over q1, q2 and q3, one
    launch each)."""
    from lam_tpu_torch.ops import probe
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
                out = kernel(*bufs, *vecs)
                y = _cat_parts(out)
                q = _cat_parts(getattr(gemv, name + "_plain")(*bufs, *vecs))
                garbage = _with_garbage_pads(bufs, mb * cb, tb)
                if name in DUAL_CONTROLS:  # the strip walk's bits
                    control = getattr(probe, DUAL_CONTROLS[name])
                    for b in (bufs, garbage):
                        _check(all(torch.equal(u, v) for u, v in zip(
                            out, control(*b, *vecs))), f"{name} rank {k}: "
                            "the strip walk != the two-pass walk")
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
                _check(torch.equal(y, _cat_parts(kernel(*garbage, *vecs))),
                       f"{name} rank {k} read a pad tile or a pad scale")
                del garbage
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
        walks = [x for x in (inner, acc) if x in DUAL_CONTROLS]
        print(f"dual kernels, 2x2 grid {storage} (tb={tb}, half-slab ({m2}, "
              f"{m}), {mb * cb} real + {mb} pad tiles a rank; 4 rank packs in "
              f"{pack_s:.2f} s): rel l2 kernel-plain / kernel-f64 max {inner} "
              f"{max(errs[inner]):.3e} (<= 1e-5), {acc} {max(errs[acc]):.3e} "
              f"(<= 1e-13); ranks' (own, payload) summed vs the one-device "
              f"kernels: inner {e32:.3e} (<= 1e-5), accurate {e64:.3e} "
              f"(<= 1e-13)" + (f"; {', '.join(walks)} (strip walk) == the "
                               "two-pass walk bit for bit on both ranks, "
                               "garbage pads too" if walks else ""))
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
        {name: _rotating(lambda q, fn=fn: fn(q, bufs[1][:real], *vec32),
                         copies)
         for name, fn in (("gemv_q16_dual", gemv.gemv_q16_dual),
                          ("gemv_q16_dual_bf16", gemv.gemv_q16_dual_bf16),
                          ("gemv_q16_dual_twopass",
                           probe.gemv_q16_dual_twopass),
                          ("gemv_q16_dual_bf16_twopass",
                           probe.gemv_q16_dual_bf16_twopass))},
        _nbytes(q1, bufs[1][:real], *vec32, *gemv.gemv_q16_dual(*bufs,
                                                                 *vec32)))
    _walk_against_control(
        "gemv_q16_dual", entries["gemv_q16_dual"]["bound_ms"],
        _rotating(lambda q: gemv.gemv_q16_dual(q, bufs[1][:real], *vec32),
                  copies),
        _rotating(lambda q: probe.gemv_q16_dual_twopass(
            q, bufs[1][:real], *vec32), copies),
        _rotating(probe.stream_i16, copies), "read floor (lam_stream_i16)")
    _walk_against_control(
        "gemv_q16_dual_bf16", entries["gemv_q16_dual_bf16"]["bound_ms"],
        _rotating(lambda q: gemv.gemv_q16_dual_bf16(q, bufs[1][:real],
                                                    *vec32), copies),
        _rotating(lambda q: probe.gemv_q16_dual_bf16_twopass(
            q, bufs[1][:real], *vec32), copies),
        _rotating(probe.stream_i16, copies), "read floor (lam_stream_i16)")
    _pass_split("gemv_q16_dual_bf16 at rank (1, 0), kernel and two-pass "
                "control, three copies in turn", {
                    "kernel": _rotating(lambda q: gemv.gemv_q16_dual_bf16(
                        q, bufs[1][:real], *vec32), copies),
                    "control": _rotating(
                        lambda q: probe.gemv_q16_dual_bf16_twopass(
                            q, bufs[1][:real], *vec32), copies)})
    del copies
    fq6 = list(fq.operand[:6])
    entry("gemv_fq_dual", fq6, vec64, None, "f64")
    planes = [x[:real * tb] for x in fq6[:3]]
    for x in planes:
        _check(int(probe.stream_i16(x)) == int(probe.stream_i16_plain(x)),
               "lam_stream_i16's checksum is wrong on an fq plane")
    _walk_against_control(
        "gemv_fq_dual", entries["gemv_fq_dual"]["bound_ms"],
        lambda: gemv.gemv_fq_dual(*fq6, *vec64),
        lambda: probe.gemv_fq_dual_twopass(*fq6, *vec64),
        lambda: [probe.stream_i16(x) for x in planes],
        "three-plane read floor (lam_stream_i16 over q1, q2, q3, summed)")
    return [entries[name] for name in DUAL_REPLACES]


def _tile_checks(gemv, name, zero_args, cases, full, oracle, kw):
    """One broadcast mode's checks on the card: the kernel `name` on
    `zero_args` (zero tiles) equal, bit for bit, to `full()` (the
    full-plane kernel over zero planes); on each of `cases` (non-zero
    tiles) against its plain version and `oracle(*args)` (the f64 oracle
    of the stored values) at 1e-13, and repeated bitwise; `kw` the
    keyword arguments of every call. Returns the largest kernel-plain
    difference on the zero tiles."""
    kernel, plain = getattr(gemv, name), getattr(gemv, name + "_plain")
    out = kernel(*zero_args, **kw)
    _check(all(torch.equal(u, v) for u, v in zip(out, full())),
           f"{name}: zero tiles != the full-plane kernel over zero planes, "
           "bit for bit")
    errs = []
    for args in cases:
        got = kernel(*args, **kw)
        y, q = _cat_parts(got), _cat_parts(plain(*args, **kw))
        want = oracle(*args)
        errs += [_rel(y, q), _rel(y, want), _rel(q, want)]
        _check(all(torch.equal(u, v) for u, v in zip(got, kernel(*args,
                                                                  **kw))),
               f"{name} not repeatable")
    print(f"{name:<26} zero tiles == zero planes bit for bit; rel l2 on "
          f"non-zero tiles (kernel-plain, kernel-f64, plain-f64) max "
          f"{max(errs):.3e} (<= 1e-13)")
    _check(max(errs) <= 1e-13, f"{name} disagrees")
    return float((_cat_parts(out) - _cat_parts(plain(*zero_args, **kw)))
                 .abs().max())


def bcast_modes_vs_plain(gemv, pcg_symm, pcg2d_symm, Mesh, Mesh2D, a, p):
    """Phase 2, the broadcast modes of kernels 9, 17, 12 and 19 (generate
    mode on the meshes: one 512 x 512 tile for lo, or for q2 and q3, that
    every tile reads). At rank 0 of G=2 (105 tiles, where rows 9 and 17 are
    timed) and rank (1, 0)'s (2560, 5120) half-slab (rows 12 and 19), on
    the N=10000 system's packs: zero tiles equal to the full-plane kernel
    over zero planes, bit for bit; non-zero tiles (and for the fq modes one
    tile beside a full plane) against the plain version and the f64 oracle
    of the stored values at 1e-13; bitwise repeats. Timed on zero tiles,
    in turns with the full-plane sibling on the same hi or q1 plane; the
    q1 planes (55.1 and 26.2 MB) and the hi planes (110.1 and 52.4 MB)
    over three copies taken in turn, which the 50 MB L2 cannot hold.
    Kernel 9's kernel for a lo tile of zeros (gemv_df64_symm_slab_zero,
    the strip walk over hi alone): equal bit for bit to the zero plane and
    to its control, the tile-reading walk (on a +0.0 and a -0.0 tile),
    timed so and in turns LIBRARY_REPEATS times with the control, kernel 9
    over a zero plane and lam_stream_i16 over hi's bytes. Kernels 17's and
    12's kernels for tiles of zeros (gemv_fq_symm_slab_zero over q1 alone,
    gemv_df64_dual_zero over the hi rectangle alone) the same way, with
    kernels 16 and 11 on the same copies as their siblings and, for 12, two
    torch.mv over the f64 hi rectangle as its library call."""
    from lam_tpu_torch.ops import probe
    tb, out = 512, []
    # band pairs, rank 0 of G=2
    mesh = Mesh(0, 2, "cuda")
    df = pcg_symm.SymmShardedOperator.from_row_block_fn(
        lambda s, k: a[s:s + k], N, mesh=mesh, packed=True)
    fq = pcg_symm.SymmShardedOperator.from_row_block_fn(
        lambda s, k: a[s:s + k], N, mesh=mesh, precision="fq")
    ph, pl, p64 = _pair(p, df.n_padded)
    hi, lo, it, kt, lt = df.operand
    walk, ms, T = (it, kt, lt), 2 * df.m, it.shape[0]
    kw = {"ms": ms}
    zero = torch.zeros(tb, tb, device="cuda")
    flops = 2 * tb * tb * (T + int((kt < it).sum()))

    def slab_oracle(tiles):
        return torch.cat(gemv._slab_parts(tiles, p64, *walk, ms, tb, True))

    diff = _tile_checks(
        gemv, "gemv_df64_symm_slab_bcast", (hi, zero, ph, pl, *walk),
        [(hi, lo[:tb] * 3.0, ph, pl, *walk)],
        lambda: gemv.gemv_df64_symm_slab(hi, torch.zeros_like(hi), ph, pl,
                                         *walk, ms=ms, packed=True),
        lambda h, t, *_: slab_oracle(h.double() + t.double().repeat(T, 1)),
        kw)
    copies = [hi, hi.clone(), hi.clone()]
    outs = gemv.gemv_df64_symm_slab_bcast(hi, zero, ph, pl, *walk, ms=ms)
    out.append(_timed_entry(
        "gemv_df64_symm_slab_bcast", "lam_tpu/ops/gemv.py:991", SYMM_SOURCE,
        diff, (_rotating(lambda h: gemv.gemv_df64_symm_slab_bcast(
            h, zero, ph, pl, *walk, ms=ms), copies),
            _rotating(lambda h: gemv.gemv_df64_symm_slab_bcast_plain(
                h, zero, ph, pl, *walk, ms=ms), copies), None),
        (hi, zero, ph, pl, *walk, *outs), flops, "f64"))
    # the kernel for a lo tile of zeros, hi alone: the zero plane's bits
    # and the tile-reading walk's on a +0.0 and a -0.0 tile
    full = gemv.gemv_df64_symm_slab(hi, torch.zeros_like(hi), ph, pl, *walk,
                                    ms=ms, packed=True)
    outs = gemv.gemv_df64_symm_slab_zero(hi, ph, pl, *walk, ms=ms)
    for got in (outs, gemv.gemv_df64_symm_slab_bcast(
            hi, torch.full_like(zero, -0.0), ph, pl, *walk, ms=ms)):
        _check(all(torch.equal(u, v) for u, v in zip(got, full)),
               "gemv_df64_symm_slab_zero or the tile-reading walk on a "
               "-0.0 tile != the zero lo plane, bit for bit")
    print("gemv_df64_symm_slab_zero (hi alone), and the tile-reading walk on "
          "+0.0 and -0.0 tiles, == zero plane bit for bit")
    del full
    diff = float((_cat_parts(outs) - _cat_parts(
        gemv.gemv_df64_symm_slab_zero_plain(hi, ph, pl, *walk, ms=ms)))
        .abs().max())
    entry = _timed_entry(
        "gemv_df64_symm_slab_zero", "lam_tpu/ops/gemv.py:991",
        "lam_tpu_torch/csrc/strip_walk.cuh", diff,
        (_rotating(lambda h: gemv.gemv_df64_symm_slab_zero(
            h, ph, pl, *walk, ms=ms), copies),
         _rotating(lambda h: gemv.gemv_df64_symm_slab_zero_plain(
             h, ph, pl, *walk, ms=ms), copies), None),
        (hi, ph, pl, *walk, *outs), flops, "f64")
    out.append(entry)
    zlo = torch.zeros_like(hi)
    _zero_walk_in_turns(
        "gemv_df64_symm_slab_zero (three hi copies)", entry["bound_ms"],
        _rotating(lambda h: gemv.gemv_df64_symm_slab_zero(
            h, ph, pl, *walk, ms=ms), copies),
        _rotating(lambda h: gemv.gemv_df64_symm_slab_bcast(
            h, zero, ph, pl, *walk, ms=ms), copies),
        _rotating(lambda h: gemv.gemv_df64_symm_slab(
            h, zlo, ph, pl, *walk, ms=ms, packed=True), copies),
        "gemv_df64_symm_slab over a zero lo plane",
        _rotating(lambda h: probe.stream_i16(h.view(torch.int16)), copies),
        "lam_stream_i16 over hi's bytes")
    del zlo
    _pass_split("gemv_df64_symm_slab_zero and its control "
                "(gemv_df64_symm_slab_bcast on a zero tile)", {
                    "walk": lambda: gemv.gemv_df64_symm_slab_zero(
                        hi, ph, pl, *walk, ms=ms),
                    "control": lambda: gemv.gemv_df64_symm_slab_bcast(
                        hi, zero, ph, pl, *walk, ms=ms)})
    _in_turns("gemv_df64_symm_slab_zero (three hi copies)",
              _rotating(lambda h: gemv.gemv_df64_symm_slab_zero(
                  h, ph, pl, *walk, ms=ms), copies),
              _rotating(lambda h: gemv.gemv_df64_symm_slab(
                  h, lo, ph, pl, *walk, ms=ms, packed=True), copies),
              "gemv_df64_symm_slab (full lo plane)")
    _in_turns("gemv_df64_symm_slab_zero (three hi copies)",
              _rotating(lambda h: gemv.gemv_df64_symm_slab_zero(
                  h, ph, pl, *walk, ms=ms), copies),
              _rotating(lambda h: gemv.gemv_f32_symm_slab(
                  h, ph, *walk, ms=ms, packed=True), copies),
              "gemv_f32_symm_slab on the same hi copies")
    del df, hi, lo, copies

    q1, q2, q3, s1, s2, s3 = fq.operand[:6]
    zt = torch.zeros(tb, tb, dtype=torch.int16, device="cuda")
    zp = torch.zeros_like(q1)

    def fq_tiles(a1, t2, t3):
        return sum(gemv._tile_plane(q, a1).double()
                   * s.double().repeat_interleave(tb)[:, None]
                   for q, s in ((a1, s1), (t2, s2), (t3, s3)))

    rest = (s1, s2, s3, ph, pl, *walk)
    diff = _tile_checks(
        gemv, "gemv_fq_symm_slab_bcast", (q1, zt, zt, *rest),
        [(q1, q2[(T - 1) * tb:].clone(), q3[:tb].clone(), *rest),
         (q1, q2[:tb].clone(), q3, *rest)],
        lambda: gemv.gemv_fq_symm_slab(q1, zp, zp, *rest, ms=ms),
        lambda a1, t2, t3, *_: slab_oracle(fq_tiles(a1, t2, t3)), kw)
    del zp
    copies = [q1, q1.clone(), q1.clone()]
    outs = gemv.gemv_fq_symm_slab_bcast(q1, zt, zt, *rest, ms=ms)
    out.append(_timed_entry(
        "gemv_fq_symm_slab_bcast", "lam_tpu/ops/gemv.py:2405", SYMM_SOURCE,
        diff, (_rotating(lambda q: gemv.gemv_fq_symm_slab_bcast(
            q, zt, zt, *rest, ms=ms), copies),
            _rotating(lambda q: gemv.gemv_fq_symm_slab_bcast_plain(
                q, zt, zt, *rest, ms=ms), copies), None),
        (q1, zt, zt, *rest, *outs), flops, "f64"))
    _in_turns("gemv_fq_symm_slab_bcast (three q1 copies)",
              _rotating(lambda q: gemv.gemv_fq_symm_slab_bcast(
                  q, zt, zt, *rest, ms=ms), copies),
              lambda: gemv.gemv_fq_symm_slab(q1, q2, q3, *rest, ms=ms),
              "gemv_fq_symm_slab (full planes)")
    _in_turns("gemv_fq_symm_slab_bcast (three q1 copies)",
              _rotating(lambda q: gemv.gemv_fq_symm_slab_bcast(
                  q, zt, zt, *rest, ms=ms), copies),
              _rotating(lambda q: gemv.gemv_q16_symm_slab(
                  q, s1, ph, *walk, ms=ms), copies),
              "gemv_q16_symm_slab on the same q1 copies")
    # the kernel for q2/q3 tiles of zeros, q1 alone: the zero planes' bits
    # and the tile-reading walk's
    zp = torch.zeros_like(q1)
    full = gemv.gemv_fq_symm_slab(q1, zp, zp, *rest, ms=ms)
    del zp
    outs = gemv.gemv_fq_symm_slab_zero(q1, s1, ph, pl, *walk, ms=ms)
    for got in (outs, gemv.gemv_fq_symm_slab_bcast(q1, zt, zt, *rest,
                                                    ms=ms)):
        _check(all(torch.equal(u, v) for u, v in zip(got, full)),
               "gemv_fq_symm_slab_zero or the tile-reading walk != the zero "
               "q2/q3 planes, bit for bit")
    del full
    zero_plain = _cat_parts(gemv.gemv_fq_symm_slab_zero_plain(
        q1, s1, ph, pl, *walk, ms=ms))
    err = _rel(_cat_parts(outs), zero_plain)
    print(f"gemv_fq_symm_slab_zero (q1 alone) == zero planes and the "
          f"tile-reading walk bit for bit; rel l2 to plain {err:.3e} "
          f"(<= 1e-13)")
    _check(err <= 1e-13, "gemv_fq_symm_slab_zero disagrees with its plain "
           "version")
    diff = float((_cat_parts(outs) - zero_plain).abs().max())
    entry = _timed_entry(
        "gemv_fq_symm_slab_zero", "lam_tpu/ops/gemv.py:2405",
        "lam_tpu_torch/csrc/strip_walk.cuh", diff,
        (_rotating(lambda q: gemv.gemv_fq_symm_slab_zero(
            q, s1, ph, pl, *walk, ms=ms), copies),
         _rotating(lambda q: gemv.gemv_fq_symm_slab_zero_plain(
             q, s1, ph, pl, *walk, ms=ms), copies), None),
        (q1, s1, ph, pl, *walk, *outs), flops, "f64")
    out.append(entry)
    _zero_walk_in_turns(
        "gemv_fq_symm_slab_zero (three q1 copies)", entry["bound_ms"],
        _rotating(lambda q: gemv.gemv_fq_symm_slab_zero(
            q, s1, ph, pl, *walk, ms=ms), copies),
        _rotating(lambda q: gemv.gemv_fq_symm_slab_bcast(
            q, zt, zt, *rest, ms=ms), copies),
        _rotating(lambda q: gemv.gemv_q16_symm_slab(
            q, s1, ph, *walk, ms=ms), copies),
        "gemv_q16_symm_slab (#16) on the same q1 copies",
        _rotating(lambda q: probe.stream_i16(q), copies),
        "lam_stream_i16 over q1")
    _pass_split("gemv_fq_symm_slab_zero and its control "
                "(gemv_fq_symm_slab_bcast on zero tiles)", {
                    "walk": lambda: gemv.gemv_fq_symm_slab_zero(
                        q1, s1, ph, pl, *walk, ms=ms),
                    "control": lambda: gemv.gemv_fq_symm_slab_bcast(
                        q1, zt, zt, *rest, ms=ms)})
    _in_turns("gemv_fq_symm_slab_zero (three q1 copies)",
              _rotating(lambda q: gemv.gemv_fq_symm_slab_zero(
                  q, s1, ph, pl, *walk, ms=ms), copies),
              lambda: gemv.gemv_fq_symm_slab(q1, q2, q3, *rest, ms=ms),
              "gemv_fq_symm_slab (full planes)")
    del fq, copies, q1, q2, q3
    torch.cuda.empty_cache()

    # the symmetric grid's half-slab at rank (1, 0): p = block 0, q = the
    # top half of block 1
    mesh = Mesh2D(2, 2, "cuda")
    df = pcg2d_symm.Symm2DOperator.from_block_fn(
        lambda r0, c0, h, w: a[r0:r0 + h, c0:c0 + w], N, mesh=mesh)
    fq = pcg2d_symm.Symm2DOperator.from_block_fn(
        lambda r0, c0, h, w: a[r0:r0 + h, c0:c0 + w], N, mesh=mesh,
        precision="fq")
    m = df.m
    m2, cb = m // 2, m // tb
    mb = cb // 2
    real = mb * cb
    ph, pl, p64 = _pair(p, df.n_padded)
    vecs = (ph[:m].clone(), pl[:m].clone(), ph[m:m + m2].clone(),
            pl[m:m + m2].clone())
    pd, qd = p64[:m].clone(), p64[m:m + m2].clone()
    flops = 4 * m2 * m

    def dual_oracle(bufs):
        stored = _stored_rect(bufs, mb, cb, tb)
        return torch.cat([stored @ pd, stored.T @ qd])

    hi, lo = df.operand
    diff = _tile_checks(
        gemv, "gemv_df64_dual_bcast", (hi, zero, *vecs),
        [(hi, lo[:tb] * 3.0, *vecs)],
        lambda: gemv.gemv_df64_dual(hi, torch.zeros_like(hi), *vecs),
        lambda h, t, *_: dual_oracle([h, gemv._tile_plane(t, h)]), {})
    dense64 = _stored_rect([hi], mb, cb, tb)
    copies = [hi, hi.clone(), hi.clone()]
    outs = gemv.gemv_df64_dual_bcast(hi, zero, *vecs)
    out.append(_timed_entry(
        "gemv_df64_dual_bcast", "lam_tpu/ops/gemv.py:1682", SYMM_SOURCE,
        diff, (_rotating(lambda h: gemv.gemv_df64_dual_bcast(h, zero, *vecs),
                         copies),
               _rotating(lambda h: gemv.gemv_df64_dual_bcast_plain(
                   h, zero, *vecs), copies),
               lambda: (torch.mv(dense64, pd), torch.mv(dense64.T, qd))),
        (hi[:real * tb], zero, *vecs, *outs), flops, "f64"))
    _in_turns("gemv_df64_dual_bcast (three hi copies)",
              _rotating(lambda h: gemv.gemv_df64_dual_bcast(h, zero, *vecs),
                        copies),
              lambda: gemv.gemv_df64_dual(hi, lo, *vecs),
              "gemv_df64_dual (full lo plane)")
    _in_turns("gemv_df64_dual_bcast (three hi copies)",
              _rotating(lambda h: gemv.gemv_df64_dual_bcast(h, zero, *vecs),
                        copies),
              _rotating(lambda h: gemv.gemv_f32_dual(h, vecs[0], vecs[2]),
                        copies),
              "gemv_f32_dual on the same hi copies")
    # the kernel for a lo tile of zeros, hi alone: the zero plane's bits
    # and the tile-reading walk's on a +0.0 and a -0.0 tile
    full = gemv.gemv_df64_dual(hi, torch.zeros_like(hi), *vecs)
    outs = gemv.gemv_df64_dual_zero(hi, *vecs)
    for got in (outs, gemv.gemv_df64_dual_bcast(
            hi, torch.full_like(zero, -0.0), *vecs)):
        _check(all(torch.equal(u, v) for u, v in zip(got, full)),
               "gemv_df64_dual_zero or the tile-reading walk on a -0.0 tile "
               "!= the zero lo plane, bit for bit")
    del full
    zero_plain = _cat_parts(gemv.gemv_df64_dual_zero_plain(hi, *vecs))
    err = _rel(_cat_parts(outs), zero_plain)
    print(f"gemv_df64_dual_zero (hi alone), and the tile-reading walk on "
          f"+0.0 and -0.0 tiles, == zero plane bit for bit; rel l2 to plain "
          f"{err:.3e} (<= 1e-13)")
    _check(err <= 1e-13, "gemv_df64_dual_zero disagrees with its plain "
           "version")
    diff = float((_cat_parts(outs) - zero_plain).abs().max())
    entry = _timed_entry(
        "gemv_df64_dual_zero", "lam_tpu/ops/gemv.py:1682",
        "lam_tpu_torch/csrc/strip_walk.cuh", diff,
        (_rotating(lambda h: gemv.gemv_df64_dual_zero(h, *vecs), copies),
         _rotating(lambda h: gemv.gemv_df64_dual_zero_plain(h, *vecs),
                   copies),
         lambda: (torch.mv(dense64, pd), torch.mv(dense64.T, qd))),
        (hi[:real * tb], *vecs, *outs), flops, "f64")
    out.append(entry)
    _zero_walk_in_turns(
        "gemv_df64_dual_zero (three hi copies)", entry["bound_ms"],
        _rotating(lambda h: gemv.gemv_df64_dual_zero(h, *vecs), copies),
        _rotating(lambda h: gemv.gemv_df64_dual_bcast(h, zero, *vecs),
                  copies),
        _rotating(lambda h: gemv.gemv_f32_dual(h, vecs[0], vecs[2]),
                  copies),
        "gemv_f32_dual (#11) on the same hi copies",
        _rotating(lambda h: probe.stream_i16(
            h[:real * tb].view(torch.int16)), copies),
        "lam_stream_i16 over hi's bytes")
    _pass_split("gemv_df64_dual_zero and its control "
                "(gemv_df64_dual_bcast on a zero tile)", {
                    "walk": lambda: gemv.gemv_df64_dual_zero(hi, *vecs),
                    "control": lambda: gemv.gemv_df64_dual_bcast(
                        hi, zero, *vecs)})
    _in_turns("gemv_df64_dual_zero (three hi copies)",
              _rotating(lambda h: gemv.gemv_df64_dual_zero(h, *vecs),
                        copies),
              lambda: gemv.gemv_df64_dual(hi, lo, *vecs),
              "gemv_df64_dual (full lo plane)")
    del dense64, copies, df, hi, lo

    q1, q2, q3, s1, s2, s3 = fq.operand[:6]
    zp = torch.zeros_like(q1)
    rest = (s1, s2, s3, *vecs)
    last = (real - 1) * tb
    diff = _tile_checks(
        gemv, "gemv_fq_dual_bcast", (q1, zt, zt, *rest),
        [(q1, q2[last:last + tb].clone(), q3[:tb].clone(), *rest),
         (q1, q2[:tb].clone(), q3, *rest)],
        lambda: gemv.gemv_fq_dual(q1, zp, zp, *rest),
        lambda a1, t2, t3, *_: dual_oracle(
            [a1, gemv._tile_plane(t2, a1), gemv._tile_plane(t3, a1), s1, s2,
             s3]), {})
    del zp
    copies = [q1, q1.clone(), q1.clone()]
    outs = gemv.gemv_fq_dual_bcast(q1, zt, zt, *rest)
    out.append(_timed_entry(
        "gemv_fq_dual_bcast", "lam_tpu/ops/gemv.py:2624", SYMM_SOURCE, diff,
        (_rotating(lambda q: gemv.gemv_fq_dual_bcast(q, zt, zt, *rest),
                   copies),
         _rotating(lambda q: gemv.gemv_fq_dual_bcast_plain(q, zt, zt, *rest),
                   copies), None),
        (q1[:real * tb], zt, zt, *(x[:real] for x in (s1, s2, s3)), *vecs,
         *outs), flops, "f64"))
    _in_turns("gemv_fq_dual_bcast (three q1 copies)",
              _rotating(lambda q: gemv.gemv_fq_dual_bcast(q, zt, zt, *rest),
                        copies),
              lambda: gemv.gemv_fq_dual(q1, q2, q3, *rest),
              "gemv_fq_dual (full planes)")
    _in_turns("gemv_fq_dual_bcast (three q1 copies)",
              _rotating(lambda q: gemv.gemv_fq_dual_bcast(q, zt, zt, *rest),
                        copies),
              _rotating(lambda q: gemv.gemv_q16_dual(q, s1, vecs[0],
                                                     vecs[2]), copies),
              "gemv_q16_dual on the same q1 copies")
    # the kernel for q2/q3 tiles of zeros, q1 alone: the zero planes' bits
    # and the tile-reading walk's
    zp = torch.zeros_like(q1)
    full = gemv.gemv_fq_dual(q1, zp, zp, *rest)
    del zp
    outs = gemv.gemv_fq_dual_zero(q1, s1, *vecs)
    for got in (outs, gemv.gemv_fq_dual_bcast(q1, zt, zt, *rest),
                gemv.gemv_fq_dual_zero(q1, s1, *vecs)):
        _check(all(torch.equal(u, v) for u, v in zip(got, full)),
               "gemv_fq_dual_zero (or a repeat) or the tile-reading walk != "
               "the zero q2/q3 planes, bit for bit")
    del full
    zero_plain = _cat_parts(gemv.gemv_fq_dual_zero_plain(q1, s1, *vecs))
    y = _cat_parts(outs)
    err, err_f64 = _rel(y, zero_plain), _rel(y, dual_oracle([q1, s1]))
    print(f"gemv_fq_dual_zero (q1 alone) == zero planes, the tile-reading "
          f"walk and its repeat bit for bit; rel l2 to plain {err:.3e}, to "
          f"the f64 oracle {err_f64:.3e} (<= 1e-13)")
    _check(max(err, err_f64) <= 1e-13, "gemv_fq_dual_zero disagrees with "
           "its plain version or the f64 oracle")
    diff = float((y - zero_plain).abs().max())
    entry = _timed_entry(
        "gemv_fq_dual_zero", "lam_tpu/ops/gemv.py:2624",
        "lam_tpu_torch/csrc/strip_walk.cuh", diff,
        (_rotating(lambda q: gemv.gemv_fq_dual_zero(q, s1, *vecs), copies),
         _rotating(lambda q: gemv.gemv_fq_dual_zero_plain(q, s1, *vecs),
                   copies), None),
        (q1[:real * tb], s1[:real], *vecs, *outs), flops, "f64")
    out.append(entry)
    _zero_walk_in_turns(
        "gemv_fq_dual_zero (three q1 copies)", entry["bound_ms"],
        _rotating(lambda q: gemv.gemv_fq_dual_zero(q, s1, *vecs), copies),
        _rotating(lambda q: gemv.gemv_fq_dual_bcast(q, zt, zt, *rest),
                  copies),
        _rotating(lambda q: gemv.gemv_q16_dual(q, s1, vecs[0], vecs[2]),
                  copies),
        "gemv_q16_dual (#18) on the same q1 copies",
        _rotating(lambda q: probe.stream_i16(q[:real * tb]), copies),
        "lam_stream_i16 over q1")
    _pass_split("gemv_fq_dual_zero and its control (gemv_fq_dual_bcast on "
                "zero tiles)", {
                    "walk": lambda: gemv.gemv_fq_dual_zero(q1, s1, *vecs),
                    "control": lambda: gemv.gemv_fq_dual_bcast(
                        q1, zt, zt, *rest)})
    return out


def gen_bcast_vs_plain(gemv, pcg_symm, pcg2d_symm, Mesh, Mesh2D):
    """Phase 9, the four broadcast modes at the shapes generate mode gives
    them at N=GEN_MESH_N, on operands that the CLI's builders make on the
    card: rank 0 of G=2's packed band walk (`from_gen_tridiagonal(packed=
    True)`, `from_gen_fq`) and rank (1, 0)'s half-slab of the R=2 grid
    (`from_gen_tridiagonal`, `from_gen_fq`). Each mode on the operator's
    own zero tiles equals its full-plane kernel over zero planes bit for
    bit; on the operator's operands and on non-zero tiles (random, from a
    seed) it agrees with its plain version and the f64 oracle of the stored
    values at 1e-13, repeated bitwise. At GEN_PROBE_N a plain f64 expansion
    of the planes does not fit on the card: there the probes' x and
    residual gates hold the modes. The operators that hold kernels 15's,
    9's, 12's and 17's tiles count them zero when built and take the
    zero-tile kernels: one device's fq operator (the facade's) and the
    grid's diagonal rank (0, 0) multiply by gemv_fq_symm_zero, one rank's
    fq band pair by gemv_fq_symm_slab_zero and the grid's rank (1, 0) at
    df64 by gemv_df64_dual_zero, never by the tile-reading walk, bit for
    bit its result (and, for gemv_fq_symm_zero, the zero planes'); the
    band walk's packed df64 and fq tiles give gemv_df64_symm_slab_zero and
    gemv_fq_symm_slab_zero the tile-reading walk's bits (phase 9's runs
    hold their routing on the meshes)."""
    from lam_tpu_torch import ops
    from lam_tpu_torch.precision import join_f64, split_f64
    from lam_tpu_torch.solver.api import ConjugateGradient
    tb = 512
    rng = torch.Generator(device="cuda").manual_seed(15)
    p = np.random.default_rng(15).uniform(-1, 1, size=GEN_MESH_N)

    # kernel 15's mode on the triangles generate mode builds
    cg = ConjugateGradient(precision="fq", device="cuda")
    cg.generate_matrix(GEN_MESH_N)
    grid = pcg2d_symm.Symm2DOperator.from_gen_fq(GEN_MESH_N,
                                                 mesh=Mesh2D(0, 2, "cuda"))
    for label, op, n in (("one device", cg.op, cg.op.n_padded),
                         ("grid rank (0, 0)", grid, grid.m)):
        _, _, x = _pair(p[:n], n)
        ops.reset_counters()
        y = op.matvec(x) if op is cg.op else op.mv_pair(op.operand, x, x)[0]
        torch.cuda.synchronize()
        ran = _launched("gemv_fq_symm_zero", "gemv_fq_symm_bcast")
        _check(ran == {"gemv_fq_symm_zero": 1, "gemv_fq_symm_bcast": 0},
               f"gen fq operator ({label}): launches {ran}, not the "
               "zero-tile kernel alone")
        planes, diag = op.operand[:6], op.operand[6:8]
        ph, pl = split_f64(x)
        zq = torch.zeros_like(planes[0])
        for other in (gemv.gemv_fq_symm_bcast(*planes, ph, pl),
                      gemv.gemv_fq_symm(planes[0], zq, zq, *planes[3:], ph,
                                        pl)):
            _check(torch.equal(y, join_f64(*other) + join_f64(*diag) * x),
                   f"gen fq operator ({label}): the zero-tile kernel != "
                   "the tile-reading walk or the zero planes, bit for bit")
        del zq
    print(f"gen N={GEN_MESH_N}: the gen fq operators (one device, grid rank "
          "(0, 0)) multiply by gemv_fq_symm_zero alone, == the tile-reading "
          "walk and the zero planes bit for bit")
    del cg, grid

    def lo_tile():
        return torch.rand((tb, tb), generator=rng, device="cuda") * 2.0 ** -24

    def q_tile():
        return torch.randint(-32768, 32768, (tb, tb), generator=rng,
                             device="cuda", dtype=torch.int16)

    def q_scales(s1):
        return s1 * 2.0 ** -16, s1 * 2.0 ** -32

    # band pairs, rank 0 of G=2
    mesh = Mesh(0, 2, "cuda")
    df = pcg_symm.SymmShardedOperator.from_gen_tridiagonal(
        GEN_MESH_N, mesh=mesh, packed=True)
    hi, lo, it, kt, lt = df.operand
    _check(lo.shape == (tb, tb), "the packed gen operator's lo is not a tile")
    ph, pl, p64 = _pair(p, df.n_padded)
    walk, ms, T = (it, kt, lt), 2 * df.m, it.shape[0]
    outs = (gemv.gemv_df64_symm_slab_zero(hi, ph, pl, *walk, ms=ms),
            gemv.gemv_df64_symm_slab_bcast(hi, lo, ph, pl, *walk, ms=ms))
    _check(all(torch.equal(u, v) for u, v in zip(*outs)),
           "the packed gen operator: gemv_df64_symm_slab_zero != the "
           "tile-reading walk, bit for bit")

    def slab_oracle(tiles):
        return torch.cat(gemv._slab_parts(tiles, p64, *walk, ms, tb, True))

    _tile_checks(
        gemv, "gemv_df64_symm_slab_bcast", (hi, lo, ph, pl, *walk),
        [(hi, lo, ph, pl, *walk), (hi, lo_tile(), ph, pl, *walk)],
        lambda: gemv.gemv_df64_symm_slab(hi, torch.zeros_like(hi), ph, pl,
                                         *walk, ms=ms, packed=True),
        lambda h, t, *_: slab_oracle(h.double() + t.double().repeat(T, 1)),
        {"ms": ms})
    fq = pcg_symm.SymmShardedOperator.from_gen_fq(GEN_MESH_N, mesh=mesh)
    q1, q2, q3, s1, s2, s3 = fq.operand[:6]
    _check(q2.shape == q3.shape == (tb, tb),
           "the gen fq operator's q2/q3 are not tiles")
    _check(all(torch.equal(x, y) for x, y in zip(fq.operand[-3:], walk)),
           "the gen fq and df64 operators walk different tables")
    vec = (ph, pl, *walk)

    def fq_tiles(a1, t2, t3, *scales):
        return sum(gemv._tile_plane(q, a1).double()
                   * s.double().repeat_interleave(tb)[:, None]
                   for q, s in zip((a1, t2, t3), scales))

    _tile_checks(
        gemv, "gemv_fq_symm_slab_bcast", (q1, q2, q3, s1, s2, s3, *vec),
        [(q1, q2, q3, s1, s2, s3, *vec),
         (q1, q_tile(), q_tile(), s1, *q_scales(s1), *vec)],
        lambda: gemv.gemv_fq_symm_slab(q1, torch.zeros_like(q1),
                                       torch.zeros_like(q1), s1, s2, s3,
                                       *vec, ms=ms),
        lambda a1, t2, t3, c1, c2, c3, *_: slab_oracle(
            fq_tiles(a1, t2, t3, c1, c2, c3)), {"ms": ms})
    outs = (gemv.gemv_fq_symm_slab_zero(q1, s1, *vec, ms=ms),
            gemv.gemv_fq_symm_slab_bcast(q1, q2, q3, s1, s2, s3, *vec,
                                         ms=ms))
    _check(all(torch.equal(u, v) for u, v in zip(*outs)),
           "the gen fq band walk: gemv_fq_symm_slab_zero != the "
           "tile-reading walk, bit for bit")
    del df, fq, hi, q1, outs
    # one rank's gen fq band pair (a mesh of one rank: no collective)
    # counts its tiles zero when built and takes the zero walk alone
    band = pcg_symm.SymmShardedOperator.from_gen_fq(GEN_MESH_N,
                                                    mesh=Mesh(0, 1, "cuda"))
    _, _, x = _pair(p, band.n_padded)
    ops.reset_counters()
    y = band.matvec(x)
    torch.cuda.synchronize()
    ran = _launched("gemv_fq_symm_slab_zero", "gemv_fq_symm_slab_bcast")
    _check(ran == {"gemv_fq_symm_slab_zero": 1, "gemv_fq_symm_slab_bcast": 0},
           f"gen fq band pair: launches {ran}, not the zero-tile kernel "
           "alone")
    q1, q2, q3, s1, s2, s3, dh, dl, *walk1 = band.operand
    parts = gemv.gemv_fq_symm_slab_bcast(q1, q2, q3, s1, s2, s3,
                                         *split_f64(x), *walk1,
                                         ms=2 * band.m)
    yd = join_f64(*parts[:2]) + join_f64(dh, dl) * pcg_symm._own_rows(
        x, 0, 1, band.m)
    _check(torch.equal(y, pcg_symm._scatter_bands(
        yd, join_f64(*parts[2:]), 0, 1, band.m)),
        "gen fq band pair: the zero-tile kernel's matvec != the "
        "tile-reading walk's, bit for bit")
    print(f"gen N={GEN_MESH_N}: the gen fq band pair multiplies by "
          "gemv_fq_symm_slab_zero alone, == the tile-reading walk bit for "
          "bit")
    del band, q1, x, y

    # the symmetric grid's half-slab at rank (1, 0): p = block 0, q = the
    # top half of block 1
    mesh = Mesh2D(2, 2, "cuda")
    df = pcg2d_symm.Symm2DOperator.from_gen_tridiagonal(GEN_MESH_N,
                                                        mesh=mesh)
    hi, lo = df.operand
    _check(lo.shape == (tb, tb), "the gen grid operator's lo is not a tile")
    m = df.m
    m2, cb = m // 2, m // tb
    mb = cb // 2
    ph, pl, p64 = _pair(p, df.n_padded)
    vecs = (ph[:m].clone(), pl[:m].clone(), ph[m:m + m2].clone(),
            pl[m:m + m2].clone())
    pd, qd = p64[:m].clone(), p64[m:m + m2].clone()

    def dual_oracle(bufs):
        stored = _stored_rect(bufs, mb, cb, tb)
        return torch.cat([stored @ pd, stored.T @ qd])

    # the rank counts its lo tile zero when built and takes the zero walk
    # alone: rank (1, 0) multiplies p-block 0 and the top half of block 1
    p_own, p_recv = p64[m:2 * m].clone(), p64[:m].clone()
    ops.reset_counters()
    own, payload = df.mv_pair(df.operand, p_own, p_recv)
    torch.cuda.synchronize()
    ran = _launched("gemv_df64_dual_zero", "gemv_df64_dual_bcast")
    _check(ran == {"gemv_df64_dual_zero": 1, "gemv_df64_dual_bcast": 0},
           f"gen grid rank (1, 0) at df64: launches {ran}, not the "
           "zero-tile kernel alone")
    parts = gemv.gemv_df64_dual_bcast(hi, lo, *split_f64(p_recv),
                                      *split_f64(p_own[:m2]))
    _check(torch.equal(own[:m2], join_f64(*parts[:2]))
           and not own[m2:].any()
           and torch.equal(payload, join_f64(*parts[2:])),
           "gen grid rank (1, 0): the zero-tile kernel's parts != the "
           "tile-reading walk's, bit for bit")
    print(f"gen N={GEN_MESH_N}: the gen grid's rank (1, 0) at df64 "
          "multiplies by gemv_df64_dual_zero alone, == the tile-reading "
          "walk bit for bit")
    del own, payload, parts

    _tile_checks(
        gemv, "gemv_df64_dual_bcast", (hi, lo, *vecs),
        [(hi, lo, *vecs), (hi, lo_tile(), *vecs)],
        lambda: gemv.gemv_df64_dual(hi, torch.zeros_like(hi), *vecs),
        lambda h, t, *_: dual_oracle([h, gemv._tile_plane(t, h)]), {})
    fq = pcg2d_symm.Symm2DOperator.from_gen_fq(GEN_MESH_N, mesh=mesh)
    q1, q2, q3, s1, s2, s3 = fq.operand[:6]
    _check(q2.shape == q3.shape == (tb, tb),
           "the gen grid's fq q2/q3 are not tiles")
    _tile_checks(
        gemv, "gemv_fq_dual_bcast", (q1, q2, q3, s1, s2, s3, *vecs),
        [(q1, q2, q3, s1, s2, s3, *vecs),
         (q1, q_tile(), q_tile(), s1, *q_scales(s1), *vecs)],
        lambda: gemv.gemv_fq_dual(q1, torch.zeros_like(q1),
                                  torch.zeros_like(q1), s1, s2, s3, *vecs),
        lambda a1, t2, t3, c1, c2, c3, *_: dual_oracle(
            [a1, gemv._tile_plane(t2, a1), gemv._tile_plane(t3, a1), c1, c2,
             c3]), {})
    # at fq the rank counts its q2/q3 tiles zero when built and takes the
    # zero walk alone
    ops.reset_counters()
    own, payload = fq.mv_pair(fq.operand, p_own, p_recv)
    torch.cuda.synchronize()
    ran = _launched("gemv_fq_dual_zero", "gemv_fq_dual_bcast")
    _check(ran == {"gemv_fq_dual_zero": 1, "gemv_fq_dual_bcast": 0},
           f"gen grid rank (1, 0) at fq: launches {ran}, not the zero-tile "
           "kernel alone")
    parts = gemv.gemv_fq_dual_bcast(q1, q2, q3, s1, s2, s3,
                                    *split_f64(p_recv),
                                    *split_f64(p_own[:m2]))
    _check(torch.equal(own[:m2], join_f64(*parts[:2]))
           and not own[m2:].any()
           and torch.equal(payload, join_f64(*parts[2:])),
           "gen grid rank (1, 0) at fq: the zero-tile kernel's parts != the "
           "tile-reading walk's, bit for bit")
    print(f"gen N={GEN_MESH_N}: the gen grid's rank (1, 0) at fq multiplies "
          "by gemv_fq_dual_zero alone, == the tile-reading walk bit for bit")
    print(f"gen N={GEN_MESH_N}: the four broadcast modes held on the "
          f"builders' operands (band walk of {T} tiles at rank 0 of G=2, "
          f"half-slab ({m2}, {m}) at rank (1, 0) of R=2)")


def _pass_split(label, fns, calls=40):
    """The device time of each kernel that the calls fns (name -> fn)
    launch, from torch.profiler (CUPTI): its mean per launch, by kernel
    name, so a call's time splits into its passes. A programmatically
    dependent pass 2 starts before pass 1 ends and waits for it: its time
    holds that wait. Returns {kernel name: ms} ({} where TIMED is off)."""
    from torch.profiler import ProfilerActivity, profile
    if not TIMED:
        return {}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            for fn in fns.values():
                fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        if ev.count and ev.device_time > 0:
            name = re.sub(r"\(anonymous namespace\)::", "", ev.key)
            split[name.split("(")[0]] = ev.device_time / 1e3
    print(f"{label}, device time a launch (torch.profiler, {calls} calls "
          "each): " + ", ".join(f"{k} {v:.4f} ms"
                                for k, v in sorted(split.items())))
    return split


def _walk_against_control(name, bound_ms, kernel, control, floor,
                          floor_label, where="(strip walk) at rank (1, 0)",
                          control_label="two-pass"):
    """A kernel's new walk against its control, the walk it replaced, in
    turns LIBRARY_REPEATS times with the read floor (or another yardstick)
    beside them, and its time against KERNEL_TARGET_MS (half its bound) and
    the control's (printed, not gates)."""
    target = KERNEL_TARGET_MS.get(name)
    goal = "" if target is None else f", target <= {target:.4f} ms"
    print(f"{name} {where}, against its {control_label} control; bound "
          f"{bound_ms:.4f} ms{goal}:")
    times, ctl = _against_library(name, kernel, control, floor, floor_label,
                                  library_label=control_label)
    below = all(t < c for t, c in zip(times, ctl))
    met = ("" if target is None else
           f"; target {'met' if max(times) <= target else 'missed'}")
    print(f"{name} over {LIBRARY_REPEATS} repeats: {min(times):.4f}-"
          f"{max(times):.4f} ms, {bound_ms / max(times):.2f}-"
          f"{bound_ms / min(times):.2f} of its bound{met}; below the "
          f"control in every repeat: {below}")
    return times, ctl


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
    from lam_tpu_torch.ops import probe
    control = getattr(probe, DUAL_CONTROLS["gemv_q16_dual_bf16"])
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
        garbage = _with_garbage_pads(bufs, real, tb)
        _check(torch.equal(y, torch.cat(gemv.gemv_q16_dual_bf16(
            *garbage, ph[pv], ph[qv]))),
            f"gemv_q16_dual_bf16 rank {k} read a pad tile or a pad scale")
        for b in (bufs, garbage):  # the strip walk's bits
            _check(torch.equal(y, torch.cat(control(*b, ph[pv], ph[qv]))),
                   f"gemv_q16_dual_bf16 rank {k}: the strip walk != the "
                   "two-pass walk")
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
          f"(<= 1e-5), == the two-pass walk bit for bit on both ranks, "
          f"garbage pads too; small-integer data == f64 oracle: {exact}; "
          f"four ranks' "
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
    """One stencil case against its plain version and its control (the
    two-launch walk, ops/probe.py); returns y's largest difference from the
    plain version (0: they must be bitwise equal)."""
    from lam_tpu_torch.ops import probe
    y, d = stencil.laplace5_f32_halo(p, up, dn, nrows, nxi=nxi, tbr=tbr)
    yc, dc = probe.laplace5_f32_halo_twopass(p, up, dn, nrows, nxi=nxi,
                                             tbr=tbr)
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
          f"kernel-plain {errs[0]:.3e} kernel-f64 {errs[1]:.3e} (<= 1e-6); "
          f"(y, p.y) == the two-launch control's bit for bit: "
          f"{torch.equal(y, yc) and float(dc) == d}")
    _check(torch.equal(y, y_plain), f"laplace5 {label}: y != plain version")
    _check(torch.equal(y, yc) and float(dc) == d,
           f"laplace5 {label}: the kernel != its two-launch control")
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
    call; then the kernel against its control (the two-launch walk) in
    turns LIBRARY_REPEATS times, conv2d beside. Returns the entry and the
    kernel's and the control's repeat times."""
    from lam_tpu_torch.ops import probe
    H, W = p.shape
    y, d = stencil.laplace5_f32(p, nyi=nyi, nxi=nxi, tbr=tbr)
    weights = torch.tensor([[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0],
                            [0.0, -1.0, 0.0]], device=p.device)
    weights = weights.view(1, 1, 3, 3)
    p4 = p.view(1, 1, H, W)
    kernel = lambda: stencil.laplace5_f32_halo(p, zero, zero, nyi, nxi=nxi,
                                               tbr=tbr)
    conv = lambda: torch.nn.functional.conv2d(p4, weights, padding=1)
    # 5 operations a valid cell for the stencil, 2 for the dot
    entry = _timed_entry(
        name, "lam_tpu/ops/stencil.py:92", STENCIL_SOURCE, y_err,
        (kernel,
         lambda: stencil.laplace5_f32_halo_plain(p, zero, zero, nyi,
                                                 nxi=nxi), conv),
        (p, zero, zero, y, d), 7 * nyi * nxi, "f32")
    times = _walk_against_control(
        name, entry["bound_ms"], kernel,
        lambda: probe.laplace5_f32_halo_twopass(p, zero, zero, nyi, nxi=nxi,
                                                tbr=tbr),
        conv, "conv2d (stencil only)", where=f"on the {H}x{W} grid",
        control_label="two-launch")
    return entry, times


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
    entry, _ = _stencil_timed(stencil, "laplace5_f32_halo", p, zero, nyi,
                              nxi, tbr, y_err)
    from lam_tpu_torch.ops import probe
    _pass_split(f"laplace5 {H}x{W}, kernel and two-launch control", {
        "kernel": lambda: stencil.laplace5_f32_halo(p, zero, zero, nyi,
                                                    nxi=nxi, tbr=tbr),
        "control": lambda: probe.laplace5_f32_halo_twopass(
            p, zero, zero, nyi, nxi=nxi, tbr=tbr)})
    del full
    big_i = STREAM_NI
    Hb, Wb, tbr_b = stencil.padded_hw(big_i, big_i)
    pb = grid(Hb, Wb, big_i, big_i)
    zb = torch.zeros(1, Wb, device="cuda")
    yb_err = _stencil_case(stencil, f"{Hb}x{Wb} zero edges", pb, zb, zb,
                           big_i, big_i, tbr_b)
    big, (times, ctl) = _stencil_timed(stencil, f"laplace5 {Hb}x{Wb}", pb,
                                       zb, big_i, big_i, tbr_b, yb_err)
    worst = max(t / c for t, c in zip(times, ctl))
    print("laplace5_f32_halo at the streaming shape: "
          + json.dumps({k: big[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "library_ms")})
          + f"; against the two-launch control at most x{worst:.4f} over "
          f"{LIBRARY_REPEATS} repeats (within 3%: {worst <= 1.03})")
    return entry


def stencil_shards(stencil):
    """Phase 2, the row-sharded heat path's stencil: laplace5_f32_halo on
    each of the HEAT_SHARDS shards of the demo's 1200 x 1000 plate (padded
    with row_groups=HEAT_SHARDS), its up/dn edges the neighbour rows the
    halo exchange delivers (zeros past the mesh's edges), held against its
    plain version (_stencil_case); the shards' y concatenated must be the
    one-device zero-edged y bit for bit, and their p . y partials summed
    the one-device p . y."""
    rng = np.random.default_rng(12)
    nyi, nxi = HEAT_NY - 2, HEAT_NX - 2
    H, W, tbr = stencil.padded_hw(nyi, nxi, row_groups=HEAT_SHARDS)
    hs = H // HEAT_SHARDS
    p = torch.zeros(H, W, device="cuda")
    p[:nyi, :nxi] = torch.from_numpy(
        rng.standard_normal((nyi, nxi)).astype(np.float32)).cuda()
    zero = torch.zeros(1, W, device="cuda")
    y1, d1 = stencil.laplace5_f32_halo(p, zero, zero, nyi, nxi=nxi, tbr=tbr)
    ys, parts = [], []
    for c in range(HEAT_SHARDS):
        shard = p[c * hs:(c + 1) * hs]
        up = p[c * hs - 1:c * hs] if c else zero
        dn = p[(c + 1) * hs:(c + 1) * hs + 1] if c < HEAT_SHARDS - 1 else zero
        nrows = min(max(nyi - c * hs, 0), hs)
        _stencil_case(stencil, f"shard {c} of {HEAT_SHARDS} ({hs}x{W}, "
                      f"nrows {nrows})", shard, up, dn, nrows, nxi, tbr)
        y, d = stencil.laplace5_f32_halo(shard, up, dn, nrows, nxi=nxi,
                                         tbr=tbr)
        ys.append(y)
        parts.append(float(d))
    torch.cuda.synchronize()
    exact = float((p.double() * y1.double()).sum())
    rel = abs(sum(parts) - exact) / abs(exact)
    same = torch.equal(torch.cat(ys), y1)
    print(f"laplace5 over {HEAT_SHARDS} halo shards of the {H}x{W} plate: "
          f"y == the one-device y bit for bit: {same}; the shards' p.y "
          f"summed vs the one-device f64 p.y rel {rel:.3e} (<= 1e-6), the "
          f"one-device kernel's {abs(float(d1) - exact) / abs(exact):.3e}")
    _check(same, "the stencil's shards differ from the one-device grid")
    _check(rel <= 1e-6, "the shards' p.y partials do not sum to p.y")


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
                if run == "heat-ir":  # through the stencil kernel's bits
                    print(f"heat-ir: {iters} inner iterations; "
                          f"{HEAT_IR_ITERS} in every earlier chip run")
                    _check(iters == HEAT_IR_ITERS, f"heat-ir took {iters} "
                           f"iterations, not {HEAT_IR_ITERS}")
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
        sharded_heat_runs(ops, lio, grids["heat-f64"], tmp, total)
    print(f"heat demo launches, summed over the runs: {total}")
    return total


def sharded_heat_runs(ops, lio, grid_f64, tmp, total):
    """Phase 4, the row-sharded heat path: the plate through the port's
    lam-heat CLI with --devices G for each G of HEAT_DEVICES, G rank
    processes of this script sharing the card over gloo (as phase 5 starts
    them). Each run must converge with a TRUE residual <= HEAT_GATE on the
    host from rank 0's grid, lie within IR_F64_ATOL of the one-device f64
    grid, launch laplace5_f32_halo on every rank and no other kernel and
    no plain version, and report gloo with every rank on cuda:0; its inner
    iterations are printed beside the one-device HEAT_IR_ITERS, with its
    solve time. The clusters run side by side (each solve's time is taken
    beside the other's). Adds the launches to total."""
    stencil_k = "laplace5_f32_halo"
    t0 = time.perf_counter()
    every = _clusters([(g, [{"run": f"heat-ir-{g}", "app": "heat", "argv": [
        str(HEAT_NX), str(HEAT_NY), os.path.join(tmp, f"heat-ir-{g}.bin"),
        "100000", "--devices", str(g)]}], None, f"heat{g}")
        for g in HEAT_DEVICES], tmp)
    wall = time.perf_counter() - t0
    for g, records in zip(HEAT_DEVICES, every):
        run = f"heat-ir-{g}"
        path = os.path.join(tmp, f"{run}.bin")
        recs = [rank_recs[0] for rank_recs in records]
        _check(all(rec["rc"] == 0 for rec in recs),
               f"{run}: a rank's lam-heat failed: "
               f"{[rec['rc'] for rec in recs]}")
        _check(all(not rec["stdout"].strip() for rec in recs[1:]),
               f"{run}: a rank other than 0 printed")
        text = recs[0]["stdout"]
        m = re.search(r"Iterations converged in (\d+) iterations with "
                      r"rel_residual=(\S+)", text)
        _check(m is not None, f"{run} did not converge:\n{text}")
        iters = int(m.group(1))
        solve_s = float(re.search(r"Time elapsed: (\S+) s", text).group(1))
        grid = lio.read_matrix(path)
        true_rel = _heat_true_rel(grid)
        gap = float(np.abs(grid - grid_f64).max())
        meshes = sorted({(rec["backend"], rec["device"]) for rec in recs})
        print(f"{run} {HEAT_NX}x{HEAT_NY}: {g} ranks on {meshes}, {iters} "
              f"inner iterations (one device: {HEAT_IR_ITERS}), "
              f"rel_residual {m.group(2)}, solve {solve_s:.4f} s (taken "
              f"beside the other cluster), clusters "
              f"{wall:.1f} s of wall time, TRUE rel residual {true_rel:.3e} "
              f"(<= {HEAT_GATE:g}), grid vs f64 max abs {gap:.3e} "
              f"(<= {IR_F64_ATOL:g}), launches rank 0 "
              f"{ {k: v for k, v in recs[0]['counts'].items() if v} }")
        _check(true_rel <= HEAT_GATE, f"{run} TRUE residual {true_rel:.3e}")
        _check(gap <= IR_F64_ATOL, f"{run}: the grid differs from f64's")
        _check(meshes == [("gloo", "cuda:0")],
               f"{run}: the mesh is {meshes}, not gloo on cuda:0")
        for r, rec in enumerate(recs):
            counts = rec["counts"]
            _check(counts[stencil_k] > 0, f"{run}: rank {r} never launched "
                   f"{stencil_k}")
            others = {k: v for k, v in counts.items() if v and k != stencil_k}
            _check(not others, f"{run}: rank {r} launched another kernel or "
                   f"a plain version: {others}")
            for k in total:
                total[k] += counts.get(k, 0)


def bench_system(generate, n, lio, tmp):
    """bench.py's system at size n, written in the binary format into tmp:
    (a, b, A.bin path, b.bin path)."""
    t0 = time.perf_counter()
    a = generate.random_spd_matrix_fast(n, seed=SEED_A)
    b = generate.random_rhs(n, seed=SEED_B)
    a_path, b_path = os.path.join(tmp, "A.bin"), os.path.join(tmp, "b.bin")
    lio.write_matrix(a_path, a)
    lio.write_matrix(b_path, b)
    print(f"bench system N={n} generated and written in "
          f"{time.perf_counter() - t0:.1f} s")
    return a, b, a_path, b_path


def solve_slice(ops, lio, cli, system, tmp):
    """Phase 3: the bench system through the port's CLI, one run per
    entry of RUNS, the native packs' cache files against the numpy
    pack's, and the host outer loop (HOST_RUNS). Returns the kernel
    launches summed over the runs and the solution of the ir run."""
    from lam_tpu_torch import _native_io
    from lam_tpu_torch.solver import api
    a, b, a_path, b_path = system
    bnorm = np.linalg.norm(b)
    total = {fn.__name__: 0 for fn in ops.KERNELS}
    xs, iters_of, load_of = {}, {}, {}
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
        _native_io.reset_calls()
        with contextlib.redirect_stdout(csv):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        counts = ops.counters()
        native = _native_io.calls()
        line = csv.getvalue().strip()
        print(f"{run} CSV (N,procs,threads,load_s,avg_gemv_s,"
              f"avg_iter_s,num_iter,err,total_cg_s): {line}")
        print(f"{run}: native library calls {native}")
        if run in NATIVE_PACK_OF:
            _check(native.get(NATIVE_PACK_OF[run], 0) > 0,
                   f"{run} did not take the native "
                   f"{NATIVE_PACK_OF[run]}")
        else:
            _check(not any(k.startswith("pack_") for k in native),
                   f"{run} packed ({native}): the cache was not read")
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
        if run in WALK_RUN_ITERS:
            print(f"{run}: {iters} iterations through the new "
                  f"walks; {WALK_RUN_ITERS[run]} before them")
            _check(iters == WALK_RUN_ITERS[run],
                   f"{run}: the iteration count moved")
        xs[run], iters_of[run], load_of[run] = x, iters, load_s
    for precision, storage in PACK_CACHE.items():
        _check(os.path.exists(f"{a_path}.{storage}pack"),
               f"{precision} --pack-cache wrote no A.bin.{storage}pack")
        numpy_cache_file(_native_io, a_path, storage,
                         load_of[f"{precision}-cold"])
    for precision in PACK_CACHE:
        warm, cold = f"{precision}-warm", f"{precision}-cold"
        _check(iters_of[warm] == iters_of[cold]
               and np.array_equal(xs[warm], xs[cold]),
               f"{precision} from the cache differs from {precision} after "
               "a fresh pack")
    jacobi_runs(ops, lio, cli, system, tmp, xs, iters_of, total)
    host = host_outer_runs(ops, api, cli, lio, a_path, b_path, tmp, N,
                           ("gemv_q16_symm",), ("gemv_q16_symm_bf16",),
                           load_of["irfq-cold"], load_of["irfq-warm"],
                           iters_of["irfq-cold"], total)
    _check(np.linalg.norm(host["host-cold"] - xs["irfq-cold"])
           <= X_ENGINE_GATE * np.linalg.norm(xs["irfq-cold"]),
           f"N={N} irfq --outer host: x differs from irfq's")
    print(f"main path launches, summed over the runs: {total}")
    return total, xs, iters_of


def _cli_run(ops, cli, argv):
    """The port's CLI in process on the card: (exit code, its CSV fields,
    the launch counts)."""
    csv = io.StringIO()
    ops.reset_counters()
    with contextlib.redirect_stdout(csv):
        rc = cli.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    return rc, csv.getvalue().strip().split(","), ops.counters()


def jacobi_runs(ops, lio, cli, system, tmp, xs, iters_of, total):
    """Phase 3, Jacobi-preconditioned CG (--preconditioner jacobi): the
    bench system through df64, ir and irfq (JACOBI_RUNS; irfq reads the
    fq cache of irfq-cold), each converged to a TRUE residual <= 2e-9 on
    the host, launching the kernels of its run without a preconditioner
    and no plain version, its iterations and solve time printed beside
    that run's; then the badly scaled system (SCALED_N), df64 without a
    preconditioner (capped at SCALED_CAP) and with Jacobi, which must
    converge <= 2e-9 in fewer iterations. Adds to xs, iters_of and
    total."""
    a, b, a_path, b_path = system
    bnorm = np.linalg.norm(b)
    for run, plain_run, kernels, not_kernels in JACOBI_RUNS:
        precision = run.split("-")[0]
        x_path = os.path.join(tmp, f"x_{run}.bin")
        argv = ["-A", a_path, "-b", b_path, "-o", x_path, "--precision",
                precision, "--preconditioner", "jacobi"]
        if precision in PACK_CACHE:
            argv.append("--pack-cache")
        rc, fields, counts = _cli_run(ops, cli, argv)
        _check(rc == 0, f"{run}: the CLI exited {rc}")
        iters, solve_s = int(fields[6]), float(fields[8])
        x = lio.read_vector(x_path)
        true_rel = float(np.linalg.norm(b - a @ x) / bnorm)
        launched = {k: v for k, v in counts.items() if v}
        print(f"{run} CSV: {','.join(fields)}")
        print(f"{run}: {iters} iterations (without a preconditioner "
              f"{iters_of[plain_run]}), solve {solve_s:.4f} s, TRUE rel "
              f"residual {true_rel:.3e} (<= {TRUE_GATE:g}), launches "
              f"{launched}")
        _check(iters <= 10000, f"{run} did not converge")
        _check(true_rel <= TRUE_GATE, f"{run} TRUE residual {true_rel:.3e}")
        for k in kernels:
            _check(counts[k] > 0, f"{run} never launched {k}")
        for k in not_kernels:
            _check(counts[k] == 0, f"{run} launched {k}")
        _check(all(counts[fn.__name__] == 0 for fn in ops.PLAIN),
               f"a plain version ran on the {run} path")
        for k in total:
            total[k] += counts[k]
        xs[run], iters_of[run] = x, iters
    from lam_tpu_torch import generate
    n = SCALED_N
    sv = np.exp(np.linspace(0.0, SCALED_SPAN, n))
    a_s = generate.random_spd_matrix_fast(n, seed=SEED_A) * np.outer(sv, sv)
    b_s = generate.random_rhs(n, seed=SEED_B)
    paths = [os.path.join(tmp, f) for f in ("A_scaled.bin", "b_scaled.bin",
                                            "x_scaled.bin")]
    lio.write_matrix(paths[0], a_s)
    lio.write_matrix(paths[1], b_s)
    got = {}
    for run, extra in (("scaled-df64", []),
                       ("scaled-df64-jacobi", ["--preconditioner", "jacobi"])):
        rc, fields, counts = _cli_run(ops, cli, [
            "-A", paths[0], "-b", paths[1], "-o", paths[2], "--precision",
            "df64", "-i", str(SCALED_CAP), *extra])
        _check(rc == 0, f"{run}: the CLI exited {rc}")
        x = lio.read_vector(paths[2])
        true_rel = float(np.linalg.norm(b_s - a_s @ x)
                         / np.linalg.norm(b_s))
        got[run] = int(fields[6])
        print(f"{run} N={n}: CSV num_iter {fields[6]} (cap {SCALED_CAP}: "
              f"{SCALED_CAP + 1} = unconverged), solve {float(fields[8]):.4f}"
              f" s, TRUE rel residual {true_rel:.3e}")
        _check(counts["gemv_df64_symm"] > 0, f"{run} never launched "
               "gemv_df64_symm")
        _check(all(counts[fn.__name__] == 0 for fn in ops.PLAIN),
               f"a plain version ran on the {run} path")
        if extra:
            _check(got[run] <= SCALED_CAP and true_rel <= TRUE_GATE,
                   f"{run} did not converge to {TRUE_GATE:g}")
        for k in total:
            total[k] += counts[k]
    print(f"scaled system N={n}: df64 {got['scaled-df64']} iterations, "
          f"with Jacobi {got['scaled-df64-jacobi']}")
    _check(got["scaled-df64-jacobi"] < got["scaled-df64"],
           "Jacobi did not cut the scaled system's iterations")


def numpy_cache_file(_native_io, a_path, storage, native_load_s):
    """The cache file a native cold pack wrote against the one the port's
    numpy pack writes for the same source, byte for byte; the numpy
    pack's cold load (pack, upload, publish) timed beside the native
    run's load_s."""
    from lam_tpu_torch.solver import operators as tops
    from lam_tpu_torch.solver import pack_cache as pc
    cache = pc.cache_path(a_path, storage)
    os.replace(cache, cache + ".native")
    available = _native_io.available
    _native_io.available = lambda: False
    try:
        _native_io.reset_calls()
        t0 = time.perf_counter()
        op = getattr(tops.DenseOperator, f"from_file_{storage}")(
            a_path, pack_cache=True, device="cuda")
        torch.cuda.synchronize()
        numpy_s = time.perf_counter() - t0
    finally:
        _native_io.available = available
    _check(not _native_io.calls(), f"the numpy {storage} pack called the "
           f"native library: {_native_io.calls()}")
    del op
    same = filecmp.cmp(cache, cache + ".native", shallow=False)
    size = os.path.getsize(cache)
    os.remove(cache + ".native")
    print(f"N={N} {storage}: cold load {native_load_s:.3f} s by the native "
          f"pack (its CLI load_s) vs {numpy_s:.3f} s by the numpy pack "
          f"(pack, upload, publish); A.bin.{storage}pack ({size} bytes) "
          f"byte-equal: {same}")
    _check(same, f"A.bin.{storage}pack from the native pack differs from "
           "the numpy pack's")
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _load_memory(api):
    """(bytes allocated before, after, peak) of the card across each
    facade load in the block."""
    seen = []
    orig = api.ConjugateGradient.load_matrix_from_file

    def load(self, filename):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = orig(self, filename)
        torch.cuda.synchronize()
        seen.append((before, torch.cuda.memory_allocated(),
                     torch.cuda.max_memory_allocated()))
        return out
    api.ConjugateGradient.load_matrix_from_file = load
    try:
        yield seen
    finally:
        api.ConjugateGradient.load_matrix_from_file = orig


@contextlib.contextmanager
def _host_cycles():
    """The seconds of each host matvec the host outer loop runs in the
    block: one a refinement cycle."""
    from lam_tpu_torch.solver import host_outer
    seen = []
    orig = host_outer.host_matvec

    def timed(a):
        mv = orig(a)

        def run(x):
            t0 = time.perf_counter()
            y = mv(x)
            seen.append(time.perf_counter() - t0)
            return y
        return run
    host_outer.host_matvec = timed
    try:
        yield seen
    finally:
        host_outer.host_matvec = orig


def _exact_true_rel(path, lio, b, blk=1024):
    """|b - A x| / |b| by an independent blocked pass a[s:s+blk] @ x over
    the file's memory map in extended precision (np.longdouble): no
    dsymv, and its own rounding far below the f64 products it checks."""
    am = lio.open_matrix_memmap(path)
    ld = np.longdouble

    def rel(x):
        xl = x.astype(ld)
        rr = ld(0)
        for s0 in range(0, am.shape[0], blk):
            r = b[s0:s0 + blk].astype(ld) - np.asarray(
                am[s0:s0 + blk]).astype(ld) @ xl
            rr += np.sum(r * r)
        return float(np.sqrt(rr) / ld(np.linalg.norm(b)))
    return rel


def host_outer_runs(ops, api, cli, lio, a_path, b_path, tmp, n, kernels,
                    not_kernels, device_cold_s, device_warm_s, device_iters,
                    total):
    """irfq --outer host on a fresh copy of the matrix file, cold (the
    native pack, published, four buffers uploaded) and warm (the partial
    q1 read), through the CLI in process (HOST_RUNS), held as the module
    docstring's phase 3 says. Adds the launches to `total`; returns {run:
    x}."""
    from lam_tpu_torch import _native_io
    host_path = os.path.join(tmp, "A_host.bin")
    shutil.copyfile(a_path, host_path)
    b = lio.read_vector(b_path)
    true_rel = _exact_true_rel(host_path, lio, b)
    plain = [fn.__name__ for fn in ops.PLAIN]
    xs, iters_of = {}, {}
    for run, packs in HOST_RUNS:
        x_path = os.path.join(tmp, f"x_{run}.bin")
        argv = ["-A", host_path, "-b", b_path, "-o", x_path, "--precision",
                "irfq", "--outer", "host", "--pack-cache", "--device", "cuda"]
        csv = io.StringIO()
        ops.reset_counters()
        _native_io.reset_calls()
        with _recorded_facades(api) as seen, _load_memory(api) as mem, \
                _host_cycles() as cycles, contextlib.redirect_stdout(csv):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        counts, native = ops.counters(), _native_io.calls()
        _check(rc == 0, f"N={n} irfq {run}: the CLI exited {rc}")
        facade = seen[-1]
        t = dict(facade.timings)
        operand = facade.op.operand
        need = sum(operand[i].numel() * operand[i].element_size()
                   for i in (0, 3, 6, 7))
        del facade, operand
        seen.clear()
        gc.collect()
        torch.cuda.empty_cache()
        before, after, peak = mem[0]
        x = lio.read_vector(x_path)
        rel = true_rel(x)
        iters = t["num_iters"]
        print(f"N={n} irfq {run} CSV: {csv.getvalue().strip()}")
        print(f"N={n} irfq {run}: load {t['load_s']:.3f} s (device outer: "
              f"cold {device_cold_s:.3f} s, warm {device_warm_s:.3f} s), "
              f"solve {t['solve_s']:.4f} s, {len(cycles)} cycles (host "
              f"matvecs {sum(cycles):.3f} s), {iters} inner iterations "
              f"(device outer {device_iters}), reported residual "
              f"{t['rel_residual']:.6e}, independent TRUE residual "
              f"{rel:.6e}; device +{after - before} B across the load "
              f"(peak +{peak - before} B) for {need} B of q1, s1, dh, dl; "
              f"native calls {native}; launches "
              f"{({k: v for k, v in counts.items() if v})}")
        _check(t["rel_residual"] <= 1e-9 and iters <= 10000,
               f"N={n} irfq {run} did not converge")
        _check(rel <= TRUE_GATE, f"N={n} irfq {run}: TRUE residual "
               f"{rel:.3e} above {TRUE_GATE:g}")
        _check(abs(t["rel_residual"] - rel) <= HOST_ERR_GATE * rel,
               f"N={n} irfq {run}: reported residual {t['rel_residual']:.6e}"
               f" is not the TRUE residual {rel:.6e}")
        _check(max(after, peak) - before <= HOST_MEM_GATE * need,
               f"N={n} irfq {run}: the device grew by {after - before} B "
               f"(peak {peak - before} B) for {need} B of q1 buffers")
        _check(abs(iters - device_iters) <= HOST_ITERS_GATE * device_iters,
               f"N={n} irfq {run}: {iters} inner iterations, device outer "
               f"{device_iters}")
        if packs:
            _check(native.get("pack_fq", 0) > 0,
                   f"N={n} irfq {run} did not pack natively: {native}")
        else:
            _check(not any(k.startswith("pack_") for k in native),
                   f"N={n} irfq {run} packed ({native}): no partial read")
        for k in kernels:
            _check(counts[k] > 0, f"N={n} irfq {run} never launched {k}")
        for k in not_kernels + ("gemv_fq_symm", "gemv_fq_symm_zero"):
            _check(counts[k] == 0, f"N={n} irfq {run} launched {k}")
        _check(all(counts[k] == 0 for k in plain),
               f"a plain version ran on the N={n} irfq {run} path")
        for k in total:
            total[k] += counts[k]
        xs[run], iters_of[run] = x, iters
    _check(np.array_equal(xs["host-warm"], xs["host-cold"])
           and iters_of["host-warm"] == iters_of["host-cold"],
           f"N={n} irfq --outer host from the cache differs from a cold "
           "pack")
    return xs


def rank_main(argv):
    """One rank of a phase-5 cluster (`chip_smoke.py --rank r --ranks G
    --port P --jobs J --out D`): joins the process group, runs every job
    of J through the port's CLI in process with --backend sharded (or the
    job's own --backend; a job with an "app" through lam-heat-torch's or
    lam-bench-torch's main with the rank flags), and
    writes D/rank<r>.json with each job's exit code, output, launch
    counts and the mesh's backend and device."""
    import argparse

    import torch.distributed as dist

    from lam_tpu_torch import cli, ops
    from lam_tpu_torch.parallel import mesh as pmesh
    from lam_tpu_torch.solver import api

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
        if "app" in job:  # lam-heat-torch or lam-bench-torch
            from lam_tpu_torch.apps import heat_cli
            from lam_tpu_torch.bench import runner
            app = {"heat": heat_cli.main, "bench": runner.main}[job["app"]]
            with contextlib.redirect_stdout(out):
                rc = app(job["argv"] + [
                    "--device", "cuda", "--coordinator", address,
                    "--num-processes", str(args.ranks), "--process-id",
                    str(args.rank)])
            torch.cuda.synchronize()
            results.append({"run": job["run"], "rc": rc,
                            "stdout": out.getvalue(),
                            "counts": ops.counters(),
                            "backend": mesh.backend,
                            "device": str(mesh.device)})
            continue
        if "ckpt_stop" in job:
            timings = _ckpt_stop(job["ckpt_stop"])
            torch.cuda.synchronize()
            results.append({"run": job["run"], "rc": 0, "stdout": "",
                            "counts": ops.counters(),
                            "backend": mesh.backend,
                            "device": str(mesh.device), "timings": timings,
                            "plane_bytes": []})
            gc.collect()
            torch.cuda.empty_cache()
            continue
        if "tiles" in job:
            timings = _tiles_grid_solve(job)
            torch.cuda.synchronize()
            results.append({"run": job["run"], "rc": 0, "stdout": "",
                            "counts": ops.counters(),
                            "backend": mesh.backend,
                            "device": str(mesh.device), "timings": timings,
                            "plane_bytes": []})
            gc.collect()
            torch.cuda.empty_cache()
            continue
        with _recorded_facades(api) as seen, contextlib.redirect_stdout(out):
            backend = ([] if "--backend" in job["argv"]
                       else ["--backend", "sharded"])
            rc = cli.main(job["argv"] + backend + [
                "--device", "cuda", "--init-col",
                "--coordinator", address, "--num-processes",
                str(args.ranks), "--process-id", str(args.rank)])
        torch.cuda.synchronize()
        # the facade's unrounded timings and the bytes of its operand's
        # planes of the first plane's shape (not a broadcast tile)
        facade = seen[-1] if seen else None
        planes = []
        if facade is not None:
            operand = facade.op.operand
            operand = operand if isinstance(operand, tuple) else (operand,)
            planes = [x.numel() * x.element_size() for x in operand
                      if x.shape == operand[0].shape]
        results.append({"run": job["run"], "rc": rc, "stdout": out.getvalue(),
                        "counts": ops.counters(), "backend": mesh.backend,
                        "device": str(mesh.device),
                        "timings": {} if facade is None
                        else dict(facade.timings),
                        "plane_bytes": planes})
        # the next job finds the card as this one did: nothing held
        seen.clear()
        del facade
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _tiles_grid_solve(job):
    """One rank of a phase-9 run over a tile handed in: the symmetric R=2
    grid's gen operator of job["storage"] at N=job["tiles"] rebuilt on
    every rank with the lo tile TILES_EPS * I (df64) or the q2 tile I
    against s2 = TILES_EPS (fq; the diagonal ranks' triangle kernel and
    the others' dual kernel read it at every tile), solved by cg_solve to
    1e-9; rank 0 saves x to job["x"] (.npy). Returns the solve's
    timings."""
    from lam_tpu_torch import cg_solve
    from lam_tpu_torch.parallel import pcg2d_symm
    from lam_tpu_torch.parallel.mesh import make_mesh2d
    n, tb = job["tiles"], 512
    mesh = make_mesh2d(device="cuda")
    eye = torch.eye(tb, device="cuda")
    if job["storage"] == "fq":
        gen = pcg2d_symm.Symm2DOperator.from_gen_fq(n, mesh=mesh)
        q1, _, q3, s1, _, s3, dh, dl = gen.operand
        operand = (q1, eye.to(torch.int16), q3, s1,
                   torch.full_like(s1, TILES_EPS), s3, dh, dl)
    else:
        gen = pcg2d_symm.Symm2DOperator.from_gen_tridiagonal(n, mesh=mesh)
        operand = (gen.operand[0], eye * TILES_EPS)
    op = pcg2d_symm.Symm2DOperator(operand, n, gen.n_padded, mesh, tb,
                                   job["storage"])
    del gen
    t0 = time.perf_counter()
    res = cg_solve(op, np.ones(n), max_iters=4 * n, rel_error=1e-9)
    x = res.x.cpu().numpy()
    solve_s = time.perf_counter() - t0
    if mesh.rank == 0:
        np.save(job["x"], x)
    return {"num_iters": int(res.num_iters),
            "converged": bool(res.converged),
            "rel_residual": float(res.rel_residual), "solve_s": solve_s}


def _free_ports(k):
    """k distinct free TCP ports of this host, their sockets held open
    together while they are picked."""
    import socket
    socks = [socket.socket() for _ in range(k)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def _cluster(g, jobs, tmp, env=None, label=None):
    """Run the jobs in a cluster of g rank processes of this script on the
    one card, with `env` added to their environment; returns each rank's
    records (`_clusters` of one)."""
    return _clusters([(g, jobs, env, label)], tmp)[0]


def _clusters(specs, tmp):
    """Run clusters side by side on the one card, each (g, jobs, env,
    label) a process group of g rank processes of this script with `env`
    added to their environment; returns each cluster's records, one list
    of job records a rank. Kills every rank and fails when one fails or
    the clusters outlive CLUSTER_TIMEOUT_S."""
    started = []
    for (g, jobs, env, label), port in zip(specs, _free_ports(len(specs))):
        out = os.path.join(tmp, label or f"cluster{g}")
        os.makedirs(out, exist_ok=True)
        jobs_path = os.path.join(out, "jobs.json")
        with open(jobs_path, "w") as f:
            json.dump(jobs, f)
        logs = [open(os.path.join(out, f"rank{r}.log"), "w")
                for r in range(g)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--ranks", str(g), "--port", str(port), "--jobs", jobs_path,
             "--out", out], stdout=logs[r], stderr=subprocess.STDOUT,
            env=None if env is None else {**os.environ, **env})
            for r in range(g)]
        started.append((g, out, logs, procs))
    deadline = time.monotonic() + CLUSTER_TIMEOUT_S
    every = [proc for _, _, _, procs in started for proc in procs]
    try:
        for proc in every:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in every:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for _, _, logs, _ in started:
            for log in logs:
                log.close()
    failed = []
    for g, out, _, procs in started:
        codes = [proc.returncode for proc in procs]
        if any(codes):
            for r in range(g):
                with open(os.path.join(out, f"rank{r}.log")) as f:
                    print(f"--- rank {r} of {g} (exit {codes[r]}):\n"
                          + f.read()[-3000:])
            failed.append(f"the {g}-rank cluster failed: exit codes "
                          f"{codes}")
    if failed:
        raise AssertionError("; ".join(failed))
    records = []
    for g, out, _, _ in started:
        ranks = []
        for r in range(g):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        records.append(ranks)
    return records


def sharded_runs(ops, lio, system, local_xs, local_iters, tmp):
    """Phase 5: the bench system through the port's CLI with --backend
    sharded, G rank processes on the one card over gloo, one cluster per
    G running its entries of SHARDED_RUNS in order; last in the 2-rank
    cluster, phase 13's sharded row (`bench_sharded_row`). Returns the
    kernel launches summed over the runs and ranks (that row's apart) and
    that row."""
    a, b, a_path, b_path = system
    x_local = local_xs["ir"]
    bnorm = np.linalg.norm(b)
    total = {fn.__name__: 0 for fn in ops.KERNELS}
    plain = [fn.__name__ for fn in ops.PLAIN]
    xs, iters_of = {}, {}
    clusters = [(g, [r for r in SHARDED_RUNS if r[1] == g], None)
                for g in SHARD_G] + [(4, MXU_RUNS, MXU_ENV)]
    bench_csv = os.path.join(tmp, "bench_sharded.csv")
    specs = []
    for g, runs, env in clusters:
        jobs = [{"run": run, "argv": ["-A", a_path, "-b", b_path, "-o",
                                      os.path.join(tmp, f"x_{run}.bin"),
                                      *flags]}
                for run, _, flags, _, _ in runs]
        if g == 2 and env is None:
            jobs.append({"run": BENCH_SHARDED_RUN, "app": "bench",
                         "argv": BENCH_SHARDED_FLAGS + ["-o", bench_csv]})
        specs.append((g, jobs, env, f"cluster{g}" + ("-mxu" if env else "")))
    # the G=2 and G=4 clusters side by side (their own files, a few GB of
    # the card), then the mxu cluster alone
    t0 = time.perf_counter()
    every = _clusters(specs[:2], tmp)
    print(f"{' and '.join(str(g) for g, _, _ in clusters[:2])}-rank "
          f"clusters side by side: {time.perf_counter() - t0:.1f} s of wall "
          "time")
    t0 = time.perf_counter()
    every += _clusters(specs[2:], tmp)
    print(f"{clusters[2][0]}-rank cluster with {clusters[2][2]}: "
          f"{time.perf_counter() - t0:.1f} s of wall time")
    for (g, runs, env), records in zip(clusters, every):
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
            x_ref = local_xs[JACOBI_OF.get(run, "ir")]
            x_rel = float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))
            x_gate = X_ENGINE_GATE if env else X_GATE
            meshes = sorted({(rec["backend"], rec["device"]) for rec in recs})
            beside = "" if env else ", taken beside the other cluster"
            print(f"{run}: {g} ranks on {meshes}{beside}, load "
                  f"{load_s:.3f} s, init {init_s:.3f} s, {iters} "
                  f"iterations, solve "
                  f"{solve_s:.4f} s, avg gemv {gemv_s * 1e3:.3f} ms, TRUE "
                  f"rel residual {true_rel:.3e} "
                  f"(<= {TRUE_GATE:g}), x vs one-device "
                  f"{JACOBI_OF.get(run, 'ir')} {x_rel:.3e} "
                  f"(<= {x_gate:g}), launches rank 0 "
                  f"{ {k: v for k, v in recs[0]['counts'].items() if v} }")
            if run in ONE_DEVICE_OF:
                print(f"{run}: {iters} iterations; the one-device "
                      f"{ONE_DEVICE_OF[run]} run took "
                      f"{local_iters[ONE_DEVICE_OF[run]]}")
            if run in WALK_RUN_ITERS:
                print(f"{run}: {iters} iterations through the new "
                      f"walks; {WALK_RUN_ITERS[run]} before them")
                _check(iters == WALK_RUN_ITERS[run],
                       f"{run}: the iteration count moved")
            xs[run], iters_of[run] = x, iters
            _check(iters <= 10000, f"{run} did not converge")
            _check(true_rel <= TRUE_GATE, f"{run} TRUE residual "
                   f"{true_rel:.3e} above {TRUE_GATE:g}")
            _check(x_rel <= x_gate, f"{run}: x differs from the one-device "
                   f"{JACOBI_OF.get(run, 'ir')} solve by {x_rel:.3e}")
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
        if g == 2 and env is None:
            bench_row = bench_sharded_row(
                [rank_recs[len(runs)] for rank_recs in records], bench_csv,
                plain)
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
    return total, bench_row


def bench_sharded_row(recs, csv_path, plain):
    """Phase 13's sharded row, run in phase 5's 2-rank cluster: both ranks
    through lam-bench-torch's main with the rank flags, spd mode in memory
    at N=10000 (each rank builds its own band pair through the facade's
    _build_operator), --precision irfq. Rank 0 alone prints and appends its
    row: procs 2, phase 5's packed-irfq count, err <= 2e-9; every rank
    launched kernels 16 and 17 and nothing else, no plain version. Returns
    the row; its launches stay out of the kernels line."""
    run = BENCH_SHARDED_RUN
    _check(all(rec["run"] == run and rec["rc"] == 0 for rec in recs),
           f"{run}: a rank's lam-bench-torch failed: "
           f"{[rec['rc'] for rec in recs]}")
    _check(not any(rec["stdout"].strip() for rec in recs[1:]),
           f"{run}: a rank other than 0 printed")
    line = recs[0]["stdout"].strip()
    with open(csv_path) as f:
        _check(f.read().splitlines() == [line],
               f"{run}: the CSV holds other rows than rank 0's {line!r}")
    fields = line.split(",")
    print(f"phase 13 {run} (in phase 5's 2-rank cluster) CSV (N,procs,"
          f"threads,load_s,avg_gemv_s,avg_iter_s,num_iter,err,total_cg_s): "
          f"{line}")
    _check(fields[:3] == [str(N), "2", "1"], f"{run}: row {line}")
    _check(int(fields[6]) == BENCH_SHARDED_ITERS,
           f"{run}: {fields[6]} iterations, not phase 5's "
           f"{BENCH_SHARDED_ITERS}")
    _check(float(fields[7]) <= TRUE_GATE, f"{run}: err {fields[7]}")
    for r, rec in enumerate(recs):
        launched = {k: v for k, v in rec["counts"].items() if v}
        print(f"phase 13 {run}: rank {r} launches {launched}")
        _check(sorted(launched) == sorted(_QFQ), f"{run}: rank {r} "
               f"launched {sorted(launched)}, not {sorted(_QFQ)}")
        _check(not any(rec["counts"][k] for k in plain),
               f"{run}: a plain version ran on rank {r}")
    return line


def _ckpt_stop(spec):
    """One rank of phase 11's stopped mesh run: the facade's operator
    (--backend sharded, the phase-5 shard cache), cg_solve_ir_resumable
    stopped after its first refinement cycle with its state in
    spec["dir"]. Returns the cycle's inner iterations and seconds."""
    from lam_tpu_torch.solver import api
    from lam_tpu_torch.solver import checkpoint as ckpt
    from lam_tpu_torch.solver.cg import default_inner_floor
    cg = api.ConjugateGradient(backend="sharded", precision=spec["precision"],
                               device="cuda", pack_cache=True)
    cg.load_matrix_from_file(spec["a"])
    cg.load_rhs_from_file(spec["b"])
    _, cycles = ckpt.cg_solve_ir_resumable(
        cg.op.as_f32(), cg.op, cg.rhs, max_iters=10000, rel_error=1e-9,
        inner_floor=default_inner_floor(spec["precision"]), max_cycles=1,
        checkpoint_path=spec["dir"])
    return {"inner": [k for k, _ in cycles], "cycle_s": [t for _, t in cycles],
            "load_s": cg.timings["load_s"]}


def checkpoint_runs(ops, lio, cli, system, tmp):
    """Phase 11: resumable solves and the plain-torch engines on phase 3's
    file (see the module docstring). Returns nothing: its launches stay
    out of the kernels line."""
    from lam_tpu_torch import cg_solve_block
    from lam_tpu_torch.solver import checkpoint as ckpt
    from lam_tpu_torch.solver.cg import default_inner_floor
    from lam_tpu_torch.solver.operators import DenseOperator
    t_phase = time.perf_counter()
    a, b, a_path, b_path = system
    bnorm = np.linalg.norm(b)
    plain = [fn.__name__ for fn in ops.PLAIN]
    ck = os.path.join(tmp, "ckpt")

    def run(label, flags, kernels, iters=None):
        x_path = os.path.join(tmp, f"x_ck_{label}.bin")
        rc, fields, counts = _cli_run(ops, cli, ["-A", a_path, "-b", b_path,
                                                 "-o", x_path, *flags])
        _check(rc == 0, f"phase 11 {label}: the CLI exited {rc}")
        got = int(fields[6])
        x = lio.read_vector(x_path)
        true_rel = float(np.linalg.norm(b - a @ x) / bnorm)
        launched = {k: v for k, v in counts.items() if v}
        print(f"phase 11 {label}: load_s {float(fields[3]):.3f}, solve_s "
              f"{float(fields[8]):.4f}, CSV num_iter {got}, TRUE rel "
              f"residual {true_rel:.3e}, launches {launched}")
        _check(all(counts[k] == 0 for k in plain),
               f"phase 11 {label}: a plain version ran")
        if kernels:
            for k in kernels:
                _check(counts[k] > 0, f"phase 11 {label} never launched {k}")
        else:
            _check(not launched, f"phase 11 {label} launched a port kernel")
        if iters is not None:
            _check(got == iters, f"phase 11 {label}: {got} iterations, "
                   f"not {iters}")
        if not label.endswith("-stop"):
            _check(true_rel <= TRUE_GATE, f"phase 11 {label}: TRUE "
                   f"residual {true_rel:.3e} above {TRUE_GATE:g}")
        return got, x

    # CG and Jacobi PCG: stopped by -i, resumed, against a whole run
    for label, flags, kernels in (
            ("df64", ["--precision", "df64"], ("gemv_df64_symm",)),
            ("df64-jacobi", ["--precision", "df64", "--preconditioner",
                             "jacobi"], ("gemv_df64_symm",))):
        d = os.path.join(ck, label)
        stop = CKPT_STOP[label]
        run(f"{label}-stop", flags + ["--checkpoint", d, "-i", str(stop),
                                      "--checkpoint-every", "100"],
            kernels, stop + 1)
        _, x_res = run(f"{label}-resume", flags + ["--checkpoint", d,
                                                   "--resume"],
                       kernels, CKPT_ITERS[label])
        _, x_whole = run(f"{label}-whole", flags + [
            "--checkpoint", d + "-whole", "--checkpoint-every", "100"],
            kernels, CKPT_ITERS[label])
        _check(np.array_equal(x_res, x_whole),
               f"phase 11 {label}: the resumed x differs from the "
               "uninterrupted run's")
        print(f"phase 11 {label}: stopped at {stop}, resumed to "
              f"{CKPT_ITERS[label]}, x bitwise the uninterrupted run's")
    # ir and irfq: stopped after the first cycle through the API
    for precision, ctor, flags, kernels in (
            ("ir", DenseOperator.from_file_df64, [],
             ("gemv_f32_symm", "gemv_df64_symm")),
            ("irfq", DenseOperator.from_file_fq, ["--pack-cache"],
             ("gemv_q16_symm", "gemv_fq_symm"))):
        d = os.path.join(ck, precision)
        op = ctor(a_path, pack_cache=bool(flags), device="cuda")
        ops.reset_counters()
        t0 = time.perf_counter()
        _, cycles = ckpt.cg_solve_ir_resumable(
            op.as_f32(), op, b, max_iters=10000, rel_error=1e-9,
            inner_floor=default_inner_floor(precision), max_cycles=1,
            checkpoint_path=d)
        counts = ops.counters()
        print(f"phase 11 {precision}-stop (API, max_cycles=1): "
              f"{cycles[0][0]} inner iterations in "
              f"{time.perf_counter() - t0:.3f} s, launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        _check(all(counts[k] > 0 for k in kernels)
               and all(counts[k] == 0 for k in plain),
               f"phase 11 {precision}-stop: not the kernels of its path")
        del op
        gc.collect()
        torch.cuda.empty_cache()
        base = ["--precision", precision, *flags]
        _, x_res = run(f"{precision}-resume", base + ["--checkpoint", d,
                                                      "--resume"],
                       kernels, CKPT_ITERS[precision])
        _, x_whole = run(f"{precision}-whole",
                         base + ["--checkpoint", d + "-whole"], kernels,
                         CKPT_ITERS[precision])
        _check(np.array_equal(x_res, x_whole),
               f"phase 11 {precision}: the resumed x differs from the "
               "uninterrupted run's")
    # packed-irfq at G=2: stopped after its first cycle, resumed
    d = os.path.join(ck, "packed-irfq")
    jobs = [{"run": "ck-packed-irfq-stop",
             "ckpt_stop": {"precision": "irfq", "a": a_path, "b": b_path,
                           "dir": d}},
            {"run": "ck-packed-irfq-resume",
             "argv": ["-A", a_path, "-b", b_path, "-o",
                      os.path.join(tmp, "x_ck_packed.bin"), "--precision",
                      "irfq", "--pack-cache", "--checkpoint", d,
                      "--resume"]}]
    t0 = time.perf_counter()
    records = _cluster(2, jobs, tmp, label="cluster2-ckpt")
    print(f"phase 11 2-rank cluster: {time.perf_counter() - t0:.1f} s of "
          "wall time")
    for j, job in enumerate(jobs):
        recs = [rank_recs[j] for rank_recs in records]
        _check(all(rec["rc"] == 0 for rec in recs),
               f"{job['run']}: a rank failed")
        for rec in recs:
            launched = {k: v for k, v in rec["counts"].items() if v}
            _check(all(rec["counts"][k] > 0 for k in _QFQ)
                   and all(rec["counts"][k] == 0 for k in plain),
                   f"{job['run']}: not the kernels of its path: {launched}")
        print(f"phase 11 {job['run']}: rank 0 timings "
              f"{recs[0].get('timings')}, rank 0 launches "
              f"{ {k: v for k, v in recs[0]['counts'].items() if v} }")
    fields = records[0][1]["stdout"].strip().split(",")
    x = lio.read_vector(os.path.join(tmp, "x_ck_packed.bin"))
    true_rel = float(np.linalg.norm(b - a @ x) / bnorm)
    print(f"phase 11 ck-packed-irfq-resume CSV: {','.join(fields)}; TRUE "
          f"rel residual {true_rel:.3e}")
    _check(int(fields[7]) == WALK_RUN_ITERS["packed-irfq-cold"]
           and true_rel <= TRUE_GATE,
           "phase 11 packed-irfq G=2: the resumed run's count or residual")
    # the plain-torch engines: no port kernel
    for label, flags in (("xla-df64", ["--precision", "df64", "--engine",
                                       "xla"]),
                         ("f64", ["--precision", "f64"])):
        got, _ = run(label, flags, ())
        _check(abs(got - CKPT_ITERS["df64"]) <= 2,
               f"phase 11 {label}: {got} iterations, not within 2 of "
               f"{CKPT_ITERS['df64']}")
    # block CG on the packed df64 operator: the triangle's block walk
    op = DenseOperator.from_file_df64(a_path, device="cuda")
    rhs = np.column_stack([b] + [np.random.default_rng(SEED_B + j).uniform(
        -1, 1, N) for j in range(1, BLOCK_K)])
    ops.reset_counters()
    t0 = time.perf_counter()
    res = cg_solve_block(op, rhs, max_iters=10000, rel_error=1e-9)
    x = res.x.cpu().numpy()
    solve_s = time.perf_counter() - t0
    counts = ops.counters()
    rels = [float(np.linalg.norm(rhs[:, j] - a @ x[:, j])
                  / np.linalg.norm(rhs[:, j])) for j in range(BLOCK_K)]
    print(f"phase 11 block-df64 (k={BLOCK_K}): solve_s {solve_s:.4f}, "
          f"iterations {res.num_iters.tolist()}, TRUE rel residuals "
          f"{[f'{r:.3e}' for r in rels]}, launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    _check(bool(res.converged.all()) and max(rels) <= TRUE_GATE,
           "phase 11 block-df64: a column did not converge")
    _check(not any(counts.values()), "phase 11 block-df64 launched a port "
           "kernel")
    del op, res
    torch.cuda.empty_cache()
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s")


def large_system_runs(ops, gemv, generate, lio, cli, tmp):
    """Phase 6: bench.py's system at its second size, N=20000 (padded to
    20480: 'auto' picks the bf16 engine of the q16 kernels there), through
    the port's CLI: irfq --pack-cache cold and warm under 'auto' (the bf16
    triangle walk and the fq walk, not the exact q16 body; warm gives the
    same count and a bitwise-equal x), irfq with the engine set to 'vpu'
    (the exact body, not the bf16 one), and packed-irfq at G=2 (--backend
    sharded, p the full 20480 vector: every rank the bf16 slab walk and the
    fq slab walk, nothing else). Each converged, TRUE <= 2e-9 on the host,
    x within X_ENGINE_GATE of the 'vpu' run's x, no plain version. Then one
    cold fq load by the numpy pack, timed, and irfq --outer host cold and
    warm (host_outer_runs: the bf16 body). Returns the kernel launches
    summed over the runs and ranks."""
    from lam_tpu_torch import _native_io
    from lam_tpu_torch.solver import api
    from lam_tpu_torch.solver import operators as tops
    t_phase = time.perf_counter()
    a, b, a_path, b_path = bench_system(generate, N_LARGE, lio, tmp)
    bnorm = np.linalg.norm(b)
    total = {fn.__name__: 0 for fn in ops.KERNELS}
    plain = [fn.__name__ for fn in ops.PLAIN]
    bf16_run = (("gemv_q16_symm_bf16", "gemv_fq_symm"), ("gemv_q16_symm",))
    runs = (("irfq-cold", "auto") + bf16_run, ("irfq-warm", "auto") + bf16_run,
            ("irfq-vpu", "vpu", ("gemv_q16_symm", "gemv_fq_symm"),
             ("gemv_q16_symm_bf16",)))
    xs, iters_of, load_of = {}, {}, {}

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
        xs[run], iters_of[run], load_of[run] = x, iters, load_s
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
    available = _native_io.available
    _native_io.available = lambda: False
    try:
        t0 = time.perf_counter()
        op = tops.DenseOperator.from_file_fq(a_path, device="cuda")
        torch.cuda.synchronize()
        numpy_s = time.perf_counter() - t0
    finally:
        _native_io.available = available
    del op
    gc.collect()
    torch.cuda.empty_cache()
    print(f"N={N_LARGE} fq: cold load {load_of['irfq-cold']:.3f} s by the "
          f"native streamed pack (irfq-cold's load_s, published too) vs "
          f"{numpy_s:.3f} s by the numpy pack (pack and upload)")
    del a
    gc.collect()
    xs.update(host_outer_runs(
        ops, api, cli, lio, a_path, b_path, tmp, N_LARGE,
        ("gemv_q16_symm_bf16",), ("gemv_q16_symm",), load_of["irfq-cold"],
        load_of["irfq-warm"], iters_of["irfq-cold"], total))
    upload_turns(a_path)
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


def upload_turns(a_path, turns=3):
    """Phase 6: the q1 plane of A.bin.fqpack (432 MB at N=20000) to the
    card in turns, through the pinned ring (stream_file_to_device from the
    file, to_device from memory) and by plain copies (np.fromfile then
    .to(), torch.from_numpy(...).to()), each result bit for bit the
    plain one's; the file is in the page cache (warm)."""
    from lam_tpu_torch.ops import transfer
    from lam_tpu_torch.solver import pack_cache as pc
    path = pc.cache_path(a_path, "fq")
    with open(path, "rb") as fh:
        _, _, _, specs, offs = pc._offsets(fh, a_path, "fq")
    dtype, shape = specs[0]
    count = int(np.prod(shape))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    host = np.fromfile(path, dtype, count, offset=offs[0]).reshape(shape)
    rows = {k: [] for k in ("stream", "fromfile", "to_device", "plain")}
    for _ in range(turns):
        for k, fn in (
                ("stream", lambda: transfer.stream_file_to_device(
                    path, offs[0], dtype, shape, "cuda")),
                ("fromfile", lambda: torch.from_numpy(np.fromfile(
                    path, dtype, count, offset=offs[0]).reshape(shape)).to(
                        "cuda")),
                ("to_device", lambda: transfer.to_device(host, "cuda")),
                ("plain", lambda: torch.from_numpy(host).to("cuda"))):
            dt, out = timed(fn)
            rows[k].append(dt)
            if k == "stream":
                ref = out
            else:
                _check(torch.equal(out, ref), f"upload {k} differs")
            del out
        del ref
    print(f"N={N_LARGE} q1 plane upload ({host.nbytes} B, warm), {turns} "
          f"turns: stream_file_to_device "
          f"{[round(x, 4) for x in rows['stream']]} s vs np.fromfile + "
          f".to() {[round(x, 4) for x in rows['fromfile']]} s; to_device "
          f"{[round(x, 4) for x in rows['to_device']]} s vs "
          f"torch.from_numpy(...).to() {[round(x, 4) for x in rows['plain']]}"
          " s")
    torch.cuda.empty_cache()


def _tridiag_mv(x):
    """Generate mode's tridiagonal (2 on the diagonal, 1 beside it) times
    x, O(n), in f64 on the host: no N^2 matrix is built for a check."""
    y = 2.0 * x
    y[1:] += x[:-1]
    y[:-1] += x[1:]
    return y


def _gen_true(x):
    """TRUE |b - A x| / |b| of generate mode's system (b = ones)."""
    return float(np.linalg.norm(1.0 - _tridiag_mv(x)) / np.sqrt(x.shape[0]))


def _host_cg(n, max_iters, rel_error):
    """f64 CG on the host over generate mode's system, with the port's
    update order and stopping rule: (x, iterations)."""
    b = np.ones(n)
    x = np.zeros(n)
    r, p = b.copy(), b.copy()
    rr = bb = float(r @ r)
    k = 0
    while k < max_iters and np.sqrt(rr / bb) >= rel_error:
        ap = _tridiag_mv(p)
        alpha = rr / float(p @ ap)
        x += alpha * p
        r -= alpha * ap
        rr_new = float(r @ r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        k += 1
    return x, k


@contextlib.contextmanager
def _recorded_facades(api):
    """The facades whose solves the CLI records, in order, so a run's
    timings can be read unrounded (the CSV prints %g)."""
    seen = []
    orig = api.ConjugateGradient.record_result

    def record(self, result, solve_s):
        seen.append(self)
        return orig(self, result, solve_s)
    api.ConjugateGradient.record_result = record
    try:
        yield seen
    finally:
        api.ConjugateGradient.record_result = orig


def _gen_cli(ops, cli, api, argv):
    """One generate-mode run through the CLI in process: (CSV fields, the
    facade's timings, launch counters), the facade released."""
    csv = io.StringIO()
    ops.reset_counters()
    with _recorded_facades(api) as seen, contextlib.redirect_stdout(csv):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    counts = ops.counters()
    _check(rc == 0, f"CLI {' '.join(argv)} exited {rc}")
    timings = dict(seen[-1].timings)
    seen.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return csv.getvalue().strip().split(","), timings, counts


def _gen_counts(run, counts, kernels, not_kernels, total):
    from lam_tpu_torch import ops
    for k in kernels:
        _check(counts[k] > 0, f"{run} never launched {k}")
    for k in not_kernels:
        _check(counts[k] == 0, f"{run} launched {k}: the storage or "
               "engine was not honoured")
    _check(all(counts[fn.__name__] == 0 for fn in ops.PLAIN),
           f"a plain version ran on the {run} path")
    for k in total:
        total[k] += counts[k]


def _tiles_mv(x, tb):
    """Generate mode's tridiagonal plus TILES_EPS * I in every (tb, tb)
    block (the walk's tiles each read TILES_EPS * I, the mirror of an
    off-diagonal one too), times x: O(n), in f64 on the host."""
    return _tridiag_mv(x) + TILES_EPS * np.tile(x.reshape(-1, tb).sum(0),
                                                x.shape[0] // tb)


def handed_tiles_runs(ops, api, pcg_symm, Mesh):
    """Phase 8, the tile-reading walks of kernels 15, 9 and 17 on the main
    path: operators built from generate mode's planes at TILES_N with a
    broadcast tile handed in that is not zero, TILES_EPS * I (fq: q2 = I
    with s2 = TILES_EPS, q3 zero; df64: the lo tile), through
    `DenseOperator.from_fq_planes` and the `SymmShardedOperator`
    constructor (packed df64 and fq) on a mesh of one rank, solved by
    `cg_solve` to 1e-9 (kernel 12's: phase 9, `MESH_TILES_RUNS`). Each
    converged with a TRUE residual <= 2e-9 of the system with the tile (the
    O(n) host product `_tiles_mv`), far above it for the tridiagonal alone
    (the tile was read), its tile-reading walk launched and the zero-tile
    kernel not, no plain version. Returns the launches."""
    from lam_tpu_torch import DenseOperator, cg_solve
    t_phase = time.perf_counter()
    tb = 512
    total = {fn.__name__: 0 for fn in ops.KERNELS}
    cg = api.ConjugateGradient(precision="fq", device="cuda")
    cg.generate_matrix(TILES_N)
    q1, _, zq, s1, _, s3, dh, dl = cg.op.operand
    eye = torch.eye(tb, device="cuda")
    fq = DenseOperator.from_fq_planes(
        q1, eye.to(torch.int16), zq, s1, torch.full_like(s1, TILES_EPS), s3,
        dh, dl, TILES_N, cg.op.n_padded, device="cuda")
    band = pcg_symm.SymmShardedOperator.from_gen_tridiagonal(
        TILES_N, mesh=Mesh(0, 1, "cuda"), packed=True)
    hi, _, *tables = band.operand
    df = pcg_symm.SymmShardedOperator(
        (hi, eye * TILES_EPS, *tables), TILES_N, band.n_padded, band.mesh,
        band.m, tb, "packed")
    band = pcg_symm.SymmShardedOperator.from_gen_fq(
        TILES_N, mesh=Mesh(0, 1, "cuda"))
    b1, _, bq3, b_s1, _, b_s3, *rest = band.operand
    band_fq = pcg_symm.SymmShardedOperator(
        (b1, eye.to(torch.int16), bq3, b_s1, torch.full_like(b_s1, TILES_EPS),
         b_s3, *rest), TILES_N, band.n_padded, band.mesh, band.m, tb, "fq")
    del cg, band
    b = np.ones(TILES_N)
    for run, op, walk, zero in (
            ("tiles-fq", fq, "gemv_fq_symm_bcast", "gemv_fq_symm_zero"),
            ("tiles-packed-df64", df, "gemv_df64_symm_slab_bcast",
             "gemv_df64_symm_slab_zero"),
            ("tiles-packed-fq", band_fq, "gemv_fq_symm_slab_bcast",
             "gemv_fq_symm_slab_zero")):
        ops.reset_counters()
        t0 = time.perf_counter()
        res = cg_solve(op, b, max_iters=4 * TILES_N, rel_error=1e-9)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        counts = ops.counters()
        x = res.x.cpu().numpy()
        true_rel = float(np.linalg.norm(b - _tiles_mv(x, tb))
                         / np.linalg.norm(b))
        tri_rel = _gen_true(x)
        print(f"{run}: {int(res.num_iters)} iterations in {solve_s:.3f} s, "
              f"TRUE rel residual {true_rel:.3e} (<= {TRUE_GATE:g}), "
              f"{tri_rel:.3e} against the tridiagonal alone, launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        _check(bool(res.converged) and true_rel <= TRUE_GATE,
               f"{run}: TRUE residual {true_rel:.3e}")
        _check(tri_rel > 1e3 * TRUE_GATE, f"{run}: the tile made no "
               "difference")
        _gen_counts(run, counts, (walk,), (zero,), total)
    print(f"phase 8, tiles handed in: {time.perf_counter() - t_phase:.1f} s")
    return total


def generate_runs(ops, lio, cli, tmp):
    """Phase 8: generate mode (`-s N`) through the port's CLI on the card,
    every system built on the device. At N=10000 (-e 1e-9) the runs of
    GEN_RUNS, each converged with a TRUE |b - A x| / |b| <= 2e-9 on the
    host (the O(N) tridiagonal product), its kernels launched and no plain
    version, df64's count within 1% of the host f64 CG's; then the
    reference's gen-sweep probes at N=150000 (-i 15, num_iter 16), one at
    a time, each operator freed before the next: df64's x within 1e-10 of
    the host f64 CG's after 15 iterations, and every probe's residual
    equal to the host's TRUE residual of its x within 1e-6, load_s and
    avg_gemv_s printed beside the plane's byte bound. Between them,
    `handed_tiles_runs`. Returns the kernel launches summed over the
    runs and each probe's avg_gemv_s (phase 13's yardstick)."""
    from lam_tpu_torch.ops import layout
    from lam_tpu_torch.parallel import pcg_symm
    from lam_tpu_torch.parallel.mesh import Mesh
    from lam_tpu_torch.solver import api
    t_phase = time.perf_counter()
    total = {fn.__name__: 0 for fn in ops.KERNELS}
    t0 = time.perf_counter()
    _, host_iters = _host_cg(GEN_N, 10 ** 6, 1e-9)
    print(f"gen N={GEN_N}: host f64 CG {host_iters} iterations "
          f"({time.perf_counter() - t0:.2f} s)")
    for run, flags, kernels, not_kernels in GEN_RUNS:
        x_path = os.path.join(tmp, f"x_{run}.bin")
        fields, timings, counts = _gen_cli(ops, cli, api, [
            "-s", str(GEN_N), "-e", "1e-9", "-o", x_path, "--device",
            "cuda"] + flags)
        iters = int(fields[6])
        x = lio.read_vector(x_path)
        true_rel = _gen_true(x)
        launched = {k: v for k, v in counts.items() if v}
        print(f"{run} CSV: {','.join(fields)}")
        print(f"{run}: load {timings['load_s']:.3f} s, {iters} iterations, "
              f"solve {timings['solve_s']:.4f} s, TRUE rel residual "
              f"{true_rel:.3e} (<= {TRUE_GATE:g}), launches {launched}")
        _check(timings["num_iters"] == iters <= 10000
               and timings["rel_residual"] < 1e-9, f"{run} did not converge")
        _check(true_rel <= TRUE_GATE, f"{run} TRUE residual {true_rel:.3e} "
               f"above {TRUE_GATE:g}")
        _gen_counts(run, counts, kernels, not_kernels, total)
        if run == "gen-df64":
            print(f"{run}: {iters} iterations, host f64 CG {host_iters} "
                  f"(within {GEN_COUNT_GATE:.0%})")
            _check(abs(iters - host_iters) <= GEN_COUNT_GATE * host_iters,
                   f"{run}: {iters} iterations against the host's "
                   f"{host_iters}")
        os.remove(x_path)
    print(f"phase 8, N={GEN_N}: {time.perf_counter() - t_phase:.1f} s")
    for k, v in handed_tiles_runs(ops, api, pcg_symm, Mesh).items():
        total[k] += v

    n_p = layout.padded_size(GEN_PROBE_N, layout.SYMM_TB)
    nblk = n_p // layout.SYMM_TB
    tile = layout.SYMM_TB * layout.SYMM_TB
    plane_bytes = {"hi": 4 * tile * layout.tri_tile_count(nblk),
                   "q1": 2 * tile * layout.padded_tri_tile_count(nblk)}
    x_host, k_host = _host_cg(GEN_PROBE_N, GEN_PROBE_ITERS, 1e-9)
    _check(k_host == GEN_PROBE_ITERS, "the host CG stopped early")
    probe_gemv_s = {}
    for run, precision, kernels, plane in GEN_PROBES:
        t0 = time.perf_counter()
        x_path = os.path.join(tmp, f"x_{run}.bin")
        fields, timings, counts = _gen_cli(ops, cli, api, [
            "-s", str(GEN_PROBE_N), "-i", str(GEN_PROBE_ITERS), "-o", x_path,
            "--precision", precision, "--device", "cuda"])
        print(f"{run} CSV: {','.join(fields)}")
        _check(fields[6] == str(GEN_PROBE_ITERS + 1),
               f"{run}: CSV num_iter {fields[6]}, not {GEN_PROBE_ITERS + 1}")
        x = lio.read_vector(x_path)
        true_rel = _gen_true(x)
        err = timings["rel_residual"]
        _check(fields[7] == f"{err:g}", f"{run}: CSV err {fields[7]}")
        err_rel = abs(err - true_rel) / true_rel
        bound_ms = plane_bytes[plane] / HBM_BYTES_PER_S * 1e3
        gemv_ms = timings["avg_gemv_s"] * 1e3
        acc = ""
        if "avg_gemv_acc_s" in timings:  # ir, irfq: the outer matvec
            acc_ms = timings["avg_gemv_acc_s"] * 1e3
            acc = (f", accurate matvec {acc_ms:.3f} ms "
                   f"(x{acc_ms / bound_ms:.3f})")
        print(f"{run}: load_s {timings['load_s']:.3f} s (the device build), "
              f"avg_gemv_s {gemv_ms:.3f} ms against the {bound_ms:.3f} ms "
              f"byte bound of its {plane_bytes[plane] / 1e9:.2f} GB plane "
              f"(x{gemv_ms / bound_ms:.3f}){acc}, solve_s "
              f"{timings['solve_s']:.4f} s, residual {err:.6e} against the "
              f"host TRUE {true_rel:.6e} (rel {err_rel:.2e} <= "
              f"{GEN_ERR_GATE:g}), launches "
              f"{ {k: v for k, v in counts.items() if v} }, "
              f"{time.perf_counter() - t0:.1f} s")
        _check(err_rel <= GEN_ERR_GATE, f"{run}: residual {err:.6e} against "
               f"the host TRUE {true_rel:.6e}")
        if precision == "df64":
            x_rel = float(np.linalg.norm(x - x_host) / np.linalg.norm(x_host))
            print(f"{run}: x against the host f64 CG's after "
                  f"{GEN_PROBE_ITERS} iterations {x_rel:.3e} "
                  f"(<= {GEN_X_GATE:g})")
            _check(x_rel <= GEN_X_GATE, f"{run}: x differs from the host "
                   f"CG's by {x_rel:.3e}")
        _gen_counts(run, counts, kernels, _TILE_WALKS, total)
        probe_gemv_s[run] = timings["avg_gemv_s"]
        os.remove(x_path)
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    return total, probe_gemv_s


def _mesh_kernels(run, r, kernels, not_kernels, names):
    """(kernels rank r must launch, kernels it must not) of a phase-9 run:
    on the symmetric grid a diagonal rank walks its triangle, the others
    their half-slab, and nothing else launches anywhere."""
    if "symgrid" in run:
        ran = kernels[r not in (0, 3)]
        return ran, [k for k in names if k not in ran]
    return kernels, not_kernels


def mesh_generate_runs(ops, lio, tmp):
    """Phase 9: generate mode on the meshes through the port's CLI, G rank
    processes of this script on the one card over gloo (phase 5's
    clusters, one for G=2 and one for G=4). At N=GEN_MESH_N (-e 1e-9) the
    runs of MESH_GEN_RUNS, each converged with a TRUE |b - A x| / |b| <= 2e-9
    on the host (the O(N) tridiagonal product of rank 0's x), procs = G in
    rank 0's CSV row, every rank's kernels launched and the others not, no
    plain version; the df64-class counts within 1% of a host f64 CG's on
    the same system, the refinement counts printed beside it. Then each
    cluster's N=150000 probes (-i 15, num_iter 16): df64's x within 1e-10
    of the host f64 CG's after 15 iterations, every probe's residual equal
    to the host's TRUE residual of its x within 1e-6; load_s (the device
    build), avg_gemv_s and the bytes of the ranks' planes (read from the
    operators' tensors) beside their byte bound, and the q16 engine each
    rank ran. Returns the kernel launches summed over the runs and ranks."""
    t_phase = time.perf_counter()
    names = [fn.__name__ for fn in ops.KERNELS]
    plain = [fn.__name__ for fn in ops.PLAIN]
    total = {k: 0 for k in names}
    _, host_iters = _host_cg(GEN_MESH_N, 10 ** 6, 1e-9)
    x_host, k_host = _host_cg(GEN_PROBE_N, GEN_PROBE_ITERS, 1e-9)
    _check(k_host == GEN_PROBE_ITERS, "the host CG stopped early")
    print(f"gen N={GEN_MESH_N}: host f64 CG {host_iters} iterations")
    for g in SHARD_G:
        runs = [r for r in MESH_GEN_RUNS if r[1] == g]
        probes = [r for r in MESH_GEN_PROBES if r[1] == g]
        jobs = [{"run": run, "argv": [
            "-s", str(GEN_MESH_N), "-e", "1e-9", "-o",
            os.path.join(tmp, f"x_{run}.bin"), *flags]}
            for run, _, flags, _, _ in runs]
        jobs += [{"run": run, "argv": [
            "-s", str(GEN_PROBE_N), "-i", str(GEN_PROBE_ITERS), "-o",
            os.path.join(tmp, f"x_{run}.bin"), *flags]}
            for run, _, flags, _ in probes]
        tiles = [r for r in MESH_TILES_RUNS if r[1] == g]
        jobs += [{"run": run, "tiles": n,
                  "storage": "fq" if "-fq-" in run else "df64",
                  "x": os.path.join(tmp, f"x_{run}.npy")}
                 for run, _, n, _, _ in tiles]
        t0 = time.perf_counter()
        records = _cluster(g, jobs, tmp, label=f"gen{g}")
        print(f"{g}-rank generate-mode cluster: {len(jobs)} runs in "
              f"{time.perf_counter() - t0:.1f} s of wall time")
        cases = ([(r, k, n) for r, _, _, k, n in runs]
                 + [(r, k, _TILE_WALKS) for r, _, _, k in probes])
        for j, (run, kernels, not_kernels) in enumerate(cases):
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
            _check(sorted({(rec["backend"], rec["device"]) for rec in recs})
                   == [("gloo", "cuda:0")], f"{run}: not gloo on cuda:0")
            t = recs[0]["timings"]
            iters = int(fields[7])
            x = lio.read_vector(os.path.join(tmp, f"x_{run}.bin"))
            true_rel = _gen_true(x)
            engines = [[k for k in _Q16_WALKS if rec["counts"][k]]
                       for rec in recs]
            for r, rec in enumerate(recs):
                ran, idle = _mesh_kernels(run, r, kernels, not_kernels,
                                          names)
                for k in ran:
                    _check(rec["counts"][k] > 0,
                           f"{run}: rank {r} never launched {k}")
                for k in idle:
                    _check(rec["counts"][k] == 0,
                           f"{run}: rank {r} launched {k}")
                _check(not any(rec["counts"][k] for k in plain),
                       f"{run}: a plain version ran on rank {r}")
                for k in names:
                    total[k] += rec["counts"][k]
            launched = {k: v for k, v in recs[0]["counts"].items() if v}
            if run.endswith("150k"):
                _check(fields[7] == str(GEN_PROBE_ITERS + 1),
                       f"{run}: CSV num_iter {fields[7]}, not "
                       f"{GEN_PROBE_ITERS + 1}")
                err = t["rel_residual"]
                err_rel = abs(err - true_rel) / true_rel
                nbytes = sum(sum(rec["plane_bytes"]) for rec in recs)
                bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
                gemv_ms = [rec["timings"]["avg_gemv_s"] * 1e3 for rec in recs]
                acc = ""
                if "avg_gemv_acc_s" in t:
                    acc_ms = t["avg_gemv_acc_s"] * 1e3
                    acc = f", rank 0's accurate matvec {acc_ms:.3f} ms"
                load_s = max(rec["timings"]["load_s"] for rec in recs)
                print(f"{run}: load_s {load_s:.3f} s (the slowest rank's "
                      f"device build), avg_gemv_s "
                      f"{min(gemv_ms):.3f}-{max(gemv_ms):.3f} ms over the "
                      f"ranks against the {bound_ms:.3f} ms byte bound of "
                      f"the ranks' {nbytes / 1e9:.2f} GB of planes on the "
                      f"one card (x{gemv_ms[0] / bound_ms:.3f} at rank 0)"
                      f"{acc}, solve_s {t['solve_s']:.4f} s, q16 engines "
                      f"by rank {engines}, residual {err:.6e} against the "
                      f"host TRUE {true_rel:.6e} (rel {err_rel:.2e} <= "
                      f"{GEN_ERR_GATE:g}), launches rank 0 {launched}")
                _check(err_rel <= GEN_ERR_GATE, f"{run}: residual {err:.6e} "
                       f"against the host TRUE {true_rel:.6e}")
                if "df64" in run:
                    x_rel = float(np.linalg.norm(x - x_host)
                                  / np.linalg.norm(x_host))
                    print(f"{run}: x against the host f64 CG's after "
                          f"{GEN_PROBE_ITERS} iterations {x_rel:.3e} (<= "
                          f"{GEN_X_GATE:g})")
                    _check(x_rel <= GEN_X_GATE, f"{run}: x differs from the "
                           f"host CG's by {x_rel:.3e}")
            else:
                print(f"{run}: {g} ranks, load {t['load_s']:.3f} s, {iters} "
                      f"iterations (host f64 CG {host_iters}), solve "
                      f"{t['solve_s']:.4f} s, avg gemv "
                      f"{t['avg_gemv_s'] * 1e3:.3f} ms, TRUE rel residual "
                      f"{true_rel:.3e} (<= {TRUE_GATE:g}), q16 engines by "
                      f"rank {engines}, launches rank 0 {launched}")
                _check(t["num_iters"] <= 10000 and t["rel_residual"] < 1e-9,
                       f"{run} did not converge")
                _check(true_rel <= TRUE_GATE, f"{run} TRUE residual "
                       f"{true_rel:.3e} above {TRUE_GATE:g}")
                if "df64" in run:
                    _check(abs(iters - host_iters)
                           <= GEN_COUNT_GATE * host_iters,
                           f"{run}: {iters} iterations against the host's "
                           f"{host_iters}")
            os.remove(os.path.join(tmp, f"x_{run}.bin"))
        for j, (run, _, n, kernels, not_kernels) in enumerate(
                tiles, start=len(cases)):
            recs = [rank_recs[j] for rank_recs in records]
            _check(all(rec["run"] == run and rec["rc"] == 0 for rec in recs),
                   f"{run}: a rank failed")
            t = recs[0]["timings"]
            path = os.path.join(tmp, f"x_{run}.npy")
            x = np.load(path)
            os.remove(path)
            b = np.ones(n)
            true_rel = float(np.linalg.norm(b - _tiles_mv(x, 512))
                             / np.linalg.norm(b))
            tri_rel = _gen_true(x)
            launched = [{k: v for k, v in rec["counts"].items() if v}
                        for rec in recs]
            print(f"{run}: {g} ranks, {t['num_iters']} iterations in "
                  f"{t['solve_s']:.3f} s, TRUE rel residual {true_rel:.3e} "
                  f"(<= {TRUE_GATE:g}), {tri_rel:.3e} against the "
                  f"tridiagonal alone, launches by rank {launched}")
            _check(t["converged"] and true_rel <= TRUE_GATE,
                   f"{run}: TRUE residual {true_rel:.3e}")
            _check(tri_rel > 1e3 * TRUE_GATE, f"{run}: the tile made no "
                   "difference")
            for r, rec in enumerate(recs):
                for k in kernels[r not in (0, 3)]:
                    _check(rec["counts"][k] > 0,
                           f"{run}: rank {r} never launched {k}")
                for k in not_kernels:
                    _check(rec["counts"][k] == 0,
                           f"{run}: rank {r} launched {k}")
                _check(not any(rec["counts"][k] for k in plain),
                       f"{run}: a plain version ran on rank {r}")
                for k in names:
                    total[k] += rec["counts"][k]
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
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


def kernel_checks():
    """Phase 2 (after the build and the SASS checks): every kernel against
    its plain version, with its timings where TIMED is on. Returns the
    `kernels` entries."""
    from lam_tpu_torch import ops
    from lam_tpu_torch.ops import gemv, layout, probe, stencil
    from lam_tpu_torch.parallel import pcg, pcg2d_symm, pcg_symm
    from lam_tpu_torch.parallel.mesh import Mesh, Mesh2D
    from lam_tpu_torch.precision import split_f64_host
    from lam_tpu_torch.solver.operators import (_host_pack_planes,
                                                _host_pack_tri)
    t0 = time.perf_counter()
    results = kernels_vs_plain(gemv, layout, _host_pack_planes,
                               _host_pack_tri, split_f64_host)
    torch.cuda.empty_cache()
    results.append(stencil_vs_plain(stencil))
    stencil_shards(stencil)
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
    torch.cuda.empty_cache()
    results += bcast_modes_vs_plain(gemv, pcg_symm, pcg2d_symm, Mesh, Mesh2D,
                                    a, p)
    del a, one
    torch.cuda.empty_cache()
    results.append(bf16_symm_large(gemv, layout))
    torch.cuda.empty_cache()
    results.append(bf16_slab_large(gemv, layout, pcg_symm))
    _check(sorted(r["name"] for r in results)
           == sorted(fn.__name__ for fn in ops.KERNELS + probe.PROBES
                     if fn not in probe.CONTROLS),
           "phase 2 did not hold every kernel against its plain version")
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")
    return results


SMI_STATE = ("nvidia-smi", "--query-gpu=name,power.limit,temperature.gpu,"
             "clocks.sm,ecc.errors.uncorrected.volatile.total",
             "--format=csv")


def fresh_main():
    """One of phase 10's fresh processes (`chip_smoke.py --fresh-checks`):
    phase 2's checks with TIMED off, in a process that has run nothing
    else. On a failed check it prints the kernel library's path (its name
    carries the hash of the sources, headers and flags) and the card's
    state, and exits 1."""
    global TIMED
    TIMED = False
    if not torch.cuda.is_available():
        return 1
    from lam_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = _build.library_path()
    print(f"fresh process {os.getpid()}: library {os.path.relpath(path)}")
    try:
        kernel_checks()
    except AssertionError as e:
        print(f"FRESH CHECK FAILED in process {os.getpid()}: {e}")
        print(f"library {path}")
        print(subprocess.run(SMI_STATE, capture_output=True,
                             text=True).stdout.strip())
        return 1
    print(f"fresh process {os.getpid()}: every check held")
    return 0


def fresh_checks(beside):
    """Phase 10: phase 2's kernel-against-plain checks, without their
    timings, in FRESH_CHECKS fresh processes of this script started
    together (`--fresh-checks`), on the library this run built: a check
    that fails there and held in phase 2 is a fault (one earlier chip
    call's kernels disagreed with their plain versions in a fresh process,
    once). They run while `beside()` (phase 12, host-bound rank processes)
    runs in this one: they time nothing. Each is killed after
    FRESH_TIMEOUT_S, and every one is stopped when `beside` fails; the
    run fails unless every one exits 0."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fresh-checks"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range(FRESH_CHECKS)]
    try:
        beside()
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.communicate()
        raise
    outs, codes = [], []
    for proc in procs:
        try:
            out, _ = proc.communicate(
                timeout=max(1.0, t0 + FRESH_TIMEOUT_S - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        outs.append(out)
        codes.append(proc.returncode)
    for k, (out, code) in enumerate(zip(outs, codes)):
        lines = out.strip().splitlines()
        keep = lines[-3:] if code == 0 else lines[-40:]
        print(f"phase 10, fresh process {k + 1} (exit {code}):\n"
              + "\n".join(keep))
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    _check(not any(codes), f"phase 10: a fresh process failed or was "
           f"killed: exit codes {codes}")


def _best_of(csv_rows):
    """{(N, procs): the lowest total_cg_s of the group} of CSV rows."""
    best = {}
    for row in csv_rows:
        f = row.split(",")
        key, t = (int(f[0]), int(f[1])), float(f[8])
        best[key] = min(t, best.get(key, t))
    return best


def bench_runs(ops, smi, bench_a, probe_gemv_s, sharded_row):
    """Phase 13: lam-bench-torch (lam_tpu_torch.bench.runner.main) in
    process, its system cache a temporary directory and the only one
    searched (`systems.cache_dirs` patched: no .npy in the checkout's
    io/bench or the temporary directory is read or written), the runs of
    BENCH_RUNS appending to one CSV: each run's rows with their num_iter,
    procs 1, err <= 2e-9 (spd mode), its kernels launched and the others
    not, no plain version; the N=150000 gen row's avg_gemv_s within 10% of
    phase 8's df64 probe (`probe_gemv_s`); the cold irfq run found no
    system in the cache and published the .npy, equal element for element
    to phase 3's matrix (`bench_a`), and its .fqpack, which the warm run
    reads with a lower load_s and the same count and err. Then
    phase 5's sharded row is appended and lam_tpu_torch.bench.clean.main
    picks the best: one BEST_RESULTS row per (N, procs), the lowest
    total_cg_s. Its launches stay out of the kernels line."""
    from lam_tpu_torch.bench import clean, runner, systems
    from lam_tpu_torch.solver import pack_cache
    t0 = time.perf_counter()
    plain = [fn.__name__ for fn in ops.PLAIN]
    cache_dirs = systems.cache_dirs
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "cache")
        systems.cache_dirs = lambda: [cache]
        csv_path = os.path.join(tmp, "bench.csv")
        rows_of = {}
        try:
            _check(systems.find_cached(N, SEED_A) is None, "phase 13: a "
                   "cached system before the cold run")
            for run, flags, iters, kernels, not_kernels in BENCH_RUNS:
                out = io.StringIO()
                t1 = time.perf_counter()
                ops.reset_counters()
                with contextlib.redirect_stdout(out):
                    rc = runner.main(flags + ["-o", csv_path, "--device",
                                              "cuda"])
                torch.cuda.synchronize()
                counts = ops.counters()
                gc.collect()
                torch.cuda.empty_cache()
                rows = out.getvalue().strip().splitlines()
                launched = {k: v for k, v in counts.items() if v}
                for row in rows:
                    print(f"phase 13 {run} CSV (N,procs,threads,load_s,"
                          f"avg_gemv_s,avg_iter_s,num_iter,err,total_cg_s): "
                          f"{row}")
                print(f"phase 13 {run}: launches {launched}, "
                      f"{time.perf_counter() - t1:.1f} s")
                _check(rc == 0, f"phase 13 {run}: lam-bench-torch exited {rc}")
                sizes = list(itertools.takewhile(
                    str.isdigit, flags[flags.index("--sizes") + 1:]))
                _check(len(rows) == len(sizes),
                       f"phase 13 {run}: {len(rows)} rows for {sizes}")
                for row, n in zip(rows, sizes):
                    f = row.split(",")
                    _check(f[:3] == [n, "1", "1"] and int(f[6]) == iters,
                           f"phase 13 {run}: row {row}, not N={n}, procs 1, "
                           f"num_iter {iters}")
                    if "spd" in flags:
                        _check(float(f[7]) <= TRUE_GATE,
                               f"phase 13 {run}: err {f[7]}")
                for k in kernels:
                    _check(counts[k] > 0, f"phase 13 {run} never launched "
                           f"{k}")
                for k in not_kernels:
                    _check(counts[k] == 0, f"phase 13 {run} launched {k}")
                _check(not any(counts[k] for k in plain),
                       f"phase 13 {run}: a plain version ran")
                rows_of[run] = [row.split(",") for row in rows]
        finally:
            systems.cache_dirs = cache_dirs
        big = rows_of["bench-gen"][1]
        ratio = float(big[4]) / probe_gemv_s
        print(f"phase 13 bench-gen: N={GEN_PROBE_N} avg_gemv_s "
              f"{float(big[4]) * 1e3:.3f} ms, x{ratio:.4f} of phase 8's "
              f"df64 probe ({probe_gemv_s * 1e3:.3f} ms; <= "
              f"{BENCH_GEN_GATE:.0%} apart)")
        _check(abs(ratio - 1) <= BENCH_GEN_GATE, "phase 13 bench-gen: "
               "avg_gemv_s is not phase 8's df64 probe's")
        npy = os.path.join(cache, f"lam_bench_spd_N{N}_s{SEED_A}.npy")
        _check(os.path.exists(npy) and os.path.exists(
            pack_cache.cache_path(npy, "fq")), "phase 13: the cold irfq run "
            "published no .npy or no .fqpack")
        _check(np.array_equal(np.load(npy, mmap_mode="r"), bench_a),
               "phase 13: the cached system is not phase 3's matrix")
        (cold,), (warm,) = (rows_of["bench-spd-irfq-cold"],
                            rows_of["bench-spd-irfq-warm"])
        print(f"phase 13 irfq --pack-cache: load_s cold {cold[3]} s "
              f"(generate, publish, pack), warm {warm[3]} s (both caches "
              f"read); the .npy equals phase 3's matrix")
        _check(cold[6:8] == warm[6:8], "phase 13: the warm irfq run differs "
               "from the cold one")
        _check(float(warm[3]) < float(cold[3]), "phase 13: the warm load "
               "was not the faster")
        with open(csv_path, "a") as f:
            f.write(sharded_row + "\n")
        with open(csv_path) as f:
            csv_rows = f.read().splitlines()
        best_path = os.path.join(tmp, "BEST_RESULTS")
        _check(clean.main([csv_path, "-o", best_path]) == 0,
               "phase 13: lam-bench-clean failed")
        with open(best_path) as f:
            best = [line for line in f.read().splitlines()
                    if clean.is_data(line)]
        print("phase 13 BEST_RESULTS: " + " | ".join(best))
        want = _best_of(csv_rows)
        got = {(int(f[0]), int(f[1])): float(f[8])
               for f in (line.split(",") for line in best)}
        _check(len(best) == len(got) == len(want) == 3 and got == want,
               f"phase 13: BEST_RESULTS {got}, not one row per (N, procs) "
               f"at its lowest total_cg_s {want}")
    print(f"phase 13: {time.perf_counter() - t0:.1f} s ({smi})")


def dryrun_phase(ops, smi):
    """Phase 12: lam_tpu_torch.dryrun's entry() and dryrun_multichip(4)
    on the card (see the module docstring). Returns nothing: its launches
    stay out of the kernels line."""
    from lam_tpu_torch import dryrun, generate
    from lam_tpu_torch.solver import oracle_cg
    t0 = time.perf_counter()
    fn, args = dryrun.entry()
    ops.reset_counters()
    x = fn(*args)
    torch.cuda.synchronize()
    counts = ops.counters()
    _check(counts["gemv_df64"] > 0, "phase 12 entry: kernel 4 never "
           "launched")
    _check(not any(counts[f.__name__] for f in ops.PLAIN),
           "phase 12 entry: a plain version ran")
    a, b = generate.tridiagonal_matrix(512), generate.ones_rhs(512)
    xo = torch.from_numpy(oracle_cg(a, b, max_iters=20)[0])
    err = _rel(x.cpu(), xo)
    _check(err < 1e-10, f"phase 12 entry: x {err} from oracle_cg's")
    print(f"phase 12 entry: gemv_df64 {counts['gemv_df64']} launches, x "
          f"{err:.3e} relative from oracle_cg's 20 iterations")
    t1 = time.perf_counter()
    for rec in dryrun.dryrun_multichip(DRYRUN_RANKS, device="cuda"):
        print(f"phase 12 {rec['line']}; kernels " + ", ".join(
            f"{k} {v}" for k, v in sorted(rec["kernels"].items())))
    print(f"phase 12: dry run over {DRYRUN_RANKS} ranks "
          f"{time.perf_counter() - t1:.1f} s, phase "
          f"{time.perf_counter() - t0:.1f} s ({smi})")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from lam_tpu_torch.ops import _build

    t_run = time.perf_counter()
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
    from lam_tpu_torch import _native_io
    t0 = time.perf_counter()
    native = _native_io.build()
    _check(native is not None and _native_io.available(),
           "the native host library did not build (no g++?)")
    gpp = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    print(f"native host library built in {time.perf_counter() - t0:.1f} s "
          f"by {gpp}: {os.path.relpath(native)}")
    from lam_tpu_torch import cli, generate, ops
    from lam_tpu_torch import io as lio
    from lam_tpu_torch.apps import bmp, bmp_cli, heat, heat_cli
    from lam_tpu_torch.ops import gemv
    from lam_tpu_torch.parallel import pcg2d_symm, pcg_symm
    from lam_tpu_torch.parallel.mesh import Mesh, Mesh2D
    from lam_tpu_torch.tools import q16_probe

    stream_sass(_build)
    results = kernel_checks()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        system = bench_system(generate, N, lio, tmp)
        counts, local_xs, local_iters = solve_slice(ops, lio, cli, system,
                                                    tmp)
        torch.cuda.empty_cache()
        heat_counts = heat_demo(ops, heat, heat_cli, bmp_cli, bmp, lio)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        shard_counts, bench_sharded = sharded_runs(ops, lio, system,
                                                   local_xs, local_iters, tmp)
        print(f"phase 5: {time.perf_counter() - t0:.1f} s")
        del local_xs
        torch.cuda.empty_cache()
        checkpoint_runs(ops, lio, cli, system, tmp)
        bench_a = system[0]  # phase 13 holds its cached system to it
        del system
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        large_counts = large_system_runs(ops, gemv, generate, lio, cli, tmp)
    torch.cuda.empty_cache()
    probe_counts = probe_tool(q16_probe)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        gen_counts, probe_gemv_s = generate_runs(ops, lio, cli, tmp)
    torch.cuda.empty_cache()
    gen_bcast_vs_plain(gemv, pcg_symm, pcg2d_symm, Mesh, Mesh2D)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mesh_gen_counts = mesh_generate_runs(ops, lio, tmp)
    torch.cuda.empty_cache()
    bench_runs(ops, smi, bench_a, probe_gemv_s["gen-df64-150k"],
               bench_sharded)
    del bench_a
    torch.cuda.empty_cache()
    fresh_checks(lambda: dryrun_phase(ops, smi))
    print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s in all ({smi})")
    for r in results:
        r["launches"] = sum(c.get(r["name"], 0) for c in (
            counts, heat_counts, shard_counts, large_counts, probe_counts,
            gen_counts, mesh_gen_counts))
        _check(r["launches"] > 0, f"{r['name']} never launched on the "
               "main path")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]) if "--rank" in sys.argv else
             fresh_main() if "--fresh-checks" in sys.argv else main())
