"""`python -m lam_tpu_torch.cli`: the solver CLI of lam_tpu/cli.py, file
mode and generate mode, on one device or sharded over the ranks of a
process group.

Flags (the reference's getopt surface):
  -A <file>   read matrix                    -b <file>  read rhs
  -s <int>    generate the n x n system      -o <file>  write solution
  -i <int>    max iterations                 -e <float> relative error
  -v          verbose                        -h         help
  --precision auto|df64|ir|f32|dfq|irq|fq|irfq|f64 (auto: df64 on a card,
              f64 on the CPU)   --device cuda|cpu (default cuda)
  --engine auto|pallas|pallas_symm|pallas_symm_packed|xla
              (pallas: the full square; pallas_symm: the full square of a
              symmetric matrix, its lower triangle read; xla: the unpadded
              square and plain torch products, lam_tpu's oracle engine,
              which f64 forces)
  --pack-cache  publish/reuse the packed planes beside the matrix file
  --outer device|host  where irfq forms its outer residuals: on the device
              over the fq cascade (default), or on the host against the
              f64 source file with only the q1 plane on the device
  --backend local|sharded|sharded2d|auto (auto, the default: sharded
              with more than one rank)  --comm gather|ring  --devices N
  --coordinator <host:port> --num-processes N --process-id i
  --preconditioner jacobi  Jacobi-preconditioned CG on every backend (with
              ir/irq/irfq it scales the inner f32 loop)
  --check-symmetric  verify A v == A^T v on the matrix file first
  --no-warmup   time the first solve with the kernel build in it
  --profile <dir>  a torch.profiler trace of the timed solve, one file per
              rank: <dir>/lam-cg.rank<r>.json
  --init-col    add the warm-up seconds after load_s in the CSV
  --checkpoint <dir>  persist the solver state in <dir> (lam_tpu's files:
              x.bin, r.bin, p.bin and state.json, or x.bin, r.bin and
              ir_state.json), every --checkpoint-every iterations (default
              100) or, with ir/irq/irfq, at every refinement cycle; no
              warm-up solve
  --resume    continue from the state in --checkpoint <dir>, written by the
              port or by lam_tpu for the same operator layout
Legacy positional form (lam_tpu/cli.py:17-21): `matrix rhs sol iters err`,
any prefix of them; explicit flags win, -i defaults to 1000 there, and
more than five positionals is refused.
Defaults: io/matrix.bin io/rhs.bin io/sol.bin, -i 10000, -e 1e-9. -s
cannot be given with -A or -b ("Option -A and -b cannot be used with -s."
on stderr, rc 1) nor with --outer host (one line on stderr, rc 1: the
host outer loop needs the source file). --resume without --checkpoint,
and --checkpoint with --outer host, are refused before anything is read
(one line on stderr, rc 1); it builds the reference's
benchmark system, the dense tridiagonal (2 on the diagonal, 1 beside it)
against a right-hand side of ones, on the device
(lam_tpu_torch/solver/api.py); on a sharded backend each rank builds its
own part on its device. With --outer host the CSV row is the same, its
avg_gemv_s the inner q1 matvec.

A sharded run starts one process per rank, each with the same flags and
its own --process-id (lam_tpu/cli.py:108-120, :265-269); --device cuda
puts rank r on cuda:{r % device_count} (the card of LOCAL_RANK where a
launcher sets it), --device cpu runs a CPU cluster over gloo. Only rank 0
prints and writes the solution. --backend sharded takes every precision:
f32/df64/ir on row shards or the band-pair walk, dfq/irq/fq/irfq on the
band-pair walk's quantized storages (with --pack-cache each rank keeps
<matrix>.shardpack/<storage>.g<G>.s<rank>). --backend sharded2d runs on
the largest R x R grid of the ranks (ranks beyond R^2 stay idle, said on
stderr): f32/df64/ir on dense blocks, and with --engine pallas_symm_packed
df64/ir, or with --precision dfq/irq/fq/irfq, on the symmetric grid, which
stores each element once (with --pack-cache each rank of a quantized
storage keeps <matrix>.shardpack/<storage>.r<R>.s<rank>).

Default output is lam_tpu's one-line CSV:
  N,procs,threads,load_s,avg_gemv_s,avg_iter_s,num_iter,err,total_cg_s
with procs the ranks the backend uses and num_iter = max_iters + 1 for an
unconverged run, as the reference prints it (a checkpointed run's row
too). Still refused, with one line on stderr and rc 1: --platform (JAX's
platform: the port takes --device) and --local-devices (JAX's virtual CPU
devices: start one process per rank).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="lam-cg-torch", add_help=False,
        description="Dense CG solver on PyTorch/CUDA (lam-cg parity)")
    p.add_argument("-A", dest="matrix", metavar="<file>", default=None,
                   help="Read matrix from file")
    p.add_argument("-b", dest="rhs", metavar="<file>", default=None,
                   help="Read right hand side from file")
    p.add_argument("-s", dest="size", type=int, default=None,
                   metavar="<int>", help="Generate matrix of size n x n")
    p.add_argument("-o", dest="output", metavar="<file>",
                   default=None, help="Write solution to file")
    p.add_argument("-i", dest="max_iters", type=int, default=None,
                   metavar="<int>", help="Maximum number of iterations "
                   "(default 10000; 1000 in positional form)")
    p.add_argument("-e", dest="rel_error", type=float, default=None,
                   metavar="<float>", help="Relative error")
    p.add_argument("pos", nargs="*", metavar="matrix rhs sol iters err",
                   help="Legacy positional form (lam_tpu/cli.py:17-21)")
    p.add_argument("-v", dest="verbose", action="store_true",
                   help="Verbose mode")
    p.add_argument("-h", dest="help", action="store_true",
                   help="Show this help message")
    p.add_argument("--precision", default="auto",
                   choices=["df64", "ir", "f32", "dfq", "irq", "fq",
                            "irfq", "f64", "auto"],
                   help="auto (default) = df64 on a card, f64 on the CPU; "
                        "f64 = CG on the f64 square with plain torch "
                        "products (engine xla, the oracle path); "
                        "df64 = f64-parity CG on the (hi, lo) pair; ir = "
                        "f32 iterations refined with the df64 matvec; "
                        "f32 = f32 CG; dfq = CG on packed storage with the "
                        "lo plane quantized to int16 (6 B/element); irq = "
                        "refinement on dfq, the inner loop reading the f32 "
                        "hi plane; fq = CG on the fully-quantized "
                        "cascade of three int16 planes (6 B/element); "
                        "irfq = refinement on fq, the inner loop reading "
                        "only the 2-byte first plane")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "pallas", "pallas_symm_packed",
                            "pallas_symm", "xla"],
                   help="pallas_symm_packed (what auto picks) stores and "
                        "reads only the lower-triangle tiles of a "
                        "symmetric matrix; pallas stores the full square "
                        "(f32/df64/ir; any square matrix, symmetric or "
                        "not). With --backend sharded: auto/pallas split "
                        "the rows, pallas_symm (slab) and "
                        "pallas_symm_packed walk band pairs (df64/ir; "
                        "dfq/irq/fq/irfq packed only, what auto picks for "
                        "them). With --backend sharded2d: auto/pallas give "
                        "dense blocks, pallas_symm/pallas_symm_packed the "
                        "symmetric grid (df64/ir/dfq/irq/fq/irfq). On one "
                        "device pallas_symm stores the full square of a "
                        "symmetric matrix and reads its lower triangle "
                        "(f32/df64/ir). xla stores the unpadded square "
                        "(row shards, grid blocks) and multiplies by plain "
                        "torch products (f64/f32/df64/ir; f64 forces it)")
    p.add_argument("--pack-cache", action="store_true",
                   help="File mode: publish/reuse the packed planes "
                        "beside the matrix file (<file>.dfqpack, "
                        ".fqpack, .f32pack, .df64pack) so reloads skip "
                        "the pack; ignored with a notice by --engine "
                        "pallas")
    p.add_argument("--outer", default="device",
                   choices=["device", "host"],
                   help="Where --precision irfq computes its outer "
                        "refinement residuals. 'device' (default): the "
                        "full 6 B/element fq cascade is uploaded and "
                        "r = b - A x runs on-device — fastest once "
                        "resident. 'host' (file mode, backend=local): "
                        "only the 2 B/element q1 inner plane is "
                        "uploaded and the host streams the exact f64 "
                        "source for each outer residual — ~3x less "
                        "link traffic, the fastest time-to-answer from "
                        "cold storage on transfer-bound links "
                        "(solver/host_outer.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda or cpu); cuda raises when no "
                        "card is present")
    p.add_argument("--backend", default="auto",
                   choices=["local", "sharded", "sharded2d", "auto"],
                   help="auto (default) = sharded when the run has more "
                        "than one rank, else local; "
                        "sharded = one rank per device of a process group "
                        "(the reference's MPI/NCCL backends); sharded2d = "
                        "the largest R x R grid of the ranks: dense blocks "
                        "(f32/df64/ir) or, with a symmetric engine or a "
                        "quantized precision, each element stored once")
    p.add_argument("--comm", default="gather", choices=["gather", "ring"],
                   help="Sharded matvec communication: all_gather of p, "
                        "or a ring of column-block matvecs")
    p.add_argument("--devices", type=int, default=None,
                   help="Number of mesh devices: must equal the process "
                        "group's size (default: that size)")
    p.add_argument("--coordinator", metavar="<host:port>", default=None,
                   help="Multi-process mode: address of the TCP rendezvous "
                        "of torch.distributed.init_process_group (rank 0 "
                        "listens there). Launch one process per rank.")
    p.add_argument("--num-processes", type=int, default=None,
                   metavar="<int>", help="Total process count "
                   "(multi-process mode)")
    p.add_argument("--process-id", type=int, default=None,
                   metavar="<int>", help="This process's rank "
                   "(multi-process mode)")
    p.add_argument("--local-devices", type=int, default=None,
                   metavar="<int>", help=argparse.SUPPRESS)
    p.add_argument("--platform", default=None, help=argparse.SUPPRESS)
    p.add_argument("--preconditioner", default=None,
                   choices=["jacobi"],
                   help="Preconditioned CG (surplus over the reference; "
                        "works on every backend and composes with "
                        "--precision ir/irq/irfq — there it scales the "
                        "inner f32 loop)")
    p.add_argument("--check-symmetric", action="store_true",
                   help="File mode: verify A v == A^T v on the matrix "
                        "file before building the operator (two "
                        "streamed passes over the file). The "
                        "lower-triangle engines otherwise TRUST "
                        "symmetry (CG's contract) and would silently "
                        "solve with the mirrored lower half of a "
                        "non-symmetric input")
    p.add_argument("--no-warmup", action="store_true",
                   help="Include the kernel build and first launches in "
                        "the solve timing")
    p.add_argument("--init-col", action="store_true",
                   help="Emit the warm-up seconds (init_s) as a CSV "
                        "column after load_s")
    p.add_argument("--profile", metavar="<dir>", default=None,
                   help="Capture a torch.profiler trace of the timed "
                        "solve, one file per rank: "
                        "<dir>/lam-cg.rank<r>.json")
    p.add_argument("--checkpoint", metavar="<dir>", default=None,
                   help="Persist solver state every --checkpoint-every "
                        "iterations, or at each refinement cycle with "
                        "ir/irq/irfq (resumable with --resume)")
    p.add_argument("--checkpoint-every", type=int, default=100,
                   metavar="<int>",
                   help="Iterations between checkpoints (default 100; not "
                        "used by ir/irq/irfq)")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the state in --checkpoint <dir>")
    return p


def main(argv=None):
    """Entry point: I/O and argument errors print one line to stderr and
    return 1, as lam_tpu.cli does."""
    try:
        return _cli_main(argv)
    except (OSError, ValueError, NotImplementedError) as e:
        print(f"lam-cg: {e}", file=sys.stderr)
        return 1


def _cli_main(argv=None):
    args = build_parser().parse_args(argv)
    if args.help:
        print("Usage: lam-cg-torch [ (-A -b | -s) -o -e -i -h -v "
              "--precision --engine --device --pack-cache --outer --backend "
              "--comm --devices --coordinator --num-processes --process-id "
              "--preconditioner --check-symmetric --no-warmup --profile "
              "--init-col --checkpoint --checkpoint-every --resume ] | "
              "[matrix rhs sol iters err]")
        print("Options:")
        print("  -A <file>       Read matrix from file")
        print("  -b <file>       Read right hand side from file")
        print("  -o <file>       Write solution to file")
        print("  -i <int>        Maximum number of iterations")
        print("  -e <float>      Relative error")
        print("  -s <int>        Generate matrix of size n x n")
        print("  -v              Verbose mode")
        print("  -h              Show this help message")
        print("  --precision auto|df64|ir|f32|dfq|irq|fq|irfq|f64   "
              "--device cuda|cpu")
        print("  --engine auto|pallas|pallas_symm|pallas_symm_packed|xla")
        print("  --pack-cache    Reuse/publish <matrix>.<storage>pack")
        print("  --outer device|host  irfq's outer residuals on the device "
              "or, file mode, on the host")
        print("  --backend local|sharded|sharded2d|auto  --comm gather|ring  "
              "--devices N")
        print("  --coordinator <host:port> --num-processes N --process-id i")
        print("  --preconditioner jacobi  --check-symmetric  --no-warmup  "
              "--profile <dir>")
        print("  --checkpoint <dir>  --checkpoint-every N  --resume")
        return 0
    if args.resume and not args.checkpoint:
        print("lam-cg: --resume needs --checkpoint <dir>, the state to "
              "resume from", file=sys.stderr)
        return 1
    if args.checkpoint and args.outer == "host":
        # lam_tpu fails only mid-run here: its q1-only operator refuses
        # the accurate matvec that a checkpointed refinement cycle runs
        print("lam-cg: --checkpoint does not compose with --outer host "
              "(the device holds only the q1 inner plane, not the "
              "accurate operator a checkpointed cycle runs)",
              file=sys.stderr)
        return 1
    if args.platform is not None:
        raise NotImplementedError(
            "--platform picks JAX's platform; the port takes --device "
            "cuda|cpu")
    # the legacy positional form (lam_tpu/cli.py:215-235): explicit flags
    # win; unset slots take the positional drivers' defaults (-i 1000)
    positional = bool(args.pos)
    if positional:
        if len(args.pos) > 5:
            print("Too many positional arguments.", file=sys.stderr)
            return 1
        slots = args.pos + [None] * (5 - len(args.pos))
        args.matrix = args.matrix or slots[0]
        args.rhs = args.rhs or slots[1]
        args.output = args.output or slots[2]
        if args.max_iters is None and slots[3] is not None:
            args.max_iters = int(slots[3])
        if args.rel_error is None and slots[4] is not None:
            args.rel_error = float(slots[4])
    if args.max_iters is None:
        args.max_iters = 1000 if positional else 10000
    if args.rel_error is None:
        args.rel_error = 1e-9
    if args.output is None:
        args.output = "io/sol.bin"
    generate = args.size is not None
    if generate and (args.matrix is not None or args.rhs is not None):
        print("Option -A and -b cannot be used with -s.", file=sys.stderr)
        return 1
    if generate and args.outer == "host":
        print("lam-cg: --outer host solves against the f64 source file "
              "(-A); generate mode (-s) has no file to stream the outer "
              "residuals from", file=sys.stderr)
        return 1
    if not generate:
        args.matrix = args.matrix or "io/matrix.bin"
        args.rhs = args.rhs or "io/rhs.bin"
    if args.local_devices is not None:
        raise ValueError(
            "--local-devices (JAX's virtual CPU devices) has no counterpart "
            "in the port: start one process per rank with --coordinator, "
            "--num-processes and --process-id (--device cpu for a CPU "
            "cluster)")

    from lam_tpu_torch.parallel.mesh import process_group
    with process_group(args.coordinator, args.num_processes,
                       args.process_id, device=args.device):
        rc = _solve(args)
    return rc


def _solve(args):
    from lam_tpu_torch.solver.api import ConjugateGradient

    cg = ConjugateGradient(backend=args.backend, precision=args.precision,
                           engine=args.engine, device=args.device,
                           pack_cache=args.pack_cache, comm=args.comm,
                           n_devices=args.devices, outer=args.outer,
                           check_symmetric=args.check_symmetric)
    if cg.mesh is not None and not cg.mesh.active:
        return 0  # a rank outside the R x R grid takes no part
    # rank-0-only output, like the reference's PRINT_RANK0 macros
    rank0 = cg.rank == 0
    verbose = args.verbose and rank0

    def vprint(*a):
        if verbose:
            print(*a)
    generate = args.size is not None
    vprint("Command line arguments:")
    if generate:
        vprint(f"  rows/cols:         {args.size}")
        size_gb = args.size * args.size * 8 / 1024**3
        vprint(f"  size of the problem: {size_gb:f} GB")
    else:
        vprint(f"  input_file_matrix: {args.matrix}")
        vprint(f"  input_file_rhs:    {args.rhs}")
    vprint(f"  output_file_sol:   {args.output}")
    vprint(f"  max_iters:         {args.max_iters}")
    vprint(f"  rel_error:         {args.rel_error:e}")
    vprint(f"  device:            {cg.device}")
    vprint(f"  precision={cg.precision} engine={cg.engine}")
    if cg.backend != "local":
        vprint(f"  backend={cg.backend} comm={cg.comm}: {cg.mesh.size} "
               f"rank(s), "
               f"process group {cg.mesh.backend or 'none'}, rank 0 on "
               f"{cg.device}")
    vprint("")

    t0 = time.perf_counter()
    if generate:
        vprint("Generating the system ...")
        cg.generate_matrix(args.size)
        cg.generate_rhs()
    else:
        vprint("Reading matrix from file ...")
        cg.load_matrix_from_file(args.matrix)
        vprint("Reading right hand side from file ...")
        cg.load_rhs_from_file(args.rhs)
    load_s = time.perf_counter() - t0
    vprint("Done\n")

    vprint("Solving the system ...")
    with _profiled(args.profile, cg.rank):
        if args.checkpoint:
            converged = _checkpointed_solve(cg, args)
        else:
            converged = cg.solve(args.max_iters, args.rel_error,
                                 warmup=not args.no_warmup,
                                 preconditioner=args.preconditioner)
    avg_gemv = cg.measure_gemv()
    t = cg.timings
    if not rank0:
        pass  # every rank ran the collectives above; rank 0 reports
    elif verbose:
        state = "Converged in" if converged else "Did not converge in"
        print(f"{state} {t['num_iters']} iterations, "
              f"relative error is {t['rel_residual']:e}")
        print(f"Time elapsed: {t['solve_s']:f} s "
              f"(avg iteration {t['avg_iter_s']:e} s, "
              f"avg gemv {avg_gemv:e} s)")
        print("")
        print("Writing solution to file ...")
    else:
        init_col = f"{t.get('init_s', 0.0):g}," if args.init_col else ""
        print(f"{cg.n},{cg.used_devices()},1,{load_s:g},{init_col}"
              f"{avg_gemv:g},{t['avg_iter_s']:g},{t['csv_num_iters']},"
              f"{t['rel_residual']:g},{t['solve_s']:g}")
    cg.save_result_to_file(args.output)
    vprint("Done\n")
    vprint("Finished successfully")
    return 0


def _checkpointed_solve(cg, args):
    """The resumable solve of --checkpoint (lam_tpu/cli.py:328-353), no
    warm-up: ir/irq/irfq checkpoint at refinement-cycle boundaries, the
    other precisions every --checkpoint-every iterations. The result
    goes through the facade's record_result, so the CSV row is a plain
    solve's."""
    from lam_tpu_torch.solver import checkpoint as ckpt
    from lam_tpu_torch.solver.cg import default_inner_floor
    kw = dict(max_iters=args.max_iters, rel_error=args.rel_error,
              checkpoint_path=args.checkpoint, resume=args.resume,
              preconditioner=args.preconditioner)
    t0 = time.perf_counter()
    if cg.precision in ("ir", "irq", "irfq"):
        result, _ = ckpt.cg_solve_ir_resumable(
            cg.op.as_f32(), cg.op, cg.rhs,
            inner_floor=default_inner_floor(cg.precision), **kw)
    else:
        result, _ = ckpt.cg_solve_resumable(
            cg.op, cg.rhs, segment=args.checkpoint_every, **kw)
    float(result.rel_residual)  # waits for the device
    return cg.record_result(result, time.perf_counter() - t0)


@contextlib.contextmanager
def _profiled(directory, rank):
    """A torch.profiler trace of the block (the CPU and, on a card, its
    CUDA activity), written to <directory>/lam-cg.rank<rank>.json: one
    file per rank; no directory, no trace."""
    if directory is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(directory,
                                          f"lam-cg.rank{rank}.json"))


if __name__ == "__main__":
    sys.exit(main())
