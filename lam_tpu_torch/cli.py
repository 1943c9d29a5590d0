"""`python -m lam_tpu_torch.cli`: the solver CLI of lam_tpu/cli.py, file
mode, on one device or sharded over the ranks of a process group.

Flags (the reference's getopt surface, file mode):
  -A <file>   read matrix                    -b <file>  read rhs
  -o <file>   write solution                 -i <int>   max iterations
  -e <float>  relative error                 -v         verbose
  -h          help
  --precision df64|ir|f32|dfq|irq|fq|irfq   --device cuda|cpu (default cuda)
  --engine auto|pallas|pallas_symm_packed   (pallas: the full square)
  --pack-cache  publish/reuse the packed planes beside the matrix file
  --backend local|sharded    --comm gather|ring    --devices N
  --coordinator <host:port> --num-processes N --process-id i
  --init-col    add the warm-up seconds after load_s in the CSV
Defaults: io/matrix.bin io/rhs.bin io/sol.bin, -i 10000, -e 1e-9.

A sharded run starts one process per rank, each with the same flags and
its own --process-id (lam_tpu/cli.py:108-120, :265-269); --device cuda
puts rank r on cuda:{r % device_count}, --device cpu runs a CPU cluster
over gloo. Only rank 0 prints and writes the solution.

Default output is lam_tpu's one-line CSV:
  N,procs,threads,load_s,avg_gemv_s,avg_iter_s,num_iter,err,total_cg_s
with procs the ranks the backend uses and num_iter = max_iters + 1 for an
unconverged run, as the reference prints it. Every other lam_tpu flag
(generate mode -s, positional arguments, --backend sharded2d, --engine
xla, ...) raises NotImplementedError; --local-devices (JAX's virtual CPU
devices) has no counterpart and is refused with a message.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="lam-cg-torch", add_help=False,
        description="Dense CG solver on PyTorch/CUDA (lam-cg parity)")
    p.add_argument("-A", dest="matrix", metavar="<file>",
                   default="io/matrix.bin", help="Read matrix from file")
    p.add_argument("-b", dest="rhs", metavar="<file>", default="io/rhs.bin",
                   help="Read right hand side from file")
    p.add_argument("-o", dest="output", metavar="<file>",
                   default="io/sol.bin", help="Write solution to file")
    p.add_argument("-i", dest="max_iters", type=int, default=10000,
                   metavar="<int>", help="Maximum number of iterations")
    p.add_argument("-e", dest="rel_error", type=float, default=1e-9,
                   metavar="<float>", help="Relative error")
    p.add_argument("-v", dest="verbose", action="store_true",
                   help="Verbose mode")
    p.add_argument("-h", dest="help", action="store_true",
                   help="Show this help message")
    p.add_argument("--precision", default="df64",
                   choices=["df64", "ir", "f32", "dfq", "irq", "fq",
                            "irfq"],
                   help="df64 = f64-parity CG on the (hi, lo) pair; ir = "
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
                        "pallas_symm_packed walk band pairs (df64/ir). "
                        "pallas_symm on one device and xla are not "
                        "ported yet")
    p.add_argument("--pack-cache", action="store_true",
                   help="File mode: publish/reuse the packed planes "
                        "beside the matrix file (<file>.dfqpack, "
                        ".fqpack, .f32pack, .df64pack) so reloads skip "
                        "the pack; ignored with a notice by --engine "
                        "pallas")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda or cpu); cuda raises when no "
                        "card is present")
    p.add_argument("--backend", default="local",
                   choices=["local", "sharded", "sharded2d"],
                   help="sharded = one rank per device of a process group "
                        "(the reference's MPI/NCCL backends); sharded2d is "
                        "not ported yet")
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
    p.add_argument("--init-col", action="store_true",
                   help="Emit the warm-up seconds (init_s) as a CSV "
                        "column after load_s")
    return p


def main(argv=None):
    """Entry point: I/O and argument errors print one line to stderr and
    return 1, as lam_tpu.cli does."""
    try:
        return _cli_main(argv)
    except (OSError, ValueError) as e:
        print(f"lam-cg: {e}", file=sys.stderr)
        return 1


def _cli_main(argv=None):
    args, unported = build_parser().parse_known_args(argv)
    if unported:
        raise NotImplementedError(
            f"lam-cg-torch: not ported yet: {' '.join(unported)}")
    if args.help:
        print("Usage: lam-cg-torch [ -A -b -o -e -i -h -v "
              "--precision --engine --device --pack-cache --backend --comm "
              "--devices --coordinator --num-processes --process-id "
              "--init-col ]")
        print("Options:")
        print("  -A <file>       Read matrix from file")
        print("  -b <file>       Read right hand side from file")
        print("  -o <file>       Write solution to file")
        print("  -i <int>        Maximum number of iterations")
        print("  -e <float>      Relative error")
        print("  -v              Verbose mode")
        print("  -h              Show this help message")
        print("  --precision df64|ir|f32|dfq|irq|fq|irfq   --device cuda|cpu")
        print("  --engine auto|pallas|pallas_symm_packed")
        print("  --pack-cache    Reuse/publish <matrix>.<storage>pack")
        print("  --backend local|sharded  --comm gather|ring  --devices N")
        print("  --coordinator <host:port> --num-processes N --process-id i")
        return 0
    if args.local_devices is not None:
        raise ValueError(
            "--local-devices (JAX's virtual CPU devices) has no counterpart "
            "in the port: start one process per rank with --coordinator, "
            "--num-processes and --process-id (--device cpu for a CPU "
            "cluster)")
    if args.backend == "sharded2d":
        raise NotImplementedError("lam-cg-torch: --backend sharded2d is not "
                                  "ported yet")

    import torch.distributed as dist

    if args.coordinator:
        # a caller that joined the group already (a launcher running
        # several solves per process) keeps it; a group joined here is
        # left here
        owns_group = not dist.is_initialized()
        from lam_tpu_torch.parallel.mesh import distributed_init
        distributed_init(args.coordinator, args.num_processes,
                         args.process_id, device=args.device)
    elif args.num_processes is not None or args.process_id is not None:
        raise ValueError("--num-processes and --process-id need "
                         "--coordinator")
    else:
        owns_group = False
    try:
        rc = _solve(args)
        if owns_group:
            # the store's host (rank 0) must not leave while another rank
            # still talks to it
            dist.barrier()
    finally:
        if owns_group:
            dist.destroy_process_group()
    return rc


def _solve(args):
    from lam_tpu_torch.solver.api import ConjugateGradient

    cg = ConjugateGradient(backend=args.backend, precision=args.precision,
                           engine=args.engine, device=args.device,
                           pack_cache=args.pack_cache, comm=args.comm,
                           n_devices=args.devices)
    # rank-0-only output, like the reference's PRINT_RANK0 macros
    rank0 = cg.rank == 0
    verbose = args.verbose and rank0

    def vprint(*a):
        if verbose:
            print(*a)
    vprint("Command line arguments:")
    vprint(f"  input_file_matrix: {args.matrix}")
    vprint(f"  input_file_rhs:    {args.rhs}")
    vprint(f"  output_file_sol:   {args.output}")
    vprint(f"  max_iters:         {args.max_iters}")
    vprint(f"  rel_error:         {args.rel_error:e}")
    vprint(f"  device:            {cg.device}")
    vprint(f"  precision={cg.precision} engine={cg.engine}")
    if cg.backend == "sharded":
        vprint(f"  backend=sharded comm={cg.comm}: {cg.mesh.size} rank(s), "
               f"process group {cg.mesh.backend or 'none'}, rank 0 on "
               f"{cg.device}")
    vprint("")

    t0 = time.perf_counter()
    vprint("Reading matrix from file ...")
    cg.load_matrix_from_file(args.matrix)
    vprint("Reading right hand side from file ...")
    cg.load_rhs_from_file(args.rhs)
    load_s = time.perf_counter() - t0
    vprint("Done\n")

    vprint("Solving the system ...")
    converged = cg.solve(args.max_iters, args.rel_error)
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
        init_col = f"{t['init_s']:g}," if args.init_col else ""
        print(f"{cg.n},{cg.used_devices()},1,{load_s:g},{init_col}"
              f"{avg_gemv:g},{t['avg_iter_s']:g},{t['csv_num_iters']},"
              f"{t['rel_residual']:g},{t['solve_s']:g}")
    cg.save_result_to_file(args.output)
    vprint("Done\n")
    vprint("Finished successfully")
    return 0


if __name__ == "__main__":
    sys.exit(main())
