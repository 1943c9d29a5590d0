"""`python -m lam_tpu_torch.cli`: the solver CLI of lam_tpu/cli.py, file
mode on one device.

Flags (the reference's getopt surface, file mode):
  -A <file>   read matrix                    -b <file>  read rhs
  -o <file>   write solution                 -i <int>   max iterations
  -e <float>  relative error                 -v         verbose
  -h          help
  --precision df64|ir|f32|dfq|irq|fq|irfq   --device cuda|cpu (default cuda)
  --engine auto|pallas|pallas_symm_packed   (pallas: the full square)
  --pack-cache  publish/reuse the packed planes beside the matrix file
Defaults: io/matrix.bin io/rhs.bin io/sol.bin, -i 10000, -e 1e-9.

Default output is lam_tpu's one-line CSV:
  N,procs,threads,load_s,avg_gemv_s,avg_iter_s,num_iter,err,total_cg_s
with num_iter = max_iters + 1 for an unconverged run, as the reference
prints it. Every other lam_tpu flag (generate mode -s, positional
arguments, --backend, --engine pallas_symm|xla, ...) raises
NotImplementedError.
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
                        "not). pallas_symm and xla are not ported yet")
    p.add_argument("--pack-cache", action="store_true",
                   help="File mode: publish/reuse the packed planes "
                        "beside the matrix file (<file>.dfqpack, "
                        ".fqpack, .f32pack, .df64pack) so reloads skip "
                        "the pack; ignored with a notice by --engine "
                        "pallas")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda or cpu); cuda raises when no "
                        "card is present")
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
              "--precision --engine --device --pack-cache ]")
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
        return 0

    from lam_tpu_torch.solver.api import ConjugateGradient

    verbose = args.verbose

    def vprint(*a):
        if verbose:
            print(*a)

    cg = ConjugateGradient(precision=args.precision, engine=args.engine,
                           device=args.device, pack_cache=args.pack_cache)
    vprint("Command line arguments:")
    vprint(f"  input_file_matrix: {args.matrix}")
    vprint(f"  input_file_rhs:    {args.rhs}")
    vprint(f"  output_file_sol:   {args.output}")
    vprint(f"  max_iters:         {args.max_iters}")
    vprint(f"  rel_error:         {args.rel_error:e}")
    vprint(f"  device:            {cg.device}")
    vprint(f"  precision={cg.precision} engine={cg.engine}")
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
    if verbose:
        state = "Converged in" if converged else "Did not converge in"
        print(f"{state} {t['num_iters']} iterations, "
              f"relative error is {t['rel_residual']:e}")
        print(f"Time elapsed: {t['solve_s']:f} s "
              f"(avg iteration {t['avg_iter_s']:e} s, "
              f"avg gemv {avg_gemv:e} s)")
        print("")
        print("Writing solution to file ...")
    else:
        print(f"{cg.n},1,1,{load_s:g},{avg_gemv:g},{t['avg_iter_s']:g},"
              f"{t['csv_num_iters']},{t['rel_residual']:g},{t['solve_s']:g}")
    cg.save_result_to_file(args.output)
    vprint("Done\n")
    vprint("Finished successfully")
    return 0


if __name__ == "__main__":
    sys.exit(main())
