"""`python -m lam_tpu_torch.apps.heat_cli`: the heat-equation demo CLI of
lam_tpu/apps/heat_cli.py (`lam-heat`), on PyTorch.

Positional args `nx ny output_file.bin max_iters`, all optional with the
reference defaults. Flags:
  --solver cg|jacobi     (default cg; jacobi is the numerics-parity sweep)
  --epsilon              Jacobi stop threshold (default 1e-3)
  --rel-error            CG stop threshold (default 1e-10)
  --precision auto|f64|ir  (auto: ir on a CUDA device, f64 on the CPU)
  --devices G            row-shard the grid over G ranks (halo exchange;
                         implies ir): one process per rank, each started
                         with the same flags and its own --process-id
  --coordinator <host:port> --num-processes G --process-id r
                         the process group of a --devices run (as lam-cg's;
                         under srun or mpirun --coordinator alone)
  --device cuda|cpu      (default cuda; cuda raises when no card is present)
The printed lines are lam_tpu's, so one parser reads both CLIs' output;
with --devices only rank 0 prints and writes the output file.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
import time


def main(argv=None):
    """Entry point: I/O and argument errors print one line to stderr and
    return 1, as lam_tpu's does."""
    try:
        return _cli_main(argv)
    except (OSError, ValueError) as e:
        print(f"lam-heat: {e}", file=sys.stderr)
        return 1


def _cli_main(argv=None):
    p = argparse.ArgumentParser(prog="lam-heat-torch")
    p.add_argument("nx", nargs="?", type=int, default=10)
    p.add_argument("ny", nargs="?", type=int, default=10)
    p.add_argument("output_file", nargs="?", default="io/heat.bin")
    p.add_argument("max_iterations", nargs="?", type=int, default=1000000)
    p.add_argument("--solver", choices=["cg", "jacobi"], default="cg")
    p.add_argument("--epsilon", type=float, default=1e-3)
    p.add_argument("--rel-error", type=float, default=1e-10)
    p.add_argument("--devices", type=int, default=None,
                   help="Row-shard the grid over this many devices: one "
                        "edge-row exchange with each neighbour per matvec "
                        "(implies the ir solver); the process group must "
                        "have this many ranks")
    p.add_argument("--coordinator", metavar="<host:port>", default=None,
                   help="Multi-process mode: address of the TCP rendezvous "
                        "of torch.distributed.init_process_group (rank 0 "
                        "listens there). Launch one process per rank; "
                        "under srun or mpirun the rank count and rank "
                        "come from the launcher's variables.")
    p.add_argument("--num-processes", type=int, default=None,
                   metavar="<int>", help="Total process count "
                   "(multi-process mode; default: the launcher's)")
    p.add_argument("--process-id", type=int, default=None,
                   metavar="<int>", help="This process's rank "
                   "(multi-process mode; default: the launcher's)")
    p.add_argument("--precision", choices=["auto", "f64", "ir"],
                   default="auto",
                   help="CG solver precision: ir = f32 inner on the stencil "
                        "kernel + f64 refinement (CUDA default), f64 = "
                        "plain f64 CG (CPU default)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda or cpu); cuda raises when no "
                        "card is present")
    args = p.parse_args(argv)

    if args.nx <= 0 or args.ny <= 0 or args.max_iterations < 0:
        print("Wrong argument value", file=sys.stderr)
        return 1

    import torch.distributed as dist

    from lam_tpu_torch.parallel.mesh import process_group
    with process_group(args.coordinator, args.num_processes,
                       args.process_id, device=args.device):
        rank = dist.get_rank() if dist.is_initialized() else 0
        # only rank 0 prints and writes the file
        with (contextlib.redirect_stdout(io.StringIO()) if rank
              else contextlib.nullcontext()):
            rc = _demo(args, rank)
    return rc


def _demo(args, rank):
    print("Command line arguments:")
    print(f"  nx:             {args.nx}")
    print(f"  ny:             {args.ny}")
    print(f"  output_file:    {args.output_file}")
    print(f"  max_iterations: {args.max_iterations}")
    print(f"  solver:         {args.solver}")
    print("")

    from lam_tpu_torch import io as lio
    from lam_tpu_torch.apps import heat

    print("Initializing the rectangle ...")
    grid = heat.initial_grid(args.nx, args.ny)
    print("Done\n")

    print("Solving the heat equation ...")
    # warm-up pass, as lam_tpu's: here it builds or loads the kernels and
    # sets up the device, and constructs the operators the timed solve
    # constructs again, so it is reported as warm-up time
    t_init = time.perf_counter()
    if args.solver == "jacobi":
        heat.solve_heat_jacobi(grid, max_iters=0, epsilon=args.epsilon,
                               device=args.device)
    else:
        heat.solve_heat_cg(grid, max_iters=0, rel_error=args.rel_error,
                           precision=args.precision, devices=args.devices,
                           device=args.device)
    init_s = time.perf_counter() - t_init
    t0 = time.perf_counter()
    if args.solver == "jacobi":
        grid, iters, diff = heat.solve_heat_jacobi(
            grid, max_iters=args.max_iterations, epsilon=args.epsilon,
            device=args.device)
        metric = f"max_diff={diff:e}"
        converged = diff < args.epsilon
    else:
        grid, iters, rel = heat.solve_heat_cg(
            grid, max_iters=args.max_iterations, rel_error=args.rel_error,
            precision=args.precision, devices=args.devices,
            device=args.device)
        metric = f"rel_residual={rel:e}"
        converged = rel < args.rel_error
    dt = time.perf_counter() - t0
    print(f"Warm-up (compile + construction) time: {init_s:f} s")
    if converged:
        print(f"Iterations converged in {iters} iterations with {metric}")
    else:
        print(f"Iterations did not converge in {iters} iterations, "
              f"{metric}")
    print(f"Time elapsed: {dt:f} s")
    print("Done\n")

    print("Writing matrix to file ...")
    if rank == 0:
        lio.write_matrix(args.output_file, grid)  # (ny, nx) header
    print("Done\n")
    print("Finished successfully")
    return 0


if __name__ == "__main__":
    sys.exit(main())
