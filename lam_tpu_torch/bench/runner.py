"""`lam-bench-torch`: the benchmark sweep runner of lam_tpu/bench/runner.py
(the reference's SLURM sweep scripts) on the port.

    lam-bench-torch --sizes 1000 2000 4000 --mode gen -i 15 -o results/gen.csv
    lam-bench-torch --sizes 10000 20000 --mode spd --pack-cache \\
        -o results/file.csv
    python -m lam_tpu_torch.bench.clean results/*.csv -o results/BEST_RESULTS

One solve a size, through the facade (lam_tpu_torch.solver.api):
  --mode gen   generate mode's tridiagonal against ones, built on the
               device (-i defaults to 15, the reference's capped
               throughput probe: its CSV then shows num_iter 16);
  --mode spd   bench.py's system, random_spd_matrix_fast(n, seed) above
               n=4096 (else random_spd_matrix) against random_rhs(n,
               seed+10), built in memory (`_build_operator`: each rank of a
               sharded run stores only its own part), or with --pack-cache
               read from the shared .npy system cache (lam_tpu_torch.bench.
               systems; generated and published on a miss) through the
               file path, so the packed-plane caches beside the file apply
               and a warm sweep skips both the generation and the pack
               (-i defaults to 10000).
Each size prints one row of lam-cg's CSV,
    N,procs,threads,load_s,avg_gemv_s,avg_iter_s,num_iter,err,total_cg_s
(num_iter = max_iters + 1 when unconverged, as the reference prints it;
avg_gemv_s the inner f32 or q16 matvec of ir/irq/irfq), and -o appends the
rows to a file after the sweep.

Flags: lam_tpu's (--sizes --mode -i -e -o --backend --precision --engine
--devices --comm --seed --pack-cache) and the port's --device cuda|cpu
(default cuda; cuda without a card is rc 1, never a CPU run). A sharded
sweep starts one process per rank with the same flags and its own
--coordinator <host:port> --num-processes G --process-id r, as lam-cg-torch
takes them: every rank runs every solve and measurement, rank 0 alone
prints and appends, and a rank outside the R x R grid of --backend
sharded2d takes no part. A group the caller joined already is kept.
Errors print one line on stderr and give rc 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _spd_matrix(gen, n, seed):
    """bench.py's system matrix: the spectrum-exact Householder
    construction above n=4096, the QR one up to it."""
    return (gen.random_spd_matrix_fast(n, seed=seed) if n > 4096
            else gen.random_spd_matrix(n, seed=seed))


def _cached_system(gen, n, seed):
    """The path of the cached N x N system of `seed`, generated and
    published on a miss. In a run of several ranks rank 0 alone looks and
    publishes, and sends the path to the others (every rank of the group
    takes part, those outside a grid too). OSError when no cache
    directory takes the file."""
    import torch.distributed as dist

    from lam_tpu_torch.bench import systems
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    path = None
    if ranks == 1 or dist.get_rank() == 0:
        path = systems.find_cached(n, seed)
        if path is None:
            path = systems.publish(_spd_matrix(gen, n, seed), n, seed)
    if ranks > 1:
        box = [path]
        dist.broadcast_object_list(box, src=0)
        path = box[0]
    if path is None:
        raise OSError(f"no writable cache dir for the N={n} system")
    return path


def run_one(n, mode, max_iters, rel_error, backend, precision, engine,
            devices, seed=2024, comm="gather", pack_cache=False,
            device="cuda"):
    """One point of a sweep (lam_tpu/bench/runner.py:23-78): the system of
    `mode` at size n, solved, its matvec timed; returns its CSV row, or
    None on a rank outside the R x R grid."""
    import torch

    from lam_tpu_torch import generate as gen
    from lam_tpu_torch.solver.api import ConjugateGradient

    cg = ConjugateGradient(backend=backend, precision=precision,
                           engine=engine, device=device,
                           pack_cache=pack_cache, comm=comm,
                           n_devices=devices)
    t0 = time.perf_counter()
    # a cold cache's generation and publish are part of the load
    path = (_cached_system(gen, n, seed)
            if mode == "spd" and pack_cache else None)
    if cg.mesh is not None and not cg.mesh.active:
        return None
    if mode == "gen":
        cg.generate_matrix(n)
        cg.generate_rhs()
    elif path is not None:
        cg.load_matrix_from_file(path)
        cg.rhs = gen.random_rhs(n, seed=seed + 10)
    else:
        a = _spd_matrix(gen, n, seed)
        cg.n = n
        cg.op = cg._build_operator(lambda s, m: a[s:s + m, :], n,
                                   full_matrix=a)
        del a
        if cg.device.type == "cuda":
            torch.cuda.synchronize(cg.device)
        cg.rhs = gen.random_rhs(n, seed=seed + 10)
    load_s = time.perf_counter() - t0
    cg.solve(max_iters, rel_error)
    avg_gemv = cg.measure_gemv()
    t = cg.timings
    return (f"{n},{cg.used_devices()},1,{load_s:g},{avg_gemv:g},"
            f"{t['avg_iter_s']:g},{t['csv_num_iters']},"
            f"{t['rel_residual']:g},{t['solve_s']:g}")


def build_parser():
    p = argparse.ArgumentParser(prog="lam-bench-torch")
    p.add_argument("--sizes", type=int, nargs="+", required=True)
    p.add_argument("--mode", choices=["gen", "spd"], default="gen")
    p.add_argument("-i", dest="max_iters", type=int, default=None,
                   help="default: 15 for gen (reference cap), 10000 for spd")
    p.add_argument("-e", dest="rel_error", type=float, default=1e-9)
    p.add_argument("-o", dest="output", default=None,
                   help="append CSV rows here (default: stdout only)")
    p.add_argument("--backend", default="auto")
    p.add_argument("--precision", default="auto")
    p.add_argument("--engine", default="auto")
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--comm", default="gather", choices=["gather", "ring"])
    p.add_argument("--seed", type=int, default=2024,
                   help="spd-mode system seed (shared with bench.py)")
    p.add_argument("--pack-cache", action="store_true",
                   help="spd mode: reuse/publish the .npy system cache "
                        "(io/bench/, shared with bench.py and lam-bench) "
                        "and load it through the file path so the "
                        "packed-plane caches beside it apply")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda or cpu); cuda without a card "
                        "is an error")
    p.add_argument("--coordinator", metavar="<host:port>", default=None,
                   help="Multi-process mode: the TCP rendezvous of the "
                        "process group (rank 0 listens there). Launch one "
                        "process per rank.")
    p.add_argument("--num-processes", type=int, default=None,
                   metavar="<int>", help="Total process count")
    p.add_argument("--process-id", type=int, default=None,
                   metavar="<int>", help="This process's rank")
    return p


def main(argv=None):
    """Entry point: I/O and argument errors, and a card asked for where
    there is none, print one line on stderr and give rc 1."""
    try:
        return _bench_main(argv)
    except (OSError, ValueError, NotImplementedError) as e:
        print(f"lam-bench: {e}", file=sys.stderr)
        return 1


def _bench_main(argv=None):
    args = build_parser().parse_args(argv)
    import torch.distributed as dist

    from lam_tpu_torch.parallel.mesh import process_group
    from lam_tpu_torch.solver.operators import resolve_device
    try:
        resolve_device(args.device)
    except RuntimeError as e:  # CUDA asked for and absent
        print(f"lam-bench: {e}", file=sys.stderr)
        return 1
    max_iters = args.max_iters
    if max_iters is None:
        # gen mode is the reference's capped throughput probe
        max_iters = 15 if args.mode == "gen" else 10000
    with process_group(args.coordinator, args.num_processes,
                       args.process_id, device=args.device):
        rank0 = not dist.is_initialized() or dist.get_rank() == 0
        rows = []
        for n in args.sizes:
            row = run_one(n, args.mode, max_iters, args.rel_error,
                          args.backend, args.precision, args.engine,
                          args.devices, seed=args.seed, comm=args.comm,
                          pack_cache=args.pack_cache, device=args.device)
            if row is None:
                # outside the grid: no part in the solve, but in the
                # group's collectives that build each size's grid
                continue
            if rank0:
                print(row, flush=True)
            rows.append(row)
    if args.output and rank0:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                    exist_ok=True)
        with open(args.output, "a") as f:
            f.writelines(row + "\n" for row in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
