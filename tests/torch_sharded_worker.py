"""One rank of a lam_tpu_torch sharded cluster, for the tests.

    python tests/torch_sharded_worker.py --coordinator 127.0.0.1:<port> \\
        --num-processes G --process-id r --device cpu|cuda \\
        --jobs jobs.json --out <dir>

Runs the jobs of jobs.json in order, every rank the same list, and writes
<dir>/results.r<rank>.json: one record per job with its kernel and
plain-version counts. The process group is joined before the first job
and left after the last. Jobs:
  {"kind": "cli", "name", "argv"}: lam_tpu_torch.cli.main(argv plus this
      rank's --coordinator/--num-processes/--process-id/--device, which
      find the group joined), its exit code and standard output;
  {"kind": "solve", "name", "op": "dense"|"symm", "precision":
      "f32"|"df64"|"ir", "comm", "packed", "tb", "matrix", "rhs",
      "rel_error"}: the operator built from the matrix file, cg_solve or
      cg_solve_ir; iterations, convergence, the recurrence residual, and
      x saved as <dir>/<name>.r<rank>.npy;
  {"kind": "matvec", "name", "op", "precision", "comm", "packed", "tb",
      "matrix", "p"}: the whole A @ p (np.load(p)) saved as
      <dir>/<name>.r<rank>.npy.
Imports nothing of JAX.
"""

import argparse
import contextlib
import io
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lam_tpu_torch import cg_solve, cg_solve_ir, cli, ops  # noqa: E402
from lam_tpu_torch import io as lio  # noqa: E402
from lam_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from lam_tpu_torch.parallel.pcg import ShardedDenseOperator  # noqa: E402
from lam_tpu_torch.parallel.pcg_symm import SymmShardedOperator  # noqa: E402


def _operator(job, mesh):
    storage = "df64" if job["precision"] == "ir" else job["precision"]
    if job["op"] == "dense":
        return ShardedDenseOperator.from_file(
            job["matrix"], mesh=mesh, precision=storage, comm=job["comm"])
    return SymmShardedOperator.from_file(job["matrix"], mesh=mesh,
                                         tb=job["tb"], packed=job["packed"])


def _run(job, args, out, mesh):
    name = job["name"]
    if job["kind"] == "cli":
        argv = job["argv"] + [
            "--coordinator", args.coordinator, "--num-processes",
            str(args.num_processes), "--process-id", str(args.process_id),
            "--device", args.device]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        return {"rc": rc, "stdout": buf.getvalue()}
    op = _operator(job, mesh)
    rec = {"backend": mesh.backend, "device": str(mesh.device),
           "size": mesh.size}
    if job["kind"] == "matvec":
        y = op.matvec(op.prepare_b(np.load(job["p"])))
        if isinstance(op, ShardedDenseOperator):
            y = op.extract_x(y)
        np.save(os.path.join(out, f"{name}.r{args.process_id}.npy"),
                y[:op.n].double().cpu().numpy())
        return rec
    b = lio.read_vector(job["rhs"])
    if job["precision"] == "ir":
        res = cg_solve_ir(op.as_f32(), op, b, max_iters=10000,
                          rel_error=job["rel_error"])
    else:
        res = cg_solve(op, b, max_iters=10000, rel_error=job["rel_error"])
    np.save(os.path.join(out, f"{name}.r{args.process_id}.npy"),
            res.x.double().cpu().numpy())
    rec.update(iters=int(res.num_iters), converged=bool(res.converged),
               rel=float(res.rel_residual))
    return rec


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--device", default="cpu")
    p.add_argument("--jobs", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    with open(args.jobs) as f:
        jobs = json.load(f)
    pmesh.distributed_init(args.coordinator, args.num_processes,
                           args.process_id, device=args.device)
    mesh = pmesh.make_mesh(device=args.device)
    results = []
    for job in jobs:
        ops.reset_counters()
        rec = _run(job, args, args.out, mesh)
        if args.device == "cuda":
            torch.cuda.synchronize()
        rec.update(name=job["name"], counts=ops.counters())
        results.append(rec)
    with open(os.path.join(args.out, f"results.r{args.process_id}.json"),
              "w") as f:
        json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
