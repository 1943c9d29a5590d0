"""One rank of a lam_tpu_torch sharded cluster, for the tests.

    python tests/torch_sharded_worker.py [--coordinator 127.0.0.1:<port>] \\
        [--num-processes G --process-id r] --device cpu|cuda \\
        --jobs jobs.json --out <dir>

Runs the jobs of jobs.json in order, every rank the same list, and writes
<dir>/results.r<rank>.json: one record per job with its kernel and
plain-version counts, and first the record "launch": the rank, size,
device, backend, card and the sources of the join (`mesh.Launch`). The
process group is joined before the first job and left after the last,
with the flags given, or from a launcher's variables (srun's or mpirun's,
set by `launch_cluster`) where they are left out. Jobs:
  {"kind": "cli", "name", "argv"}: lam_tpu_torch.cli.main(argv plus this
      rank's --coordinator/--num-processes/--process-id/--device, which
      find the group joined; --coordinator alone under a launcher), its
      exit code and standard output;
  {"kind": "solve", "name", "op": "dense"|"symm"|"grid"|"symgrid",
      "precision": "f32"|"df64"|"ir"|"dfq"|"irq"|"fq"|"irfq", "comm",
      "packed", "tb", "pack_cache", "matrix", "rhs", "rel_error"}: the
      operator built from the matrix file (row shards, the band-pair walk,
      or the dense or the symmetric R x R grid over the largest square of
      the ranks), cg_solve or cg_solve_ir with
      the precision's inner floor (and the job's "preconditioner", if
      any); iterations, convergence, the recurrence residual, and x saved
      as <dir>/<name>.r<rank>.npy;
  {"kind": "matvec", "name", "op", "precision", "comm", "packed", "tb",
      "matrix", "p"}: the whole A @ p (np.load(p)) saved as
      <dir>/<name>.r<rank>.npy;
  {"kind": "diagonal", "name", "op", "precision", "comm", "packed", "tb",
      "matrix"}: the operator's whole diagonal() saved the same way, and
      the whole f32 inverse diagonal of the preconditioned inner loop
      (`_inv_diag_f32`) as <dir>/<name>.inv.r<rank>.npy;
  {"kind": "heat", "name", "nx", "ny", "rel_error"}: the row-sharded heat
      solve (`solve_heat_cg(devices=G)`) of the nx x ny demo plate; its
      inner iterations, residual, and the grid saved as above;
  {"kind": "heat-cli", "name", "argv"}: lam_tpu_torch.apps.heat_cli.main
      as the "cli" job runs lam_tpu_torch.cli.main;
  {"kind": "bench", "name", "argv", "env"}: lam_tpu_torch.bench.runner.main
      the same way, with "env" set in this process's environment first;
  {"kind": "from_file", "name", "op", "precision", "engine", "comm",
      "packed", "tb", "matrix"}: the operator's `from_file` constructor
      beside the one built from per-rank reads (as "solve" builds it):
      whether every operand tensor is equal (dtype and bits) and the
      sizes (n, n_padded) of both;
  {"kind": "halo", "name"}: Mesh.halo of the rows rank+1 and -(rank+1)
      (4 wide); the (up, dn) it returns saved as above;
  {"kind": "checkpoint", "name", "op", "precision", "engine", ..., "dir"}:
      the resumable solve (lam_tpu_torch.solver.checkpoint) uninterrupted,
      then stopped (CG after 30 iterations, refinement after one cycle)
      with its state in "dir" and resumed from it; each run's iterations,
      whether the resumed x is bitwise the uninterrupted one (and, for
      CG, cg_solve's), and the resumed x saved as above;
  {"kind": "block", "name", "op", "precision", "engine", ..., "rhs_block"}:
      cg_solve_block of np.load(rhs_block); per-column iterations and the
      whole X saved as above.
A rank outside the grid records {"idle": true} for a grid job.
`launch_cluster` is what the tests call: it starts the rank processes of
one CPU cluster and returns their records. One cluster runs at a time on a
host (`host_lock`, a file lock, which the dry run's test takes too): a
solve is a chain of small collectives, and clusters of several test files
sharing the cores stretch each other many times over.
Imports nothing of JAX.
"""

import argparse
import contextlib
import fcntl
import io
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lam_tpu_torch import (cg_solve, cg_solve_block, cg_solve_ir,  # noqa: E402
                           cli, ops)
from lam_tpu_torch.solver import checkpoint as ckpt  # noqa: E402
from lam_tpu_torch import io as lio  # noqa: E402
from lam_tpu_torch.apps import heat, heat_cli  # noqa: E402
from lam_tpu_torch.bench import runner  # noqa: E402
from lam_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from lam_tpu_torch.parallel.pcg import ShardedDenseOperator  # noqa: E402
from lam_tpu_torch.parallel.pcg2d import Sharded2DOperator  # noqa: E402
from lam_tpu_torch.parallel.pcg2d_symm import Symm2DOperator  # noqa: E402
from lam_tpu_torch.parallel.pcg_symm import SymmShardedOperator  # noqa: E402
from lam_tpu_torch.solver.cg import (_inv_diag_f32,  # noqa: E402
                                     default_inner_floor)

_BASE = {"ir": "df64", "irq": "dfq", "irfq": "fq"}
_GRID_OPS = ("grid", "symgrid")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def host_lock():
    """Hold this host's cluster lock (a file lock in the temporary
    directory): one cluster of rank processes runs at a time, whichever
    test file starts it."""
    lock_path = os.path.join(tempfile.gettempdir(),
                             f"lam_tpu_torch_cluster.{os.getuid()}.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


# an Open MPI launcher's URI: job id 1531576320 (a multiple of 4096), the
# launcher's address, its port
OMPI_URI = "1531576320.0;tcp://127.0.0.1:34911"


def _rank_start(launcher, g, r, port):
    """(the extra argv, the launcher's variables) of rank r of g: the
    three rank flags (launcher None); under 'slurm' no flag, the step's
    node list 127.0.0.1 and JAX_COORDINATOR_PORT the coordinator's port;
    under 'ompi' an explicit --coordinator beside mpirun's variables."""
    coordinator = ["--coordinator", f"127.0.0.1:{port}"]
    if launcher is None:
        return coordinator + ["--num-processes", str(g), "--process-id",
                              str(r)], {}
    if launcher == "slurm":
        return [], {"SLURM_JOB_ID": "4242", "SLURM_STEP_NODELIST":
                    "127.0.0.1", "SLURM_NTASKS": str(g),
                    "SLURM_PROCID": str(r), "SLURM_LOCALID": str(r),
                    "JAX_COORDINATOR_PORT": str(port)}
    assert launcher == "ompi", launcher
    return coordinator, {"OMPI_MCA_orte_hnp_uri": OMPI_URI,
                         "OMPI_COMM_WORLD_SIZE": str(g),
                         "OMPI_COMM_WORLD_RANK": str(r),
                         "OMPI_COMM_WORLD_LOCAL_RANK": str(r)}


def launch_cluster(g, jobs, out, timeout_s, device="cpu", launcher=None):
    """Run the jobs in a gloo cluster of g processes of this script (on
    CPUs, or sharing the card with device="cuda"), started with the rank
    flags, or as srun ('slurm') or mpirun ('ompi') starts them, the rank
    count and rank in the launcher's variables and no rank flag; returns
    each rank's records as {job name: record}, among them "launch", which
    must show the rank, the size and the launcher the rank was given.
    Every rank is killed at the timeout."""
    os.makedirs(out, exist_ok=True)
    jobs_path = os.path.join(out, "jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    # no launcher's variables but the cluster's own
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SLURM_", "OMPI_", "JAX_COORDINATOR_"))}
    env.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    logs = []
    # held until this cluster has ended; the timeout runs from its start
    with host_lock():
        port = _free_port()
        starts = [_rank_start(launcher, g, r, port) for r in range(g)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *flags, "--device",
             device, "--jobs", jobs_path, "--out", out],
            env={**env, **rank_env}, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for flags, rank_env in starts]
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=timeout_s)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    codes = [proc.returncode for proc in procs]
    assert not any(codes), f"exit codes {codes}:\n" + "\n".join(logs)
    records = []
    for r in range(g):
        with open(os.path.join(out, f"results.r{r}.json")) as f:
            records.append({rec["name"]: rec for rec in json.load(f)})
        launch = records[r]["launch"]
        assert (launch["rank"], launch["size"], launch["launched_by"]) == (
            r, g, launcher or "flags"), launch
    return records


def _operator(job, mesh):
    """This rank's part of the job's operator, read from its matrix file
    (each rank reads only its own rows or block)."""
    storage = _BASE.get(job["precision"], job["precision"])
    path = job["matrix"]
    n = lio.read_header(path)[0]
    src = path if job.get("pack_cache", False) else None

    def rows(s, count):
        return lio.read_matrix_rows(path, s, count)

    def block(r0, c0, h, w):
        return lio.read_matrix_block(path, r0, c0, h, w)

    engine = job.get("engine", "auto")
    if job["op"] == "dense":
        return ShardedDenseOperator.from_row_block_fn(
            rows, n, mesh=mesh, precision=storage, comm=job["comm"],
            engine=engine)
    if job["op"] == "grid":
        return Sharded2DOperator.from_block_fn(block, n, mesh=mesh,
                                               precision=storage,
                                               engine=engine)
    if job["op"] == "symgrid":
        return Symm2DOperator.from_block_fn(
            block, n, mesh=mesh, tb=job["tb"], precision=storage,
            pack_cache_src=src)
    return SymmShardedOperator.from_row_block_fn(
        rows, n, mesh=mesh, tb=job["tb"], packed=job.get("packed", False),
        precision=storage, pack_cache_src=src)


def _from_file(job, mesh):
    """This rank's part of the job's operator through its `from_file`
    constructor."""
    storage = _BASE.get(job["precision"], job["precision"])
    path, engine = job["matrix"], job.get("engine", "auto")
    if job["op"] == "dense":
        return ShardedDenseOperator.from_file(
            path, mesh=mesh, precision=storage, engine=engine,
            comm=job["comm"])
    if job["op"] == "grid":
        return Sharded2DOperator.from_file(path, mesh=mesh,
                                           precision=storage, engine=engine)
    if job["op"] == "symgrid":
        return Symm2DOperator.from_file(path, mesh=mesh, tb=job["tb"],
                                        precision=storage)
    return SymmShardedOperator.from_file(
        path, mesh=mesh, tb=job["tb"], packed=job.get("packed", False),
        precision=storage)


def _operands(op):
    return op.operand if isinstance(op.operand, tuple) else (op.operand,)


def _save(out, name, rank, x):
    np.save(os.path.join(out, f"{name}.r{rank}.npy"), x)


def _rank_flags(launch):
    """The rank flags of an entry point's run in this cluster: the three
    flags as this rank was started, or --coordinator alone under a
    launcher, whose variables give the rest."""
    flags = ["--coordinator", launch.coordinator]
    if launch.launched_by == "flags":
        flags += ["--num-processes", str(launch.num_processes),
                  "--process-id", str(launch.process_id)]
    return flags


def _run(job, args, out, meshes):
    name = job["name"]
    if job["kind"] in ("cli", "heat-cli", "bench"):
        os.environ.update(job.get("env", {}))
        argv = job["argv"] + _rank_flags(args.launch) + [
            "--device", args.device]
        buf, err = io.StringIO(), io.StringIO()
        main = {"cli": cli.main, "heat-cli": heat_cli.main,
                "bench": runner.main}[job["kind"]]
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = main(argv)
        return {"rc": rc, "stdout": buf.getvalue(), "stderr": err.getvalue()}
    if job["kind"] == "heat":
        grid, iters, rel = heat.solve_heat_cg(
            heat.initial_grid(job["nx"], job["ny"]), devices=meshes[0].size,
            rel_error=job["rel_error"], device=args.device)
        _save(out, name, args.process_id, grid)
        return {"iters": iters, "rel": rel, "backend": meshes[0].backend,
                "device": str(meshes[0].device)}
    if job["kind"] == "halo":
        first = torch.full((4,), args.process_id + 1.0,
                           device=meshes[0].device)
        up, dn = meshes[0].halo(first, -first)
        _save(out, name, args.process_id,
              torch.stack([up, dn]).cpu().numpy())
        return {}
    mesh = meshes[job["op"] in _GRID_OPS]
    if not mesh.active:
        return {"idle": True}
    op = _operator(job, mesh)
    rec = {"backend": mesh.backend, "device": str(mesh.device),
           "size": mesh.size}
    if job["kind"] == "from_file":
        other = _from_file(job, mesh)
        pairs = list(zip(_operands(op), _operands(other)))
        rec.update(
            equal=len(_operands(op)) == len(_operands(other)) and all(
                x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs),
            tensors=len(pairs), types=[type(op).__name__,
                                       type(other).__name__],
            sizes=[[op.n, op.n_padded], [other.n, other.n_padded]])
        return rec
    if job["kind"] == "diagonal":
        d, inv = op.diagonal(), _inv_diag_f32(op)
        if not isinstance(op, SymmShardedOperator):
            # a rank holds its rows (or its grid row's block)
            d, inv = op.extract_x(d), op.extract_x(inv)
        _save(out, name, args.process_id, d[:op.n].cpu().numpy())
        _save(out, f"{name}.inv", args.process_id,
              inv[:op.n].cpu().numpy())
        return rec
    if job["kind"] == "matvec":
        y = op.matvec(op.prepare_b(np.load(job["p"])))
        if not isinstance(op, SymmShardedOperator):
            y = op.extract_x(y)
        _save(out, name, args.process_id, y[:op.n].double().cpu().numpy())
        return rec
    if job["kind"] == "checkpoint":
        return _checkpoint(job, op, rec, out, args.process_id)
    if job["kind"] == "block":
        res = cg_solve_block(op, np.load(job["rhs_block"]), max_iters=10000,
                             rel_error=job["rel_error"])
        _save(out, name, args.process_id, res.x.double().cpu().numpy())
        rec.update(iters=res.num_iters.tolist(),
                   converged=res.converged.tolist())
        return rec
    b = lio.read_vector(job["rhs"])
    pre = job.get("preconditioner")
    if job["precision"] in _BASE:
        res = cg_solve_ir(op.as_f32(), op, b, max_iters=10000,
                          rel_error=job["rel_error"],
                          inner_floor=default_inner_floor(job["precision"]),
                          preconditioner=pre)
    else:
        res = cg_solve(op, b, max_iters=10000, rel_error=job["rel_error"],
                       preconditioner=pre)
    _save(out, name, args.process_id, res.x.double().cpu().numpy())
    rec.update(iters=int(res.num_iters), converged=bool(res.converged),
               rel=float(res.rel_residual))
    return rec


def _checkpoint(job, op, rec, out, rank):
    b = lio.read_vector(job["rhs"])
    kw = {"max_iters": 10000, "rel_error": job["rel_error"]}
    ck = job["dir"]
    if job["precision"] in _BASE:
        kw["inner_floor"] = default_inner_floor(job["precision"])
        op32 = op.as_f32()
        full, _ = ckpt.cg_solve_ir_resumable(op32, op, b, **kw)
        part, _ = ckpt.cg_solve_ir_resumable(op32, op, b, max_cycles=1,
                                             checkpoint_path=ck, **kw)
        res, _ = ckpt.cg_solve_ir_resumable(op32, op, b, checkpoint_path=ck,
                                            resume=True, **kw)
        mono_equal = None
    else:
        full, _ = ckpt.cg_solve_resumable(op, b, segment=25, **kw)
        part, _ = ckpt.cg_solve_resumable(op, b, max_iters=30, segment=10,
                                          rel_error=job["rel_error"],
                                          checkpoint_path=ck)
        res, _ = ckpt.cg_solve_resumable(op, b, segment=50,
                                         checkpoint_path=ck, resume=True,
                                         **kw)
        mono = cg_solve(op, b, **kw)
        mono_equal = bool(torch.equal(mono.x, full.x))
    _save(out, job["name"], rank, res.x.double().cpu().numpy())
    rec.update(iters=int(full.num_iters), part_iters=int(part.num_iters),
               part_converged=bool(part.converged),
               resumed_iters=int(res.num_iters),
               converged=bool(res.converged),
               bitwise=bool(torch.equal(res.x, full.x)),
               mono_bitwise=mono_equal)
    return rec


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument("--device", default="cpu")
    p.add_argument("--jobs", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    with open(args.jobs) as f:
        jobs = json.load(f)
    if args.coordinator is None:  # all from the launcher
        launch = pmesh.distributed_init(device=args.device)
    else:
        launch = pmesh.distributed_init(args.coordinator, args.num_processes,
                                        args.process_id, device=args.device)
    args.launch, args.process_id = launch, launch.process_id
    meshes = [pmesh.make_mesh(device=args.device), None]
    if any(job.get("op") in _GRID_OPS for job in jobs):
        meshes[1] = pmesh.make_mesh2d(device=args.device)
    results = [{"name": "launch", "rank": launch.process_id,
                "size": launch.num_processes, "device": launch.device,
                "backend": launch.backend,
                "mesh_device": str(meshes[0].device),
                "mesh_backend": meshes[0].backend,
                "launched_by": launch.launched_by, "source": launch.source,
                "coordinator": launch.coordinator, "uuid": launch.uuid}]
    for job in jobs:
        ops.reset_counters()
        rec = _run(job, args, args.out, meshes)
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
