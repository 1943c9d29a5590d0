"""The port's compile check and multi-rank dry run: `entry` and
`dryrun_multichip`, the counterparts of __graft_entry__.py:6-34 and
:35-273.

    python -m lam_tpu_torch.dryrun --ranks G [--device cuda|cpu]

`entry(device)` returns (fn, example_args): fn(a_hi, a_lo, b) runs the
port's CG loop (`solver.cg._cg_loop`) for 20 iterations over the df64
full-square matvec of engine 'pallas' (kernel 4, `gemv_df64`, on the
card; its plain version on the CPU), on lam_tpu's example: the
generate-mode tridiagonal of n=512 against ones.

`dryrun_multichip(G, device)` starts G rank processes of this module
(`--coordinator/--num-processes/--process-id/--device`, as the CLI's
sharded runs take them; a rank started by srun or mpirun needs only
`--coordinator`, `--device` and `--workdir`), joined in one process
group (gloo when they share a card or the CPU). Each leg is one
converged solve of `random_spd_system(n, seed=2024)`, or one matvec, in
lam_tpu's order:

  gather, ir/gather, ring, ir/ring     row shards (precision 'auto': df64
                                       on a card, f64 on the CPU), then
                                       refinement on the df64 pair
  symm, ir/symm, symm-packed, ir/symm-packed, symm-dfq, irq/symm-dfq
                                       band pairs: slab, packed, dfq
  2d, 2d-chain, 2d-gen                 the dense R x R grid (R = isqrt(G)
                                       >= 2): a solve, one matvec_chain
                                       step, the generate-mode tridiagonal
  sym2d, ir/sym2d, sym2d-gen, sym2d-dfq, irq/sym2d-dfq, sym2d-fq,
  irfq/sym2d-fq, sym2d-genfq          the symmetric grid: df64, dfq, fq
                                       and the gen constructors
  heat                                 the row-sharded heat solve

held to lam_tpu's checks (__graft_entry__.py:87-101): every solve
converged, its TRUE residual |b - A x| / |b|, recomputed on the host in
f64, below 1e-8, and a direct solve's iterations within max(3, k // 50)
of `oracle_cg`'s k (refinement solves are held by their TRUE residual
only); the matvecs and the heat grid as lam_tpu holds them. Rank 0 prints
one `DRYRUN_OK <leg> ...` line a leg; the parent fails unless every leg
printed one, or if a rank fails or outlives RANK_TIMEOUT_S (it kills the
others and raises with every rank's log). Each rank records its kernel
launches and plain-version calls a leg (`ops.counters()`); on the card
the parent fails if any plain version ran or a leg launched none of the
kernels in its KERNELS_OF row.

Sizes: on the CPU lam_tpu's, n = max(64 G, 512) with tb = 128. The
card's symmetric kernels take only their own tile (tb = 512,
`layout.SYMM_TB`), so there n = 2 G * 512 (4096 at G = 4), the smallest
at which every rank of the band pairs holds a band of real tiles and
every block of the R = 2 grid four tile rows of them.

With device='cuda' and no card it raises at once; no leg is caught and
skipped. The kernels are built in the parent before the ranks start, so a
failed build raises there.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from lam_tpu_torch import generate as gen
from lam_tpu_torch.solver.cg import cg_solve, cg_solve_ir, default_inner_floor
from lam_tpu_torch.solver.operators import resolve_device
from lam_tpu_torch.solver.oracle import oracle_cg

SEED = 2024
REL_ERROR = 1e-9
TRUE_GATE = 1e-8      # TRUE residual of every solve
CHAIN_GATE = 1e-10    # 2d-chain against (A b) / |A b|, relative
GEN_N = 300           # the gen constructors' size
GEN_GATE = 1e-9       # their matvecs against T @ p, max abs
HEAT_GATE = 1e-6      # the sharded heat grid against the one-device f64's
CPU_TB = 128
RANK_TIMEOUT_S = 900  # a rank that takes longer is killed: a hang

# the kernels each leg launches on the card (summed over its ranks); the
# f64 legs of the CPU run plain torch products and no kernel
KERNELS_OF = {
    "gather": ("gemv_df64",),
    "ir/gather": ("gemv_f32", "gemv_df64"),
    "ring": ("gemv_df64_cols",),
    "ir/ring": ("gemv_f32_cols", "gemv_df64_cols"),
    "symm": ("gemv_df64_symm_slab",),
    "ir/symm": ("gemv_f32_symm_slab", "gemv_df64_symm_slab"),
    "symm-packed": ("gemv_df64_symm_slab",),
    "ir/symm-packed": ("gemv_f32_symm_slab", "gemv_df64_symm_slab"),
    "symm-dfq": ("gemv_dfq_symm_slab",),
    "irq/symm-dfq": ("gemv_f32_symm_slab", "gemv_dfq_symm_slab"),
    "2d": ("gemv_df64",),
    "2d-chain": ("gemv_df64",),
    "2d-gen": ("gemv_df64",),
    "sym2d": ("gemv_df64_symm", "gemv_df64_dual"),
    "ir/sym2d": ("gemv_f32_symm", "gemv_f32_dual", "gemv_df64_symm",
                 "gemv_df64_dual"),
    "sym2d-gen": ("gemv_df64_symm_bcast", "gemv_df64_dual_zero"),
    "sym2d-dfq": ("gemv_dfq_symm", "gemv_dfq_dual"),
    "irq/sym2d-dfq": ("gemv_f32_symm", "gemv_f32_dual", "gemv_dfq_symm",
                      "gemv_dfq_dual"),
    "sym2d-fq": ("gemv_fq_symm", "gemv_fq_dual"),
    "irfq/sym2d-fq": ("gemv_q16_symm", "gemv_q16_dual", "gemv_fq_symm",
                      "gemv_fq_dual"),
    "sym2d-genfq": ("gemv_fq_symm_zero", "gemv_fq_dual_zero"),
    "heat": ("laplace5_f32_halo",),
}


def entry(device="cuda"):
    """(fn, example_args): the flagship df64 CG loop (__graft_entry__.py:
    6-34). fn(a_hi, a_lo, b) runs 20 iterations of `_cg_loop` over the
    df64 full-square matvec (kernel 4 on the card) and returns x."""
    from lam_tpu_torch.solver.cg import _cg_loop
    from lam_tpu_torch.solver.operators import _mv_df64_pallas, vdot
    dev = resolve_device(device)
    n = 512  # one tile: minimal padded size
    a = gen.tridiagonal_matrix(n)
    b = gen.ones_rhs(n)
    a_hi = a.astype(np.float32)
    a_lo = (a - a_hi.astype(np.float64)).astype(np.float32)

    def fn(a_hi, a_lo, b):
        def matvec_dot(p):
            ap = _mv_df64_pallas((a_hi, a_lo), p)
            return ap, vdot(p, ap)

        return _cg_loop(matvec_dot, b, 20, REL_ERROR).x

    return fn, tuple(torch.from_numpy(x).to(dev) for x in (a_hi, a_lo, b))


def sizes(n_ranks, device):
    """(n, tb) of the dry run over n_ranks ranks on `device`."""
    if torch.device(device).type == "cuda":
        from lam_tpu_torch.ops import layout
        return 2 * n_ranks * layout.SYMM_TB, layout.SYMM_TB
    return max(64 * n_ranks, 512), CPU_TB


def legs_of(n_ranks):
    """The legs a run over n_ranks ranks takes, in order."""
    legs = [f"{pre}{name}" for name in ("gather", "ring", "symm",
                                        "symm-packed", "symm-dfq")
            for pre in ("", "irq/" if name == "symm-dfq" else "ir/")]
    if math.isqrt(n_ranks) >= 2:
        legs += ["2d", "2d-chain", "2d-gen", "sym2d", "ir/sym2d",
                 "sym2d-gen", "sym2d-dfq", "irq/sym2d-dfq", "sym2d-fq",
                 "irfq/sym2d-fq", "sym2d-genfq"]
    return legs + ["heat"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_argv(rank, n_ranks, port, device, work):
    """The command line of rank `rank`."""
    return [sys.executable, "-m", "lam_tpu_torch.dryrun", "--coordinator",
            f"127.0.0.1:{port}", "--num-processes", str(n_ranks),
            "--process-id", str(rank), "--device", device, "--workdir", work]


def _wait_all(procs, deadline):
    """Wait until every process has exited, one has failed, or the
    deadline passes; then kill the survivors. Returns the exit codes
    (None for a killed process)."""
    while time.monotonic() < deadline:
        codes = [proc.poll() for proc in procs]
        if all(c is not None for c in codes) or any(codes):
            break
        time.sleep(0.1)
    codes = [proc.poll() for proc in procs]
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return codes


def _card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(0)


def dryrun_multichip(n_ranks, device="cuda"):
    """Converged sharded solves of every backend over n_ranks rank
    processes, checked against `oracle_cg` (module docstring). Returns
    one record a leg: {"leg", "line" (rank 0's DRYRUN_OK line), "seconds"
    (rank 0's), "kernels" and "plain" ({name: count} summed over the
    ranks, nonzero only)}. Raises on any failure."""
    dev = resolve_device(device)
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    if dev.type == "cuda":
        from lam_tpu_torch.ops import _build
        _build.build()
        print(f"dryrun: {n_ranks} ranks sharing {_card_line()}")
    n, tb = sizes(n_ranks, dev)
    legs = legs_of(n_ranks)
    a, b = gen.random_spd_system(n, seed=SEED)
    _, iters_ref, _, _ = oracle_cg(a, b, max_iters=2000, rel_error=REL_ERROR)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory(prefix="lam_dryrun_") as work:
        np.save(os.path.join(work, "a.npy"), a)
        np.save(os.path.join(work, "b.npy"), b)
        with open(os.path.join(work, "system.json"), "w") as f:
            json.dump({"tb": tb, "oracle": iters_ref}, f)
        port = _free_port()
        logs = [open(os.path.join(work, f"rank{r}.log"), "w")
                for r in range(n_ranks)]
        try:
            procs = [subprocess.Popen(
                _rank_argv(r, n_ranks, port, dev.type, work), cwd=root,
                stdout=logs[r], stderr=subprocess.STDOUT)
                for r in range(n_ranks)]
            codes = _wait_all(procs, time.monotonic() + RANK_TIMEOUT_S)
        finally:
            for log in logs:
                log.close()
        texts = []
        for r in range(n_ranks):
            with open(os.path.join(work, f"rank{r}.log")) as f:
                texts.append(f.read())
        if any(c != 0 for c in codes):
            raise RuntimeError(
                f"dry run over {n_ranks} ranks failed: exit codes {codes} "
                "(None: killed)\n" + "\n".join(
                    f"--- rank {r} (exit {codes[r]}):\n{texts[r][-4000:]}"
                    for r in range(n_ranks)))
        records = []
        for r in range(n_ranks):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                records.append(json.load(f))
    ok = {leg: line for line, leg in
          re.findall(r"^(DRYRUN_OK (\S+) .*)$", texts[0], re.M)}
    missing = [leg for leg in legs if leg not in ok]
    if missing:
        raise RuntimeError(f"legs without a DRYRUN_OK line: {missing}\n"
                           + texts[0][-4000:])
    out = []
    for leg in legs:
        kernels, plain = {}, {}
        for rec in records:
            for name, count in rec["legs"][leg]["counts"].items():
                into = plain if name.endswith("_plain") else kernels
                into[name] = into.get(name, 0) + count
        out.append({"leg": leg, "line": ok[leg],
                    "seconds": records[0]["legs"][leg]["seconds"],
                    "kernels": kernels, "plain": plain})
    if dev.type == "cuda":
        bad = [(r["leg"], r["plain"]) for r in out if r["plain"]]
        idle = [(r["leg"], name) for r in out for name in KERNELS_OF[r["leg"]]
                if not r["kernels"].get(name)]
        if bad or idle:
            raise RuntimeError(f"dry run on the card: plain versions ran "
                               f"{bad}; kernels not launched {idle}")
    return out


# -- one rank ---------------------------------------------------------------


class _Rank:
    """One rank's run of the legs: the system, the meshes, and a record
    of each leg's seconds and counters."""

    def __init__(self, args):
        from lam_tpu_torch.parallel import mesh as pmesh
        self.device = args.device
        work = args.workdir
        with open(os.path.join(work, "system.json")) as f:
            meta = json.load(f)
        self.tb, self.iters_ref = meta["tb"], meta["oracle"]
        self.a = np.load(os.path.join(work, "a.npy"), mmap_mode="r")
        self.b = np.load(os.path.join(work, "b.npy"))
        self.bnorm = np.linalg.norm(self.b)
        self.mesh = pmesh.make_mesh(device=self.device)
        self.rank = self.mesh.rank
        r = math.isqrt(self.mesh.size)
        self.mesh2 = None
        if r >= 2:  # every rank creates the grid's subgroups, idle ones too
            self.mesh2 = pmesh.make_mesh2d(r, device=self.device)
        self.legs = {}

    def _sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def leg(self, name, run):
        """Run one leg: counters zeroed before it, read after it; rank 0
        prints its DRYRUN_OK line (run's return value)."""
        from lam_tpu_torch import ops
        self._sync()
        ops.reset_counters()
        t0 = time.perf_counter()
        said = run()
        self._sync()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in ops.counters().items() if v}
        self.legs[name] = {"seconds": seconds, "counts": counts}
        if self.rank == 0:
            print(f"DRYRUN_OK {name} {said} seconds={seconds:.3f}",
                  flush=True)

    def solve(self, name, res):
        """lam_tpu's check of a solve (__graft_entry__.py:87-101); the
        DRYRUN_OK fields. A refinement leg ('<mode>/<leg>') is held by its
        TRUE residual only, a direct solve to the oracle's count too."""
        x = res.x.double().cpu().numpy()
        if not bool(res.converged):
            raise RuntimeError(f"{name}: did not converge "
                               f"({int(res.num_iters)} iterations)")
        true_rel = float(np.linalg.norm(self.b - self.a @ x) / self.bnorm)
        if not true_rel < TRUE_GATE:
            raise RuntimeError(f"{name}: TRUE residual {true_rel}")
        iters = int(res.num_iters)
        oracle = "-"
        if "/" not in name:
            # per-shard partial sums change the reduction order, so the
            # 1e-9 crossing moves a few iterations against the oracle
            tol = max(3, self.iters_ref // 50)
            if abs(iters - self.iters_ref) > tol:
                raise RuntimeError(f"{name}: {iters} iterations vs oracle "
                                   f"{self.iters_ref}")
            oracle = self.iters_ref
        return f"iters={iters} oracle={oracle} true_rel={true_rel:.3e}"

    def gen_matvec(self, name, op):
        """A gen constructor's matvec against T @ p on the host."""
        pg = gen.random_rhs(GEN_N, seed=4)
        y = op.extract_x(op.matvec(op.prepare_b(pg))).double().cpu().numpy()
        err = float(np.abs(y[:GEN_N] - gen.tridiagonal_matrix(GEN_N) @ pg)
                    .max())
        if not err < GEN_GATE:
            raise RuntimeError(f"{name}: max abs error {err}")
        return f"err={err:.3e}"

    def run(self):
        from lam_tpu_torch.parallel.pcg import ShardedDenseOperator
        from lam_tpu_torch.parallel.pcg_symm import SymmShardedOperator
        a, b, dev, tb, mesh = self.a, self.b, self.device, self.tb, self.mesh
        kw = {"max_iters": 2000, "rel_error": REL_ERROR}
        kw_ir = {"max_iters": 10000, "rel_error": REL_ERROR}
        for comm in ("gather", "ring"):
            op = ShardedDenseOperator.from_dense(
                a, mesh=mesh, precision="auto", comm=comm, device=dev)
            self.leg(comm, lambda: self.solve(comm, cg_solve(op, b, **kw)))
            acc = ShardedDenseOperator.from_dense(
                a, mesh=mesh, precision="df64", comm=comm, device=dev)
            self.leg(f"ir/{comm}", lambda: self.solve(
                f"ir/{comm}", cg_solve_ir(acc.as_f32(), acc, b, **kw_ir)))
        for name, opts in (("symm", {}), ("symm-packed", {"packed": True}),
                           ("symm-dfq", {"precision": "dfq"})):
            op = SymmShardedOperator.from_dense(a, mesh=mesh, tb=tb,
                                                device=dev, **opts)
            self.leg(name, lambda: self.solve(name, cg_solve(op, b, **kw)))
            ir = "irq/" if name == "symm-dfq" else "ir/"
            self.leg(ir + name, lambda: self.solve(
                ir + name, cg_solve_ir(op.as_f32(), op, b, **kw_ir)))
        if self.mesh2 is not None:
            if self.mesh2.active:
                self.grid_legs(kw, kw_ir)
            mesh.barrier()  # the ranks outside the grid wait here
        self.leg("heat", self.heat)

    def grid_legs(self, kw, kw_ir):
        from lam_tpu_torch.parallel.pcg2d import Sharded2DOperator
        from lam_tpu_torch.parallel.pcg2d_symm import Symm2DOperator
        a, b, dev, tb, mesh2 = self.a, self.b, self.device, self.tb, self.mesh2
        op2 = Sharded2DOperator.from_dense(a, mesh=mesh2, precision="auto",
                                           device=dev)
        self.leg("2d", lambda: self.solve("2d", cg_solve(op2, b, **kw)))

        def chain():
            # the matvec_chain program applies the solve's operator: one
            # normalized power-iteration step against numpy
            v = op2.extract_x(op2.matvec_chain(op2.prepare_b(b), 1))
            ab = a @ b
            ref = ab / np.linalg.norm(ab)
            err = float(np.linalg.norm(v.double().cpu().numpy() - ref)
                        / np.linalg.norm(ref))
            if not err < CHAIN_GATE:
                raise RuntimeError(f"2d-chain: relative error {err}")
            return f"err={err:.3e}"

        self.leg("2d-chain", chain)
        self.leg("2d-gen", lambda: self.gen_matvec(
            "2d-gen", Sharded2DOperator.from_gen_tridiagonal(
                GEN_N, mesh=mesh2, precision="auto", device=dev)))
        for storage in ("df64", "dfq", "fq"):
            name = "sym2d" if storage == "df64" else f"sym2d-{storage}"
            ir = {"df64": "ir", "dfq": "irq", "fq": "irfq"}[storage]
            op = Symm2DOperator.from_dense(a, mesh=mesh2, tb=tb,
                                           precision=storage, device=dev)
            self.leg(name, lambda: self.solve(name, cg_solve(op, b, **kw)))
            self.leg(f"{ir}/{name}", lambda: self.solve(
                f"{ir}/{name}", cg_solve_ir(
                    op.as_f32(), op, b,
                    inner_floor=default_inner_floor(ir), **kw_ir)))
            if storage == "df64":
                self.leg("sym2d-gen", lambda: self.gen_matvec(
                    "sym2d-gen", Symm2DOperator.from_gen_tridiagonal(
                        GEN_N, mesh=mesh2, tb=tb, device=dev)))
        self.leg("sym2d-genfq", lambda: self.gen_matvec(
            "sym2d-genfq", Symm2DOperator.from_gen_fq(
                GEN_N, mesh=mesh2, tb=tb, device=dev)))

    def heat(self):
        """The row-sharded heat solve against the one-device f64 solve
        (computed on the host)."""
        from lam_tpu_torch.apps import heat
        g0 = heat.initial_grid(40, 36)
        ref, _, _ = heat.solve_heat_cg(g0, precision="f64", rel_error=1e-11,
                                       device="cpu")
        out, iters, rel = heat.solve_heat_cg(
            g0, devices=self.mesh.size, rel_error=1e-11, device=self.device)
        err = float(np.abs(out - ref).max())
        if not (rel < 1e-11 and err < HEAT_GATE):
            raise RuntimeError(f"heat: rel {rel}, max abs error {err}")
        return f"iters={iters} rel={rel:.3e} err={err:.3e}"


def _rank_main(args):
    import torch.distributed as dist

    from lam_tpu_torch.parallel.mesh import distributed_init
    distributed_init(args.coordinator, args.num_processes, args.process_id,
                     device=args.device)
    rank = _Rank(args)
    rank.run()
    with open(os.path.join(args.workdir, f"rank{rank.rank}.json"), "w") as f:
        json.dump({"legs": rank.legs}, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m lam_tpu_torch.dryrun",
        description="Converged sharded solves of every backend over G "
                    "rank processes, checked against the f64 oracle")
    p.add_argument("--ranks", type=int, default=4,
                   help="rank processes (G); the 2-D legs need G >= 4")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    # the rank processes' flags (set by dryrun_multichip)
    p.add_argument("--coordinator", help=argparse.SUPPRESS)
    p.add_argument("--num-processes", type=int, help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, help=argparse.SUPPRESS)
    p.add_argument("--workdir", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.coordinator is not None:
        return _rank_main(args)
    t0 = time.perf_counter()
    for rec in dryrun_multichip(args.ranks, args.device):
        counts = rec["kernels"] or rec["plain"]
        print(f"{rec['line']}\n  {rec['leg']}: "
              + (", ".join(f"{k} {v}" for k, v in sorted(counts.items()))
                 or "no kernel (plain torch products)"))
    print(f"dry run over {args.ranks} ranks on {args.device}: every leg "
          f"passed in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
