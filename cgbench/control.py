"""The control of the check that decides `correct`: the plain reference CG,
computed in float32 (the precision below the f64 answers the
configurations state), put in the solver's place. Everything else is a run
of the cell: the same system and right-hand sides from the seed, the same
closed loop for --seconds, the same check. Its runs have to come out not
correct; the smallest reading of each compared number over its seeds is
that number's upper reading.

    python3 cgbench/control.py --workload spd40k.ir --seconds 10 \\
        --seeds 11 12 13

prints one JSON line per seed. The benchmark's own runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from cgbench import harness  # noqa: E402
from cgbench.reference.cg import cg, exact_matmul  # noqa: E402


class ReferenceSolver:
    """reference/cg.py in float32 on the full float32 square, one
    right-hand side at a time, with the traffic's stopping rule."""

    def __init__(self, a_host, traffic, device):
        exact_matmul()
        self.traffic = traffic
        self.device = device
        a = torch.from_numpy(a_host).to(device)
        self.a = a.to(torch.float32)
        del a
        self._x = None

    @staticmethod
    def prepare(device):
        pass

    def warm(self, b):
        t0 = time.perf_counter()
        self.solve(b)
        return time.perf_counter() - t0

    def solve(self, b):
        t = self.traffic
        b = torch.as_tensor(b, dtype=torch.float64, device=self.device)
        x, k, conv = cg(self.a, b[:, None], t["rel_error"], t["max_iters"])
        self._x = x[:, 0].to(torch.float64)
        return bool(conv[0]), int(k[0])

    def x(self):
        return self._x

    def gemv_s(self):
        return None

    def details(self):
        return {"precision": "f32 reference (control)"}


def run_control(cell, cfg, traffic, seed, seconds, t_start):
    """A run of the cell on the card with the control in the solver's
    place."""
    return harness.run_cell(cell, cfg, traffic, seed, seconds, False,
                            "cuda", t_start, solver_cls=ReferenceSolver)


def main(argv=None):
    p = argparse.ArgumentParser(prog="cgbench-control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell, cfg, traffic = harness.find_cell(harness.load_spec(),
                                           args.workload)
    t_start = T_START
    for seed in args.seeds:
        run = run_control(cell, cfg, traffic, seed, args.seconds, t_start)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": harness.check.correct(run.checks),
            "attempted": run.attempted, "failed": run.failed,
            "iters": [min(run.iters), max(run.iters)],
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in run.checks.items()}}), flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
