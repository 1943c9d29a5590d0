"""The benchmark's run of one cell: set-up, the measured window, the traced
solves, and the check that decides `correct`.

Everything a cell is made of is found by name: BENCHMARK.json names the
cell's configuration and traffic, whose files are configs/<name>.json and
traffic/<name>.json under this folder; the configuration's "system" names
the module of reference/ that generates it; each metric is read by
metrics/<name>.py (the name up to its first dot), whose read(run) returns
the number or None.

The solver under test is the port's facade (ProgramSolver). The control
puts the plain reference in its place (control.py); the rest of the run is
the same.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time

import torch

from cgbench import trace as tracing
from cgbench.reference import check

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the process must not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "lam_tpu")
# solves the traced run profiles after its window
TRACED_SOLVES = 3


def load_spec(root=ROOT):
    with open(pathlib.Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(kind, name):
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def find_cell(spec, name):
    """(cell, configuration, traffic) of the cell `name`: the entry of
    spec's workloads and the contents of its two files."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (one of "
                       f"{sorted(cells)})")
    cell = cells[name]
    return cell, _load_json("configs", cell["config"]), _load_json(
        "traffic", cell["traffic"])


def metrics_for(spec, cell_name, traced):
    """The metric entries a run of the cell reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with a workloads list
    only in those cells."""
    entries = spec["per_layer" if traced else "end_to_end"]
    return [m for m in entries
            if cell_name in m.get("workloads", [cell_name])]


def load_reader(name):
    """The module metrics/<q>.py of metric `name`, q its part before the
    first dot: a quantity split by the cells it is reported in, each part
    under its own bound (solve_s and a solve_s.<part>), has one reader."""
    quantity = name.split(".")[0]
    path = HERE / "metrics" / f"{quantity}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"cgbench.metrics.{quantity}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None):
    """The FORBIDDEN top-level names among `names` (default: the modules
    this process has loaded), compared whole: lam_tpu_torch is not
    lam_tpu."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_used_bytes(dev):
    """The device's memory in use as the device reports it
    (cudaMemGetInfo: total less free), allocator caches, libraries'
    workspaces and loaded kernels included; None off a card."""
    if dev.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(dev)
    return total - free


class ProgramSolver:
    """The system under test: lam_tpu_torch's facade on one device, built
    from the host f64 matrix through the in-memory path (`_build_operator`
    with the whole matrix), solving one right-hand side at a time."""

    def __init__(self, a_host, traffic, device):
        from lam_tpu_torch.solver.api import ConjugateGradient
        self.traffic = traffic
        self.cg = ConjugateGradient(backend="local",
                                    precision=traffic["precision"],
                                    engine="auto", device=device,
                                    pack_cache=False)
        n = a_host.shape[0]
        self.cg.n = n
        self.cg.op = self.cg._build_operator(lambda s, m: a_host[s:s + m],
                                             n, full_matrix=a_host)

    @staticmethod
    def prepare(device):
        """Load (building at the first run in a checkout) the kernel
        library and the native host library, both kept in
        lam_tpu_torch/_build/."""
        if device.type == "cuda":
            from lam_tpu_torch import _native_io
            from lam_tpu_torch.ops import _build
            _build.library()
            _native_io.available()

    def warm(self, b):
        """One solve with the facade's warm-up; returns its init_s."""
        t = self.traffic
        self.cg.rhs = b
        self.cg.solve(t["max_iters"], t["rel_error"], warmup=True)
        return self.cg.timings["init_s"]

    def solve(self, b):
        """(converged, counted iterations) of one solve; its x stays
        readable by x() until the next."""
        t = self.traffic
        self.cg.rhs = b
        ok = self.cg.solve(t["max_iters"], t["rel_error"],
                           warmup=t["warmup"])
        return ok, self.cg.timings["num_iters"]

    def x(self):
        return self.cg.result.x

    def gemv_s(self):
        """measure_gemv's CUDA-event time of the matvec the CG loop
        iterates on (the inner one of a refinement precision)."""
        return self.cg.measure_gemv()

    def details(self):
        from lam_tpu_torch.ops import gemv
        return {"precision": self.cg.precision,
                "q16_impl": gemv._q16_impl(self.cg.op.n_padded)}


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers read it."""

    config: dict
    traffic: dict
    on_card: bool
    setup_s: float
    build_s: float
    warmup_s: float
    window_s: float
    solve_times: list
    iters: list
    memory_peak_bytes: int | None
    solver_bytes: int | None
    attempted: int = 0
    failed: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    gemv_s: float | None = None
    trace: dict | None = None
    traced_iters: int = 0
    details: dict = dataclasses.field(default_factory=dict)


def run_cell(cell, cfg, traffic, seed, seconds, traced, device, t_start,
             solver_cls=ProgramSolver):
    """One run of a cell from the seed; t_start is the host clock at the
    process's start. Set-up: the system made on the device and brought to
    the host, the solver built from it (build_s) and warmed up; then the
    closed loop of solves for `seconds`, each answer copied to the host
    outside its timed interval; the matvec timed; with `traced`, a few
    solves profiled; then the solver freed and every solve judged against
    the f64 matrix uploaded again.

    The device's memory in use is read once the benchmark's own copy of
    the system is freed (the baseline), and after the build, the warm-up
    and the window. The allocator keeps what it frees, so these readings
    hold its peak; memory taken outside it counts where it is held at a
    reading. memory_peak_bytes is the highest reading, solver_bytes that
    less the baseline."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    solver_cls.prepare(dev)
    system = importlib.import_module(f"cgbench.reference.{cfg['system']}")
    gen = system.generator(seed, dev)
    a = system.make_matrix(cfg, gen)
    pool = system.make_rhs_pool(cfg, int(traffic["rhs_pool"]), gen)
    a_host = a.cpu().numpy()
    del a
    if on_card:
        torch.cuda.empty_cache()
    base = device_used_bytes(dev)
    t0 = time.perf_counter()
    solver = solver_cls(a_host, traffic, dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    used = [device_used_bytes(dev)]
    warmup_s = solver.warm(pool[-1])
    used.append(device_used_bytes(dev))
    solves, times, iters = [], [], []
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    while True:
        i = len(solves) % len(pool)
        t0 = time.perf_counter()
        ok, k = solver.solve(pool[i])
        t1 = time.perf_counter()
        times.append(t1 - t0)
        iters.append(k)
        solves.append((i, solver.x().cpu(), ok))
        if t1 - w0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - w0
    used.append(device_used_bytes(dev))
    peak = max(used) if on_card else None
    run = Run(cfg, traffic, on_card, setup_s, build_s, warmup_s, window_s,
              times, iters, peak, peak - base if on_card else None,
              details=solver.details())
    run.gemv_s = solver.gemv_s()
    if traced:
        run.trace, traced, run.traced_iters = _traced_solves(
            solver, pool, len(solves), TRACED_SOLVES, dev)
        solves += traced
    del solver
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    a = torch.from_numpy(a_host).to(dev)
    run.checks, run.failed = check.judge(a, pool, solves, cfg)
    run.attempted = len(solves)
    return run


def _traced_solves(solver, pool, start, count, dev):
    """`count` more solves under torch.profiler, inside the SPAN the trace
    reduction reads: (its summary, the solves, their counted
    iterations)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    solves, iters = [], 0
    with profile(activities=activities) as prof:
        with record_function(tracing.SPAN):
            for j in range(count):
                i = (start + j) % len(pool)
                ok, k = solver.solve(pool[i])
                solves.append((i, solver.x().cpu(), ok))
                iters += k
            _sync(dev)
    return tracing.reduce(prof.events()), solves, iters


def result_line(spec, cell, run, traced, device_info):
    """The result's JSON object, its checks last."""
    metrics = {}
    for entry in metrics_for(spec, cell["name"], traced):
        value = load_reader(entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device = dict(device_info, memory_peak_bytes=run.memory_peak_bytes)
    out = {"correct": check.correct(run.checks), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["program"] = run.details
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in run.checks.items()}
    return out


def check_lines(run):
    """The compared numbers beside their limits, one line each."""
    return [f"check {name} {value!r} limit {limit!r}"
            for name, (value, limit) in run.checks.items()]
