"""The benchmark of lam_tpu_torch: one run of one cell.

    python3 cgbench/run.py --workload spd40k.ir --seed 7 --seconds 40 --trace 0

Run from the root of a checkout. It exits 1 and prints no result where
torch sees no card or fewer than the cell asks for, where the port cannot
be imported, or where the process holds a JAX module (or lam_tpu's) once
the window has closed. Otherwise it prints the compared numbers beside
their limits as the last lines of standard error, and the result as one
JSON object, the last line of standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _fail(msg):
    print(f"cgbench: {msg}", file=sys.stderr)
    return 1


def _power_limit():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"unread (rc {out.returncode})")


def main(argv=None):
    p = argparse.ArgumentParser(prog="cgbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from cgbench import harness
    spec = harness.load_spec(ROOT)
    try:
        cell, cfg, traffic = harness.find_cell(spec, args.workload)
    except KeyError as e:
        return _fail(e.args[0])
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False: this benchmark "
                     "runs on a card only")
    if torch.cuda.device_count() < cell["chips"]:
        return _fail(f"{args.workload} needs {cell['chips']} cards, torch "
                     f"sees {torch.cuda.device_count()}")
    try:
        import lam_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the port lam_tpu_torch cannot be imported: {e}")
    traced = bool(args.trace)
    run = harness.run_cell(cell, cfg, traffic, args.seed, args.seconds,
                           traced, "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        return _fail(f"the process holds {', '.join(found)} after the "
                     "window")
    card = _power_limit()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"]}
    out = harness.result_line(spec, cell, run, traced, device)
    out["program"]["card"] = card
    times = sorted(run.solve_times)
    print(f"cgbench: {args.workload} seed {args.seed} on {card}; "
          f"{run.attempted} solves, {run.failed} failed; setup_s "
          f"{run.setup_s!r} build_s {run.build_s!r} warmup_s "
          f"{run.warmup_s!r} window_s {run.window_s!r} in {len(times)} "
          f"solves of {times[0]!r} to {times[-1]!r} s, median "
          f"{times[len(times) // 2]!r}, iterations "
          f"{min(run.iters)} to {max(run.iters)}, matvec {run.gemv_s!r} s",
          file=sys.stderr)
    for line in harness.check_lines(run):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
