"""`python -m lam_tpu_torch.bench.clean`: the results post-processor of
lam_tpu/bench/clean.py (the reference's TESTS/results/clean.sh).

    python -m lam_tpu_torch.bench.clean results/*.csv [-o BEST_RESULTS]
        [--time-field K]

Each source file is rewritten with its data rows only (rows that start
with a digit), sorted by (N, procs); a row carrying an inline '#'
annotation ('# projected' study rows are not measurements) is dropped and
counted on stderr. A file with no data rows is left as it is, with one
line on stderr. BEST_RESULTS gets, per file, a banner and the row with
the lowest column K (default -1, total_cg_s) of each (N, procs). It runs
on the host with the standard library alone; its output is byte for byte
lam_tpu's.
"""

from __future__ import annotations

import argparse
import sys


def is_data(line):
    """A data row starts with a digit."""
    line = line.strip()
    return bool(line) and line[0].isdigit()


def _num(field):
    return float(field.strip())


def _key(row):
    return _num(row[0]), _num(row[1])


def clean_rows(lines):
    """The data rows of `lines`, split on commas and sorted by (N, procs),
    without the rows that carry an inline '#' annotation: (rows, how many
    annotated rows were dropped)."""
    rows, dropped = [], 0
    for line in lines:
        if not is_data(line):
            continue
        if "#" in line:
            dropped += 1
        else:
            rows.append(line.strip().split(","))
    rows.sort(key=_key)
    return rows, dropped


def best_rows(rows, time_field=-1):
    """The row with the lowest `time_field` of each (N, procs) group,
    sorted by (N, procs); the first of equal times."""
    best = {}
    for row in rows:
        key = (row[0], row[1])
        if key not in best or _num(row[time_field]) < _num(
                best[key][time_field]):
            best[key] = row
    return [best[k] for k in sorted(best, key=_key)]


def main(argv=None):
    p = argparse.ArgumentParser(prog="lam-bench-clean")
    p.add_argument("files", nargs="+")
    p.add_argument("-o", dest="output", default="BEST_RESULTS")
    p.add_argument("--time-field", type=int, default=-1,
                   help="column index used to pick the best row")
    args = p.parse_args(argv)

    with open(args.output, "w") as out:
        out.write("\n")
        for path in args.files:
            with open(path) as f:
                rows, dropped = clean_rows(f.readlines())
            if dropped:
                print(f"lam-bench-clean: {path}: dropped {dropped} "
                      "annotated row(s) (inline '#' comment — e.g. "
                      "'# projected' study rows are not measurements)",
                      file=sys.stderr)
            if not rows:
                # not a results CSV: a rewrite would empty it
                print(f"lam-bench-clean: {path}: no data rows "
                      "(not a results CSV?) — skipped", file=sys.stderr)
                continue
            with open(path, "w") as f:
                f.writelines(",".join(r) + "\n" for r in rows)
            out.write("-" * 53 + "\n")
            out.write(f"-----------------File: {path}"
                      "-------------------------\n")
            out.write("-" * 53 + "\n")
            out.writelines(",".join(r) + "\n"
                           for r in best_rows(rows, args.time_field))
    return 0


if __name__ == "__main__":
    sys.exit(main())
