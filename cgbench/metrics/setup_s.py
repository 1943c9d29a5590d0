"""setup_s: from the first line of cgbench/run.py to the window's start:
imports, the kernel library (built by the first run in a checkout), the
system made on the card and brought to the host, the solver's build and
its warm-up solve."""


def read(run):
    return run.setup_s
