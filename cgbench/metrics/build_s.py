"""build_s: the benchmark's span around the operator build (the facade's
_build_operator: symmetry check, pad, host pack, upload), ending in a
synchronise."""


def read(run):
    return run.build_s
