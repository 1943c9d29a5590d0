"""kernels_per_iter: the device kernels the profiler saw over the traced
solves (copies and fills left out), over their counted iterations."""


def read(run):
    if not run.on_card or run.trace is None or not run.traced_iters:
        return None
    return run.trace["kernels"] / run.traced_iters
