"""inner_iters: the mean of the solver's counted iterations over the
window's solves (total inner iterations for a refinement precision)."""


def read(run):
    return sum(run.iters) / len(run.iters) if run.iters else None
