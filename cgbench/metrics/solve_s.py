"""solve_s: the window's seconds over the solves completed in it."""


def read(run):
    return run.window_s / len(run.solve_times) if run.solve_times else None
