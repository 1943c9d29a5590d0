"""device_idle_share: the share of the traced solves' window in which no
operation ran on the card (trace.py: the union of device intervals)."""


def read(run):
    if not run.on_card or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
