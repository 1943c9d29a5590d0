"""warmup_s: the facade's init_s, the warm-up solve of solve(warmup=True)
(first launches, the allocator's first requests)."""


def read(run):
    return run.warmup_s
