"""device_mem_gb: the card memory the solver takes, in 1e9 bytes, as the
device reports it (cudaMemGetInfo): its highest reading over the build, the
warm-up and the window, less the reading once the benchmark's own copy of
the system was freed. The allocator's caches, the libraries' workspaces and
the program's loaded kernels count; the answers are kept on the host."""


def read(run):
    if run.solver_bytes is None:
        return None
    return run.solver_bytes / 1e9
