"""The shared on-disk cache of benchmark SPD systems (.npy), as
lam_tpu/bench/systems.py keeps it.

The reference generates its benchmark matrices once and every sweep
re-reads the files. Here a system is `random_spd_matrix_fast(n, seed)` (or
`random_spd_matrix` up to n=4096) saved with np.save as
`lam_bench_spd_N{n}_s{seed}.npy`, the name bench.py and lam_tpu's
`lam-bench` use, so the two packages share one corpus: a file either
publishes is byte-equal to the other's and found by either. The search
order is $LAM_BENCH_CACHE_DIR, <repo root>/io/bench (the root found from
this file, the same directory as lam_tpu's: a tool may run from any
working directory), <cwd>/io/bench, then the temporary directory, without
repeats. lam_tpu's last entry is a literal /tmp; here it is
`tempfile.gettempdir()`, so a run that sets TMPDIR keeps its systems
there.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

SEED = 2024


def cache_dirs():
    """The cache directories, in search order, each once."""
    env = os.environ.get("LAM_BENCH_CACHE_DIR")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    dirs = ([env] if env else []) + [
        os.path.join(root, "io", "bench"),
        os.path.join(os.getcwd(), "io", "bench"), tempfile.gettempdir()]
    # the working directory may be the repo root
    return list(dict.fromkeys(dirs))


def cache_paths(n, seed=SEED):
    """Where the N x N system of `seed` may be, in search order."""
    name = f"lam_bench_spd_N{n}_s{seed}.npy"
    return [os.path.join(d, name) for d in cache_dirs()]


def find_cached(n, seed=SEED):
    """The path of a cached N x N system, or None."""
    for path in cache_paths(n, seed):
        if os.path.exists(path):
            return path
    return None


def publish(a, n, seed=SEED):
    """Save `a` as the N x N system of `seed` in the first cache directory
    that takes it, atomically (written to `<path>.tmp`, then renamed), and
    return its path; None when no directory is writable (a full disk must
    not fail the run that generated the system)."""
    for path in cache_paths(n, seed):
        tmp = path + ".tmp"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "wb") as fh:
                np.save(fh, a)
            os.replace(tmp, path)
            return path
        except OSError:
            _remove(tmp)
        except BaseException:
            _remove(tmp)
            raise
    return None


def _remove(path):
    try:
        os.remove(path)
    except OSError:
        pass
