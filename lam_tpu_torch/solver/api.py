"""The solver facade of lam_tpu/solver/api.py, main-path subset.

One device, file mode: a symmetric SPD system read from the binary
format (or .npy), stored as packed lower-triangle planes and solved by
CG in one of five precisions:

    'df64' f64-parity CG on the (hi, lo) pair (the default)
    'ir'   f32 inner CG on the hi plane, refined with the df64 matvec
    'f32'  f32 CG on an f32 plane
    'fq'   CG on the fully-quantized three-plane storage (f64 vectors)
    'irfq' f32 inner CG on the 2-byte q1 plane of the fq storage,
           refined with the fq matvec

pack_cache=True reads the packed planes from `<file>.<storage>pack`
when that cache is usable and publishes a fresh pack there otherwise.

Every other backend, precision or mode of the JAX facade raises
NotImplementedError. The device is explicit; asking for CUDA where
there is none raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lam_tpu_torch import io as lio
from lam_tpu_torch.solver.cg import cg_solve, cg_solve_ir, default_inner_floor
from lam_tpu_torch.solver.operators import DenseOperator, resolve_device

PRECISIONS = ("df64", "ir", "f32", "fq", "irfq")
_BASE = {"ir": "df64", "irfq": "fq"}  # refinement mode -> its storage


class ConjugateGradient:
    def __init__(self, backend="local", precision="df64", device="cuda",
                 pack_cache=False):
        if backend != "local":
            raise NotImplementedError(f"backend={backend!r} is not ported "
                                      "yet (only 'local')")
        if precision not in PRECISIONS:
            raise NotImplementedError(f"precision={precision!r} is not "
                                      f"ported yet (one of {PRECISIONS})")
        self.backend = backend
        self.precision = precision
        self.device = resolve_device(device)
        self.pack_cache = pack_cache
        self.op = None
        self.rhs = None
        self.result = None
        self.timings = {}
        self.n = None

    def load_matrix_from_file(self, filename):
        """Read and pack the matrix onto the device; times the load."""
        t0 = time.perf_counter()
        rows, cols = lio.read_header(filename)
        if rows != cols:
            raise ValueError(f"{filename}: matrix must be square")
        self.n = rows
        storage = _BASE.get(self.precision, self.precision)
        ctor = getattr(DenseOperator, f"from_file_{storage}")
        self.op = ctor(filename, pack_cache=self.pack_cache,
                       device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["load_s"] = time.perf_counter() - t0
        return True

    def load_rhs_from_file(self, filename):
        b = lio.read_vector(filename)
        if self.n is not None and b.shape[0] != self.n:
            raise ValueError(
                "Size of right hand side does not match the matrix")
        self.rhs = b
        return True

    def solve(self, max_iters=1000, rel_error=1e-9, warmup=True):
        """Run CG; returns True iff converged.

        warmup first runs the solve with max_iters=1 (one chunk of CG
        iterations, frozen after the first, and for 'ir'/'irfq' one
        refinement cycle), so the kernel build, first launches and the
        allocator's first requests are timed as init_s, not in the
        solve."""
        if self.op is None or self.rhs is None:
            raise RuntimeError("load a system first")
        if warmup:
            t_init = time.perf_counter()
            float(self._solve_once(1, rel_error).rel_residual)
            self.timings["init_s"] = time.perf_counter() - t_init
        t0 = time.perf_counter()
        result = self._solve_once(max_iters, rel_error)
        float(result.rel_residual)  # waits for the device
        return self.record_result(result, time.perf_counter() - t0)

    def record_result(self, result, solve_s):
        """Store a CGResult and its wall time into the timings dict."""
        self.result = result
        iters = max(int(result.num_iters), 1)
        self.timings["solve_s"] = solve_s
        self.timings["avg_iter_s"] = solve_s / iters
        self.timings["num_iters"] = int(result.num_iters)
        # CSV parity: the reference's loop exits with num_iters ==
        # max_iters + 1 when unconverged and its CSV prints THAT value,
        # while its verbose print says max_iters
        self.timings["csv_num_iters"] = int(result.num_iters) + (
            0 if bool(result.converged) else 1)
        self.timings["rel_residual"] = float(result.rel_residual)
        return bool(result.converged)

    def _solve_once(self, max_iters, rel_error):
        if self.precision in _BASE:
            return cg_solve_ir(self.op.as_f32(), self.op, self.rhs,
                               max_iters=max_iters, rel_error=rel_error,
                               inner_floor=default_inner_floor(
                                   self.precision))
        return cg_solve(self.op, self.rhs, max_iters=max_iters,
                        rel_error=rel_error)

    def save_result_to_file(self, filename):
        """Write the solution (full row count) in the binary format."""
        if self.result is None:
            raise RuntimeError("solve first")
        lio.write_matrix(filename, self.x)
        return True

    def measure_gemv(self, repeats=20):
        """Average matvec time: the avg_gemv CSV column. For 'ir' and
        'irfq' that is the inner f32 matvec (nearly all of a solve's
        matvecs: f32 or q16); the accurate one (df64 or fq) is kept as
        avg_gemv_acc_s. On CUDA it is timed with CUDA events over
        `repeats` chained matvecs."""
        dt = self._time_matvec(self.op, repeats)
        if self.precision in _BASE:
            self.timings["avg_gemv_acc_s"] = dt
            dt = self._time_matvec(self.op.as_f32(), repeats)
        self.timings["avg_gemv_s"] = dt
        return dt

    def _time_matvec(self, op, repeats):
        p = op.prepare_b(self.rhs)
        op.matvec_chain(p, repeats)  # warm
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            op.matvec_chain(p, repeats)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / repeats
        t0 = time.perf_counter()
        op.matvec_chain(p, repeats)
        return (time.perf_counter() - t0) / repeats

    @property
    def x(self):
        if self.result is None:
            return None
        return np.asarray(self.result.x.detach().cpu())
