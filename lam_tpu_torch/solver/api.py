"""The solver facade of lam_tpu/solver/api.py, main-path subset.

File mode: an SPD system read from the binary format (or .npy) and
solved by CG in one of seven precisions:

    'df64' f64-parity CG on the (hi, lo) pair (the default)
    'ir'   f32 inner CG on the hi plane, refined with the df64 matvec
    'f32'  f32 CG on an f32 plane
    'dfq'  CG on the quantized-lo storage (f32 hi + int16 lo, f64
           vectors)
    'irq'  f32 inner CG on the dfq storage's hi plane, refined with the
           dfq matvec
    'fq'   CG on the fully-quantized three-plane storage (f64 vectors)
    'irfq' f32 inner CG on the 2-byte q1 plane of the fq storage,
           refined with the fq matvec

engine='auto' (and 'pallas_symm_packed') stores the packed lower
triangle, trusting the file's symmetry (CG's contract); engine='pallas'
reads the whole matrix and stores the full square (f32, df64 and ir
only), for a matrix that is not symmetric. pack_cache=True reads the
packed planes from `<file>.<storage>pack` when that cache is usable and
publishes a fresh pack there otherwise; the full-square engine ignores
it with a notice.

backend='local' solves on one device. backend='sharded' splits the
system over the ranks of a torch.distributed process group, one rank per
device (lam_tpu_torch/parallel; routed as lam_tpu/solver/api.py:154-189):
engine 'auto' or 'pallas' with f32/df64/ir gives the row-sharded
operator (comm 'gather' or 'ring'); 'pallas_symm' (slab) and
'pallas_symm_packed' with df64/ir give the band-pair operator. Every
rank calls the same methods in the same order: loads, solves and
measurements are collective.

Every other backend, precision or mode of the JAX facade raises
NotImplementedError. The device is explicit; asking for CUDA where
there is none raises.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from lam_tpu_torch import io as lio
from lam_tpu_torch.solver.cg import cg_solve, cg_solve_ir, default_inner_floor
from lam_tpu_torch.solver.operators import (DENSE_ENGINE, ENGINES,
                                            QUANT_LAYOUT, DenseOperator,
                                            check_engine, resolve_device)

PRECISIONS = ("df64", "ir", "f32", "dfq", "irq", "fq", "irfq")
# refinement mode -> its storage
_BASE = {"ir": "df64", "irq": "dfq", "irfq": "fq"}


SYMM_ENGINES = ("pallas_symm", "pallas_symm_packed")


def _check_sharded(precision, engine):
    """Raise for a sharded configuration the port does not take, with
    lam_tpu's messages (lam_tpu/solver/api.py:157-178)."""
    base = _BASE.get(precision, precision)
    if base in QUANT_LAYOUT:
        raise NotImplementedError(
            f"precision={precision!r} with backend='sharded' is not ported "
            "yet: the dfq/fq band-pair kernels (10, 16, 17 of ROADMAP "
            "Queue 2) are still to port")
    if engine == "xla":
        raise NotImplementedError(f"engine={engine!r} is not ported yet")
    if engine not in ENGINES + ("pallas_symm",):
        raise ValueError(f"unknown engine {engine!r}")
    if engine in SYMM_ENGINES and base != "df64":
        raise ValueError(
            f"--backend sharded --engine {engine} supports precision "
            "df64/ir/dfq/irq/fq/irfq (the df64 pair or a quantized form is "
            "the storage layout)")


class ConjugateGradient:
    def __init__(self, backend="local", precision="df64", engine="auto",
                 device="cuda", pack_cache=False, comm="gather",
                 n_devices=None, mesh=None):
        if precision not in PRECISIONS:
            raise NotImplementedError(f"precision={precision!r} is not "
                                      f"ported yet (one of {PRECISIONS})")
        if backend == "sharded":
            _check_sharded(precision, engine)
            if comm not in ("gather", "ring"):
                raise ValueError(f"unknown comm strategy {comm!r}")
            if mesh is None:
                from lam_tpu_torch.parallel.mesh import make_mesh
                mesh = make_mesh(n_devices, device=device)
            self.device = mesh.device
        elif backend == "local":
            check_engine(engine)
            if (engine == DENSE_ENGINE
                    and _BASE.get(precision, precision) in QUANT_LAYOUT):
                raise ValueError(
                    f"precision={precision!r} implies packed storage; use "
                    "engine='pallas_symm_packed' (or 'auto')")
            self.device = resolve_device(device)
        else:
            raise NotImplementedError(f"backend={backend!r} is not ported "
                                      "yet ('local' or 'sharded')")
        self.backend = backend
        self.precision = precision
        self.engine = engine
        self.comm = comm
        self.mesh = mesh
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
        if self.backend == "sharded":
            self.op = self._sharded_operator(filename, storage)
        elif self.engine == DENSE_ENGINE:
            # the full square, as lam_tpu's file-mode fallback builds it
            if self.pack_cache:
                print("lam-cg: --pack-cache only accelerates the packed "
                      "engine's f32/df64/ir/dfq/irq/fq/irfq file loads; "
                      "ignored for --engine pallas", file=sys.stderr)
            self.op = DenseOperator.from_dense(
                lio.read_matrix(filename), precision=storage,
                engine=DENSE_ENGINE, device=self.device)
        else:
            ctor = getattr(DenseOperator, f"from_file_{storage}")
            self.op = ctor(filename, pack_cache=self.pack_cache,
                           device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["load_s"] = time.perf_counter() - t0
        return True

    def _sharded_operator(self, filename, storage):
        """This rank's part of the sharded operator, read from the file
        (each rank reads only its own rows)."""
        if self.pack_cache:
            print("lam-cg: --pack-cache only accelerates "
                  "backend=local f32/df64/ir/dfq/irq/fq/irfq and "
                  "sharded/sharded2d dfq/irq/fq/irfq file loads; "
                  "ignored for this backend/precision", file=sys.stderr)
        if self.engine in SYMM_ENGINES:
            from lam_tpu_torch.parallel.pcg_symm import SymmShardedOperator
            return SymmShardedOperator.from_file(
                filename, mesh=self.mesh,
                packed=self.engine == "pallas_symm_packed")
        from lam_tpu_torch.parallel.pcg import ShardedDenseOperator
        return ShardedDenseOperator.from_file(
            filename, mesh=self.mesh, precision=storage, engine=self.engine,
            comm=self.comm)

    def used_devices(self):
        """Devices the backend uses: the CSV procs column (the mesh's
        ranks for 'sharded', 1 for 'local')."""
        return self.mesh.size if self.backend == "sharded" else 1

    @property
    def rank(self):
        """This process's rank: in the mesh, else in the process group
        when there is one (each rank of a 'local' multi-process run
        solves alone), else 0."""
        if self.mesh is not None:
            return self.mesh.rank
        return dist.get_rank() if dist.is_initialized() else 0

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
        iterations, frozen after the first, and for 'ir'/'irq'/'irfq' one
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
        """Write the solution (full row count) in the binary format; with
        several ranks only rank 0 writes, as lam_tpu's process 0 does."""
        if self.result is None:
            raise RuntimeError("solve first")
        if self.rank == 0:
            lio.write_matrix(filename, self.x)
        return True

    def measure_gemv(self, repeats=20):
        """Average matvec time: the avg_gemv CSV column. For 'ir', 'irq'
        and 'irfq' that is the inner f32 matvec (nearly all of a solve's
        matvecs: f32 or q16); the accurate one (df64, dfq or fq) is kept
        as avg_gemv_acc_s. On CUDA it is timed with CUDA events over
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
