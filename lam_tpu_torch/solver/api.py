"""The solver facade of lam_tpu/solver/api.py, main-path subset.

File mode: an SPD system read from the binary format (or .npy) and
solved by CG in one of eight precisions, or 'auto' (the default: df64 on
a card, f64 on the CPU, lam_tpu's rule with the card in the TPU's place):

    'df64' f64-parity CG on the (hi, lo) pair
    'f64'  CG on the f64 square with plain torch products (engine 'xla',
           which 'f64' forces: the oracle path, no kernel)
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
only), for a matrix that is not symmetric; engine='pallas_symm' stores
the full square of a symmetric matrix (checked) and reads only its
lower-triangle tiles; engine='xla' stores the unpadded square (f64, f32,
df64 and ir) and multiplies by plain torch products, as lam_tpu's oracle
engine does. engine='auto' keeps the kernel engines on the CPU too (their
plain versions): lam_tpu picks 'xla' off a TPU. pack_cache=True reads the packed planes from
`<file>.<storage>pack` when that cache is usable and publishes a fresh
pack there otherwise; the full-square engines ignore it with a notice.

Generate mode (`generate_matrix`, `generate_rhs`; lam_tpu/solver/api.py:
286-425): the dense tridiagonal (2 on the diagonal, 1 beside it) and a
right-hand side of ones, built on the facade's device, CPU included, as
lam_tpu builds it on its device: the packed f32 plane for 'f32'; the
packed hi plane and ONE broadcast (tb, tb) zero lo tile for 'df64'/'ir'
(engine 'auto' or 'pallas_symm_packed': a quarter of the full-square
pair's memory); the full hi square and a zero lo square for 'df64'/'ir'
with engine 'pallas_symm' or 'pallas'; the packed int16 q1 plane and one
zero tile each for q2 and q3 for 'fq'/'irfq' (2 B per element). 'dfq'/
'irq', and 'f32' with a full-square engine, build the matrix on the host
(`from_dense`), as lam_tpu does.

backend='local' solves on one device. backend='sharded' splits the
system over the ranks of a torch.distributed process group, one rank per
device (lam_tpu_torch/parallel; routed as lam_tpu/solver/api.py:117-189):
engine 'auto' or 'pallas' with f32/df64/ir, or 'xla' with f64/f32/df64/
ir, gives the row-sharded operator (comm 'gather' or 'ring'); 'pallas_symm' (slab) and
'pallas_symm_packed' with df64/ir give the band-pair operator, and
dfq/irq/fq/irfq its quantized packed storages ('auto' routes them there;
pack_cache=True keeps one `<file>.shardpack/<storage>.g<g>.s<rank>` per
rank). backend='sharded2d' splits it over an R x R grid of the first R^2
ranks (routed as lam_tpu/solver/api.py:117-153): engine 'auto' or 'pallas'
with f32/df64/ir gives the dense grid (a block and the dense kernels on
every rank), 'xla' with f64/f32/df64/ir the same grid with plain torch
products; 'pallas_symm' and 'pallas_symm_packed' with df64/ir, and
dfq/irq/fq/irfq (which 'auto' routes there), the symmetric grid, which
stores each element once (lam_tpu_torch/parallel/pcg2d_symm.py;
pack_cache=True keeps one `<file>.shardpack/<storage>.r<R>.s<rank>` per
rank of a quantized storage).
Every rank calls the same methods in the same order: loads, solves and
measurements are collective. backend='auto' (the default) is 'sharded'
when the run has more than one rank (a process group larger than one,
or n_devices > 1), else 'local': lam_tpu's "more than one device
visible" for a port whose ranks are processes.

Generate mode on the meshes builds each rank's part on its device, routed
as lam_tpu's `_generate_fast` (lam_tpu/solver/api.py:351-399): 'fq'/'irfq'
on the band pairs (engine 'auto' or 'pallas_symm_packed') or the symmetric
grid (any symmetric engine, or 'auto') as the q1 plane with zero q2/q3
tiles; 'df64'/'ir' as the row shards (engine 'auto'/'pallas'), the band
pairs' slab ('pallas_symm') or packed hi plane with one zero lo tile
('pallas_symm_packed'), the dense grid's blocks, or the symmetric grid's
triangle and half-slabs with one zero lo tile. 'dfq'/'irq', and 'f32' on
any mesh, take the host build through the file path's constructors over
`tridiagonal_rows`, as lam_tpu's fallback does (:297-300).

outer='host' (lam_tpu/solver/api.py:37-54; precision 'irfq', backend
'local', file mode only) uploads only the q1 plane, its scales and the
diagonal pair (`DenseOperator.from_file_fq_q1`) and keeps the f64 source
memory-mapped on the host, which computes each outer residual exactly
(solver/host_outer.py); `avg_gemv_s` is then the inner q1 matvec.
Generate mode refuses it at once, before anything is built.

`solve(preconditioner="jacobi")` runs Jacobi-preconditioned CG on every
backend (the operator's `diagonal()`, split like its vectors); with
'ir'/'irq'/'irfq' it scales the inner f32 loop and leaves the outer
refinement recurrence as it is. outer='host' does not compose with it
(lam_tpu's ValueError). `check_symmetric=True` checks A v == A^T v over
the file's memory map before anything is built (lam_tpu's up-front check
and words). `solve(warmup=False)` times the first solve with the kernel
build and first launches in it, and records no init_s.

A system held in memory is built by `_build_operator(row_block_fn, n,
full_matrix=None)` (lam_tpu's name and signature, which its bench runner
calls): on 'local' the whole matrix, on the meshes each rank's own part
read through row_block_fn; the generate path of the meshes builds through
it too. A file on the meshes is read by the operator's own `from_file`, each
rank reading only its part; both choose the class in `_mesh_operator_type`.

Checkpointed solves (lam_tpu_torch/solver/checkpoint.py) run on the
facade's operator: the CLI's --checkpoint drives them and stores their
result through `record_result`. The device is explicit; asking for CUDA
where there is none raises.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from lam_tpu_torch import generate as gen
from lam_tpu_torch import io as lio
from lam_tpu_torch.ops import layout
from lam_tpu_torch.solver.cg import cg_solve, cg_solve_ir, default_inner_floor
from lam_tpu_torch.solver.host_outer import cg_solve_ir_host
from lam_tpu_torch.solver.operators import (DENSE_ENGINE, ENGINE, ENGINES,
                                            QUANT_LAYOUT, SQUARE_ENGINE,
                                            XLA_ENGINE, DenseOperator,
                                            _verifies_symmetric,
                                            auto_precision, check_engine,
                                            resolve_device)

PRECISIONS = ("df64", "ir", "f32", "dfq", "irq", "fq", "irfq", "f64",
              "auto")
# refinement mode -> its storage
_BASE = {"ir": "df64", "irq": "dfq", "irfq": "fq"}


SYMM_ENGINES = ("pallas_symm", "pallas_symm_packed")


def _check_sharded(precision, engine):
    """The engine a 1-D sharded configuration runs; raises for one the
    port does not take, with lam_tpu's messages
    (lam_tpu/solver/api.py:157-178)."""
    base = _BASE.get(precision, precision)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if base in QUANT_LAYOUT and engine == "auto":
        # quantized storage exists only as packed triangle tiles
        engine = "pallas_symm_packed"
    if engine in SYMM_ENGINES:
        if base not in ("df64",) + tuple(QUANT_LAYOUT):
            raise ValueError(
                f"--backend sharded --engine {engine} supports precision "
                "df64/ir/dfq/irq/fq/irfq (the df64 pair or a quantized "
                "form is the storage layout)")
        if base in QUANT_LAYOUT and engine != "pallas_symm_packed":
            raise ValueError(
                "precision='dfq'/'irq'/'fq'/'irfq' implies packed storage; "
                "use engine='pallas_symm_packed' (or 'auto')")
    return engine


def _check_sharded2d(precision, engine):
    """The engine a 2-D grid configuration runs (a symmetric engine: the
    symmetric grid; else the dense grid); raises for one the port does
    not take, with lam_tpu's messages (lam_tpu/solver/api.py:117-153)."""
    base = _BASE.get(precision, precision)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if base in QUANT_LAYOUT and engine == "auto":
        # quantized storage exists only on the symmetric grid
        engine = "pallas_symm_packed"
    if engine in SYMM_ENGINES:
        if base not in ("df64",) + tuple(QUANT_LAYOUT):
            raise ValueError(
                f"--backend sharded2d --engine {engine} supports precision "
                "df64/ir/dfq/irq/fq/irfq (the df64 pair or a quantized "
                "form is the storage layout)")
        return engine
    if base in QUANT_LAYOUT:
        raise ValueError(
            f"--backend sharded2d --engine {engine} supports precision "
            "f64/f32/df64/ir; the quantized storages (dfq/irq/fq/irfq) "
            "exist only on the symmetric grid (engine pallas_symm_packed "
            "or auto)")
    return engine


def auto_backend(n_devices=None):
    """backend='auto' (lam_tpu/solver/api.py:38-40): 'sharded' when the
    run has more than one rank, n_devices or else the process group's
    size, else 'local'."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    return "sharded" if n > 1 else "local"


class ConjugateGradient:
    def __init__(self, backend="auto", precision="auto", engine="auto",
                 device="cuda", pack_cache=False, comm="gather",
                 n_devices=None, mesh=None, outer="device",
                 check_symmetric=False):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r} (one of "
                             f"{PRECISIONS})")
        if precision == "auto":
            precision = auto_precision(device)
        if backend == "auto":
            backend = auto_backend(n_devices)
        if outer not in ("device", "host"):
            raise ValueError(f"outer must be 'device' or 'host', "
                             f"got {outer!r}")
        if outer == "host" and (precision != "irfq" or backend != "local"):
            # lam_tpu's check and words (lam_tpu/solver/api.py:41-52)
            raise ValueError(
                "outer='host' requires precision='irfq' and "
                "backend='local' (file mode): the host computes "
                "r = b - A x against the f64 source file while the "
                "device holds only the q1 inner plane")
        self.outer = outer
        self._host_a = None
        self._sharded_engine = None
        if backend == "sharded":
            self._sharded_engine = _check_sharded(precision, engine)
            if comm not in ("gather", "ring"):
                raise ValueError(f"unknown comm strategy {comm!r}")
            if mesh is None:
                from lam_tpu_torch.parallel.mesh import make_mesh
                mesh = make_mesh(n_devices, device=device)
            self.device = mesh.device
        elif backend == "sharded2d":
            self._sharded_engine = _check_sharded2d(precision, engine)
            if mesh is None:
                import math

                from lam_tpu_torch.parallel.mesh import make_mesh2d
                mesh = make_mesh2d(
                    None if n_devices is None else math.isqrt(n_devices),
                    device=device)
            self.device = mesh.device
        elif backend == "local":
            check_engine(engine)
            if (engine in (DENSE_ENGINE, SQUARE_ENGINE, XLA_ENGINE)
                    and _BASE.get(precision, precision) in QUANT_LAYOUT):
                raise ValueError(
                    f"precision={precision!r} implies packed storage; use "
                    "engine='pallas_symm_packed' (or 'auto')")
            self.device = resolve_device(device)
        else:
            raise ValueError(f"unknown backend {backend!r} ('local', "
                             "'sharded', 'sharded2d' or 'auto')")
        self.backend = backend
        self.precision = precision
        self.engine = engine
        self.comm = comm
        self.mesh = mesh
        self.pack_cache = pack_cache
        self.check_symmetric = check_symmetric
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
        if self.check_symmetric:
            # one check up front covers every path below
            a_map = lio.open_matrix_memmap(filename)
            if not _verifies_symmetric(a_map):
                raise ValueError(
                    f"{filename}: matrix is not symmetric (A v != A^T v "
                    "on a random vector) — the lower-triangle engines "
                    "would silently solve with its mirrored lower half; "
                    "use --engine pallas/xla with a full-square "
                    "precision (f64/f32/df64) for non-symmetric input")
            del a_map
        storage = _BASE.get(self.precision, self.precision)
        if self.backend in ("sharded", "sharded2d"):
            if self.pack_cache and storage not in QUANT_LAYOUT:
                print("lam-cg: --pack-cache only accelerates "
                      "backend=local f32/df64/ir/dfq/irq/fq/irfq and "
                      "sharded/sharded2d dfq/irq/fq/irfq file loads; "
                      "ignored for this backend/precision", file=sys.stderr)
            cls, kw = self._mesh_operator_type(
                str(filename) if self.pack_cache else None)
            self.op = cls.from_file(filename, mesh=self.mesh, **kw)
        elif (self.engine in (DENSE_ENGINE, SQUARE_ENGINE, XLA_ENGINE)
              or storage == "f64"):
            # the full square, as lam_tpu's file-mode fallback builds it
            if self.pack_cache:
                what = ("--precision f64" if storage == "f64"
                        else f"--engine {self.engine}")
                print("lam-cg: --pack-cache only accelerates the packed "
                      "engine's f32/df64/ir/dfq/irq/fq/irfq file loads; "
                      f"ignored for {what}", file=sys.stderr)
            self.op = DenseOperator.from_dense(
                lio.read_matrix(filename), precision=storage,
                engine=self.engine, device=self.device)
        elif self.outer == "host":
            # the q1 plane, its scales and the diagonal pair on the
            # device; the f64 source stays mapped for the outer residuals
            self.op = DenseOperator.from_file_fq_q1(
                filename, pack_cache=self.pack_cache, device=self.device)
            self._host_a = lio.open_matrix_memmap(filename)
        else:
            ctor = getattr(DenseOperator, f"from_file_{storage}")
            self.op = ctor(filename, pack_cache=self.pack_cache,
                           device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["load_s"] = time.perf_counter() - t0
        return True

    def _build_operator(self, row_block_fn, n, full_matrix=None,
                        block_fn=None, pack_cache_src=None):
        """The operator of an n x n system held as row_block_fn(r0, rows)
        -> its f64 rows: lam_tpu's `_build_operator` (lam_tpu/solver/
        api.py:112-194), which an in-memory system is built through. On
        'local' DenseOperator.from_dense of the whole matrix (full_matrix
        where given, else all its rows). On 'sharded' and 'sharded2d' this
        rank's part, reading only its own rows or block (block_fn(r0, c0,
        h, w) -> an f64 block, cut from row_block_fn where not given).
        pack_cache_src names the source file of a quantized storage's
        shard cache (the other storages ignore it)."""
        storage = _BASE.get(self.precision, self.precision)
        if self.backend == "local":
            a = (full_matrix if full_matrix is not None
                 else row_block_fn(0, n))
            return DenseOperator.from_dense(a, precision=storage,
                                            engine=self.engine,
                                            device=self.device)
        cls, kw = self._mesh_operator_type(pack_cache_src)
        if self.backend == "sharded2d":
            if block_fn is None:
                def block_fn(r0, c0, h, w):
                    return row_block_fn(r0, h)[:, c0:c0 + w]
            return cls.from_block_fn(block_fn, n, mesh=self.mesh, **kw)
        return cls.from_row_block_fn(row_block_fn, n, mesh=self.mesh, **kw)

    def _mesh_operator_type(self, pack_cache_src):
        """(the operator class, its keyword arguments) of this rank's part
        on 'sharded' and 'sharded2d', whichever constructor builds it
        (`_build_operator`'s row or block reads, `from_file`)."""
        storage = _BASE.get(self.precision, self.precision)
        engine = self._sharded_engine
        if self.backend == "sharded2d":
            if engine in SYMM_ENGINES:
                from lam_tpu_torch.parallel.pcg2d_symm import Symm2DOperator
                return Symm2DOperator, {"precision": storage,
                                        "pack_cache_src": pack_cache_src}
            from lam_tpu_torch.parallel.pcg2d import Sharded2DOperator
            return Sharded2DOperator, {"precision": storage,
                                       "engine": self.engine}
        if engine in SYMM_ENGINES:
            from lam_tpu_torch.parallel.pcg_symm import SymmShardedOperator
            return SymmShardedOperator, {
                "packed": engine == "pallas_symm_packed",
                "precision": storage if storage in QUANT_LAYOUT else "df64",
                "pack_cache_src": pack_cache_src}
        from lam_tpu_torch.parallel.pcg import ShardedDenseOperator
        return ShardedDenseOperator, {"precision": storage, "engine": engine,
                                      "comm": self.comm}

    def generate_matrix(self, rows, cols=None):
        """Generate mode's dense tridiagonal, built on the device (see the
        module docstring); times the build as load_s."""
        if cols is not None and cols != rows:
            raise ValueError("generated matrix must be square")
        if self.outer == "host":
            # lam_tpu raises this only at the solve, after generating
            # (lam_tpu/solver/api.py:494-498)
            raise ValueError(
                "outer='host' solves against the f64 source file: call "
                "load_matrix_from_file first (generate mode has no file "
                "to stream the outer residuals from)")
        if self.pack_cache:
            # generate mode has no source file to key a cache on
            print("lam-cg: --pack-cache only accelerates file-mode "
                  "loads; ignored in generate mode", file=sys.stderr)
        t0 = time.perf_counter()
        self.n = rows
        if self.backend == "local":
            self.op = self._generate_operator(rows)
        else:
            self.op = self._generate_mesh_operator(rows)
            if self.op is None:  # lam_tpu's host build (api.py:297-300)
                self.op = self._build_operator(
                    lambda s, m: gen.tridiagonal_rows(s, m, rows), rows)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["load_s"] = time.perf_counter() - t0
        return True

    def _packed_gen_plane(self, rows, impl, padded=False):
        """One packed triangle plane of the tridiagonal built on the
        device by `impl` (generate._tridiag_{hi,q1}_packed_impl): (plane,
        n_p). padded=True walks the Q16_P-padded tables of the fq layout
        (nblk >= 2), whose inert pad entries leave the pad tiles zero."""
        tb = layout.SYMM_TB
        n_p = layout.padded_size(rows, tb)
        nblk = n_p // tb
        tables = (layout._symm_tables_padded if padded and nblk >= 2
                  else layout._symm_tables)
        it, kt = (torch.as_tensor(x, dtype=torch.long, device=self.device)
                  for x in tables(nblk))
        return impl(rows, tb, it, kt, nblk), n_p

    def _generate_operator(self, rows):
        """The operator of lam_tpu's `_generate_fast` local branches
        (lam_tpu/solver/api.py:339-418), or its host build."""
        storage = _BASE.get(self.precision, self.precision)
        packed = self.engine in ("auto", ENGINE)
        dev = self.device
        if storage == "fq" and packed:
            q1, n_p = self._packed_gen_plane(
                rows, gen._tridiag_q1_packed_impl, padded=True)
            return DenseOperator.from_gen_fq(q1, rows, n_p, device=dev)
        if storage == "f32" and packed:
            hi, n_p = self._packed_gen_plane(rows,
                                             gen._tridiag_hi_packed_impl)
            return DenseOperator.from_packed_f32(hi, rows, n_p, device=dev)
        if storage == "df64" and packed:
            hi, n_p = self._packed_gen_plane(rows,
                                             gen._tridiag_hi_packed_impl)
            tb = layout.SYMM_TB
            lo = torch.zeros((tb, tb), dtype=torch.float32, device=dev)
            return DenseOperator.from_packed_planes(hi, lo, rows, n_p,
                                                    device=dev)
        if storage == "df64":
            n_p = layout.padded_size(rows)
            hi = gen.tridiagonal_hi_plane_device(rows, n_p, device=dev)
            lo = torch.zeros_like(hi)  # exact: the entries are f32
            return DenseOperator.from_df64_planes(hi, lo, rows,
                                                  engine=self.engine,
                                                  device=dev)
        # dfq/irq, and f32 on a full-square engine: the host build
        return DenseOperator.from_dense(gen.tridiagonal_matrix(rows),
                                        precision=storage,
                                        engine=self.engine, device=dev)

    def _generate_mesh_operator(self, rows):
        """This rank's part of the operator of lam_tpu's `_generate_fast`
        mesh branches (lam_tpu/solver/api.py:351-399), built on its device,
        or None where lam_tpu takes the host build: 'dfq'/'irq', 'f32',
        and 'fq'/'irfq' on another engine."""
        storage = _BASE.get(self.precision, self.precision)
        mesh, engine = self.mesh, self.engine
        grid = self.backend == "sharded2d"
        if storage == "fq":
            if grid and engine in ("auto",) + SYMM_ENGINES:
                from lam_tpu_torch.parallel.pcg2d_symm import Symm2DOperator
                return Symm2DOperator.from_gen_fq(rows, mesh=mesh)
            if not grid and engine in ("auto", "pallas_symm_packed"):
                from lam_tpu_torch.parallel.pcg_symm import SymmShardedOperator
                return SymmShardedOperator.from_gen_fq(rows, mesh=mesh)
            return None
        if storage != "df64":
            return None
        if grid:
            if engine in SYMM_ENGINES:
                from lam_tpu_torch.parallel.pcg2d_symm import Symm2DOperator
                return Symm2DOperator.from_gen_tridiagonal(rows, mesh=mesh)
            from lam_tpu_torch.parallel.pcg2d import Sharded2DOperator
            return Sharded2DOperator.from_gen_tridiagonal(rows, mesh=mesh,
                                                          engine=engine)
        if engine in SYMM_ENGINES:
            from lam_tpu_torch.parallel.pcg_symm import SymmShardedOperator
            return SymmShardedOperator.from_gen_tridiagonal(
                rows, mesh=mesh, packed=engine == "pallas_symm_packed")
        from lam_tpu_torch.parallel.pcg import ShardedDenseOperator
        return ShardedDenseOperator.from_gen_tridiagonal(
            rows, mesh=mesh, engine=engine, comm=self.comm)

    def generate_rhs(self):
        """Generate mode's right-hand side of ones."""
        if self.n is None:
            raise RuntimeError("generate_matrix first")
        self.rhs = gen.ones_rhs(self.n)
        return True

    def used_devices(self):
        """Devices the backend uses: the CSV procs column (the mesh's
        ranks for 'sharded' and 'sharded2d', 1 for 'local')."""
        return self.mesh.size if self.mesh is not None else 1

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

    def solve(self, max_iters=1000, rel_error=1e-9, warmup=True,
              preconditioner=None):
        """Run CG; returns True iff converged.

        warmup first runs the solve with max_iters=1 (one chunk of CG
        iterations, frozen after the first, and for 'ir'/'irq'/'irfq' one
        refinement cycle), so the kernel build, first launches and the
        allocator's first requests are timed as init_s, not in the
        solve. outer='host' warms up as lam_tpu does, with max_iters=0:
        one inner matvec, no cycle and no host matvec.
        preconditioner="jacobi" runs diagonal-scaled CG (any backend);
        with 'ir'/'irq'/'irfq' it scales the INNER f32 loop."""
        if self.op is None or self.rhs is None:
            raise RuntimeError("load a system first")
        if self.outer == "host" and preconditioner is not None:
            raise ValueError(
                "outer='host' does not compose with a "
                "preconditioner yet; drop one of the two")
        if warmup:
            t_init = time.perf_counter()
            float(self._solve_once(0 if self.outer == "host" else 1,
                                   rel_error, preconditioner).rel_residual)
            self.timings["init_s"] = time.perf_counter() - t_init
        t0 = time.perf_counter()
        result = self._solve_once(max_iters, rel_error, preconditioner)
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

    def _solve_once(self, max_iters, rel_error, preconditioner=None):
        if self.outer == "host":
            return cg_solve_ir_host(
                self._host_a, self.op, self.rhs, max_iters=max_iters,
                rel_error=rel_error, inner_floor=default_inner_floor("irfq"))
        if self.precision in _BASE:
            return cg_solve_ir(self.op.as_f32(), self.op, self.rhs,
                               max_iters=max_iters, rel_error=rel_error,
                               inner_floor=default_inner_floor(
                                   self.precision),
                               preconditioner=preconditioner)
        return cg_solve(self.op, self.rhs, max_iters=max_iters,
                        rel_error=rel_error, preconditioner=preconditioner)

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
        `repeats` chained matvecs. outer='host' times the inner q1 matvec
        alone: the accurate one is the host's."""
        if self.outer == "host":
            dt = self._time_matvec(self.op.as_f32(), repeats)
            self.timings["avg_gemv_s"] = dt
            return dt
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
        x = self.result.x
        if isinstance(x, torch.Tensor):  # host_outer's x is numpy already
            x = x.detach().cpu()
        return np.asarray(x)
