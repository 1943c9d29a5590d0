"""LAM-TPU on PyTorch and CUDA: dense SPD solves by conjugate gradients
on NVIDIA H100s.

The port of the JAX package `lam_tpu`, which stays in the repository as
its reference. This package imports torch and numpy, never jax and never
a lam_tpu module. Its paths are lam_tpu's: a symmetric system stored as
packed lower-triangle tiles, solved by df64 CG or by f32 CG with
iterative refinement ('ir'), or stored with a quantized lo plane ('dfq')
and solved by dfq CG or by refinement on its f32 hi plane ('irq'), or
stored as the fully-quantized fq cascade and solved by fq CG or by
refinement whose inner loop reads only the 2-byte first plane ('irfq',
its outer residuals on the card or, with outer='host', exact on the
host against the f64 source while the card holds only that plane:
`cg_solve_ir_host`);
or any square system stored as the full square (engine='pallas') and
solved by f32, df64 or ir CG, or a symmetric one stored as the full
square and read by its lower triangle (engine='pallas_symm'). Generate
mode builds the reference's benchmark system, the dense tridiagonal
against ones, on the device (`ConjugateGradient.generate_matrix`, the
CLI's -s). The sharded backends
(lam_tpu_torch.parallel) split a system over the ranks of a
torch.distributed process group: row shards with a gathered or ringed
operand, band pairs of the lower triangle (df64, dfq or fq storage),
dense blocks over an R x R grid, or the symmetric R x R grid that stores
each element once (df64, dfq or fq storage). Every backend takes Jacobi
preconditioning (`preconditioner="jacobi"`) and checkpointed, resumable
solves (`lam_tpu_torch.solver.checkpoint`, whose files lam_tpu reads and
writes too); lam_tpu's oracle engine 'xla' (plain torch products, what
precision 'f64' runs) and block CG over several right-hand sides
(`cg_solve_block`) run on one device, the row shards and the dense grid.
The other matvecs are hand-written CUDA kernels for sm_90a
(lam_tpu_torch/csrc, built at first use). The heat-equation demo (lam_tpu_torch.apps: Jacobi sweeps, and CG
on the 5-point Laplacian, whose 'ir' inner matvec is the hand-written
stencil kernel, on one device or row-sharded over ranks) and its BMP
converter run on the same engine. Beside them: the numpy f64 CG oracle
(`lam_tpu_torch.solver.oracle_cg`), the random SPD system generator
(`lam_tpu_torch.tools.spd_gen`, `lam-spd-gen-torch`) and the multi-rank
dry run of every sharded backend against that oracle
(`lam_tpu_torch.dryrun`).
"""

from lam_tpu_torch.solver import checkpoint
from lam_tpu_torch.solver.api import ConjugateGradient
from lam_tpu_torch.solver.cg import (CGResult, cg_solve, cg_solve_block,
                                     cg_solve_ir)
from lam_tpu_torch.solver.host_outer import cg_solve_ir_host
from lam_tpu_torch.solver.operators import DenseOperator, LinearOperator

__all__ = [
    "CGResult",
    "cg_solve",
    "cg_solve_block",
    "cg_solve_ir",
    "cg_solve_ir_host",
    "DenseOperator",
    "LinearOperator",
    "ConjugateGradient",
    "checkpoint",
]

__version__ = "0.1.0"
