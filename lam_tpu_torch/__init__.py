"""LAM-TPU on PyTorch and CUDA: dense SPD solves by conjugate gradients
on NVIDIA H100s.

The port of the JAX package `lam_tpu`, which stays in the repository as
its reference. This package imports torch and numpy, never jax and never
a lam_tpu module. Its paths are lam_tpu's: a symmetric system stored as
packed lower-triangle tiles, solved by df64 CG or by f32 CG with
iterative refinement ('ir'), or stored with a quantized lo plane ('dfq')
and solved by dfq CG or by refinement on its f32 hi plane ('irq'), or
stored as the fully-quantized fq cascade and solved by fq CG or by
refinement whose inner loop reads only the 2-byte first plane ('irfq');
or any square system stored as the full square (engine='pallas') and
solved by f32, df64 or ir CG. The 1-D sharded backends
(lam_tpu_torch.parallel) split a system over the ranks of a
torch.distributed process group: row shards with a gathered or ringed
operand, or band pairs of the lower triangle. The matvecs are
hand-written CUDA kernels for sm_90a (lam_tpu_torch/csrc, built at first
use). The heat-equation demo (lam_tpu_torch.apps: Jacobi sweeps, and CG
on the 5-point Laplacian, whose 'ir' inner matvec is the hand-written
stencil kernel) and its BMP converter run on the same engine.
"""

from lam_tpu_torch.solver.api import ConjugateGradient
from lam_tpu_torch.solver.cg import CGResult, cg_solve, cg_solve_ir
from lam_tpu_torch.solver.operators import DenseOperator, LinearOperator

__all__ = [
    "CGResult",
    "cg_solve",
    "cg_solve_ir",
    "DenseOperator",
    "LinearOperator",
    "ConjugateGradient",
]

__version__ = "0.1.0"
