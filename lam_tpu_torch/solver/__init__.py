"""CG engine, operators and the solver facade: lam_tpu.solver's names at
its path, and the numpy f64 CG oracle."""

from lam_tpu_torch.solver.cg import (
    CGResult,
    cg_solve,
    cg_solve_block,
    cg_solve_ir,
)
from lam_tpu_torch.solver.operators import DenseOperator, LinearOperator
from lam_tpu_torch.solver.api import ConjugateGradient
from lam_tpu_torch.solver.oracle import oracle_cg

__all__ = [
    "CGResult",
    "cg_solve",
    "cg_solve_block",
    "cg_solve_ir",
    "DenseOperator",
    "LinearOperator",
    "ConjugateGradient",
    "oracle_cg",
]
