"""CG engine, operators and the solver facade."""

from lam_tpu_torch.solver.oracle import oracle_cg

__all__ = ["oracle_cg"]
