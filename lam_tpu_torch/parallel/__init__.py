"""The sharded backends on torch.distributed: the process-group meshes
(`mesh`: the launch of a multi-process run, the 1-D `Mesh` and the R x R
`Mesh2D`), the row-sharded gather and ring operator (`pcg`), the
band-pair symmetric operator (`pcg_symm`: df64, dfq and fq storages), the
dense 2-D grid operator (`pcg2d`) and the symmetric 2-D grid operator
(`pcg2d_symm`: df64, dfq and fq storages)."""

from lam_tpu_torch.parallel.mesh import make_mesh
from lam_tpu_torch.parallel.pcg import ShardedDenseOperator

__all__ = ["make_mesh", "ShardedDenseOperator"]
