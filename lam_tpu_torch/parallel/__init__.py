"""The 1-D sharded backends on torch.distributed: the process-group mesh
(`mesh`), the row-sharded gather and ring operator (`pcg`) and the
band-pair symmetric operator (`pcg_symm`)."""
