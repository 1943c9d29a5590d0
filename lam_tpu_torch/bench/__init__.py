"""The port's benchmark tools, lam_tpu/bench/ module for module: the
sweep runner (`runner`, `lam-bench-torch`), the shared on-disk cache of
benchmark SPD systems (`systems`) and the results post-processor
(`clean`, `python -m lam_tpu_torch.bench.clean`)."""
