"""Tools of the port beside the solver: the q16 probe tool (q16_probe)."""
