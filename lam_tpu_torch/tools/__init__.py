"""Tools of the port beside the solver: the q16 probe tool (q16_probe) and
the random SPD system generator (spd_gen, `lam-spd-gen-torch`)."""
