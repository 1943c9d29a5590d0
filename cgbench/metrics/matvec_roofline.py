"""matvec_roofline: the least time of the matvec the CG loop iterates on,
worked out from n and the traffic's "matvec" (reference/roofline.py), as a
percentage of its time by the solver's measure_gemv (CUDA events over
chained matvecs)."""

from cgbench.reference import roofline


def read(run):
    if not run.on_card or not run.gemv_s:
        return None
    bound = roofline.matvec_bound_s(int(run.config["n"]),
                                    run.traffic["matvec"])
    return 100.0 * bound / run.gemv_s
