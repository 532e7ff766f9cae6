"""k2_roofline_pct: as k1_roofline_pct, for `hll_estimate_kernel`."""

from portbench import roofline


def read(run):
    return roofline.roofline_pct(run, "k2", "hll_estimate_kernel")
