"""k3_roofline_pct: the least time of every K3 launch in the traced
window (its samples' and distinct registers' bytes at the card's memory
rate) over the device time of `llhist_apply_kernel` in the trace, in
percent."""

from portbench import roofline_llhist


def read(run):
    return roofline_llhist.k3_roofline_pct(run)
