"""k1_roofline_pct: the least time of every K1 launch in the traced
window (its shapes' bytes and operations at the card's peaks) over the
device time of `tdigest_flush_kernel` in the trace, in percent."""

from portbench import roofline


def read(run):
    return roofline.roofline_pct(run, "k1", "tdigest_flush_kernel")
