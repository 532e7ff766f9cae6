"""device_idle_pct.ingest: the share of the traced window in which no
kernel, copy or set ran on the card (the ingest cell's)."""

from portbench import devtrace


def read(run):
    return devtrace.idle_pct(run)
