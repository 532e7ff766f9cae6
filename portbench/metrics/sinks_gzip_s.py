"""sinks_gzip_s: the mean over the window's flushes of the metric
sinks' `gzip_s` (the gzip of every series body, a part of `send_s`) in
Server.last_flush_timings' `sink:<name>` records, summed over the
sinks; None where no sink reports it, as a program without the split
does not."""

from portbench import sinkparts


def read(run):
    return sinkparts.per_flush(run, "gzip_s")
