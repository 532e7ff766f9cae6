"""sinks_encode_s: the mean over the window's flushes of the metric
sinks' `encode_s` (the Datadog sink's columnar encode) in
Server.last_flush_timings' `sink:<name>` records, summed over the
sinks; None where no sink reports it."""

from portbench import sinkparts


def read(run):
    return sinkparts.per_flush(run, "encode_s")
