"""flush_sinks_s: the mean over the window's flushes of `sinks_s` in
Server.last_flush_timings, the sink threads' dispatch to their join."""


def read(run):
    ts = run["flush_timings"]
    if not ts:
        return None
    return sum(t.get("sinks_s", 0.0) for t in ts) / len(ts)
