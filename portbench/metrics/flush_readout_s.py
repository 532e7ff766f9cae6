"""flush_readout_s: the mean over the window's flushes of the readout in
Server.last_flush_timings: dispatch_s + device_sync_s + assembly_s."""


def read(run):
    ts = run["flush_timings"]
    if not ts:
        return None
    return sum(t.get("dispatch_s", 0.0) + t.get("device_sync_s", 0.0)
               + t.get("assembly_s", 0.0) for t in ts) / len(ts)
