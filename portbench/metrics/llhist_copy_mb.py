"""llhist_copy_mb: the mean over the window's flushes of the llhist
family's device-to-host bytes (`llhist_copy_bytes` in
Server.last_flush_timings), in MB; None where the program does not
count them."""


def read(run):
    ts = run["flush_timings"]
    if not ts or any("llhist_copy_bytes" not in t for t in ts):
        return None
    return sum(t["llhist_copy_bytes"] for t in ts) / len(ts) / 1e6
