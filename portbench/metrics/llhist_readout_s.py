"""llhist_readout_s: the mean over the window's flushes of the llhist
family's readout in Server.last_flush_timings: its dispatch seconds
(`families.llhist.dispatch_s`), its compaction and copy
(`llhist_bins_s`) and its assembly (`llhist_assembly_s`); None where
the program does not time the assembly."""


def read(run):
    ts = run["flush_timings"]
    if not ts or any("llhist_assembly_s" not in t for t in ts):
        return None
    return sum(t.get("families", {}).get("llhist", {}).get("dispatch_s", 0.0)
               + t.get("llhist_bins_s", 0.0) + t["llhist_assembly_s"]
               for t in ts) / len(ts)
