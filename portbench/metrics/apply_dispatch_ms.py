"""apply_dispatch_ms: the device observatory's host dispatch seconds of
the apply kind, summed over the families, in milliseconds per million
samples taken in the window."""


def read(run):
    if not run.get("samples_in_window"):
        return None
    return run["apply_dispatch_s"] * 1e3 / (run["samples_in_window"] / 1e6)
