"""samples_per_s: samples taken into the tables by batches that finished
inside the window, over the window's seconds (its flushes included)."""


def read(run):
    if "samples_in_window" not in run:
        return None
    return run["samples_in_window"] / run["window_s"]
