"""Device ops of the port: the column store's batch ops and the three
hand-written CUDA kernels' wrappers.

Besides its module's `launches` count, each kernel wrapper adds one to
the calling thread's launch tally where it launches (`count_launch`).
A caller reads `thread_launches()` before and after a call to learn how
many kernel launches that call made on this thread, whatever other
threads launch meanwhile (the device observatory's kernel registry,
core/deviceobs.py)."""

import threading

_tally = threading.local()


def count_launch() -> None:
    """One kernel launch on the calling thread."""
    _tally.n = getattr(_tally, "n", 0) + 1


def thread_launches() -> int:
    """Kernel launches made on the calling thread so far."""
    return getattr(_tally, "n", 0)
