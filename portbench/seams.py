"""The harness's seams into the program, each undone by the function it
returns: every flush's swap through the interval gate, and the shapes of
every call into K1 and K2 (the roofline's least time is worked out from
them)."""

from __future__ import annotations

import time


def gate_swaps(gate):
    from veneur_tpu_torch.core import server as server_mod
    swap = server_mod.swap_columnstore
    server_mod.swap_columnstore = (
        lambda *a, **kw: gate.run_swap(swap, *a, **kw))

    def restore():
        server_mod.swap_columnstore = swap
    return restore


def note_kernels(launches: list):
    """Append (kernel, host time, device type, shape) per call."""
    from veneur_tpu_torch.ops import hll_estimate, tdigest_flush
    k1, k2 = tdigest_flush.flush_packed, hll_estimate.estimate

    def flush_packed(sm, sw, scal, ps):
        launches.append(("k1", time.perf_counter(), sm.device.type,
                         (int(sm.shape[0]), int(sm.shape[1]), len(ps))))
        return k1(sm, sw, scal, ps)

    def estimate(regs):
        launches.append(("k2", time.perf_counter(), regs.device.type,
                         (int(regs.shape[0]),)))
        return k2(regs)
    tdigest_flush.flush_packed = flush_packed
    hll_estimate.estimate = estimate

    def restore():
        tdigest_flush.flush_packed, hll_estimate.estimate = k1, k2
    return restore
