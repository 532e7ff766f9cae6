"""Background flush execution and the shape-ladder prewarmer (torch port
of veneur_tpu/core/flushexec.py).

**FlushReadoutExecutor**: one background worker that runs the readout
half of the flush (`core/flusher.readout_columnstore`: the kernel
launches, K1, K2 and the llhist readout among them, the device sync, the
host copies and the assembly) off the interval's critical path. With
`flush_async` on, the server's flush swaps the interval out, submits its
readout here and only joins the previous interval's, so `dispatch_s` and
`device_sync_s` block neither the flush loop nor ingest. The worker
beats the pipeline supervisor as ``flush-readout``, so a wedged readout
trips the same stall ladder as a wedged flush loop.

**ShapeLadderPrewarmer**: climbs each family's capacity ladder one rung
ahead of live traffic. In the JAX package a rung is a compile of the
kernels specialised on that capacity. The port's kernels take their
shapes at launch and nothing is compiled per capacity, so a rung here is
the first launch of the family's apply and readout kernels on throwaway
tensors of that capacity (`_BaseTable.prewarm_rung`), which also leaves
blocks of that size in the caching allocator. It has no graph and no
cache. The same `shape_prewarm` event and `prewarm.*` rows are emitted.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import Future
from typing import Callable, List, Optional

logger = logging.getLogger("veneur_tpu_torch.flushexec")

# device families the prewarmer walks (statuses are host-only; the set
# table's rung prewarm is a no-op: its device bank rides the slot
# ladder, not row capacity)
PREWARM_FAMILIES = ("counter", "gauge", "histogram", "llhist", "set")


class FlushReadoutExecutor:
    """Single background worker draining flush readouts in submit order
    (one interval is in flight at a time by construction — the flush
    loop joins N-1 before submitting N, so the queue never grows past
    one). submit() returns a stdlib concurrent.futures.Future: the
    joiner's `result(timeout)` re-raises a readout failure exactly
    where a synchronous flush would have raised, and times out with
    concurrent.futures.TimeoutError. The worker thread is what a plain
    ThreadPoolExecutor can't give us: supervisor heartbeats between
    (and around) tasks, so a wedged readout trips the stall ladder."""

    def __init__(self, beat: Optional[Callable[[str], None]] = None,
                 name: str = "flush-readout"):
        self.name = name
        self._beat = beat
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        from veneur_tpu_torch.util.crash import guarded
        self._thread = threading.Thread(
            target=guarded(self._loop), name=name, daemon=True)
        self._thread.start()

    def submit(self, fn: Callable[[], object]) -> Future:
        pending: Future = Future()
        self._queue.put((fn, pending))
        return pending

    def _loop(self) -> None:
        while True:
            if self._beat is not None:
                self._beat(self.name)
            try:
                item = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is None:
                return
            fn, pending = item
            if not pending.set_running_or_notify_cancel():
                continue
            try:
                result = fn()
            except BaseException as e:  # re-raised at result()
                pending.set_exception(e)
                logger.exception("background flush readout failed")
            else:
                pending.set_result(result)
            finally:
                if self._beat is not None:
                    self._beat(self.name)

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        self._queue.put(None)
        self._thread.join(timeout)


class ShapeLadderPrewarmer:
    """Climbs each family's capacity ladder one rung ahead of live
    traffic. `prewarm_initial()` queues every family's next doubling;
    `note_resize(family, new_cap)` (wired into the server's resize
    hook) queues the rung after the one just reached. The launches run
    on one daemon thread against throwaway state, never against table
    locks or live device state."""

    def __init__(self, store, percentiles=(), need_export: bool = True,
                 on_event: Optional[Callable] = None,
                 max_rung: int = 1 << 22):
        self.store = store
        self.need_export = need_export
        ps = tuple(percentiles)
        self._full_ps = ps
        self._all_ps = tuple(sorted(set(ps) | {0.5}))
        self.on_event = on_event
        self.max_rung = max_rung
        self.compiled_total = 0
        self.last_seconds = 0.0
        self._queued = set()  # (family, capacity) ever enqueued
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _tables(self):
        return {family: table for family, table in self.store.tables()
                if family in PREWARM_FAMILIES}

    def start(self) -> None:
        from veneur_tpu_torch.util.crash import guarded
        self._thread = threading.Thread(
            target=guarded(self._loop), name="shape-prewarm", daemon=True)
        self._thread.start()

    def prewarm_initial(self) -> None:
        """Queue every family's next capacity rung (2x current), so the
        FIRST doubling finds it warm."""
        for family, table in self._tables().items():
            self._enqueue(family, table.capacity * 2)

    def note_resize(self, family: str, new_cap: int) -> None:
        """Resize-hook feed (fired under the table's buffer lock: only
        an enqueue happens here). The rung just reached was prewarmed
        by the previous round; queue the NEXT one."""
        self._enqueue(family, new_cap * 2)

    def _enqueue(self, family: str, capacity: int) -> None:
        if capacity > self.max_rung or family not in PREWARM_FAMILIES:
            return
        key = (family, capacity)
        if key in self._queued:
            return
        self._queued.add(key)
        self._queue.put(key)

    def _loop(self) -> None:
        import time
        tables = self._tables()
        while True:
            try:
                item = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is None:
                return
            family, capacity = item
            table = tables.get(family)
            if table is None:
                continue
            ps = self._all_ps if family == "histogram" else self._full_ps
            t0 = time.perf_counter()
            try:
                compiled = table.prewarm_rung(
                    capacity, ps, need_export=self.need_export)
            except Exception:
                logger.exception("prewarm of %s rung %d failed",
                                 family, capacity)
                continue
            if not compiled:
                continue
            elapsed = time.perf_counter() - t0
            self.compiled_total += 1
            self.last_seconds = elapsed
            if self.on_event is not None:
                try:
                    self.on_event("shape_prewarm", family=family,
                                  capacity=capacity,
                                  duration_s=round(elapsed, 6))
                except Exception:
                    logger.exception("prewarm event hook failed")

    def telemetry_rows(self) -> List[tuple]:
        rows = [
            ("prewarm.compiled_total", "counter",
             float(self.compiled_total), ()),
            ("prewarm.pending", "gauge", float(self._queue.qsize()), ()),
            ("prewarm.last_seconds", "gauge", self.last_seconds, ()),
        ]
        return rows

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout)
