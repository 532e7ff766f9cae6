"""The device column store: metric keys are rows, samples are batches
(torch port of veneur_tpu/core/columnstore.py).

Five device-resident tables, each on the store's `device`:

  counters  (K,)      f32 Kahan accumulator pair
  gauges    (K,)      f32 last-write-wins + set mask
  histos    (K, C)    t-digest centroid grids + per-key stats
  llhists   (K, 4608) int32 log-linear histogram registers
  sets      (D, 16k)  HLL registers of the promoted set keys

With `shard_devices` > 1 each family's table is its sharded subclass
(core/sharded_tables.py): the same rows, the interval state split into
shards over the local cards (or the caller's placement groups), merged
at each flush on the store's device.

A host dictionary interns MetricKey (by 64-bit fnv1a digest) to a row id;
names/tags/scopes never leave the host. Samples append into numpy batch
buffers and are applied to the device tensors in fixed-size padded
batches, so the device sees a few large dispatches per second instead of
one per packet.

The import server merges forwarded state into the live generation with
each table's `merge_batch`: intern and touch under ``lock``, then apply
under ``apply_lock`` acquired while ``lock`` is still held, the order
every batch apply keeps.

State is interval-scoped: a flush swaps the live device generation out,
reads it out, and recycles it as the next spare (the map-swap trick of
reference worker.go:470-489); the key dictionary persists so steady-state
ingest never re-interns. Where the JAX package donated buffers to its
jitted kernels, the port updates tensors in place; a drained generation
is reset in place on the device's stream after its readout was copied to
the host.

The live query plane (core/query.py) reads the live generation without
swapping it (`capture_readonly` / `query_readout`): the pending columns
fold into the live state through the ingest dispatch path, then, under
both table locks, the readout runs over the live state and places only
fresh tensors in its snap (clones of the counter and gauge columns, the
kernels' outputs for the others), queued on the device's stream ahead of
any later apply. Where the JAX package could hold a reference to an
immutable array, the port's in-place state must never escape a capture.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from veneur_tpu_torch.core import profiling
from veneur_tpu_torch.device import pick_device
from veneur_tpu_torch.ops import (
    batch_hll, batch_llhist, batch_tdigest, hll_ref, llhist_ref, scalars,
    thread_launches)
from veneur_tpu_torch.samplers import metrics as m
from veneur_tpu_torch.samplers.metrics import MetricScope, UDPMetric

logger = logging.getLogger("veneur_tpu_torch.core.columnstore")

# pending-buffer padding marker: every op masks rows outside [0, K)
# before it scatters (torch has no mode="drop"), independent of capacity
PAD_ROW = np.int32(2**31 - 1)


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host column as a tensor on `device`. The column is a private
    copy (_swap_locked), so aliasing it on the CPU is safe. The span
    `store.copy_in` while the span recorder is armed."""
    armed = profiling.armed
    if armed:
        t0 = time.perf_counter()
    out = torch.from_numpy(array).to(device)
    if armed:
        profiling.record("store.copy_in", t0, time.perf_counter(),
                         {"bytes": array.nbytes})
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy that shares no memory with `t`: on the CPU `.cpu()`
    returns the tensor itself, and a drained generation is reset in place
    right after its readout. The span `store.copy_out` while the span
    recorder is armed."""
    armed = profiling.armed
    if armed:
        t0 = time.perf_counter()
    out = t.detach().to("cpu", copy=True).numpy()
    if armed:
        profiling.record("store.copy_out", t0, time.perf_counter(),
                         {"bytes": out.nbytes})
    return out


def _pad_cap(t: torch.Tensor, new_cap: int) -> torch.Tensor:
    """`t` grown along the key axis to new_cap rows of zeros."""
    grown = torch.zeros((new_cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                        device=t.device)
    grown[: t.shape[0]] = t
    return grown


@dataclass
class RowMeta:
    """Host-side identity of a row (never touches the device)."""

    name: str
    tags: List[str]
    joined_tags: str
    digest32: int
    scope: MetricScope
    wire_type: str  # counter/gauge/histogram/timer/set/status
    # per-row cache of the metricpb wire prefix/suffix (serialized fields
    # 1-3 and field 9) the forward encoder frames each row with; identity
    # only, so it lives for the row's lifetime
    pb_frame: tuple = None


class _BaseTable:
    """Row interning + touched tracking + capacity doubling, shared by all
    families.

    Lock discipline (the device-side analog of the reference's map-swap,
    worker.go:470-489):

      * ``lock`` (buffer lock) protects the pending sample columns, the
        row dictionary, meta, and touched masks. Reader threads hold it
        only for memcpy-scale work.
      * ``apply_lock`` protects the device-resident ``state``. It is
        always acquired while still holding ``lock`` (which fixes batch
        application order to buffer-swap order — load-bearing for gauge
        last-write-wins) but is held WITHOUT ``lock`` during the device
        apply, so readers filling the fresh buffer never block on it.
      * Order: ``lock`` then ``apply_lock``; never the reverse.

    Invariant: a row's touched flag may only be set in the same ``lock``
    hold that makes its value visible to a flush (appended to a pending
    buffer, or applied to state while ``apply_lock`` was acquired under
    ``lock``).
    """

    family = "unknown"
    # the flow ledger (core/ledger.py), set by ColumnStore.attach_ledger:
    # every sample a table accepts stamps agg.applied, the out-side of
    # the server's ingest identity
    ledger = None
    # the cardinality accountant (core/cardinality.py), set by
    # ColumnStore.attach_cardinality: a new key's mint asks it first
    cardinality = None
    # hook(family, old_cap, new_cap, seconds, kind=, prewarmed=), set by
    # ColumnStore.attach_resize_hook: fired under ``lock`` by a capacity
    # doubling (kind "resize") and by the first batch apply after it
    # (kind "first_apply"), so it may only record or enqueue
    on_resize = None
    # the device observatory (core/deviceobs.py), set by
    # ColumnStore.attach_deviceobs: the HBM ledger books this table's
    # generations, the kernel registry its device calls
    _deviceobs = None

    def __init__(self, device: torch.device, capacity: int = 1024,
                 batch_cap: int = 8192, max_rows: int = 0):
        self.device = device
        self.capacity = capacity
        self.batch_cap = batch_cap
        # hard row cap (0 = unlimited): a new key past it is dropped
        self.max_rows = max_rows
        self.rows: Dict[int, int] = {}  # (digest64 << 2 | scope) -> row
        # row -> its key's identity; None for a free (recycled) row
        self.meta: List[RowMeta] = []
        # metric name -> its rows, appended at intern: the query plane's
        # lookup. Reclamation replaces (never edits) the lists of the
        # names whose rows it recycled, so a reader iterating one is safe.
        self.name_rows: Dict[str, List[int]] = {}
        self.touched = np.zeros(capacity, bool)
        self.lock = threading.Lock()
        self.apply_lock = threading.Lock()
        # per-row scope code for the flusher's mask math, and per-row
        # rendered flush names / tag-list refs so steady keysets format
        # strings once per row lifetime, not once per flush
        self.scope_code = np.full(capacity, -1, np.int8)
        self._tags_cache = np.empty(capacity, object)
        self._flush_name_cache: Dict[object, np.ndarray] = {}
        # the recycled (already reset) device generation the next
        # swap_out installs, and the capacity it was shaped for (a resize
        # in between invalidates it). Guarded by apply_lock.
        self._spare = None
        self._spare_cap = -1
        # idle-row reclamation (reclaim_idle): the flush generation, per
        # row the generation it was last touched in and the one it was
        # tombstoned in (-1: live), whether it holds a key, the rows-dict
        # key it was interned under, and the free rows a new key takes
        self._generation = 0
        self._last_touched = np.zeros(capacity, np.int64)
        self._tombstone_gen = np.full(capacity, -1, np.int64)
        self._has_meta = np.zeros(capacity, bool)
        self._dict_key_of: List[int] = []
        self._free_rows: List[int] = []
        # monotonic, under ``lock``: keys refused by the row cap, rows
        # minted (fresh or recycled), tombstoned and recycled
        self.keys_dropped = 0
        self.minted_total = 0
        self.tombstoned_total = 0
        self.recycled_total = 0
        # capacity doublings and their seconds, and the first batch apply
        # after the last one (timed to the device's completion); the
        # capacities the shape-ladder prewarmer launched ahead of need
        self.resize_total = 0
        self.resize_last_seconds = 0.0
        self.first_apply_last_seconds = 0.0
        self._first_apply_pending = False
        self._prewarmed_caps = set()
        # the HBM ledger's tokens of this table's generations through the
        # double-buffer lifecycle (live -> inflight -> spare -> live ...),
        # guarded by apply_lock
        self._devobs_live = None
        self._devobs_spare = None
        self._devobs_inflight = None
        self._init_arrays()

    # subclasses define _init_arrays / _grow_arrays / _apply_cols_state /
    # _fresh_state_at / _readout_device

    def _swap_locked(self):
        """Copy out and reset the pending columns (caller holds ``lock``).
        Returns the column copies, or None when nothing is pending. The
        whole buffer is copied; rows beyond the fill point are PAD_ROW and
        masked by the device ops."""
        if self._n == 0:
            return None
        cols = tuple(c.copy() for c in self._pcols)
        self._prow[: self._n] = PAD_ROW
        self._n = 0
        return cols

    def intern(self, metric: UDPMetric) -> int:
        """Intern a metric's row WITHOUT marking it touched — for callers
        that batch values themselves (the ordered gauge replay-merge in
        core.ingest). Touched must only be set once the value is in a
        pending buffer or the state, else a concurrent flush would emit a
        touched-but-valueless row (a fabricated 0.0)."""
        with self.lock:
            return self.row_for(metric)

    def _dispatch_pending_locked(self):
        """Swap the pending buffer out under ``lock`` and apply it to the
        device state with ``lock`` released (``apply_lock`` held). Caller
        holds ``lock`` on entry and on return."""
        cols = self._swap_locked()
        if cols is None:
            return
        self.apply_lock.acquire()
        self.lock.release()
        try:
            if self._first_apply_pending:
                self._noted("apply", lambda: self._time_first_apply(
                    lambda: self._apply_cols(cols)))
            else:
                self._noted("apply", lambda: self._apply_cols(cols))
        finally:
            self.apply_lock.release()
            self.lock.acquire()

    def _noted(self, kind: str, call):
        """Run `call` and book it in the observatory's kernel registry:
        the host's dispatch seconds (no synchronisation is added) and the
        kernel launches it made on this thread. While the span recorder
        is armed, the same two clock readings are the span
        `store.<kind>.<family>` (`store.apply.histogram`, ...)."""
        obs = self._deviceobs
        armed = profiling.armed
        if obs is None and not armed:
            return call()
        t0 = time.perf_counter()
        n0 = thread_launches()
        out = call()
        t1 = time.perf_counter()
        launches = thread_launches() - n0
        if obs is not None:
            obs.note_kernel(kind, self.family, t1 - t0, launches=launches)
        if armed:
            profiling.record(f"store.{kind}.{self.family}", t0, t1,
                             {"launches": launches})
        return out

    def _time_first_apply(self, apply) -> None:
        """Run the first batch apply after a capacity doubling to the
        device's completion and report its seconds through on_resize
        (the JAX package times its post-resize retrace at the same
        point; the port has none, so this is the apply's own cost at
        the new size). Caller holds ``apply_lock``."""
        self._first_apply_pending = False
        t0 = time.perf_counter()
        apply()
        self._sync_devices()
        elapsed = time.perf_counter() - t0
        self.first_apply_last_seconds = elapsed
        hook = self.on_resize
        if hook is not None:
            try:
                hook(self.family, self.capacity, self.capacity, elapsed,
                     kind="first_apply",
                     prewarmed=self.capacity in self._prewarmed_caps)
            except Exception:
                logger.exception("resize hook failed")

    def apply_pending(self):
        with self.lock:
            self._dispatch_pending_locked()

    def _sync_devices(self) -> None:
        """Wait for the device work queued on this table's devices."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- two-phase flush: critical-path swap / readout --------------------
    #
    #   swap_out()   O(1) under the table locks: swap the pending columns
    #                out, capture touched/meta, capture the live device
    #                generation and install a fresh one (the recycled
    #                spare when capacity still matches).
    #   readout()    lock-free on the CAPTURED generation (private to the
    #                snapshot): apply the final pending columns, launch
    #                the readout kernels.
    #   snapshot_finish()  host copies + assembly.
    #   recycle()    after the host copies: reset the drained generation
    #                in place and park it as the spare.

    def swap_out(self, **kw) -> dict:
        """Critical-path flush half: swap this table's interval out with
        no device work. Extra kwargs ride into the snap (ps)."""
        snap = dict(kw)
        with self.lock:
            idle = self._idle_swap_locked(snap)
            self._note_generation_locked()
            if idle:
                return snap
            snap["cols"] = self._swap_locked()
            with self.apply_lock:
                snap["touched"] = self.touched.copy()
                snap["meta"] = list(self.meta)
                self.touched[:] = False
                self._swap_extras_locked(snap)
                snap["state"] = self._swap_device_locked()
                snap["cap"] = self._state_capacity()
                # the in-flight ledger token rides the snap; recycle()
                # retags it spare or drops it when the generation dies
                snap["_devobs"] = self._devobs_inflight
                self._devobs_inflight = None
        return snap

    def _idle_swap_locked(self, snap: dict) -> bool:
        """Family-specific idle fast path (caller holds ``lock``):
        return True to skip the generation swap entirely (the llhist
        table skips its readout when untouched). It advances nothing, so
        capture_readonly takes the same skip."""
        return False

    def _swap_extras_locked(self, snap: dict) -> None:
        """Capture family-specific host-side interval state into the
        snap and reset it (caller holds ``lock`` + ``apply_lock``)."""

    def _swap_device_locked(self):
        """Capture the live device generation and install a fresh one
        (caller holds ``apply_lock``)."""
        captured = self.state
        spare, self._spare = self._spare, None
        used_spare = (spare is not None
                      and self._spare_cap == self._state_capacity())
        if used_spare:
            self.state = spare
        else:
            self.state = self._fresh_state_at(self._state_capacity())
        self._devobs_swap_locked(used_spare)
        return captured

    def _devobs_swap_locked(self, used_spare: bool) -> None:
        """HBM-ledger bookkeeping for a generation swap (caller holds
        ``apply_lock``; the new live state is already bound): the old
        live token goes in flight, and the spare token, when its
        generation was the one installed, becomes the new live token;
        otherwise the fresh allocation registers anew and a stale spare
        token (its generation dropped for a capacity mismatch) goes."""
        obs = self._deviceobs
        if obs is None:
            return
        tok, self._devobs_live = self._devobs_live, None
        if tok is not None:
            obs.retag(tok, "inflight")
            self._devobs_inflight = tok
        spare_tok, self._devobs_spare = self._devobs_spare, None
        if used_spare and spare_tok is not None:
            obs.retag(spare_tok, "live")
            self._devobs_live = spare_tok
        else:
            obs.drop(spare_tok)
            self._devobs_rebook_live_locked()

    def _devobs_state(self):
        """The live device generation for the HBM ledger: `state`, or
        the per-shard `states` list of a sharded histogram or set table
        (None for the host-only status table)."""
        state = getattr(self, "state", None)
        if state is None:
            state = getattr(self, "states", None)
        return state

    def _devobs_rebook_live_locked(self) -> None:
        """Re-register the live generation after it was re-laid-out at a
        new size (caller holds ``apply_lock``)."""
        obs = self._deviceobs
        if obs is not None:
            obs.drop(self._devobs_live)
            self._devobs_live = obs.note_generation(
                self.family, "live", self._devobs_state())

    def _state_capacity(self) -> int:
        """Key-axis capacity the device state is shaped for (the set
        table's dense bank rides its own slot ladder)."""
        return self.capacity

    def _reset_state_(self, captured) -> None:
        """Rewrite a drained generation to the family's INIT values in
        place (zeros; the t-digest table overrides)."""
        for t in captured.values():
            t.zero_()

    def readout(self, snap: dict) -> dict:
        """Background flush half: apply the snap's final pending columns
        to the captured generation and launch its readout kernels."""
        if "state" not in snap:
            return snap  # idle fast path: nothing was swapped
        state = snap.pop("state")
        cols = snap.pop("cols")
        if cols is not None:
            self._readout_apply(state, cols, snap)
        self._readout_device(state, snap)
        return snap

    def _readout_apply(self, state, cols, snap: dict) -> None:
        self._apply_cols_state(state, cols)

    def _readout_device(self, state, snap: dict) -> None:
        raise NotImplementedError

    def _apply_cols(self, cols) -> None:
        self._apply_cols_state(self.state, cols)

    def recycle(self, snap: dict) -> None:
        """Reset the drained generation in place and park it as the next
        spare. Call only after snapshot_finish has copied the readout to
        the host: the reset is queued on the same stream after those
        copies. A stacked sharded table's merge already zeroed its
        generation after the merged copy (`_spare`), which is parked as
        it is. A snap whose generation escaped (the set table's lazy
        register view) carries neither and is left alone; its ledger
        token is dropped."""
        cap = snap.pop("cap", -1)
        captured = snap.pop("_spare", None)
        recycle = snap.pop("_recycle", None)
        tok = snap.pop("_devobs", None)
        obs = self._deviceobs
        if captured is None:
            captured = recycle
            if captured is None:
                # the generation escaped into its readout: its token goes
                if obs is not None:
                    obs.drop(tok)
                return
            self._noted("reset", lambda: self._reset_state_(captured))
        with self.apply_lock:
            if cap == self._state_capacity() and self._spare is None:
                self._spare = captured
                self._spare_cap = cap
                if obs is not None:
                    obs.retag(tok, "spare")
                    self._devobs_spare = tok
                    tok = None
        # resized under the flush, or the spare slot taken: the reset
        # generation is discarded, and its bytes leave the ledger
        if obs is not None:
            obs.drop(tok)

    def snapshot_and_reset(self, **kw):
        """The whole flush of one table: swap, readout, host copies,
        recycle. Extra kwargs ride into the snap (ps)."""
        snap = self.readout(self.swap_out(**kw))
        out = self.snapshot_finish(snap)
        self.recycle(snap)
        return out

    # -- live-query capture: a read-only snapshot between flushes --------
    #
    #   capture_readonly()  under ``lock``: fold the pending columns into
    #                 the live state (the ingest dispatch, a bounded
    #                 number of rounds), then under ``apply_lock`` copy
    #                 touched/meta/extras and queue the readout over the
    #                 live state. No swap, no reset, no recycle.
    #   query_readout()  lock-free: wait for the queued readout.
    #   snapshot_finish()  the family's ordinary host copies + assembly.
    #
    # Absent further ingest, the captured state is exactly what the next
    # swap_out hands the flush, so a query equals the next flush bit for
    # bit. Residual pending samples after the fold are the query's
    # reported staleness (`stale_pending`); they fold on the next
    # dispatch and are never lost.

    _CAPTURE_FOLD_ROUNDS = 8

    def capture_readonly(self, **kw) -> dict:
        """Read-only counterpart of swap_out + readout. Extra kwargs ride
        into the snap as for swap_out (ps, need_export, need_bins). The
        readout is queued under ``apply_lock``: an apply that follows
        runs after it on the device's stream, and the snap holds only
        tensors no apply writes."""
        snap = dict(kw)
        with self.lock:
            # by reference: rows interned after this capture lie past its
            # meta, and a reader of the snap skips them
            snap["name_rows"] = self.name_rows
            if self._idle_swap_locked(snap):
                return snap
            for _ in range(self._CAPTURE_FOLD_ROUNDS):
                if self._n == 0:
                    break
                self._dispatch_pending_locked()  # may release/reacquire
            snap["stale_pending"] = self._n
            with self.apply_lock:
                snap["touched"] = self.touched.copy()
                snap["meta"] = list(self.meta)
                self._capture_extras_locked(snap)
                self._query_readout_device(self._capture_device_locked(),
                                           snap)
                if self.device.type == "cuda":
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(self.device))
                    snap["_ready"] = ready
        return snap

    def _capture_device_locked(self):
        """The live generation a query reads (caller holds
        ``apply_lock``): `state`, or a sharded table's per-shard list."""
        return self.state

    def _capture_extras_locked(self, snap: dict) -> None:
        """Read-only counterpart of _swap_extras_locked: COPY the
        family's host-side interval state into the snap without resetting
        it (caller holds ``lock`` + ``apply_lock``)."""

    def _query_readout_device(self, state, snap: dict) -> None:
        """The flush readout over the LIVE state, for a query: safe as is
        for a family whose readout writes nothing into the state and
        stores only fresh kernel outputs; the live generation is never
        recycled."""
        self._readout_device(state, snap)
        snap.pop("_recycle", None)

    def query_readout(self, snap: dict, deadline: float) -> dict:
        """The device-sync half of a query: wait, off the table locks, for
        the readout capture_readonly queued; past `deadline` (a
        time.monotonic() value), raise TimeoutError."""
        ready = snap.pop("_ready", None)
        while ready is not None and not ready.query():
            if time.monotonic() > deadline:
                raise TimeoutError("query readout still running on the "
                                   "device at its deadline")
            time.sleep(0.0002)
        return snap

    def row_for(self, metric: UDPMetric) -> int:
        """The key's row, interned on first sight (caller holds
        ``lock``): a recycled free row when there is one, else a fresh
        row. -1 when the row cap refuses a new key; the refusal is
        counted (keys_dropped, the ledger's agg.rejected)."""
        # scope is part of row identity: the reference keeps separate maps
        # per scope variant (worker.go:59-102)
        dict_key = (metric.digest64 << 2) | int(metric.scope)
        row = self.rows.get(dict_key)
        if row is None:
            # the cardinality rung: a NEW key asks the accountant's
            # per-name mint budget before any allocation (existing rows
            # never come here); it counts the shed itself
            card = self.cardinality
            if card is not None and not card.admit_mint(
                    self.family, metric.key.name, metric.tags):
                if self.ledger is not None:
                    self.ledger.note("agg.rejected", 1, key=self.family)
                return -1
            meta = RowMeta(
                name=metric.key.name, tags=list(metric.tags),
                joined_tags=metric.key.joined_tags, digest32=metric.digest,
                scope=metric.scope, wire_type=metric.key.type)
            if self._free_rows:
                row = self._free_rows.pop()
                self.meta[row] = meta
                self._dict_key_of[row] = dict_key
                # the previous key's cached flush names and tags go
                # before the new key's first flush renders
                self._tags_cache[row] = None
                for arr in self._flush_name_cache.values():
                    if row < arr.shape[0]:
                        arr[row] = None
            elif self.max_rows and len(self.rows) >= self.max_rows:
                self.keys_dropped += 1
                if self.ledger is not None:
                    self.ledger.note("agg.rejected", 1, key=self.family)
                return -1
            else:
                row = len(self.meta)
                if row >= self.capacity:
                    self._grow()
                self.meta.append(meta)
                self._dict_key_of.append(dict_key)
            # creation counts as activity: a row interned late in its
            # life must not read as idle since generation 0
            self._last_touched[row] = self._generation
            self._has_meta[row] = True
            self.scope_code[row] = int(metric.scope)
            self._note_minted(row, metric)
            self.rows[dict_key] = row
            self.name_rows.setdefault(metric.key.name, []).append(row)
            self.minted_total += 1
            if card is not None:
                card.note_mint(self.family, metric.key.name)
        return row

    def _note_minted(self, row: int, metric: UDPMetric) -> None:
        """Mint hook, fired once per fresh or recycled row assignment
        under ``lock``: the sharded tables (core/sharded_tables.py) stamp
        the row's home shard here; a single table does nothing."""

    def _note_generation_locked(self) -> None:
        """Advance the flush generation and stamp the rows touched this
        interval (caller holds ``lock``, before ``touched`` is cleared)."""
        self._generation += 1
        self._last_touched[self.touched] = self._generation

    def reclaim_idle(self, idle_intervals: int) -> List[int]:
        """Two-phase idle-row reclamation, run after each flush; returns
        the rows tombstoned by this call.

        Phase 1 (tombstone): a row idle for >= idle_intervals flushes
        loses its rows-dict entry now; the caller erases its intern
        mappings (native table or numpy decoder), so no NEW sample can
        reach it, and a returning key interns afresh.

        Phase 2 (recycle): a row tombstoned at least one flush ago and
        untouched since goes to the free list. The dependency: a row
        touched in snapshot N must not be recycled before flush N+1,
        because flush N's assembly still reads its meta and cached names
        (core/flusher.py), and a chunk parsed against the old intern
        mapping may still be in flight. A tombstoned row touched in the
        gap (such a straggler, emitted normally) re-arms its tombstone
        and waits one more flush; a row touched between swap_out and
        this call (its value sits in the new pending buffer) counts as
        touched here, so its value is never credited to another key."""
        if idle_intervals <= 0:
            return []
        evicted_names: List[str] = []
        with self.lock:
            gen = self._generation
            n = len(self.meta)
            if n == 0:
                return []
            last = self._last_touched[:n]
            tomb = self._tombstone_gen[:n]
            # phase 2
            rearm = (tomb >= 0) & ((last > tomb) | self.touched[:n])
            tomb[rearm] = gen
            recycle = np.flatnonzero((tomb >= 0) & (gen > tomb)
                                     & (last <= tomb))
            freed_names = set()
            for row in recycle.tolist():
                tomb[row] = -1
                freed_names.add(self.meta[row].name)
                self.meta[row] = None
                self._has_meta[row] = False
                self._free_rows.append(row)
            self.recycled_total += int(recycle.size)
            for name in freed_names:
                kept = [r for r in self.name_rows.get(name, ())
                        if self.meta[r] is not None
                        and self.meta[r].name == name]
                if kept:
                    self.name_rows[name] = kept
                else:
                    self.name_rows.pop(name, None)
            # phase 1
            evicted = np.flatnonzero(
                (tomb < 0) & (gen - last >= idle_intervals)
                & self._has_meta[:n]).tolist()
            for row in evicted:
                self.rows.pop(self._dict_key_of[row], None)
                tomb[row] = gen
                evicted_names.append(self.meta[row].name)
            self.tombstoned_total += len(evicted)
        # live-row accounting outside the buffer lock (JAX order)
        if evicted_names and self.cardinality is not None:
            self.cardinality.note_evicted(self.family, evicted_names)
        return evicted

    def flush_names(self, key, rows: np.ndarray, meta_list,
                    render) -> np.ndarray:
        """Rendered flush-name object array for `rows`, cached for the
        row's lifetime under `key` (a suffix string or percentile).
        Misses render via `render(meta)` against the caller's SNAPSHOT
        meta list."""
        with self.lock:
            arr = self._flush_name_cache.get(key)
            if arr is None or arr.shape[0] < len(self.meta):
                grown = np.empty(max(self.capacity, len(self.meta)), object)
                if arr is not None:
                    grown[: arr.shape[0]] = arr
                arr = self._flush_name_cache[key] = grown
        sel = arr[rows]
        miss = np.flatnonzero(np.equal(sel, None))
        for j in miss.tolist():
            row = int(rows[j])
            sel[j] = arr[row] = render(meta_list[row])
        return sel

    def flush_tags(self, rows: np.ndarray, meta_list) -> np.ndarray:
        """Per-row tag-list refs for `rows`, cached like flush_names.
        Consumers must copy before mutating."""
        with self.lock:  # a concurrent _grow replaces the array
            arr = self._tags_cache
        sel = arr[rows]
        miss = np.flatnonzero(np.equal(sel, None))
        for j in miss.tolist():
            row = int(rows[j])
            sel[j] = arr[row] = meta_list[row].tags
        return sel

    def _grow(self):
        """Double the row capacity (caller holds ``lock``)."""
        t0 = time.perf_counter()
        new_cap = self.capacity * 2
        pad = new_cap - self.capacity
        self.touched = np.concatenate([self.touched, np.zeros(pad, bool)])
        self._last_touched = np.concatenate(
            [self._last_touched, np.zeros(pad, np.int64)])
        self._tombstone_gen = np.concatenate(
            [self._tombstone_gen, np.full(pad, -1, np.int64)])
        self._has_meta = np.concatenate([self._has_meta, np.zeros(pad, bool)])
        self.scope_code = np.concatenate(
            [self.scope_code, np.full(pad, -1, np.int8)])
        self._tags_cache = np.concatenate(
            [self._tags_cache, np.empty(pad, object)])
        for key, arr in self._flush_name_cache.items():
            self._flush_name_cache[key] = np.concatenate(
                [arr, np.empty(pad, object)])
        with self.apply_lock:
            # the spare generation is shaped for the OLD capacity
            self._spare = None
            self._spare_cap = -1
            obs = self._deviceobs
            if obs is not None:
                obs.drop(self._devobs_spare)
                self._devobs_spare = None
            self._grow_arrays(new_cap)
            # the live generation was re-laid-out at the new capacity
            self._devobs_rebook_live_locked()
        logger.info("%s table capacity %d -> %d", self.family,
                    self.capacity, new_cap)
        old_cap, self.capacity = self.capacity, new_cap
        elapsed = time.perf_counter() - t0
        self.resize_total += 1
        self.resize_last_seconds = elapsed
        self._first_apply_pending = True
        hook = self.on_resize
        if hook is not None:
            try:
                hook(self.family, old_cap, new_cap, elapsed, kind="resize")
            except Exception:
                logger.exception("resize hook failed")

    # -- shape-ladder prewarm (core/flushexec.py) -------------------------

    def prewarm_rung(self, capacity: int, percentiles=(),
                     need_export: bool = True) -> bool:
        """The torch meaning of the JAX rung prewarm: launch this
        family's batch apply and readout kernels once on throwaway
        tensors of `capacity` rows, waited for, so the caching allocator
        holds blocks of that size before a doubling asks for them. There
        is no graph and no compile cache to fill. Runs on the prewarmer's
        thread: it touches no live state and takes no table lock. Returns
        True when the rung was launched."""
        cols = self._prewarm_cols()
        if cols is None:
            return False
        obs = self._deviceobs
        t0 = time.perf_counter()
        n0 = thread_launches()
        state = self._fresh_state_at(capacity)
        # the throwaway rung state is real device memory while it runs:
        # the ledger books it as a transient `prewarm` generation
        tok = obs.note_generation(self.family, "prewarm", state) \
            if obs is not None else None
        try:
            self._prewarm_apply(state, cols, capacity)
            snap = {"ps": tuple(percentiles), "need_export": need_export,
                    "touched": np.ones(capacity, bool)}
            self._prewarm_readout(state, snap)
            self._reset_state_(state)
            self._sync_devices()
        finally:
            if obs is not None:
                obs.drop(tok)
        self._prewarmed_caps.add(capacity)
        if obs is not None:
            obs.note_kernel("prewarm", self.family,
                            time.perf_counter() - t0,
                            launches=thread_launches() - n0)
        return True

    def _prewarm_cols(self):
        """An all-padding pending batch with the live buffers' dtypes
        (None: the family has no batch apply)."""
        pcols = getattr(self, "_pcols", None)
        if not pcols:
            return None
        return (np.full(self.batch_cap, PAD_ROW, np.int32),) + tuple(
            np.zeros(self.batch_cap, c.dtype) for c in pcols[1:])

    def _prewarm_apply(self, state, cols, capacity: int) -> None:
        self._apply_cols_state(state, cols)

    def _prewarm_readout(self, state, snap: dict) -> None:
        self._readout_device(state, snap)

    def _append_batch(self, columns, touch_rows=None) -> None:
        """Vectorized append of parallel sample columns (rows first) into
        the pending buffers, dispatching whenever full. Caller holds
        self.lock; rows must already be interned. Touched flags are set
        per chunk, in the same lock hold that buffers the chunk: the
        dispatch releases the lock, and a snapshot in that window must
        not clear the flags of samples still to be buffered. touch_rows
        defaults to the row column; the set table, whose buffers carry
        device slots, passes its table rows."""
        if touch_rows is None:
            touch_rows = columns[0]
        n = len(columns[0])
        i = 0
        while i < n:
            take = min(self.batch_cap - self._n, n - i)
            for buf, data in zip(self._pcols, columns):
                buf[self._n:self._n + take] = data[i:i + take]
            self.touched[touch_rows[i:i + take]] = True
            self._n += take
            i += take
            if self._n >= self.batch_cap:
                self._dispatch_pending_locked()

    def add_batch(self, *columns) -> None:
        """Pre-interned rows plus parallel value columns, in the order of
        the family's pending buffers."""
        with self.lock:
            self._append_batch(columns)
        self._note_applied(len(columns[0]))

    def _note_applied(self, n: int) -> None:
        """Stamp n samples accepted into this family (flow ledger)."""
        led = self.ledger
        if led is not None and n:
            led.note("agg.applied", n, key=self.family)

    def _intern_stubs_locked(self, stubs):
        """Intern the import path's metric stubs and mark them touched
        (caller holds ``lock``): (int32 rows of the interned stubs, the
        mask of the stubs interned). A stub the row cap refuses drops out
        of both, counted by row_for, and its applied stamp with it."""
        rows = np.fromiter((self.row_for(s) for s in stubs), np.int32,
                           len(stubs))
        ok = rows >= 0
        rows = rows[ok]
        self.touched[rows] = True
        self._note_applied(int(rows.size))
        return rows, ok

    def _add_row_locked(self, row: int, *values) -> None:
        """Buffer one sample for an interned row (caller holds lock)."""
        self.touched[row] = True
        n = self._n
        self._prow[n] = row
        for buf, v in zip(self._pcols[1:], values):
            buf[n] = v
        self._n = n + 1
        if self._n >= self.batch_cap:
            self._dispatch_pending_locked()


class CounterTable(_BaseTable):
    def _init_arrays(self):
        self.state = self._fresh_state_at(self.capacity)
        self._prow = np.full(self.batch_cap, PAD_ROW, np.int32)
        self._pval = np.zeros(self.batch_cap, np.float32)
        self._prate = np.ones(self.batch_cap, np.float32)
        self._pcols = (self._prow, self._pval, self._prate)
        self._n = 0
        # imported counters are exact int64 sums that float32 would
        # quantize: they accumulate on the host in float64
        self._import_acc = np.zeros(self.capacity, np.float64)

    def _grow_arrays(self, new_cap):
        self.state = {k: _pad_cap(v, new_cap) for k, v in self.state.items()}

    def add(self, metric: UDPMetric) -> bool:
        with self.lock:
            row = self.row_for(metric)
            if row >= 0:
                self._add_row_locked(row, metric.value,
                                     max(metric.sample_rate, 1e-9))
        return row >= 0

    def _apply_cols_state(self, state, cols):
        rows, vals, rates = (_to_device(c, self.device) for c in cols)
        scalars.apply_counters(state, rows, vals, rates)

    def merge_batch(self, stubs: List[UDPMetric], values) -> None:
        """Import-path merge: intern, touch and accumulate in one ``lock``
        hold, so a flush never sees a touched row without its value."""
        with self.lock:
            rows, ok = self._intern_stubs_locked(stubs)
            if self._import_acc.shape[0] < self.capacity:
                grown = np.zeros(self.capacity, np.float64)
                grown[: self._import_acc.shape[0]] = self._import_acc
                self._import_acc = grown
            np.add.at(self._import_acc, rows,
                      np.asarray(values, np.float64)[ok])

    def _swap_extras_locked(self, snap: dict) -> None:
        snap["import_acc"] = self._import_acc
        self._import_acc = np.zeros(self.capacity, np.float64)

    def _capture_extras_locked(self, snap: dict) -> None:
        # a copy: merge_batch adds into the accumulator in place
        snap["import_acc"] = self._import_acc.copy()

    def _fresh_state_at(self, capacity: int):
        return scalars.init_counters(capacity, self.device)

    def _readout_device(self, state, snap: dict) -> None:
        """Counter readout is a copy of the Kahan pair; the captured
        generation is recycled after the copy."""
        snap["dev"] = (state["sum"], state["comp"])
        snap["_recycle"] = state

    def _query_readout_device(self, state, snap: dict) -> None:
        # the flush's readout holds the pair by reference, which is safe
        # only for a swapped-out generation: a query clones the live pair
        # so that no later apply leaks into it or tears it
        snap["dev"] = (state["sum"].clone(), state["comp"].clone())

    @staticmethod
    def snapshot_finish(snap: dict
                        ) -> Tuple[np.ndarray, np.ndarray, List[RowMeta]]:
        # f64 readout recovers the exact total from the Kahan pair
        values = (_host(snap["dev"][0]).astype(np.float64)
                  - _host(snap["dev"][1]).astype(np.float64))
        import_acc = snap["import_acc"]
        values[: import_acc.shape[0]] += import_acc
        return values, snap["touched"], snap["meta"]


class GaugeTable(_BaseTable):
    def _init_arrays(self):
        self.state = self._fresh_state_at(self.capacity)
        self._prow = np.full(self.batch_cap, PAD_ROW, np.int32)
        self._pval = np.zeros(self.batch_cap, np.float32)
        self._pcols = (self._prow, self._pval)
        self._n = 0

    def _grow_arrays(self, new_cap):
        self.state = {k: _pad_cap(v, new_cap) for k, v in self.state.items()}

    def add(self, metric: UDPMetric) -> bool:
        with self.lock:
            row = self.row_for(metric)
            if row >= 0:
                self._add_row_locked(row, metric.value)
        return row >= 0

    def _apply_cols_state(self, state, cols):
        rows, vals = (_to_device(c, self.device) for c in cols)
        scalars.apply_gauges(state, rows, vals)

    def merge_batch(self, stubs: List[UDPMetric], values) -> None:
        """Import-path merge: overwrite. Interned and touched under
        ``lock``; the state update takes ``apply_lock`` before ``lock`` is
        released, so it orders after any batch already swapped out."""
        with self.lock:
            rows, ok = self._intern_stubs_locked(stubs)
            self.apply_lock.acquire()
        try:
            self._noted("merge", lambda: scalars.merge_gauges(
                self.state, _to_device(rows, self.device),
                _to_device(np.asarray(values, np.float32)[ok],
                           self.device)))
        finally:
            self.apply_lock.release()

    def _fresh_state_at(self, capacity: int):
        return scalars.init_gauges(capacity, self.device)

    def _readout_device(self, state, snap: dict) -> None:
        snap["dev"] = state["value"]
        snap["_recycle"] = state

    def _query_readout_device(self, state, snap: dict) -> None:
        # see CounterTable: a query clones the live last-write-wins column
        snap["dev"] = state["value"].clone()

    @staticmethod
    def snapshot_finish(snap: dict):
        return _host(snap["dev"]), snap["touched"], snap["meta"]


class HistoTable(_BaseTable):
    """Histograms and timers, all scopes, one digest grid.

    Batches rank-park raw samples into the digest staging grid (O(batch)
    per apply, exact); the host tracks exact per-key staging occupancy and
    runs the mean-sorted `compact` before any key could overflow its C
    staging slots. The flush folds staging itself."""

    def _init_arrays(self):
        self._prow = np.full(self.batch_cap, PAD_ROW, np.int32)
        self._pval = np.zeros(self.batch_cap, np.float32)
        self._pwt = np.zeros(self.batch_cap, np.float32)
        self._pcols = (self._prow, self._pval, self._pwt)
        self._n = 0
        # exact per-key staging-slot occupancy since the last compact
        self._staged_counts = np.zeros(self.capacity, np.int32)
        self.state = batch_tdigest.init_state(self.capacity, self.device)

    def _grow_arrays(self, new_cap):
        grown = batch_tdigest.init_state(new_cap, self.device)
        for k, v in self.state.items():
            grown[k][: v.shape[0]] = v
        self.state = grown
        extended = np.zeros(new_cap, np.int32)
        extended[: self._staged_counts.shape[0]] = self._staged_counts
        self._staged_counts = extended

    def add(self, metric: UDPMetric) -> bool:
        with self.lock:
            row = self.row_for(metric)
            if row >= 0:
                self._add_row_locked(row, metric.value,
                                     1.0 / max(metric.sample_rate, 1e-9))
        return row >= 0

    def _apply_cols(self, cols):
        self._apply_cols_state(self.state, cols, self._staged_counts)

    def _apply_cols_state(self, state, cols, staged_counts):
        """Batch apply over an explicit (state, staging-occupancy) pair:
        the live path passes the table's own, the flush readout passes the
        captured generation's."""
        rows, vals, wts = cols
        slots, overflow = batch_tdigest.host_slots(
            rows, vals, wts, staged_counts)
        if overflow:
            batch_tdigest.compact(state)
            staged_counts[:] = 0
            slots, _ = batch_tdigest.host_slots(
                rows, vals, wts, staged_counts)
        batch_tdigest.apply_batch(
            state, *(_to_device(c, self.device)
                     for c in (rows, vals, wts, slots)))

    def merge_batch(self, stubs: List[UDPMetric], in_means, in_weights,
                    in_min, in_max, in_recip) -> None:
        """Import-path digest merge: interned and touched under ``lock``,
        the state update under ``apply_lock`` taken before ``lock`` is
        released."""
        with self.lock:
            rows, ok = self._intern_stubs_locked(stubs)
            self.apply_lock.acquire()
        try:
            cols = [rows] + [np.asarray(c, np.float32)[ok] for c in (
                in_means, in_weights, in_min, in_max, in_recip)]
            self._noted("merge", lambda: batch_tdigest.merge_centroid_rows(
                self.state, *(_to_device(c, self.device) for c in cols)))
            # the merge folds the staging of every row with staged weight,
            # so the whole occupancy map resets
            self._staged_counts[:] = 0
        finally:
            self.apply_lock.release()

    def _fresh_state_at(self, capacity: int):
        return batch_tdigest.init_state(capacity, self.device)

    def _prewarm_apply(self, state, cols, capacity: int) -> None:
        self._apply_cols_state(state, cols, np.zeros(capacity, np.int32))

    def _reset_state_(self, captured) -> None:
        # zeros alone would corrupt the ±inf extrema into fabricated 0.0
        batch_tdigest.reset_state_(captured)

    def _swap_extras_locked(self, snap: dict) -> None:
        snap["staged"] = self._staged_counts
        self._staged_counts = np.zeros(self.capacity, np.int32)

    # a capture folds the pending columns through _apply_cols, which reads
    # and advances the live _staged_counts exactly as an ingest dispatch
    # does, and the query readout (flush_quantiles_packed with staging
    # folded) only reads the grids: nothing takes or resets the counts

    def _readout_apply(self, state, cols, snap: dict) -> None:
        self._apply_cols_state(state, cols, snap.pop("staged"))

    def _readout_device(self, state, snap: dict) -> None:
        """The t-digest flush: sort, then kernel K1 on the card. A server
        that forwards (need_export) takes the forwarding flush, which
        also recompresses the sorted centroids into the export grid."""
        if snap.pop("need_export", False):
            snap["packed"], snap["export"] = \
                batch_tdigest.flush_export_packed(state, snap["ps"])
        else:
            snap["packed"] = batch_tdigest.flush_quantiles_packed(
                state, snap["ps"], fold_staging=True)
            snap["export"] = None
        snap["_recycle"] = state

    @staticmethod
    def snapshot_finish(snap: dict):
        """(flush outputs dict of np arrays, centroid export (means,
        weights, dmin, dmax, drecip) or None, touched, meta)."""
        out = batch_tdigest.unpack_flush(_host(snap["packed"]),
                                         len(snap["ps"]))
        export = (batch_tdigest.unpack_export(_host(snap["export"]))
                  if snap["export"] is not None else None)
        return out, export, snap["touched"], snap["meta"]


class _SetRegisters:
    """Lazy per-row dense register view over the two-tier set state:
    promoted rows slice the (D, M) device bank; sparse rows materialize
    16 KB only when a caller asks."""

    def __init__(self, dev_regs, slot_of, sparse_rows, sparse_idx,
                 sparse_rho):
        # (nslots, M) int8 — a DEVICE tensor, or None; copied to the host
        # on the first promoted-row access
        self._dev = dev_regs
        self._dev_np = None
        self._slot_of = slot_of
        # sparse COO sorted by row; boundaries found by searchsorted
        self._rows = sparse_rows
        self._idx = sparse_idx
        self._rho = sparse_rho

    def __getitem__(self, row: int) -> np.ndarray:
        slot = int(self._slot_of[row]) if row < self._slot_of.shape[0] else -1
        if slot >= 0 and self._dev is not None:
            if self._dev_np is None:
                self._dev_np = _host(self._dev)
            return self._dev_np[slot]
        regs = np.zeros(batch_hll.M, np.int8)
        lo = np.searchsorted(self._rows, row, side="left")
        hi = np.searchsorted(self._rows, row, side="right")
        if hi > lo:
            np.maximum.at(regs, self._idx[lo:hi],
                          self._rho[lo:hi].astype(np.int8))
        return regs


class SetTable(_BaseTable):
    """Sets with a two-tier HLL representation (the reference's vendored
    hyperloglog likewise keeps small sets sparse, sparse.go): samples for
    a key accumulate as host-side COO (register, rho) pairs until the key
    crosses PROMOTE_SAMPLES within the interval, at which point it is
    promoted to a row of the dense (D, 16384) device bank and its stream
    flows through the scatter-max. At flush, promoted rows' early backlog
    folds into the device bank and their estimates are kernel K2; small
    rows estimate on the host with the same LogLog-Beta math."""

    MAX_DEV_SLOTS = 65536  # device-memory guard: 16 KB/slot -> 1 GB

    def __init__(self, device: torch.device, capacity: int = 256,
                 batch_cap: int = 8192, promote_samples: int = 0,
                 max_dev_slots: int = 0, max_rows: int = 0):
        self._promote_samples = promote_samples
        if max_dev_slots > 0:
            self.MAX_DEV_SLOTS = max_dev_slots
        super().__init__(device, capacity, batch_cap, max_rows)

    @property
    def PROMOTE_SAMPLES(self) -> int:
        """Tier-crossover threshold. Auto (0): on a card the dense scatter
        tier is the fast path, so promote early; on the CPU the "device"
        is the host core and promoting buys nothing, so stay sparse."""
        if self._promote_samples > 0:
            return self._promote_samples
        return 2048 if self.device.type == "cpu" else 16

    def _init_arrays(self):
        self._prow = np.full(self.batch_cap, PAD_ROW, np.int32)
        self._pidx = np.zeros(self.batch_cap, np.int32)
        self._prho = np.zeros(self.batch_cap, np.int32)
        self._pcols = (self._prow, self._pidx, self._prho)
        self._n = 0
        self._dev_cap = min(256, self.capacity)
        self._slot_of = np.full(self.capacity, -1, np.int32)
        self._nslots = 0
        self._slot_row: List[int] = []
        self._counts = np.zeros(self.capacity, np.int32)
        # host tier: (rows, idx, rho) array chunks from add_batch, and
        # the per-sample appends of add
        self._coo: List[tuple] = []
        self._coo_scalar: Tuple[list, list, list] = ([], [], [])
        self.state = batch_hll.init_state(self._dev_cap, self.device)

    def _grow_arrays(self, new_cap):
        grown_slots = np.full(new_cap, -1, np.int32)
        grown_slots[: self._slot_of.shape[0]] = self._slot_of
        self._slot_of = grown_slots
        grown_counts = np.zeros(new_cap, np.int32)
        grown_counts[: self._counts.shape[0]] = self._counts
        self._counts = grown_counts

    @property
    def _slot_limit(self) -> int:
        """How many device slots may be ASSIGNED: the memory guard clamped
        to the current row capacity."""
        return min(self.MAX_DEV_SLOTS, self.capacity)

    def _promote_locked(self, row: int) -> None:
        """Assign a device slot (caller holds the buffer lock). A no-op
        at the slot limit — the key stays on the host tier."""
        if self._nslots >= self._slot_limit:
            return
        if self._nslots >= self._dev_cap:
            with self.apply_lock:
                # the bank grows on an 8x ladder bounded by the guard,
                # decoupled from row-capacity doublings
                self._dev_cap = min(self._dev_cap * 8, self.MAX_DEV_SLOTS)
                self.state = _pad_cap(self.state, self._dev_cap)
                self._devobs_rebook_live_locked()
        self._slot_of[row] = self._nslots
        self._slot_row.append(row)
        self._nslots += 1

    def add(self, metric: UDPMetric) -> bool:
        member = metric.value if isinstance(metric.value, bytes) else str(
            metric.value).encode()
        idx, rho = hll_ref.pos_val(hll_ref.hash_member(member))
        with self.lock:
            row = self.row_for(metric)
            if row < 0:
                return False
            self.touched[row] = True
            self._counts[row] += 1
            slot = self._slot_of[row]
            if slot < 0 and self._counts[row] >= self.PROMOTE_SAMPLES:
                self._promote_locked(row)
                slot = self._slot_of[row]
            if slot < 0:
                # host tier: list appends, turned into COO at snapshot
                self._coo_scalar[0].append(row)
                self._coo_scalar[1].append(idx)
                self._coo_scalar[2].append(rho)
                return True
            n = self._n
            self._prow[n] = slot
            self._pidx[n] = idx
            self._prho[n] = rho
            self._n = n + 1
            if self._n >= self.batch_cap:
                self._dispatch_pending_locked()
        return True

    def add_batch(self, rows, reg_idx, rho) -> None:
        """Members already hashed to (idx, rho) for interned rows: each
        sample goes to its key's tier (device slot or host COO)."""
        with self.lock:
            # Route in buffer-sized chunks, re-deriving the slot map for
            # every chunk under the CURRENT lock hold: a dispatch releases
            # the lock while applying, and a snapshot in that window
            # resets the slot assignment, so slot ids taken before it
            # would credit the fresh interval's bank at stale positions.
            start, total = 0, rows.shape[0]
            while start < total:
                free = self.batch_cap - self._n
                if free <= 0:
                    self._dispatch_pending_locked()  # may release lock
                    continue
                sl = slice(start, start + free)
                r, ix, rh = rows[sl], reg_idx[sl], rho[sl]
                start += r.shape[0]
                self._counts += np.bincount(
                    r, minlength=self._counts.shape[0]).astype(np.int32)
                for hot in np.unique(r[(self._slot_of[r] < 0)
                                       & (self._counts[r]
                                          >= self.PROMOTE_SAMPLES)]):
                    self._promote_locked(int(hot))
                slots = self._slot_of[r]
                cold = slots < 0
                # COO append and touched in this hold, before the dense
                # append below can release the lock in a dispatch
                if cold.any():
                    self.touched[r[cold]] = True
                    self._coo.append((r[cold].copy(), ix[cold].copy(),
                                      rh[cold].copy()))
                if (~cold).any():
                    # fits the free space, so a dispatch can only follow
                    # the whole chunk being buffered and touched
                    self._append_batch((slots[~cold], ix[~cold], rh[~cold]),
                                       touch_rows=r[~cold])
        self._note_applied(int(rows.shape[0]))

    def _apply_cols_state(self, state, cols):
        rows, idxs, rhos = (_to_device(c, self.device) for c in cols)
        batch_hll.apply_batch(state, rows, idxs, rhos)

    def merge_batch(self, stubs: List[UDPMetric], in_regs) -> None:
        """Import-path HLL merge (register max). Imported rows arrive
        dense, so they promote at once; rows past the slot limit fold
        into the host COO tier instead (nonzero registers become (idx,
        rho) pairs)."""
        with self.lock:
            rows, ok = self._intern_stubs_locked(stubs)
            regs = np.asarray(in_regs, np.int8)[ok]
            for r in rows.tolist():
                if self._slot_of[r] < 0:
                    self._promote_locked(r)
            target = self._slot_of[rows]
            capped = target < 0
            for j in np.flatnonzero(capped).tolist():
                nz = np.flatnonzero(regs[j])
                if nz.size:
                    self._coo.append((np.full(nz.size, rows[j], np.int32),
                                      nz.astype(np.int32),
                                      regs[j][nz].astype(np.int32)))
            target, regs = target[~capped], regs[~capped]
            self.apply_lock.acquire()
        try:
            if target.size:
                # a promotion may have grown the bank: read it here
                self._noted("merge", lambda: batch_hll.merge_rows(
                    self.state, _to_device(target, self.device),
                    _to_device(regs, self.device)))
        finally:
            self.apply_lock.release()

    def _state_capacity(self) -> int:
        return self._dev_cap

    def prewarm_rung(self, capacity: int, percentiles=(),
                     need_export: bool = True) -> bool:
        """No-op, as in the JAX package: the dense bank rides its own 8x
        slot ladder (`_dev_cap`), decoupled from row-capacity doublings
        (_promote_locked)."""
        return False

    def _fresh_state_at(self, capacity: int):
        return batch_hll.init_state(capacity, self.device)

    def _host_estimates(self, rows, idx, rho):
        """Vectorized LogLog-Beta over row-grouped COO pairs; returns
        (unique_rows, estimates). Dedupe keeps the max rho per (row,
        register), matching the device scatter-max."""
        if rows.shape[0] == 0:
            return rows, np.zeros(0, np.float32)
        key = (rows.astype(np.int64) << hll_ref.P) | idx.astype(np.int64)
        order = np.argsort(key, kind="stable")
        k, q = key[order], rho[order]
        starts = np.flatnonzero(np.r_[True, k[:-1] != k[1:]])
        qmax = np.maximum.reduceat(q, starts)
        kk = k[starts]
        r = (kk >> hll_ref.P).astype(rows.dtype)
        rb = np.flatnonzero(np.r_[True, r[:-1] != r[1:]])
        urows = r[rb]
        nnz = np.diff(np.r_[rb, r.shape[0]])
        pow_sum = np.add.reduceat(
            np.power(2.0, -qmax.astype(np.float64)), rb)
        ez = float(batch_hll.M) - nnz
        s = ez + pow_sum  # zero registers contribute 2^0 each
        zl = np.log(ez + 1.0)
        beta = hll_ref._BETA14_EZ * ez
        for i, c in enumerate(hll_ref._BETA14):
            beta = beta + c * zl ** (i + 1)
        est = np.floor(
            hll_ref._ALPHA * batch_hll.M * (batch_hll.M - ez)
            / (beta + s) + 1.0)
        return urows, est.astype(np.float32)

    def _swap_extras_locked(self, snap: dict) -> None:
        """Capture the host tier (COO backlog + slot assignment) atomically
        with the device generation: the captured slot map is what makes
        the captured pending columns' slot ids meaningful."""
        coo, self._coo = self._coo, []
        sc, self._coo_scalar = self._coo_scalar, ([], [], [])
        snap["sparse"] = {
            "coo": coo, "coo_scalar": sc,
            "slot_of": self._slot_of, "slot_row": self._slot_row,
            "nslots": self._nslots}
        self._slot_of = np.full(self.capacity, -1, np.int32)
        self._slot_row = []
        self._nslots = 0
        self._counts[:] = 0

    def _capture_extras_locked(self, snap: dict) -> None:
        """Read-only host-tier capture: the COO backlog and the slot map
        that _swap_extras_locked resets are copied, not taken (the COO
        chunks are append-once, so a list copy suffices); the per-row
        counts are neither read nor reset."""
        snap["sparse"] = {
            "coo": list(self._coo),
            "coo_scalar": tuple(list(c) for c in self._coo_scalar),
            "slot_of": self._slot_of.copy(),
            "slot_row": list(self._slot_row), "nslots": self._nslots}

    def _estimate_device(self, state, sparse: dict, snap: dict):
        """Fold the promoted rows' pre-promotion backlog into `state` (a
        register max, idempotent, so the live bank may take it), launch
        K2 over the promoted slots (its output stays on the device until
        snapshot_finish) and estimate the host-tier rows. Returns the
        host tier's COO sorted by row."""
        coo = sparse["coo"] + [tuple(np.asarray(c, np.int32)
                                     for c in sparse["coo_scalar"])]
        rows_all, idx_all, rho_all = (np.concatenate([c[i] for c in coo])
                                      for i in range(3))
        slot_of = sparse["slot_of"]
        pslots = slot_of[rows_all]
        hot = pslots >= 0
        hot_slots, hot_idx, hot_rho = pslots[hot], idx_all[hot], rho_all[hot]
        for i in range(0, hot_slots.shape[0], self.batch_cap):
            sl = slice(i, i + self.batch_cap)
            self._apply_cols_state(
                state, (hot_slots[sl], hot_idx[sl], hot_rho[sl]))
        estimates = np.zeros(self.capacity, np.float32)
        snap["dev_est"] = None
        if sparse["nslots"]:
            # kernel K2 on the card
            snap["dev_est"] = batch_hll.estimate(state[:sparse["nslots"]])
            snap["dev_rows"] = np.asarray(sparse["slot_row"], np.int64)
        s_rows, s_idx, s_rho = rows_all[~hot], idx_all[~hot], rho_all[~hot]
        if s_rows.size:
            urows, est = self._host_estimates(s_rows, s_idx, s_rho)
            estimates[urows] = est
            order = np.argsort(s_rows, kind="stable")
            s_rows, s_idx, s_rho = (s_rows[order], s_idx[order],
                                    s_rho[order])
        snap["estimates"] = estimates
        return s_rows, s_idx, s_rho

    def _readout_device(self, state, snap: dict) -> None:
        """Estimates + register view over the captured generation. The
        view keeps a live device reference (lazy copy), so the captured
        generation escapes into the snapshot and is NOT recycled."""
        sparse = snap.pop("sparse")
        s_cols = self._estimate_device(state, sparse, snap)
        snap["registers"] = _SetRegisters(
            state if sparse["nslots"] else None, sparse["slot_of"], *s_cols)

    def _query_readout_device(self, state, snap: dict) -> None:
        # estimates only: no register view of the live bank escapes
        self._estimate_device(state, snap.pop("sparse"), snap)
        snap["registers"] = None

    @staticmethod
    def snapshot_finish(snap: dict):
        estimates = snap["estimates"]
        if snap["dev_est"] is not None:
            estimates[snap["dev_rows"]] = _host(snap["dev_est"])
        return (estimates, snap["registers"], snap["touched"],
                snap["meta"])


class LLHistTable(_BaseTable):
    """Circllhist log-linear histograms: a dense (K, BINS_PAD) int32
    register table (ops/batch_llhist). The host bins values
    (llhist_ref.bin_index, or the native parser's bit-identical copy)
    into (row, bin, weight) triples; the device applies each batch as
    one scatter-add, kernel K3 on the card. Merges are register
    additions, so the family is exact.

    Weights are integral (1/sample_rate rounds to the nearest count);
    `samples_total` and `clamped_total` count the weight binned and the
    weight that fell outside the representable magnitude window.

    Whole-chunk apply: when a batch brings more samples than the pending
    buffer has free, the pending samples and the incoming ones up to the
    last whole multiple of `batch_cap` go to the device together, packed
    into one block (batch_llhist.pack), brought over by one copy and
    applied by one launch; only the remainder, fewer than `batch_cap`, is
    buffered."""

    def _init_arrays(self):
        self._prow = np.full(self.batch_cap, PAD_ROW, np.int32)
        self._pbin = np.zeros(self.batch_cap, np.int32)
        self._pwt = np.zeros(self.batch_cap, np.int32)
        self._pcols = (self._prow, self._pbin, self._pwt)
        self._n = 0
        self.state = self._fresh_state_at(self.capacity)
        # monotonic sample/clamp accounting (mutated under `lock`)
        self.samples_total = 0
        self.clamped_total = 0

    def _grow_arrays(self, new_cap):
        self.state = _pad_cap(self.state, new_cap)

    def add(self, metric: UDPMetric) -> bool:
        value = float(metric.value)
        bin_idx = int(llhist_ref.bin_index(value))
        # clamp into int32: registers are int32, and an absurd-but-valid
        # sample rate (@1e-10) must saturate, not overflow the buffer
        # assignment (same clamp as bin_batch_host and the C++ parser)
        weight = min(max(1, round(1.0 / max(metric.sample_rate, 1e-9))),
                     2**31 - 1)
        with self.lock:
            row = self.row_for(metric)
            if row < 0:
                return False
            self.samples_total += weight
            if llhist_ref.clamped_mask(value):
                self.clamped_total += weight
            self._add_row_locked(row, bin_idx, weight)
        return True

    def add_batch(self, rows, vals, weights) -> None:
        """Pre-interned rows, raw values (binned here) and 1/sample_rate
        float weights."""
        bins, wts = batch_llhist.bin_batch_host(vals, weights)
        with self.lock:
            self.samples_total += int(wts.sum())
            self.clamped_total += int(
                wts[llhist_ref.clamped_mask(vals)].sum())
            self._append_batch((np.asarray(rows, np.int32), bins, wts))
        self._note_applied(len(rows))

    def add_batch_binned(self, rows, bins, wts, clamped: int = 0) -> None:
        """ALREADY-binned samples: the native (C++) parser bins the `l`
        wire type itself, so the hand-off is three int32 columns.
        `clamped` is the parser's count of weight that fell outside the
        bin window. The columns are copied into the pending buffers
        before this returns (a pump chunk's views die at its release)."""
        with self.lock:
            self.samples_total += int(np.sum(wts, dtype=np.int64))
            self.clamped_total += int(clamped)
            self._append_batch((np.asarray(rows, np.int32),
                                np.asarray(bins, np.int32),
                                np.asarray(wts, np.int32)))
        self._note_applied(len(rows))

    def _append_batch(self, columns, touch_rows=None) -> None:
        """Whole-chunk apply (see the class note). Caller holds `lock`;
        touched flags are set in the lock hold that packs or buffers
        their samples."""
        rows, bins, wts = columns
        n = rows.shape[0]
        i = 0
        while self._n + n - i >= self.batch_cap:
            total = self._n + n - i
            take = total - total % self.batch_cap - self._n
            self._launch_locked((rows[i:i + take], bins[i:i + take],
                                 wts[i:i + take]))
            i += take  # the lock was released: re-read the pending fill
        if i < n:
            at, k = self._n, n - i
            self._prow[at:at + k] = rows[i:]
            self._pbin[at:at + k] = bins[i:]
            self._pwt[at:at + k] = wts[i:]
            self.touched[rows[i:]] = True
            self._n = at + k

    def _dispatch_pending_locked(self):
        if self._n:
            self._launch_locked()

    def _launch_locked(self, incoming=()) -> None:
        """Pack the pending samples and the `incoming` (rows, bins, wts)
        columns into one private block in this `lock` hold, with the
        incoming rows marked touched, empty the pending buffer, and apply
        the block to the live state with one copy and one launch, under
        ``apply_lock`` with ``lock`` released (the protocol of
        _BaseTable._dispatch_pending_locked). Caller holds ``lock`` on
        entry and on return."""
        n = self._n
        pieces = [(self._prow[:n], self._pbin[:n], self._pwt[:n])]
        if incoming:
            pieces.append(incoming)
        block = batch_llhist.pack(pieces)
        self._n = 0
        if incoming:
            # intp indices: numpy's int32 fancy-index path is ~2x slower
            self.touched[incoming[0].astype(np.intp)] = True
        self.apply_lock.acquire()
        self.lock.release()
        try:
            # a _grow may have replaced the state: read it under apply_lock
            if self._first_apply_pending:
                self._noted("apply", lambda: self._time_first_apply(
                    lambda: self._apply_block(self.state, block)))
            else:
                self._noted("apply", lambda: self._apply_block(
                    self.state, block))
        finally:
            self.apply_lock.release()
            self.lock.acquire()

    def _swap_locked(self):
        """Copy out the filled part of the pending columns and reset: a
        launch empties the buffers without re-padding them, so
        nothing past the fill point may be read."""
        if self._n == 0:
            return None
        cols = tuple(c[: self._n].copy() for c in self._pcols)
        self._n = 0
        return cols

    def _apply_cols_state(self, state, cols):
        self._apply_block(state, batch_llhist.pack([cols]))

    def _apply_block(self, state, block: np.ndarray) -> None:
        """Apply a private pack()ed block to `state`: one copy, one
        launch of K3."""
        batch_llhist.apply_packed(state, block)

    def _fresh_state_at(self, capacity: int):
        return batch_llhist.init_state(capacity, self.device)

    def _reset_state_(self, captured) -> None:
        captured.zero_()

    def merge_batch(self, stubs: List[UDPMetric], in_bins) -> None:
        """Import-path merge: register add. Interned and touched under
        ``lock``; the state update takes ``apply_lock`` before ``lock`` is
        released."""
        with self.lock:
            rows, ok = self._intern_stubs_locked(stubs)
            padded = batch_llhist.pad_rows_to_device(np.asarray(in_bins)[ok])
            self.samples_total += int(padded.sum(dtype=np.int64))
            self.apply_lock.acquire()
        try:
            if rows.size:
                self._noted("merge", lambda: batch_llhist.merge_rows(
                    self.state, _to_device(rows, self.device),
                    _to_device(padded, self.device)))
        finally:
            self.apply_lock.release()

    def _idle_swap_locked(self, snap: dict) -> bool:
        # every mutation path sets touched, so no pending samples and no
        # touched rows means the state is still the all-zero table the
        # last reset left: skip the swap and the readout
        if self._n == 0 and not self.touched.any():
            snap.update(packed=None, bins_dev=None,
                        touched=self.touched.copy(), meta=list(self.meta))
            return True
        return False

    def _query_readout_device(self, state, snap: dict) -> None:
        # the gathered rows and the readout are fresh tensors; a query
        # that reads no bins copies none to the host
        super()._query_readout_device(state, snap)
        if not snap.get("need_bins"):
            snap["bins_dev"] = None

    def _readout_device(self, state, snap: dict) -> None:
        """Launch the readout over the TOUCHED rows only: gather them
        (18 KB each), then flush_packed on the gathered block. Every
        touched row's output equals a whole-table readout's, and the
        capacity-sized temporaries of the whole-table pass (value-order
        copy, cumsum, float copy) are never made."""
        rows = np.flatnonzero(snap["touched"])
        sel = torch.index_select(
            state, 0, torch.from_numpy(rows).to(self.device))
        self._readout_rows(sel, snap)
        snap["_recycle"] = state

    @staticmethod
    def _readout_rows(block: torch.Tensor, snap: dict) -> None:
        """flush_packed over the touched rows' `block`. A snap that asks
        for `compact` bins keeps the readout's value-ordered registers
        for snapshot_finish's compaction; any other keeps the dense block
        (a query's bins)."""
        compact = bool(snap.get("compact"))
        snap["packed"] = batch_llhist.flush_packed(block, snap["ps"],
                                                   buckets=compact)
        snap["bins_dev"] = None if compact else block

    @staticmethod
    def snapshot_finish(snap: dict):
        """(readout dict of np arrays over the touched rows in ascending
        order, bins in the same order, touched, meta). The bins are int64
        (n_touched, BINS) registers, or for a snap that asked for
        `compact` bins a batch_llhist.CompactBuckets, compacted on the
        device so that only the nonzero bins are copied (the copy's bytes
        go into the snap as `copy_bytes`, its nonzero bins as
        `nonzero_bins`). Unlike the JAX package, whose readout spans every
        row, the readout arrays are compact like the bins."""
        compact = bool(snap.get("compact"))
        if snap["packed"] is None:  # idle-family fast path
            snap.update(copy_bytes=0, nonzero_bins=0)
            empty = np.zeros(0, np.int64)
            bins = (batch_llhist.CompactBuckets.from_device(
                empty, empty, empty) if compact
                else np.zeros((0, llhist_ref.BINS), np.int64))
            return {}, bins, snap["touched"], snap["meta"]
        packed = snap["packed"]
        if compact:
            # popped: the readout's dense registers die with the copy
            dev = batch_llhist.compact_buckets(packed.pop("sorted"))
        out = {k: _host(v) for k, v in packed.items()}
        nbytes = sum(v.nbytes for v in out.values())
        if compact:
            host = [_host(t) for t in dev]
            nbytes += sum(a.nbytes for a in host)
            bins = batch_llhist.CompactBuckets.from_device(*host)
            snap["nonzero_bins"] = int(bins.cum.shape[0])
        elif snap["bins_dev"] is None:  # a query that reads no bins
            bins = np.zeros((0, llhist_ref.BINS), np.int64)
        else:
            dense = _host(snap["bins_dev"][:, :llhist_ref.BINS])
            nbytes += dense.nbytes
            bins = dense.astype(np.int64)
        snap["copy_bytes"] = nbytes
        return out, bins, snap["touched"], snap["meta"]


@dataclass
class StatusEntry:
    value: float = 0.0
    message: str = ""
    hostname: str = ""


class StatusTable(_BaseTable):
    """Service checks: last status + message; host-only (reference
    samplers.go:210-231)."""

    def _init_arrays(self):
        self.values: List[StatusEntry] = []

    def _grow_arrays(self, new_cap):
        pass

    def add(self, metric: UDPMetric) -> bool:
        with self.lock:
            row = self.row_for(metric)
            if row < 0:
                return False
            while len(self.values) <= row:
                self.values.append(StatusEntry())
            self.touched[row] = True
            self.values[row] = StatusEntry(
                value=float(metric.value), message=metric.message,
                hostname=metric.hostname)
        return True

    def apply_pending(self):
        pass

    def snapshot_and_reset(self):
        with self.lock:
            self._note_generation_locked()
            vals = list(self.values)
            touched = self.touched.copy()
            meta = list(self.meta)
            self.values = [StatusEntry() for _ in vals]
            self.touched[:] = False
        return vals, touched, meta


class ColumnStore:
    """The five device families plus host-side status checks, every
    device table on `device` (cuda:0 unless the caller asks for the CPU;
    see device.pick_device).

    `histogram_encoding` chooses the family DogStatsD histogram/timer
    samples aggregate in: "tdigest" (reference parity, approximate
    merges) or "circllhist" (log-linear bins, exact merges). Explicit
    `|l` samples always land in the llhist family.

    With `shard_devices` > 1 the store is partitioned into that many
    shards (core/sharded_tables.py), shard i on the first min(N, C)
    cards' card i mod min(N, C) (one card: every shard on the store's
    device), or over the `shard_groups` devices the caller names, shard i
    in group i mod G: each key's home shard is fixed at mint time from
    its digest and each flush merges the shards, each group on its
    device and the partials on the store's (parallel/collectives.py).
    Digest routing
    shards all five families; `shard_routing="roundrobin"` shards only
    the histogram and set families (rotated batches would break the
    per-key order the scalar families need)."""

    def __init__(self, counter_capacity=1024, gauge_capacity=1024,
                 histo_capacity=1024, set_capacity=256, batch_cap=8192,
                 set_promote_samples=0, set_max_dev_slots=0,
                 llhist_capacity=1024, histogram_encoding="tdigest",
                 max_rows=0, device=None, shard_devices=0,
                 shard_routing="digest", shard_groups=None):
        if histogram_encoding not in ("tdigest", "circllhist"):
            raise ValueError(
                f"unknown histogram_encoding: {histogram_encoding!r}")
        self.histogram_encoding = histogram_encoding
        self.device = dev = pick_device(device)
        from veneur_tpu_torch.parallel.sharded_server import build_plane
        # the caller's placement groups, which a reshard keeps
        self.shard_groups = (None if shard_groups is None
                             else [torch.device(d) for d in shard_groups])
        self.shard_plane = plane = build_plane(shard_devices, dev,
                                               shard_routing,
                                               groups=self.shard_groups)
        if plane is not None and plane.routing == "digest":
            from veneur_tpu_torch.core.sharded_tables import (
                ShardedCounterTable, ShardedGaugeTable, ShardedLLHistTable)
            self.counters = ShardedCounterTable(
                dev, counter_capacity, batch_cap, max_rows, plane=plane)
            self.gauges = ShardedGaugeTable(
                dev, gauge_capacity, batch_cap, max_rows, plane=plane)
            self.llhists = ShardedLLHistTable(
                dev, llhist_capacity, batch_cap, max_rows, plane=plane)
        else:
            self.counters = CounterTable(dev, counter_capacity, batch_cap,
                                         max_rows)
            self.gauges = GaugeTable(dev, gauge_capacity, batch_cap,
                                     max_rows)
            self.llhists = LLHistTable(dev, llhist_capacity, batch_cap,
                                       max_rows)
        if plane is not None:
            from veneur_tpu_torch.core.sharded_tables import (
                ShardedHistoTable, ShardedSetTable)
            self.histos = ShardedHistoTable(
                dev, histo_capacity, batch_cap, max_rows, plane=plane)
            self.sets = ShardedSetTable(
                dev, set_capacity, batch_cap, max_rows, plane=plane)
        else:
            self.histos = HistoTable(dev, histo_capacity, batch_cap,
                                     max_rows)
            self.sets = SetTable(dev, set_capacity, batch_cap,
                                 promote_samples=set_promote_samples,
                                 max_dev_slots=set_max_dev_slots,
                                 max_rows=max_rows)
        self.statuses = StatusTable(dev, batch_cap=batch_cap,
                                    max_rows=max_rows)
        for family, table in self.tables():
            table.family = family
        # samples routed to a table, and samples of a wire type no
        # family takes (neither counts the other)
        self.processed = 0
        self.unknown_rejected = 0
        self._processed_lock = threading.Lock()
        self.ledger = None
        self.deviceobs = None  # set by attach_deviceobs

    def tables(self):
        """(family, table) pairs, every device family plus statuses."""
        return (("counter", self.counters), ("gauge", self.gauges),
                ("histogram", self.histos), ("llhist", self.llhists),
                ("set", self.sets), ("status", self.statuses))

    def count_processed(self, n: int) -> None:
        """Locked sample-count increment (readers race on += otherwise)."""
        with self._processed_lock:
            self.processed += n

    def attach_ledger(self, ledger) -> None:
        """Wire the flow ledger into every table (None detaches)."""
        self.ledger = ledger
        for _family, table in self.tables():
            table.ledger = ledger

    def attach_cardinality(self, accountant) -> None:
        """Wire the cardinality accountant (core/cardinality.py) into
        every table's interning path."""
        for _family, table in self.tables():
            table.cardinality = accountant

    def attach_deviceobs(self, obs) -> None:
        """Wire the device observatory (core/deviceobs.py) into every
        table's generation lifecycle and device calls, register the
        current live generations (and any parked spares) in its HBM
        ledger, and hand it the store for the shard-balance scrapes."""
        self.deviceobs = obs
        obs.attach_store(self)
        for family, table in self.tables():
            table._deviceobs = obs
            with table.apply_lock:
                state = table._devobs_state()
                if state is not None and table._devobs_live is None:
                    table._devobs_live = obs.note_generation(
                        family, "live", state)
                if table._spare is not None \
                        and table._devobs_spare is None:
                    table._devobs_spare = obs.note_generation(
                        family, "spare", table._spare)

    def attach_resize_hook(self, hook) -> None:
        """hook(family, old_cap, new_cap, seconds, kind=, prewarmed=) on
        every capacity doubling (kind "resize") and on the first batch
        apply after it (kind "first_apply"); see _BaseTable.on_resize."""
        for _family, table in self.tables():
            table.on_resize = hook

    def capacity_report(self) -> dict:
        """Per-family capacity and churn for /debug/cardinality (the JAX
        keys the port tracks)."""
        out = {}
        for family, t in self.tables():
            out[family] = {
                "row_capacity": t.capacity,
                "live_rows": len(t.rows),
                "allocated_rows": len(t.meta),
                "free_rows": len(t._free_rows),
                "minted_total": t.minted_total,
                "tombstoned_total": t.tombstoned_total,
                "recycled_total": t.recycled_total,
                "keys_dropped_total": t.keys_dropped,
                "resize_total": t.resize_total,
                "resize_last_seconds": round(t.resize_last_seconds, 6),
                "first_apply_last_seconds": round(
                    t.first_apply_last_seconds, 6),
            }
        return out

    def live_rows_by_name(self) -> Dict[str, dict]:
        """Exact per-name series accounting for /debug/cardinality: each
        table's meta copied under its buffer lock, grouped outside it.
        Proportional to capacity: the operator's drill-down, never the
        hot path."""
        per_name: Dict[str, dict] = {}
        for family, t in self.tables():
            with t.lock:
                metas = list(t.meta)
                touched = t.touched.copy()
            for row, meta in enumerate(metas):
                if meta is None:
                    continue
                entry = per_name.setdefault(
                    meta.name, {"live_rows": 0, "touched_rows": 0,
                                "families": {}})
                entry["live_rows"] += 1
                entry["families"][family] = \
                    entry["families"].get(family, 0) + 1
                if row < touched.shape[0] and touched[row]:
                    entry["touched_rows"] += 1
        return per_name

    def process(self, metric: UDPMetric) -> None:
        """Route one parsed metric to its family table (the equivalent of
        reference worker.go:350-404 ProcessMetric)."""
        t = metric.key.type
        if t == m.COUNTER:
            table = self.counters
        elif t == m.GAUGE:
            table = self.gauges
        elif t in (m.HISTOGRAM, m.TIMER):
            table = (self.llhists if self.histogram_encoding == "circllhist"
                     else self.histos)
        elif t == m.LLHIST:
            table = self.llhists
        elif t == m.SET:
            table = self.sets
        elif t == m.STATUS:
            table = self.statuses
        else:
            with self._processed_lock:
                self.unknown_rejected += 1
            # the sample was admitted by the caller: its drop is
            # explained, or the ledger's ingest identity flags it
            if self.ledger is not None:
                self.ledger.note("agg.rejected", 1, key="unknown")
            return
        # a key the row cap refuses is counted agg.rejected by row_for
        if table.add(metric):
            table._note_applied(1)
        self.count_processed(1)

    def apply_all_pending(self):
        for _family, table in self.tables():
            table.apply_pending()

    def unique_timeseries(self) -> int:
        """The series touched this interval, exact: the tables' touched
        masks (the reference estimates it with an HLL per worker)."""
        total = 0
        for _family, table in self.tables():
            with table.lock:
                total += int(np.count_nonzero(table.touched))
        return total

    def telemetry_rows(self) -> List[tuple]:
        """(name, kind, value, tags) scrape-time rows under the JAX
        package's names, for what the port's tables track: per-family
        row capacity, live and free rows, the keys minted, tombstoned,
        recycled and dropped by the row cap, the batch buffers, the set table's
        promoted slots and the llhist family's sample accounting. Reads
        are lock-free point reads (a torn gauge is one scrape stale)."""
        rows: List[tuple] = []
        for family, t in self.tables():
            tags = [f"family:{family}"]
            rows.append(("columnstore.row_capacity", "gauge",
                         float(t.capacity), tags))
            rows.append(("columnstore.live_rows", "gauge",
                         float(len(t.rows)), tags))
            rows.append(("columnstore.free_rows", "gauge",
                         float(len(t._free_rows)), tags))
            for name, value in (
                    ("keys_minted_total", t.minted_total),
                    ("keys_tombstoned_total", t.tombstoned_total),
                    ("keys_recycled_total", t.recycled_total),
                    ("keys_dropped_total", t.keys_dropped)):
                rows.append((f"columnstore.{name}", "counter",
                             float(value), tags))
            pending = getattr(t, "_n", None)
            if pending is not None:  # statuses have no batch buffers
                rows.append(("columnstore.batch_cap", "gauge",
                             float(t.batch_cap), tags))
                rows.append(("columnstore.pending_samples", "gauge",
                             float(pending), tags))
        nslots = getattr(self.sets, "_nslots", None)
        if nslots is not None:  # the two-tier set table's promoted rows
            rows.append(("columnstore.set_dev_slots", "gauge",
                         float(nslots), ["family:set"]))
        rows.append(("llhist.samples_total", "counter",
                     float(self.llhists.samples_total), ()))
        rows.append(("llhist.clamped_total", "counter",
                     float(self.llhists.clamped_total), ()))
        # the sharded serving plane: topology and per-shard routed
        # volume (parallel/sharded_server.py), absent on a single store
        if self.shard_plane is not None:
            rows.extend(self.shard_plane.telemetry_rows())
        return rows

    def synchronize(self) -> None:
        """Wait for every queued device op of this store's devices (its
        own, and every card its shards are placed on)."""
        devices = {self.device}
        if self.shard_plane is not None:
            devices.update(self.shard_plane.groups)
        for device in devices:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
