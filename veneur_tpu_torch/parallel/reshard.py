"""Elastic resharding: a live digest-range migration with a WAL-backed,
exactly-once cutover (torch port of veneur_tpu/parallel/reshard.py).

Takes a store's sharded plane from N shards to M while ingest keeps
flowing, with no loss the strict flow ledger could see. Three phases:

**plan** — the new digest-range -> home assignment is the contiguous
range partition of M (only the rows of cells whose range bound moved
change home), and the plan thread prewarms the M-shard apply and readout
kernels at the live capacities through the shape-ladder prewarmer
(core/flushexec.py), on throwaway M-shard tables.

**cutover** — under the server's flush lock, after the readouts still
in flight are joined: each family's `reshard_swap` swaps its interval
out, merges its shards into one copy and rebinds the table to the new
plane; the captured rows are written to the WAL as metricpb wire, one
spool segment per migrating digest-range cell, before any of them
merges back; then every segment is decoded and merged into the new
plane through the path crash recovery takes, and popped. Replay as the
only path is what makes the cutover exactly-once: the merged state is
volatile until its segment is popped, and the segments are popped
before the flush lock is released, so a crash anywhere either replays a
segment whose merge died with the process or finds none because the
merge already landed. The flush after the cutover equals a store that
was never resharded: counters exact through the int64 wire, llhist and
HLL registers bit for bit, t-digest centroids recompressed once (the
same count, quantiles within the compression's slack).

**recover** — a crash mid-cutover leaves range segments in the reshard
spool; the next start replays them once into whatever topology that
process builds. A lost device is a forced scale-down through the same
machinery (`device_loss`).

Every shard lives on the store's device, so `device_loss(shard)` is a
reshard to N - 1 shards on that same device, and its capture still reads
the lost shard's state (as the JAX package does on its CPU mesh).

Without `reshard_spool_dir` or `carryover_spool_dir` there is no WAL:
the cutover merges from memory (no loss absent a crash, no crash cover)
and says so loudly. An append fault (a disk error or the chaos seam)
sends only its cell down that path.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from veneur_tpu_torch.core.columnstore import _host
from veneur_tpu_torch.forward import rangewire
from veneur_tpu_torch.parallel import collectives
from veneur_tpu_torch.parallel.sharded_server import (ShardedServingPlane,
                                                      local_shard_devices)
from veneur_tpu_torch.util import chaos as chaos_mod
from veneur_tpu_torch.util.spool import CarryoverSpool

logger = logging.getLogger("veneur_tpu_torch.reshard")

_FULL = 1 << 64

# state machine: idle -> planning -> ready -> cutover -> idle
_STATE_IDS = {"idle": 0.0, "planning": 1.0, "ready": 2.0, "cutover": 3.0}

# the families' encode order: a cell's l-stat sidecar is aligned with its
# histogram frames, so the order is fixed
_FAMILY_ORDER = ("counter", "gauge", "histogram", "llhist", "set")


class ReshardError(Exception):
    """An invalid reshard request (not sharded, a bad target, one already
    in progress)."""


def migration_cells(n_old: int, n_new: int) -> List[dict]:
    """The digest-range cells of an N -> M reshard: the union of both
    partitions' range bounds splits [0, 2^64) into at most N+M-1
    contiguous cells, each with ONE old home and ONE new home."""
    bounds = sorted(set(collectives.range_bounds(n_old))
                    | set(collectives.range_bounds(n_new)))
    cells = []
    for i, lo in enumerate(bounds):
        hi = bounds[i + 1] if i + 1 < len(bounds) else _FULL
        cells.append({
            "lo": lo, "hi": hi,
            "old_home": (lo * n_old) >> 64,
            "new_home": (lo * n_new) >> 64,
        })
    return cells


class _PlanStore:
    """The plan's prewarmer reads a store through .tables() only: the
    throwaway M-shard tables at the live capacities."""

    def __init__(self, tables):
        self._tables = tuple(tables)

    def tables(self):
        return self._tables


class ReshardController:
    """The reshard state machine of one server. `begin` starts the plan
    thread; `cutover` runs under the server's flush lock; `describe` and
    `telemetry_rows` are lock-free point reads."""

    def __init__(self, server):
        self._server = server
        self._lock = threading.Lock()
        self.state = "idle"
        self.epoch = 0
        self.target_shards = 0
        self.deadline_unix = 0.0
        self.last_error = ""
        self.last_cutover_seconds = 0.0
        self.segments_written = 0
        self.replayed_segments = 0
        self.append_faults = 0
        self.capture_failures = 0
        self.device_losses = 0
        self.cutovers = 0
        self._inflight = 0  # rows captured but not yet merged back
        self._thread: Optional[threading.Thread] = None
        self._spool_obj: Optional[CarryoverSpool] = None
        cfg = server.config
        self._deadline_default = float(cfg.reshard_deadline or 30.0)
        d = cfg.reshard_spool_dir
        if not d and cfg.carryover_spool_dir:
            d = os.path.join(cfg.carryover_spool_dir, "reshard")
        self._spool_dir = d
        if not d:
            logger.warning(
                "reshard: no spool directory configured "
                "(reshard_spool_dir and carryover_spool_dir both empty): "
                "cutovers run WITHOUT a WAL, with no loss absent a crash "
                "but a crash mid-cutover loses the migrating interval")

    # -- wiring ----------------------------------------------------------

    def _spool(self) -> Optional[CarryoverSpool]:
        if self._spool_obj is None and self._spool_dir:
            # generous bounds: a range segment holds one interval's
            # migrating rows, and shedding one would be silent loss
            self._spool_obj = CarryoverSpool(
                self._spool_dir, max_bytes=2 * 1024 * 1024 * 1024,
                max_segments=65536, ledger=None)
        return self._spool_obj

    def _ledger(self):
        led = self._server.ledger
        return led if led.enabled else None

    def inflight_metrics(self) -> int:
        """The ledger stock `reshard_inflight`: rows captured out of the
        old topology but not yet merged into the new one. 0 at every
        interval close (the cutover holds the flush lock), so a nonzero
        closing level is itself a conservation break."""
        return self._inflight

    # -- public API ------------------------------------------------------

    def begin(self, shards: Optional[int] = None, devices=None,
              deadline_s: Optional[float] = None,
              block: bool = False) -> dict:
        """Start an elastic reshard to `shards` shards, or onto an
        explicit device list (the placement groups, one shard each
        unless `shards` says more): plan and prewarm on a background
        thread, then cut over at the next flush boundary it can take.
        Without `devices` the target keeps the store's placement: its
        own groups when the caller named them, else the first
        min(shards, C) cards. `block=True` joins, and raises the
        failure."""
        store = self._server.store
        if store.shard_plane is None:
            raise ReshardError("store is not sharded (no serving plane)")
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if not devices:
                raise ReshardError("no devices available for target plane")
            if shards is None:
                shards = len(devices)
        if shards is None or int(shards) < 1:
            raise ReshardError("target shards must be >= 1")
        n = int(shards)
        if devices is None:
            devices = (store.shard_groups if store.shard_groups
                       else local_shard_devices(n, store.device))
        with self._lock:
            if self.state != "idle":
                raise ReshardError(
                    f"reshard already in progress (state={self.state})")
            self.state = "planning"
            self.target_shards = n
            self.last_error = ""
            dl = (float(deadline_s) if deadline_s is not None
                  else self._deadline_default)
            self.deadline_unix = time.time() + dl
        from veneur_tpu_torch.util.crash import guarded
        self._thread = threading.Thread(
            target=guarded(self._run), args=(n, devices),
            name="reshard-plan", daemon=True)
        self._thread.start()
        if block:
            self._thread.join()
            if self.last_error:
                raise ReshardError(self.last_error)
        return self.describe()

    def device_loss(self, shard_index: int,
                    deadline_s: Optional[float] = None,
                    block: bool = False) -> dict:
        """A forced scale-down after losing one shard's device: a reshard
        to N - 1 shards over the placement groups other than the lost
        shard's (over the one group itself when every shard shares it),
        through the plan and cutover.

        The capture still reads the lost shard's state: on a host whose
        card was really lost, reading it would raise before the cutover
        and the reshard would fail, so the drill saves every shard; the
        JAX package's drill on its CPU mesh reads it too."""
        plane = self._server.store.shard_plane
        if plane is None:
            raise ReshardError("store is not sharded (no serving plane)")
        index = int(shard_index)
        survivors = plane.n - (1 if 0 <= index < plane.n else 0)
        if survivors < 1:
            raise ReshardError("no surviving devices")
        groups = list(plane.groups)
        if 0 <= index < plane.n and len(groups) > 1:
            del groups[index % len(groups)]
        self.device_losses += 1
        logger.error("device loss on shard %d/%d: forcing scale-down to %d "
                     "shards on %d devices", index, plane.n, survivors,
                     len(groups))
        return self.begin(survivors, devices=groups, deadline_s=deadline_s,
                          block=block)

    def past_deadline(self) -> bool:
        return (self.state != "idle" and self.deadline_unix > 0
                and time.time() > self.deadline_unix)

    def describe(self) -> dict:
        plane = self._server.store.shard_plane
        return {
            "state": self.state,
            "epoch": self.epoch,
            "shards": plane.n if plane is not None else 0,
            "target_shards": self.target_shards,
            "deadline_unix": round(self.deadline_unix, 3),
            "past_deadline": self.past_deadline(),
            "durable": bool(self._spool_dir),
            "spool_dir": self._spool_dir,
            "cutovers": self.cutovers,
            "last_cutover_seconds": round(self.last_cutover_seconds, 6),
            "segments_written": self.segments_written,
            "replayed_segments": self.replayed_segments,
            "append_faults": self.append_faults,
            "capture_failures": self.capture_failures,
            "device_losses": self.device_losses,
            "inflight_metrics": self._inflight,
            "last_error": self.last_error,
        }

    def telemetry_rows(self) -> List[tuple]:
        return [
            ("reshard.state", "gauge", _STATE_IDS.get(self.state, -1.0),
             (f"state:{self.state}",)),
            ("reshard.epoch", "counter", float(self.epoch), ()),
            ("reshard.cutovers", "counter", float(self.cutovers), ()),
            ("reshard.last_cutover_seconds", "gauge",
             self.last_cutover_seconds, ()),
            ("reshard.segments_written", "counter",
             float(self.segments_written), ()),
            ("reshard.replayed_segments", "counter",
             float(self.replayed_segments), ()),
            ("reshard.append_faults", "counter",
             float(self.append_faults), ()),
            ("reshard.capture_failures", "counter",
             float(self.capture_failures), ()),
            ("reshard.device_losses", "counter",
             float(self.device_losses), ()),
            ("reshard.inflight_metrics", "gauge",
             float(self._inflight), ()),
        ]

    # -- plan ------------------------------------------------------------

    def _run(self, n: int, devices) -> None:
        try:
            chaos = self._server.chaos
            if chaos is not None:
                chaos.reshard_prewarm_delay()
            plane = ShardedServingPlane(n, self._server.store.device,
                                        groups=devices)
            self._prewarm(plane)
            with self._lock:
                self.state = "ready"
            self.cutover(plane)
        except Exception as e:
            logger.exception("reshard to %d shards failed", n)
            self.last_error = f"{type(e).__name__}: {e}"
            with self._lock:
                self.state = "idle"
        finally:
            self.deadline_unix = 0.0
            self.target_shards = 0

    def _prewarm(self, plane: ShardedServingPlane) -> None:
        """Launch the M-shard apply and readout kernels once on throwaway
        tables at the LIVE capacities, so the caching allocator holds
        blocks of those sizes before the rebound tables ask for them. A
        failure costs the first apply's allocations, not the reshard."""
        from veneur_tpu_torch.core import sharded_tables as st
        from veneur_tpu_torch.core.flushexec import ShapeLadderPrewarmer
        classes = {
            "counter": st.ShardedCounterTable,
            "gauge": st.ShardedGaugeTable,
            "histogram": st.ShardedHistoTable,
            "llhist": st.ShardedLLHistTable,
            "set": st.ShardedSetTable,
        }
        server = self._server
        shim_tables = []
        for family, table in server.store.tables():
            cls = classes.get(family)
            if cls is None:
                continue
            try:
                shim_tables.append((family, cls(
                    plane.device, capacity=table.capacity,
                    batch_cap=table.batch_cap, plane=plane)))
            except Exception:
                logger.exception(
                    "reshard plan: throwaway %s table build failed (the "
                    "first apply pays the allocation)", family)
        if not shim_tables:
            return
        pw = ShapeLadderPrewarmer(
            _PlanStore(shim_tables), percentiles=server.percentiles,
            need_export=(server.config.is_local
                         and server.forward_client is not None),
            on_event=server.telemetry.record_event)
        pw.start()
        for family, table in shim_tables:
            pw._enqueue(family, table.capacity)
        # stop() queues its sentinel after the rungs, so every rung runs
        # before the thread ends (or the deadline abandons it)
        pw.stop(timeout=max(1.0, self.deadline_unix - time.time()))

    # -- cutover ---------------------------------------------------------

    def cutover(self, plane: ShardedServingPlane) -> None:
        """The topology swap. The join, swaps, capture, WAL append,
        merge-back and segment pops all run under the server's flush
        lock, so no flush delivers half-migrated state and the
        popped-segment invariant holds (module note)."""
        server = self._server
        chaos = server.chaos
        t0 = time.perf_counter()
        with self._lock:
            self.state = "cutover"
        try:
            with server._flush_lock:
                # join the readouts in flight first: a pending readout
                # applies its staged columns through the LIVE routing,
                # which the rebinding replaces; a future keeps its
                # result, so the flush's own join re-reads it
                for rec in list(server._inflight_flushes):
                    pending = rec.get("pending")
                    if pending is not None:
                        try:
                            pending.result(timeout=120.0)
                        except Exception:
                            logger.exception(
                                "reshard: an in-flight readout's join "
                                "failed; its interval takes the readout "
                                "miss path")
                store = server.store
                n_old = store.shard_plane.n
                n_new = plane.n
                snaps: Dict[str, dict] = {}
                for family, table in store.tables():
                    if not hasattr(table, "reshard_swap"):
                        continue  # host-only families (statuses)
                    try:
                        snaps[family] = table.reshard_swap(plane)
                    except Exception:
                        self.capture_failures += 1
                        logger.exception(
                            "reshard: %s capture failed; the family "
                            "restarts empty on the new plane (its "
                            "interval so far is lost)", family)
                store.shard_plane = plane
                cells = self._encode_cells(snaps, n_old, n_new)
                self._wal_and_merge(cells, chaos)
                # the captured old-topology generations are dead: their
                # `reshard_capture` ledger tokens go
                for family, table in store.tables():
                    snap = snaps.get(family)
                    obs = table._deviceobs
                    if snap is not None and obs is not None:
                        obs.drop(snap.pop("_devobs", None))
                self.epoch += 1
                self.cutovers += 1
        finally:
            self.last_cutover_seconds = time.perf_counter() - t0
            with self._lock:
                self.state = "idle"
        logger.info("reshard cutover complete: %d -> %d shards, epoch %d, "
                    "%.3fs", n_old, n_new, self.epoch,
                    self.last_cutover_seconds)
        server.telemetry.record_event(
            "reshard_cutover", shards_old=n_old, shards_new=n_new,
            epoch=self.epoch, duration_s=round(self.last_cutover_seconds, 6))

    # -- capture encode --------------------------------------------------

    def _encode_cells(self, snaps: Dict[str, dict], n_old: int,
                      n_new: int) -> List[dict]:
        """Every touched captured row as a frame of its digest-range
        cell. ALL touched rows are encoded, zero-total counters too:
        touched rows emit at flush, so the flush after the cutover must
        see the row set a store never resharded would."""
        cells = migration_cells(n_old, n_new)
        for cell in cells:
            cell["frames"] = []
            cell["histo_l"] = {k: [] for k in rangewire.LSTAT_FIELDS}
            cell["count"] = 0
        bounds = np.array([c["lo"] for c in cells], np.uint64)

        def rows_and_cells(snap):
            touched = snap["touched"]
            meta = snap["meta"]
            limit = min(touched.shape[0], len(meta))
            rows = np.flatnonzero(touched[:limit])
            idx = np.searchsorted(bounds, snap["digest64"][rows],
                                  side="right") - 1
            return rows.tolist(), idx.tolist(), meta

        def compact(snap, key):
            # the llhist and set captures hold the touched rows only, in
            # ascending order: a row's place among them
            rows, idx, meta = rows_and_cells(snap)
            at = np.searchsorted(snap[key + "_rows"], rows).tolist()
            return rows, idx, meta, at

        for family in _FAMILY_ORDER:
            snap = snaps.get(family)
            if snap is None:
                continue
            if family == "counter" and "dev" in snap:
                values = (_host(snap["dev"][0]).astype(np.float64)
                          - _host(snap["dev"][1]).astype(np.float64))
                acc = snap.get("import_acc")
                if acc is not None:
                    values[:acc.shape[0]] += acc
                rows, idx, meta = rows_and_cells(snap)
                for row, c in zip(rows, idx):
                    cells[c]["frames"].append(rangewire.counter_to_wire(
                        meta[row], values[row]))
                    cells[c]["count"] += 1
            elif family == "gauge" and "dev" in snap:
                values = _host(snap["dev"]).astype(np.float64)
                rows, idx, meta = rows_and_cells(snap)
                for row, c in zip(rows, idx):
                    cells[c]["frames"].append(rangewire.gauge_to_wire(
                        meta[row], values[row]))
                    cells[c]["count"] += 1
            elif family == "histogram" and "hstate" in snap:
                h = {k: _host(v) for k, v in snap["hstate"].items()}
                weights = h["weights"]
                means = np.divide(h["wv"], weights,
                                  out=np.zeros_like(weights),
                                  where=weights > 0)
                rows, idx, meta = rows_and_cells(snap)
                for row, c in zip(rows, idx):
                    cells[c]["frames"].append(rangewire.histogram_to_wire(
                        meta[row], means[row], weights[row],
                        h["dmin"][row], h["dmax"][row], h["drecip"][row]))
                    cells[c]["count"] += 1
                    for k in rangewire.LSTAT_FIELDS:
                        cells[c]["histo_l"][k].append(float(h[k][row]))
            elif family == "llhist" and "bins" in snap:
                bins = _host(snap["bins"])
                rows, idx, meta, at = compact(snap, "bins")
                for row, c, i in zip(rows, idx, at):
                    cells[c]["frames"].append(rangewire.llhist_to_wire(
                        meta[row], bins[i]))
                    cells[c]["count"] += 1
            elif family == "set" and "regs" in snap:
                regs = _host(snap["regs"])
                rows, idx, meta, at = compact(snap, "regs")
                for row, c, i in zip(rows, idx, at):
                    cells[c]["frames"].append(rangewire.set_to_wire(
                        meta[row], regs[i]))
                    cells[c]["count"] += 1
        out = []
        for cell in cells:
            if not cell["frames"]:
                continue
            if cell["histo_l"]["lsum"]:
                cell["frames"].append(
                    rangewire.lstat_sidecar(cell["histo_l"]))
            out.append(cell)
        return out

    # -- WAL + merge-back ------------------------------------------------

    def _wal_and_merge(self, cells: List[dict], chaos) -> None:
        spool = self._spool()
        token = f"reshard-{self.epoch + 1:06d}"
        self._inflight = sum(cell["count"] for cell in cells)
        mem_cells: List[List[bytes]] = []
        for i, cell in enumerate(cells):
            if spool is None:
                mem_cells.append(cell["frames"])
                continue
            try:
                if chaos is not None:
                    chaos.reshard_append_seam()
                spool.append(cell["frames"], extra={
                    "kind": "reshard", "token": token, "cell": i,
                    "lo": str(cell["lo"]), "hi": str(cell["hi"]),
                    "old_home": cell["old_home"],
                    "new_home": cell["new_home"],
                    "count": cell["count"]})
                self.segments_written += 1
            except (chaos_mod.ChaosError, OSError) as e:
                self.append_faults += 1
                logger.error(
                    "reshard: range segment append failed (%s); cell %d "
                    "merges from memory, with no loss absent a crash but "
                    "no crash cover", e, i)
                mem_cells.append(cell["frames"])
        # the widest crash window: every durable cell is on disk and the
        # rebound tables are empty; a crash here must replay to the state
        # the merge below makes
        if chaos is not None:
            chaos.reshard_cutover_delay()
        if spool is not None:
            for seg in spool.segments():
                extra = seg.extra or {}
                if extra.get("kind") != "reshard":
                    continue
                batch = rangewire.decode_segment(seg.read_metrics())
                self._merge_decoded(batch)
                spool.pop(seg)
        for frames in mem_cells:
            self._merge_decoded(rangewire.decode_segment(frames))
        self._inflight = 0

    def _merge_decoded(self, batch: rangewire.DecodedBatch) -> int:
        """Merge one decoded range segment into the live tables: the one
        replay path of the cutover's merge-back and of crash recovery.
        Each family batch stamps ingest.admitted (key reshard) and its
        merge_batch agg.applied (or agg.rejected for a row the caps
        refuse), so the ingest identity balances within the interval."""
        store = self._server.store
        led = self._ledger()

        def admit(n: int) -> None:
            if led is not None and n:
                led.note("ingest.admitted", n, key="reshard")

        merged = 0
        if batch.counter_stubs:
            admit(len(batch.counter_stubs))
            store.counters.merge_batch(batch.counter_stubs,
                                       batch.counter_values)
            merged += len(batch.counter_stubs)
        if batch.gauge_stubs:
            admit(len(batch.gauge_stubs))
            store.gauges.merge_batch(batch.gauge_stubs, batch.gauge_values)
            merged += len(batch.gauge_stubs)
        if batch.histo_stubs:
            from veneur_tpu_torch.ops import batch_tdigest
            admit(len(batch.histo_stubs))
            pm, pw = batch_tdigest.pack_centroids_many(
                batch.histo_means, batch.histo_weights)
            store.histos.merge_batch(
                batch.histo_stubs, pm, pw, batch.histo_mins,
                batch.histo_maxs, batch.histo_recips)
            if batch.lstats is not None:
                if hasattr(store.histos, "merge_local_stats"):
                    store.histos.merge_local_stats(
                        batch.histo_stubs,
                        *(batch.lstats[k] for k in rangewire.LSTAT_FIELDS))
                else:
                    logger.warning(
                        "reshard replay: the store has no sharded "
                        "histogram table; the migrated local-sample stats "
                        "(min/max/sum) are dropped")
            merged += len(batch.histo_stubs)
        if batch.llhist_stubs:
            admit(len(batch.llhist_stubs))
            store.llhists.merge_batch(batch.llhist_stubs,
                                      np.stack(batch.llhist_bins))
            merged += len(batch.llhist_stubs)
        if batch.set_stubs:
            admit(len(batch.set_stubs))
            store.sets.merge_batch(batch.set_stubs, np.stack(batch.set_regs))
            merged += len(batch.set_stubs)
        if batch.parse_errors:
            logger.error("reshard replay: %d unparseable frames dropped",
                         batch.parse_errors)
        return merged

    # -- recovery --------------------------------------------------------

    def recover(self) -> int:
        """Replay the range segments a killed predecessor left. Runs at
        start, before the listeners: the rows merge into whatever
        topology THIS process built (the WAL holds rows, not homes, and
        merge_batch routes them anew), so recovery is right even when
        the restart's shard count differs from the crashed target."""
        spool = self._spool()
        if spool is None:
            return 0
        replayed = 0
        for seg in spool.segments():
            extra = seg.extra or {}
            if extra.get("kind") != "reshard":
                continue
            try:
                batch = rangewire.decode_segment(seg.read_metrics())
                self._merge_decoded(batch)
            except Exception:
                logger.exception("reshard recovery: segment %s replay "
                                 "failed; left in place", seg.path)
                continue
            spool.pop(seg)
            replayed += 1
            self.replayed_segments += 1
        if replayed:
            logger.warning("reshard recovery: replayed %d range segment(s) "
                           "of an interrupted cutover", replayed)
            self._server.telemetry.record_event("reshard_replay",
                                                segments=replayed)
        return replayed
