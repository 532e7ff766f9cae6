"""The column store partitioned into shards (torch port of
veneur_tpu/core/sharded_tables.py).

One host intern table, and the interval state of every device family
split into N shards over the plane's placement groups (shard i in group
i mod G, on that group's device; parallel/sharded_server.py):

  counters    (N, K) Kahan pairs      merge = sum over shards (selection)
  gauges      (N, K) LWW + set mask   merge = masked sum + any
  llhists     (N, K, BINS) int32      merge = register add (exact)
  histograms  N per-shard digests     merge = concat + recompress
  sets        N per-shard HLL banks   merge = register max

Routing is digest-home by default: a key's 64-bit fnv1a digest picks its
home shard at mint time (parallel/sharded_server.py), and every sample,
batch and import merge for that key lands there. Gauges keep
last-write-wins order (a key's writes all go to one shard), and counter
pairs and llhist and HLL registers merge by selection, so the flush
equals a single table's over the same stream. `shard_routing:
roundrobin` rotates whole batches over the shards for the histogram and
set families; the scalar and llhist families then stay single tables.

A stacked family keeps one (n_j, K, ...) state per group (the state
itself with one group, the list of them with several) and applies each
batch's samples of a group with its single-table op on the group's flat
view (parallel/collectives.py): the llhist apply is kernel K3 on rows
`local * K + row`, one launch per pack()ed block and group, on the
group's device. The per-shard families apply each shard's samples to
its own state, created on its shard's device. Each flush readout merges
the shards, each group on its device and the partials on the store's;
the stacked merges zero the drained generation in place after the
merged copy (the JAX package's fused donated merge + reset), and the
merged t-digest and HLL states feed K1 and K2 on the store's device. A
live query merges without zeroing.

The elastic reshard (parallel/reshard.py) swaps each family out with
`reshard_swap`: the interval's generation is swapped and its final
pending columns folded on the old topology, the shards are merged into
one copy that is not reset (the query-path merges, over the touched rows
for the llhist and set banks), and the table is rebound to the new
plane with every row's home recomputed and fresh state. Each rebinding
bumps the table's topology epoch, which swap_out and capture_readonly
stamp: a readout swapped out before a cutover recycles nothing into the
new plane, and a query that straddles one retries.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from veneur_tpu_torch.core.columnstore import (
    PAD_ROW, CounterTable, GaugeTable, HistoTable, LLHistTable, SetTable,
    _BaseTable, _pad_cap, _SetRegisters, _to_device)
from veneur_tpu_torch.ops import batch_hll, batch_llhist, batch_tdigest, \
    hll_ref, scalars
from veneur_tpu_torch.parallel import collectives
from veneur_tpu_torch.parallel.sharded_server import (ROUTING_DIGEST,
                                                      ShardedServingPlane)

__all__ = [
    "ShardedCounterTable", "ShardedGaugeTable", "ShardedHistoTable",
    "ShardedLLHistTable", "ShardedSetTable",
]


class _DigestRouted:
    """Mixin: per-row home-shard assignment, shared by every sharded
    family table. Initialised BEFORE _BaseTable.__init__ (whose
    _init_arrays builds the shards' state)."""

    def _routing_init(self, device, capacity: int,
                      plane: ShardedServingPlane) -> None:
        device = torch.device(device)
        if plane.device != device:
            raise ValueError(f"the shards merge on {plane.device}, the "
                             f"table lives on {device}")
        self._plane = plane
        self._n_shards = plane.n
        # row -> home shard, stamped at mint time (_note_minted)
        self._shard_of = np.zeros(capacity, np.int8)
        self._rr_next = 0  # roundrobin mode's rotation cursor
        # bumped by every reshard cutover (_retopo_locked): snaps carry
        # the epoch they were taken under
        self._topo_epoch = 0

    @property
    def _digest_routed(self) -> bool:
        return self._plane.routing == ROUTING_DIGEST

    def _note_minted(self, row: int, metric) -> None:
        if row < self._shard_of.shape[0]:
            self._shard_of[row] = self._plane.home(metric.digest64)

    def _grow_shard_of(self, new_cap: int) -> None:
        grown = np.zeros(new_cap, np.int8)
        grown[: self._shard_of.shape[0]] = self._shard_of
        self._shard_of = grown

    def _home_of(self, rows: np.ndarray) -> np.ndarray:
        """(batch,) rows -> home shard per sample, -1 for a row outside
        the table (padding)."""
        rows = np.asarray(rows, np.int64)
        shard_of = self._shard_of
        ok = (rows >= 0) & (rows < shard_of.shape[0])
        return np.where(ok, shard_of[np.where(ok, rows, 0)],
                        -1).astype(np.int32)

    def _shard_counts_of(self, home: np.ndarray) -> np.ndarray:
        return np.bincount(home[home >= 0],
                           minlength=self._n_shards).astype(np.int64)

    def _merge_noted(self, merge):
        """Run one collective merge of a flush readout, booked as a
        `merge` row of the kernel registry, and count the merge round."""
        out = self._noted("merge", merge)
        self._plane.note_merge_round()
        return out

    def _group_cols(self, state, rows, note: bool = True):
        """A batch's samples cut by placement group: (group state, its
        device, int32 rows of the group's flat view, the mask selecting
        the group's samples or None for all) for each group with a
        sample. The per-shard sample counts fold into the plane unless
        `note` is off (a prewarm rung's all-padding batch)."""
        home = self._home_of(rows)
        if note:
            self._plane.note_routed(self.family,
                                    self._shard_counts_of(home))
        states = collectives.groups_of(state)
        state_rows = _key_rows(states[0])
        out = []
        for g, local, sel in self._plane.split(home):
            out.append((states[g], self._plane.groups[g],
                        collectives.flat_rows(
                            local, rows if sel is None else rows[sel],
                            state_rows), sel))
        return out

    def _sync_devices(self) -> None:
        for device in {self.device, *self._plane.groups}:
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    # -- elastic reshard (parallel/reshard.py) ---------------------------

    def swap_out(self, **kw) -> dict:
        snap = super().swap_out(**kw)
        snap["_topo_epoch"] = self._topo_epoch
        return snap

    def capture_readonly(self, **kw) -> dict:
        snap = super().capture_readonly(**kw)
        snap["topo_epoch"] = self._topo_epoch
        return snap

    def recycle(self, snap: dict) -> None:
        if snap.pop("_topo_epoch", self._topo_epoch) != self._topo_epoch:
            # swapped out under the old topology, read out after a
            # cutover rebound this table: its (N_old, ...) generation
            # must never become a spare of the new plane
            for key in ("cap", "_spare", "_recycle"):
                snap.pop(key, None)
            obs = self._deviceobs
            if obs is not None:
                obs.drop(snap.pop("_devobs", None))
            return
        super().recycle(snap)

    def _row_digests(self) -> np.ndarray:
        """Every row's 64-bit key digest (rows-dict keys are
        (digest64 << 2) | scope), sized like `touched` (caller holds
        ``lock``)."""
        keys = self._dict_key_of[: self.touched.shape[0]]
        digests = np.zeros(self.touched.shape[0], np.uint64)
        digests[: len(keys)] = np.fromiter(
            ((k >> 2) & 0xFFFFFFFFFFFFFFFF for k in keys), np.uint64,
            len(keys))
        return digests

    def reshard_swap(self, new_plane: ShardedServingPlane, **kw) -> dict:
        """The per-family cutover step, in one hold of ``lock`` then
        ``apply_lock``: swap the interval's generation out as a flush
        does (its final pending columns folded on the old topology),
        merge its shards into one copy that is not reset
        (`_reshard_capture_device`: the query-path merges, so the values
        are those a flush would emit), and rebind the table to
        `new_plane` (`_retopo_locked`). Ingest after the locks release
        lands on the new plane; everything before is in the returned
        snap, which the controller writes to the WAL and merges back
        through the family's merge_batch."""
        snap = dict(kw)
        with self.lock:
            idle = self._idle_swap_locked(snap)
            if not idle:
                snap["cols"] = self._swap_locked()
            with self.apply_lock:
                if not idle:
                    self._note_generation_locked()
                    snap["touched"] = self.touched.copy()
                    snap["meta"] = list(self.meta)
                    snap["digest64"] = self._row_digests()
                    self.touched[:] = False
                    self._swap_extras_locked(snap)
                    state = self._swap_device_locked()
                    cols = snap.pop("cols", None)
                    if cols is not None:
                        self._readout_apply(state, cols, snap)
                    snap.pop("staged", None)
                    self._reshard_capture_device(state, snap)
                    # the old topology's generation stays booked until
                    # the controller's merge-back is done
                    obs = self._deviceobs
                    if obs is not None:
                        tok = self._devobs_inflight
                        self._devobs_inflight = None
                        obs.retag(tok, "reshard_capture")
                        snap["_devobs"] = tok
                self._retopo_locked(new_plane)
        snap["_topo_epoch"] = self._topo_epoch
        return snap

    def _reshard_capture_device(self, state, snap: dict) -> None:
        """Family hook: the captured generation's shards merged into one
        copy that is not reset (caller holds both locks)."""
        raise NotImplementedError

    def _retopo_locked(self, plane: ShardedServingPlane) -> None:
        """Rebind this table to `plane` (caller holds ``lock`` and
        ``apply_lock``): every live row's home under the new range
        partition, fresh state on the new placement groups, and the old
        topology's spare and prewarmed rungs forgotten."""
        if plane.device != self.device:
            raise ValueError(f"the shards merge on {plane.device}, the "
                             f"table lives on {self.device}")
        self._plane = plane
        self._n_shards = plane.n
        self._rr_next = 0
        shard_of = np.zeros(self._shard_of.shape[0], np.int8)
        if self.rows:
            digests = np.fromiter(
                ((k >> 2) & 0xFFFFFFFFFFFFFFFF for k in self.rows),
                np.uint64, len(self.rows))
            rows = np.fromiter(self.rows.values(), np.int64, len(self.rows))
            ok = rows < shard_of.shape[0]
            shard_of[rows[ok]] = plane.homes(digests[ok])
        self._shard_of = shard_of
        self._spare = None
        self._spare_cap = -1
        obs = self._deviceobs
        if obs is not None:
            # the parked spare dies with the old topology, and so does
            # the live generation an idle cutover never swapped
            obs.drop(self._devobs_spare)
            self._devobs_spare = None
            obs.drop(self._devobs_live)
            self._devobs_live = None
        self._prewarmed_caps = set()
        self._topo_epoch += 1
        self._retopo_device_locked()
        if obs is not None:
            self._devobs_live = obs.note_generation(
                self.family, "live", self._devobs_state())

    def _retopo_device_locked(self) -> None:
        # stacked families: a fresh (M, K, ...) generation
        self.state = self._fresh_state_at(self._state_capacity())


def _key_rows(group_state) -> int:
    """The key axis of a group's stacked state (a tensor or a dict)."""
    if isinstance(group_state, dict):
        group_state = next(iter(group_state.values()))
    return group_state.shape[1]


def _take(col: np.ndarray, sel):
    return col if sel is None else col[sel]


class _Stacked:
    """The stacked families' drained-generation reset over the groups."""

    def _reset_state_(self, captured) -> None:
        collectives.zero_(captured)


# ---------------------------------------------------------------------------
# Stacked families: one (N, K, ...) state, the single-table op on its flat
# view per dispatch, a sum over shards at flush.
# ---------------------------------------------------------------------------


class ShardedCounterTable(_Stacked, _DigestRouted, CounterTable):
    """CounterTable partitioned into shards: each key's deltas accumulate
    in its home shard's Kahan pair; the flush merge is a sum over shards,
    pure selection under digest routing, so the f64 host readout equals a
    single table's."""

    def __init__(self, device, capacity: int = 1024, batch_cap: int = 8192,
                 max_rows: int = 0, *, plane: ShardedServingPlane):
        self._routing_init(device, capacity, plane)
        super().__init__(device, capacity, batch_cap, max_rows)

    def _fresh_state_at(self, capacity: int):
        return collectives.init_stacked(scalars.init_counters, self._plane,
                                        capacity)

    def _grow_arrays(self, new_cap):
        self._grow_shard_of(new_cap)
        self.state = collectives.grow_stacked(self.state, new_cap)

    def _apply_cols_state(self, state, cols, note: bool = True):
        rows, vals, rates = cols
        for gstate, device, flat, sel in self._group_cols(state, rows,
                                                          note):
            collectives.apply_counters_sharded(gstate, *(
                _to_device(c, device)
                for c in (flat, _take(vals, sel), _take(rates, sel))))

    def _prewarm_apply(self, state, cols, capacity: int) -> None:
        self._apply_cols_state(state, cols, note=False)

    def _readout_device(self, state, snap: dict) -> None:
        """The merged pair, and the drained generation zeroed in place
        after it as the next interval's spare."""
        snap["dev"] = self._merge_noted(
            lambda: collectives.merge_counters_stacked_reset(state,
                                                             self.device))
        snap["_spare"] = state

    def _query_readout_device(self, state, snap: dict) -> None:
        # the same sum over the LIVE generation, without zeroing it; its
        # outputs are fresh tensors no apply writes
        snap["dev"] = collectives.merge_counters_stacked(state, self.device)
        self._plane.note_merge_round()

    def _prewarm_readout(self, state, snap: dict) -> None:
        collectives.merge_counters_stacked_reset(state, self.device)

    def _reshard_capture_device(self, state, snap: dict) -> None:
        # the (sum, comp) pair a flush differences; counter totals are
        # integral, so the f64 total crosses the int64 wire exactly
        snap["dev"] = collectives.merge_counters_stacked(state, self.device)
        self._plane.note_merge_round()


class ShardedGaugeTable(_Stacked, _DigestRouted, GaugeTable):
    """GaugeTable partitioned into shards. Digest-home routing keeps
    last-write-wins: every write of a key goes to its home shard, in
    buffer order."""

    def __init__(self, device, capacity: int = 1024, batch_cap: int = 8192,
                 max_rows: int = 0, *, plane: ShardedServingPlane):
        self._routing_init(device, capacity, plane)
        super().__init__(device, capacity, batch_cap, max_rows)

    def _fresh_state_at(self, capacity: int):
        return collectives.init_stacked(scalars.init_gauges, self._plane,
                                        capacity)

    def _grow_arrays(self, new_cap):
        self._grow_shard_of(new_cap)
        self.state = collectives.grow_stacked(self.state, new_cap)

    def _apply_cols_state(self, state, cols, note: bool = True):
        rows, vals = cols
        for gstate, device, flat, sel in self._group_cols(state, rows,
                                                          note):
            collectives.apply_gauges_sharded(gstate, *(
                _to_device(c, device) for c in (flat, _take(vals, sel))))

    def _prewarm_apply(self, state, cols, capacity: int) -> None:
        self._apply_cols_state(state, cols, note=False)

    def merge_batch(self, stubs, values) -> None:
        """Import-path overwrite, each stub on its home shard's row; the
        state update takes ``apply_lock`` before ``lock`` is released,
        as in GaugeTable."""
        with self.lock:
            rows, ok = self._intern_stubs_locked(stubs)
            self.apply_lock.acquire()
        try:
            if rows.size:
                vals = np.asarray(values, np.float32)[ok]

                def merge():
                    for gstate, device, flat, sel in self._group_cols(
                            self.state, rows, note=False):
                        collectives.merge_gauges_sharded(
                            gstate, _to_device(flat, device),
                            _to_device(_take(vals, sel), device))
                self._noted("merge", merge)
        finally:
            self.apply_lock.release()

    def _readout_device(self, state, snap: dict) -> None:
        snap["dev"], _set = self._merge_noted(
            lambda: collectives.merge_gauges_stacked_reset(state,
                                                           self.device))
        snap["_spare"] = state

    def _query_readout_device(self, state, snap: dict) -> None:
        snap["dev"], _set = collectives.merge_gauges_stacked(state,
                                                             self.device)
        self._plane.note_merge_round()

    def _prewarm_readout(self, state, snap: dict) -> None:
        collectives.merge_gauges_stacked_reset(state, self.device)

    def _reshard_capture_device(self, state, snap: dict) -> None:
        # the home shard's last write; the set mask rides along
        snap["dev"], snap["set"] = collectives.merge_gauges_stacked(
            state, self.device)
        self._plane.note_merge_round()


class ShardedLLHistTable(_Stacked, _DigestRouted, LLHistTable):
    """LLHistTable partitioned into shards: an (n_j, K, BINS_PAD) int32
    register bank per placement group. Each pack()ed block's rows become
    rows of a group's flat (n_j*K, BINS_PAD) view, `local * K + row`, and
    each group's samples are applied with one copy and one launch of K3
    on its device, padding (row -1) still dropped; with one group that is
    the whole block in one launch. The flush merges the touched rows with
    a register add over shards: integer addition, so registers,
    percentiles, counts, sums and buckets equal a single table's."""

    def __init__(self, device, capacity: int = 1024, batch_cap: int = 8192,
                 max_rows: int = 0, *, plane: ShardedServingPlane):
        self._routing_init(device, capacity, plane)
        super().__init__(device, capacity, batch_cap, max_rows)

    def _fresh_state_at(self, capacity: int):
        return collectives.init_stacked(batch_llhist.init_state,
                                        self._plane, capacity)

    def _grow_arrays(self, new_cap):
        self._grow_shard_of(new_cap)
        self.state = collectives.grow_stacked(self.state, new_cap)

    def _apply_block(self, state, block: np.ndarray,
                     note: bool = True) -> None:
        groups = self._group_cols(state, block[0], note)
        if len(groups) == 1 and groups[0][3] is None:
            # one group: the block is private (pack), its row column
            # becomes the flat rows and it goes over in one copy
            gstate, _device, flat, _sel = groups[0]
            block[0] = flat
            collectives.apply_llhist_block_sharded(gstate, block)
            return
        for gstate, _device, flat, sel in groups:
            collectives.apply_llhist_block_sharded(gstate, batch_llhist.pack(
                [(flat, block[1][sel], block[2][sel])]))

    def _prewarm_apply(self, state, cols, capacity: int) -> None:
        self._apply_block(state, batch_llhist.pack([cols]), note=False)

    def merge_batch(self, stubs, in_bins) -> None:
        """Import-path register add, each incoming row on its home
        shard."""
        with self.lock:
            rows, ok = self._intern_stubs_locked(stubs)
            padded = batch_llhist.pad_rows_to_device(np.asarray(in_bins)[ok])
            self.samples_total += int(padded.sum(dtype=np.int64))
            home = self._home_of(rows)
            self.apply_lock.acquire()
        try:
            if rows.size:
                def merge():
                    states = collectives.groups_of(self.state)
                    for g, local, sel in self._plane.split(home):
                        device = self._plane.groups[g]
                        collectives.merge_llhist_rows_at(
                            states[g], _to_device(local, device),
                            _to_device(_take(rows, sel), device),
                            _to_device(_take(padded, sel), device))
                self._noted("merge", merge)
        finally:
            self.apply_lock.release()

    def _touched_rows(self, snap: dict) -> torch.Tensor:
        return torch.from_numpy(np.flatnonzero(snap["touched"])).to(
            self.device)

    def _readout_device(self, state, snap: dict) -> None:
        """Merge the touched rows over shards (the drained bank zeroed in
        place after), then flush_packed on the merged block."""
        rows = self._touched_rows(snap)
        merged = self._merge_noted(
            lambda: collectives.merge_llhist_stacked_reset(
                state, self.device, rows))
        self._readout_rows(merged, snap)
        snap["_spare"] = state

    def _query_readout_device(self, state, snap: dict) -> None:
        merged = collectives.merge_llhist_stacked(state, self.device,
                                                  self._touched_rows(snap))
        self._plane.note_merge_round()
        snap["packed"] = batch_llhist.flush_packed(merged, snap["ps"])
        snap["bins_dev"] = merged if snap.get("need_bins") else None

    def _prewarm_readout(self, state, snap: dict) -> None:
        merged = collectives.merge_llhist_stacked_reset(
            state, self.device, self._touched_rows(snap))
        batch_llhist.flush_packed(merged, snap["ps"])

    def _reshard_capture_device(self, state, snap: dict) -> None:
        # register add over the touched rows (the JAX package merges the
        # whole bank; integer addition gives the same rows)
        snap["bins"] = collectives.merge_llhist_stacked(
            state, self.device, self._touched_rows(snap))
        snap["bins_rows"] = np.flatnonzero(snap["touched"])
        self._plane.note_merge_round()


# ---------------------------------------------------------------------------
# Per-shard families (histograms, sets): a list of N states, each shard's
# samples applied to its own, merged at flush.
# ---------------------------------------------------------------------------


class _PerShardStates:
    """Generation swap over the per-shard `states` list (`self.state`
    stays None)."""

    def _swap_device_locked(self):
        captured = self.states
        spare, self._spare = self._spare, None
        used_spare = (spare is not None
                      and self._spare_cap == self._state_capacity())
        self.states = spare if used_spare else self._fresh_state_at(
            self._state_capacity())
        self._devobs_swap_locked(used_spare)
        return captured

    def _capture_device_locked(self):
        # a shallow copy under apply_lock: a consistent set of per-shard
        # state refs
        return list(self.states)

    def _retopo_device_locked(self) -> None:
        self.states = self._fresh_state_at(self._state_capacity())
        self.state = None

    def _rr_shard(self) -> int:
        """The next shard of roundrobin routing (caller holds a lock)."""
        i = self._rr_next
        self._rr_next = (i + 1) % self._n_shards
        return i


class ShardedHistoTable(_PerShardStates, _DigestRouted, HistoTable):
    """HistoTable whose interval state is N per-shard digest tables:
    ingest applies each key's samples to its home shard (digest) or each
    whole batch to the next shard (roundrobin), with staging occupancy
    tracked per shard; the flush merges the shards by concat +
    recompress and runs K1 on the merged state."""

    def __init__(self, device, capacity: int = 1024, batch_cap: int = 8192,
                 max_rows: int = 0, *, plane: ShardedServingPlane):
        self._routing_init(device, capacity, plane)
        super().__init__(device, capacity, batch_cap, max_rows)

    def _init_arrays(self):
        self._prow = np.full(self.batch_cap, PAD_ROW, np.int32)
        self._pval = np.zeros(self.batch_cap, np.float32)
        self._pwt = np.zeros(self.batch_cap, np.float32)
        self._pcols = (self._prow, self._pval, self._pwt)
        self._n = 0
        self.state = None  # the shards' state lives in .states
        self.states = self._fresh_state_at(self.capacity)
        self._shard_counts = self._fresh_counts(self.capacity)

    def _fresh_counts(self, capacity: int) -> List[np.ndarray]:
        return [np.zeros(capacity, np.int32) for _ in range(self._n_shards)]

    def _fresh_state_at(self, capacity: int):
        return [batch_tdigest.init_state(capacity, device)
                for device in self._plane.devices]

    def _grow_arrays(self, new_cap):
        self._grow_shard_of(new_cap)
        grown = []
        for st, device in zip(self.states, self._plane.devices):
            new = batch_tdigest.init_state(new_cap, device)
            for k, v in st.items():
                new[k][: v.shape[0]] = v
            grown.append(new)
        self.states = grown
        extended = self._fresh_counts(new_cap)
        for e, counts in zip(extended, self._shard_counts):
            e[: counts.shape[0]] = counts
        self._shard_counts = extended

    def _apply_to_shard(self, states, shard_counts, i: int, rows, vals,
                        wts) -> None:
        """One shard's samples into an explicit (states, staging
        occupancy) generation: the live path passes the table's own, the
        flush readout the captured one; compacts the shard first when a
        key's staging would overflow."""
        slots, overflow = batch_tdigest.host_slots(rows, vals, wts,
                                                   shard_counts[i])
        if overflow:
            batch_tdigest.compact(states[i])
            shard_counts[i][:] = 0
            slots, _ = batch_tdigest.host_slots(rows, vals, wts,
                                                shard_counts[i])
        device = self._plane.devices[i]
        batch_tdigest.apply_batch(
            states[i], *(_to_device(np.ascontiguousarray(c), device)
                         for c in (rows, vals, wts, slots)))

    def _apply_cols_states(self, states, shard_counts, cols,
                           note: bool = True) -> None:
        rows, vals, wts = cols
        if not self._digest_routed:
            # roundrobin: the whole batch to the next shard
            self._apply_to_shard(states, shard_counts, self._rr_shard(),
                                 rows, vals, wts)
            return
        home = self._home_of(rows)
        counts = self._shard_counts_of(home)
        for i in np.flatnonzero(counts).tolist():
            sel = home == i
            self._apply_to_shard(states, shard_counts, i, rows[sel],
                                 vals[sel], wts[sel])
        if note:
            self._plane.note_routed(self.family, counts)

    def _apply_cols(self, cols):
        self._apply_cols_states(self.states, self._shard_counts, cols)

    def merge_batch(self, stubs, in_means, in_weights, in_min, in_max,
                    in_recip) -> None:
        """Import-path digest merge, each digest on its home shard
        (digest routing) or all on the next shard (roundrobin)."""
        with self.lock:
            rows, ok = self._intern_stubs_locked(stubs)
            home = (self._home_of(rows) if self._digest_routed
                    else np.full(rows.shape, self._rr_shard(), np.int32))
            self.apply_lock.acquire()
        try:
            cols = [np.asarray(c, np.float32)[ok] for c in (
                in_means, in_weights, in_min, in_max, in_recip)]

            def merge():
                for i in np.unique(home[home >= 0]).tolist():
                    sel = home == i
                    device = self._plane.devices[i]
                    batch_tdigest.merge_centroid_rows(
                        self.states[i], *(_to_device(
                            np.ascontiguousarray(c[sel]), device)
                            for c in [rows] + cols))
                    # the merge folds every staged row of this shard
                    self._shard_counts[i][:] = 0
            self._noted("merge", merge)
        finally:
            self.apply_lock.release()

    def _swap_extras_locked(self, snap: dict) -> None:
        snap["staged"] = self._shard_counts
        self._shard_counts = self._fresh_counts(self.capacity)

    def _readout_apply(self, states, cols, snap: dict) -> None:
        self._apply_cols_states(states, snap.pop("staged"), cols)

    def _flush_merged(self, merged, snap: dict) -> None:
        """K1 on the merged state: the forwarding flush (export too) or
        the plain one; the merged staging is empty, so it is not
        folded."""
        ps = snap["ps"]
        if snap.pop("need_export", False):
            snap["packed"], snap["export"] = \
                batch_tdigest.flush_export_packed(merged, ps)
        else:
            snap["packed"] = batch_tdigest.flush_quantiles_packed(
                merged, ps, fold_staging=False)
            snap["export"] = None

    def _readout_device(self, states, snap: dict) -> None:
        merged = self._merge_noted(
            lambda: collectives.merge_histo_stacked(states, self.device))
        self._flush_merged(merged, snap)
        snap["_recycle"] = states

    def _prewarm_apply(self, states, cols, capacity: int) -> None:
        counts = self._fresh_counts(capacity)
        rows, vals, wts = cols
        for i in range(self._n_shards):
            self._apply_to_shard(states, counts, i, rows, vals, wts)

    def _prewarm_readout(self, states, snap: dict) -> None:
        self._flush_merged(collectives.merge_histo_stacked(states,
                                                           self.device),
                           snap)

    def _reset_state_(self, captured) -> None:
        for st in captured:
            batch_tdigest.reset_state_(st)

    def _retopo_device_locked(self) -> None:
        super()._retopo_device_locked()
        self._shard_counts = self._fresh_counts(self.capacity)

    def _reshard_capture_device(self, states, snap: dict) -> None:
        # concat + recompress over the shards (staging already folded);
        # the merged state holds the digest's d* stats, which the wire
        # carries, and the local l* stats, which ride the sidecar
        snap["hstate"] = collectives.merge_histo_stacked(states,
                                                         self.device)
        self._plane.note_merge_round()

    def merge_local_stats(self, stubs, lmin, lmax, lsum, lweight,
                          lrecip) -> None:
        """Re-attach migrated local sample stats to the rows' home
        shards. The import merge (merge_batch) carries the digest side
        only: a forwarded digest has no local samples. A reshard replay
        is the one caller whose l* stats are local history, so the
        controller calls this right after the centroid merge of the same
        stubs (already interned and booked: no agg.applied here)."""
        with self.lock:
            rows = np.fromiter((self.row_for(s) for s in stubs), np.int32,
                               len(stubs))
            ok = rows >= 0
            rows = rows[ok]
            home = self._home_of(rows)
            self.apply_lock.acquire()
        try:
            arrs = [np.asarray(a, np.float32)[ok]
                    for a in (lmin, lmax, lsum, lweight, lrecip)]
            for i in np.unique(home[home >= 0]).tolist():
                sel = home == i
                st = self.states[i]
                device = self._plane.devices[i]
                idx = _to_device(rows[sel].astype(np.int64), device)
                vals = [_to_device(np.ascontiguousarray(a[sel]), device)
                        for a in arrs]
                st["lmin"].scatter_reduce_(0, idx, vals[0], "amin")
                st["lmax"].scatter_reduce_(0, idx, vals[1], "amax")
                st["lsum"].index_add_(0, idx, vals[2])
                st["lweight"].index_add_(0, idx, vals[3])
                st["lrecip"].index_add_(0, idx, vals[4])
        finally:
            self.apply_lock.release()


class ShardedSetTable(_PerShardStates, _DigestRouted, SetTable):
    """SetTable whose registers are N per-shard dense (K, 16384) banks,
    one row per key (no host tier: the merge needs uniform dense rows,
    as in the JAX package). Each key's members go to its home shard
    (digest) or each batch to the next shard (roundrobin); the flush
    merges the touched rows with a register max over shards and runs K2
    on them."""

    def __init__(self, device, capacity: int = 256, batch_cap: int = 8192,
                 max_rows: int = 0, *, plane: ShardedServingPlane):
        self._routing_init(device, capacity, plane)
        super().__init__(device, capacity, batch_cap, max_rows=max_rows)

    def _init_arrays(self):
        self._prow = np.full(self.batch_cap, PAD_ROW, np.int32)
        self._pidx = np.zeros(self.batch_cap, np.int32)
        self._prho = np.zeros(self.batch_cap, np.int32)
        self._pcols = (self._prow, self._pidx, self._prho)
        self._n = 0
        self.state = None  # the shards' banks live in .states
        self.states = self._fresh_state_at(self.capacity)

    def _fresh_state_at(self, capacity: int):
        return [batch_hll.init_state(capacity, device)
                for device in self._plane.devices]

    def _grow_arrays(self, new_cap):
        self._grow_shard_of(new_cap)
        self.states = [_pad_cap(st, new_cap) for st in self.states]

    def _state_capacity(self) -> int:
        # dense per-shard banks track the row capacity
        return self.capacity

    def add(self, metric) -> bool:
        member = metric.value if isinstance(metric.value, bytes) else str(
            metric.value).encode()
        idx, rho = hll_ref.pos_val(hll_ref.hash_member(member))
        with self.lock:
            row = self.row_for(metric)
            if row >= 0:
                self._add_row_locked(row, idx, rho)
        return row >= 0

    def add_batch(self, rows, reg_idx, rho) -> None:
        """Members already hashed to (idx, rho) for interned rows."""
        with self.lock:
            self._append_batch((np.asarray(rows, np.int32),
                                np.asarray(reg_idx, np.int32),
                                np.asarray(rho, np.int32)))
        self._note_applied(int(len(rows)))

    def _apply_to_shard(self, states, i: int, rows, idxs, rhos) -> None:
        device = self._plane.devices[i]
        batch_hll.apply_batch(states[i], *(
            _to_device(np.ascontiguousarray(c), device)
            for c in (rows, idxs, rhos)))

    def _apply_cols_states(self, states, cols, note: bool = True) -> None:
        rows, idxs, rhos = cols
        if not self._digest_routed:
            self._apply_to_shard(states, self._rr_shard(), rows, idxs, rhos)
            return
        home = self._home_of(rows)
        counts = self._shard_counts_of(home)
        for i in np.flatnonzero(counts).tolist():
            sel = home == i
            self._apply_to_shard(states, i, rows[sel], idxs[sel], rhos[sel])
        if note:
            self._plane.note_routed(self.family, counts)

    def _apply_cols(self, cols):
        self._apply_cols_states(self.states, cols)

    def _readout_apply(self, states, cols, snap: dict) -> None:
        self._apply_cols_states(states, cols)

    def merge_batch(self, stubs, in_regs) -> None:
        """Import-path register max, each row on its home shard (digest
        routing) or all on the next shard (roundrobin)."""
        with self.lock:
            rows, ok = self._intern_stubs_locked(stubs)
            home = (self._home_of(rows) if self._digest_routed
                    else np.full(rows.shape, self._rr_shard(), np.int32))
            self.apply_lock.acquire()
        try:
            regs = np.asarray(in_regs, np.int8)[ok]

            def merge():
                for i in np.unique(home[home >= 0]).tolist():
                    sel = home == i
                    device = self._plane.devices[i]
                    batch_hll.merge_rows(
                        self.states[i],
                        _to_device(np.ascontiguousarray(rows[sel]), device),
                        _to_device(np.ascontiguousarray(regs[sel]), device))
            self._noted("merge", merge)
        finally:
            self.apply_lock.release()

    def _swap_extras_locked(self, snap: dict) -> None:
        """No host tier to capture."""

    def _capture_extras_locked(self, snap: dict) -> None:
        """No host tier to copy."""

    def _estimate_merged(self, states, snap: dict, note: bool):
        """Merge the touched rows over shards (register max), launch K2
        on them (its output stays on the device until snapshot_finish)
        and return the merged (touched, M) bank."""
        rows = np.flatnonzero(snap["touched"])
        rows_t = torch.from_numpy(rows).to(self.device)
        if note:
            merged = self._merge_noted(
                lambda: collectives.merge_hll_stacked(states, self._plane,
                                                      rows_t))
        else:
            merged = collectives.merge_hll_stacked(states, self._plane,
                                                   rows_t)
        snap["estimates"] = np.zeros(self.capacity, np.float32)
        snap["dev_est"] = None
        if rows.size:
            snap["dev_est"] = batch_hll.estimate(merged)  # K2 on the card
            snap["dev_rows"] = rows.astype(np.int64)
        return rows, merged

    def _readout_device(self, states, snap: dict) -> None:
        """Estimates and a register view of the merged touched rows; the
        view holds the merged bank, so the drained per-shard banks are
        recycled."""
        rows, merged = self._estimate_merged(states, snap, note=True)
        slot_of = np.full(self.capacity, -1, np.int32)
        slot_of[rows] = np.arange(rows.size, dtype=np.int32)
        empty = np.zeros(0, np.int32)
        snap["registers"] = _SetRegisters(merged, slot_of, empty, empty,
                                          empty)
        snap["_recycle"] = states

    def _query_readout_device(self, states, snap: dict) -> None:
        # estimates only; the merge writes nothing into the live banks
        self._estimate_merged(states, snap, note=False)
        self._plane.note_merge_round()
        snap["registers"] = None

    def prewarm_rung(self, capacity: int, percentiles=(),
                     need_export: bool = True) -> bool:
        """Unlike the two-tier table's bank, the dense per-shard banks
        track the row capacity, so a rung is prewarmed."""
        return _BaseTable.prewarm_rung(self, capacity, percentiles,
                                       need_export)

    def _prewarm_apply(self, states, cols, capacity: int) -> None:
        rows, idxs, rhos = cols
        for i in range(self._n_shards):
            self._apply_to_shard(states, i, rows, idxs, rhos)

    def _prewarm_readout(self, states, snap: dict) -> None:
        self._estimate_merged(states, snap, note=False)

    def _reset_state_(self, captured) -> None:
        for st in captured:
            st.zero_()

    def _reshard_capture_device(self, states, snap: dict) -> None:
        # register max over the touched rows
        rows = np.flatnonzero(snap["touched"])
        snap["regs"] = collectives.merge_hll_stacked(
            states, self._plane, torch.from_numpy(rows).to(self.device))
        snap["regs_rows"] = rows
        self._plane.note_merge_round()
