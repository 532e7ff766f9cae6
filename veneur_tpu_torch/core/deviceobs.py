"""Device capacity observatory (port of veneur_tpu/core/deviceobs.py).

The accounting layer for what the column store keeps on the card, two
planes wired through the existing registries:

- **HBM ledger** — every `_BaseTable` generation registers its tensors'
  bytes (`numel() * element_size()`) as a *token* tagged family / table /
  lifecycle state (``live`` / ``spare`` / ``inflight`` / ``prewarm`` /
  ``reshard_capture``, the old topology's generation a reshard cutover
  holds until its rows have merged into the new one), split by the
  device each tensor lives on, so a store sharded over several cards
  books each shard on its own card (`ledger()["by_device"]`).
  Lifecycle transitions *retag* the token (a recycled spare is the
  generation it was captured as, reset in place, so its bytes are
  conserved) and every exit path (a capacity mismatch at recycle, a
  generation that escaped into its readout, a resize) *drops* it. The
  invariant the conservation tests pin: ``total_bytes()`` equals the
  exact sum of the registered generations' bytes at every step of swap,
  readout, recycle, resize and prewarm. `report()` reconciles the total
  against `torch.cuda.memory_stats()` of every visible card (the CPU
  reports nothing, as the JAX CPU backend does), and the total feeds the
  overload ladder's device watermark rung (`overload_device_soft_bytes`
  / `_hard_bytes`) beside the RSS rung.
- **Kernel registry** — the apply / readout / merge / reset / prewarm
  paths register dispatch counts and seconds into per-(kind, family)
  LatencyHist rows (`device.kernel.*`). The seconds are the host's
  dispatch time around the call, as in the JAX package: launches are
  asynchronous and the registry adds no synchronisation, so a row times
  the launch, not the kernel. Each row also counts the hand-written
  kernels (K1 `tdigest_flush`, K2 `hll_estimate`, K3 `llhist_apply`)
  its calls launched on the card, read from the calling thread's launch
  tally (`veneur_tpu_torch.ops.thread_launches`). A compile is the
  first-use nvcc build or library load of a kernel (ops/_cuda.py),
  booked under the kernel's name: the port compiles nothing per
  capacity, so a resize or a prewarm rung books none.

- **Shard balance** — for a sharded store (core/sharded_tables.py),
  the live rows per shard (in all and per family), the samples the
  plane routed to each, the occupancy of the digest space in 16 bins,
  the skew (max/mean live rows) and the hot shards (> 2x the mean), read
  from the host-side routing arrays only. `shard_skew()` feeds the
  `device.shard.skew` gauge and the `shard_skew` alert rule kind. The
  `reshard_plan` entry projects the live digests onto every candidate
  shard count from 2 to `reshard_plan_max_shards` and prices the best
  one: its projected skew, the rows it would move and its migration
  cells (parallel/reshard.py). The JAX package's range is its device
  count; one card holds any count, so the port's bound is a setting.

Everything is scrape-time or O(1)-under-a-lock on the hot path, and the
whole observatory is gated by the `device_observatory` config knob. The
full ledger and kernel table are served at ``GET /debug/device``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from veneur_tpu_torch.core.latency import LatencyHist

# lifecycle states a generation token may carry
STATE_LIVE = "live"
STATE_SPARE = "spare"
STATE_INFLIGHT = "inflight"
STATE_PREWARM = "prewarm"
STATE_RESHARD = "reshard_capture"

_STATES = (STATE_LIVE, STATE_SPARE, STATE_INFLIGHT, STATE_PREWARM,
           STATE_RESHARD)

# kernel kinds the registry tracks; each timed kind renders a
# `device.kernel.<kind>_s` llhist series (p50/p99/max gauges + count
# counter)
KERNEL_KINDS = ("apply", "readout", "merge", "reset", "prewarm")
HIST_ROWS = ("device.kernel.apply_s", "device.kernel.readout_s",
             "device.kernel.merge_s", "device.kernel.reset_s",
             "device.kernel.prewarm_s")

# a shard holding more than this multiple of the mean live rows is hot
HOT_SHARD_FACTOR = 2.0
# digest-space occupancy histogram bins (a power of two: the top bits)
DIGEST_BINS = 16

# the hand-written kernel each family's device work launches on the card
FAMILY_KERNELS = {"histogram": "tdigest_flush", "set": "hll_estimate",
                  "llhist": "llhist_apply"}


def nbytes_of(tree: Any) -> int:
    """Bytes of every tensor leaf of a table state: a tensor, or dicts,
    lists and tuples of them (numpy arrays count their nbytes); other
    leaves (ints, None) contribute nothing."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(nbytes_of(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes_of(v) for v in tree)
    numel = getattr(tree, "numel", None)
    if numel is not None and hasattr(tree, "element_size"):
        return int(numel()) * int(tree.element_size())
    return int(getattr(tree, "nbytes", 0) or 0)


def device_name(device) -> str:
    """`type:index` of a torch device (`cpu:0` for the CPU)."""
    return f"{device.type}:{0 if device.index is None else device.index}"


def bytes_by_device(tree: Any) -> Dict[str, int]:
    """nbytes_of split by the device each tensor leaf lives on
    (`device_name`); numpy leaves count as the host's `cpu:0`."""
    out: Dict[str, int] = {}

    def walk(t):
        if t is None:
            return
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            n = nbytes_of(t)
            if n:
                dev = getattr(t, "device", None)
                key = device_name(dev) if dev is not None and not \
                    isinstance(dev, str) else "cpu:0"
                out[key] = out.get(key, 0) + n
    walk(tree)
    return out


def cuda_memory_stats() -> List[Tuple[int, dict]]:
    """(index, torch.cuda.memory_stats) of every visible CUDA device; none
    without CUDA. Imports torch here: the proxy's HTTP API serves
    /debug/memory from a process without it."""
    import torch
    if not torch.cuda.is_available():
        return []
    return [(i, torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())]


def backend_memory_stats() -> List[dict]:
    """Per-device allocator figures under the JAX package's keys, for the
    ledger's reconciliation: bytes handed out by the caching allocator
    (`allocated_bytes.all.current`), its peak, the card's total memory
    (`mem_get_info`), and the bytes the allocator has reserved on the
    card, which it keeps beyond what it hands out."""
    import torch
    rows: List[dict] = []
    for i, stats in cuda_memory_stats():
        rows.append({
            "device": i,
            "platform": "gpu",
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "reserved_bytes": int(stats.get("reserved_bytes.all.current",
                                            0)),
        })
    return rows


class _Token:
    __slots__ = ("family", "state", "nbytes", "by_device")

    def __init__(self, family: str, state: str, nbytes: int,
                 by_device: Dict[str, int]):
        self.family = family
        self.state = state
        self.nbytes = nbytes
        self.by_device = by_device


class DeviceObservatory:
    """One server's (or standalone store's) device observatory.

    Disabled, every note_* call is a cheap early return and
    `note_generation` hands back None (retag/drop tolerate None), so the
    hook sites in the column store cost one attribute read."""

    # the largest shard count shard_balance()'s reshard plan prices (the
    # JAX package's bound is its device count; one card holds any count)
    reshard_plan_max_shards = 8

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._tokens: Dict[int, _Token] = {}
        self._next_token = 1
        self._total = 0           # running sum of registered bytes
        self.peak_bytes = 0       # high-water mark of _total
        # kernel registry: (kind, family) -> dispatch count / launches /
        # hist of the dispatch seconds
        self._dispatch: Dict[Tuple[str, str], int] = {}
        self._launches: Dict[Tuple[str, str], int] = {}
        self._kernel_hists: Dict[Tuple[str, str], LatencyHist] = {}
        # compile counts + last compile seconds per kernel
        self._compiles: Dict[str, int] = {}
        self._compile_seconds: Dict[str, float] = {}
        # the store the shard-balance plane reads at scrape time
        self._store = None
        if enabled:
            from veneur_tpu_torch.ops import _cuda
            _cuda.subscribe_loads(self.note_compile)

    # ------------------------------------------------------------------
    # HBM ledger
    # ------------------------------------------------------------------

    def note_generation(self, family: str, state: str,
                        tensors: Any) -> Optional[int]:
        """Register one device generation; returns an opaque token used
        to retag/drop it across lifecycle transitions, or None when the
        observatory is disabled or the state holds no tensors."""
        if not self.enabled or tensors is None:
            return None
        by_device = bytes_by_device(tensors)
        nbytes = sum(by_device.values())
        if nbytes <= 0:
            return None
        with self._lock:
            tok = self._next_token
            self._next_token += 1
            self._tokens[tok] = _Token(family, state, nbytes, by_device)
            self._total += nbytes
            if self._total > self.peak_bytes:
                self.peak_bytes = self._total
        return tok

    def retag(self, token: Optional[int], new_state: str) -> None:
        """Move a registered generation to a new lifecycle state. The
        bytes stay registered: a retag conserves the ledger total."""
        if token is None:
            return
        with self._lock:
            t = self._tokens.get(token)
            if t is not None:
                t.state = new_state

    def drop(self, token: Optional[int]) -> None:
        """Unregister a generation (freed, escaped or resized away)."""
        if token is None:
            return
        with self._lock:
            t = self._tokens.pop(token, None)
            if t is not None:
                self._total -= t.nbytes

    def total_bytes(self) -> int:
        with self._lock:
            return self._total

    def ledger(self) -> dict:
        """Full ledger breakdown: per-family per-state bytes, per-table
        rows (one table per family in the port), totals, peak, and a
        forecast-to-next-resize row (a grow doubles the live generation,
        so next-resize demand is live bytes x2 for the growing family;
        the report forecasts the worst case: every family doubling at
        once)."""
        with self._lock:
            toks = [(t.family, t.state, t.nbytes)
                    for t in self._tokens.values()]
            per_device = [t.by_device for t in self._tokens.values()]
            total, peak = self._total, self.peak_bytes
        by_device: Dict[str, int] = {}
        for split in per_device:
            for dev, nbytes in split.items():
                by_device[dev] = by_device.get(dev, 0) + nbytes
        by_family: Dict[str, Dict[str, int]] = {}
        by_table: Dict[str, dict] = {}
        live_total = 0
        for family, state, nbytes in toks:
            fam = by_family.setdefault(family, {s: 0 for s in _STATES})
            fam[state] += nbytes
            row = by_table.setdefault(
                family, {"family": family, "bytes": 0, "states": {}})
            row["bytes"] += nbytes
            row["states"][state] = row["states"].get(state, 0) + nbytes
            if state == STATE_LIVE:
                live_total += nbytes
        return {
            "total_bytes": total,
            "peak_bytes": peak,
            "live_bytes": live_total,
            # worst-case demand at the next capacity rung: every live
            # generation doubles while the old one is still resident for
            # the copy
            "forecast_next_resize_bytes": live_total * 2,
            "generations": len(toks),
            "by_family": by_family,
            "by_table": by_table,
            # each device's share: a sharded store's shards are booked
            # on their own cards
            "by_device": by_device,
        }

    # ------------------------------------------------------------------
    # Kernel registry
    # ------------------------------------------------------------------

    def note_kernel(self, kind: str, family: str,
                    seconds: Optional[float] = None, n: int = 1,
                    launches: int = 0) -> None:
        """Record `n` dispatches of a device path; `seconds` (the host's
        dispatch time, when the caller timed it) feeds the
        `device.kernel.<kind>_s` llhist for that family, and `launches`
        counts the hand-written kernel launches the dispatch made."""
        if not self.enabled:
            return
        key = (kind, family)
        hist = None
        with self._lock:
            self._dispatch[key] = self._dispatch.get(key, 0) + n
            if launches:
                self._launches[key] = self._launches.get(key, 0) + launches
            if seconds is not None:
                hist = self._kernel_hists.get(key)
                if hist is None:
                    hist = self._kernel_hists[key] = LatencyHist(
                        f"device.kernel.{kind}_s")
        if hist is not None:
            hist.observe(seconds)

    def note_compile(self, kernel: str,
                     seconds: Optional[float] = None) -> None:
        """Record one kernel build or library load (ops/_cuda.py) under
        the kernel's name."""
        if not self.enabled:
            return
        with self._lock:
            self._compiles[kernel] = self._compiles.get(kernel, 0) + 1
            if seconds is not None:
                self._compile_seconds[kernel] = float(seconds)

    def kernel_launches(self) -> Dict[str, int]:
        """Launches of each hand-written kernel booked by the registry's
        dispatches."""
        with self._lock:
            launches = dict(self._launches)
        out: Dict[str, int] = {}
        for (_kind, family), n in launches.items():
            kernel = FAMILY_KERNELS.get(family, family)
            out[kernel] = out.get(kernel, 0) + n
        return out

    def kernel_report(self) -> dict:
        with self._lock:
            dispatch = dict(self._dispatch)
            launches = dict(self._launches)
            hists = dict(self._kernel_hists)
            compiles = dict(self._compiles)
            compile_s = dict(self._compile_seconds)
        kernels: List[dict] = []
        for (kind, family), count in sorted(dispatch.items()):
            row = {"kind": kind, "family": family, "dispatches": count}
            if (kind, family) in launches:
                row["kernel"] = FAMILY_KERNELS.get(family, family)
                row["launches"] = launches[(kind, family)]
            hist = hists.get((kind, family))
            if hist is not None:
                row["wall"] = hist.snapshot()
            kernels.append(row)
        return {
            "kernels": kernels,
            "kernel_launches": self.kernel_launches(),
            "compiles": compiles,
            "last_compile_seconds": compile_s,
        }

    # ------------------------------------------------------------------
    # Shard balance
    # ------------------------------------------------------------------

    def attach_store(self, store) -> None:
        self._store = store

    def _sharded_tables(self) -> List[Tuple[str, Any]]:
        store = self._store
        if store is None:
            return []
        return [(family, table) for family, table in store.tables()
                if getattr(table, "_shard_of", None) is not None
                and getattr(table, "_n_shards", 0) > 1]

    @staticmethod
    def _live_homes(table):
        """(home shard of every live row, their 64-bit digests), read
        under the table's buffer lock."""
        with table.lock:
            n = len(table.meta)
            shard_of = np.asarray(table._shard_of[:n])
            live = np.asarray(table._has_meta[:n], bool)
            # dict keys are (digest64 << 2) | scope
            digests = [(dk >> 2) & 0xFFFFFFFFFFFFFFFF
                       for row, dk in enumerate(table._dict_key_of)
                       if row < n and live[row]]
        return shard_of[live].astype(np.int64), digests

    def shard_balance(self) -> Optional[dict]:
        """Per-shard live rows, samples routed and digest occupancy of
        the attached store's sharded tables; None when the store is not
        sharded. Host-side arrays only, no device sync."""
        tables = self._sharded_tables()
        if not tables:
            return None
        n_shards = tables[0][1]._n_shards
        rows = np.zeros(n_shards, np.int64)
        digest_hist = np.zeros(DIGEST_BINS, np.int64)
        per_family: Dict[str, list] = {}
        digests_all: List[np.ndarray] = []
        shift = np.uint64(64 - (DIGEST_BINS.bit_length() - 1))
        for family, table in tables:
            homes, dig_list = self._live_homes(table)
            fam_rows = np.bincount(homes, minlength=n_shards)[:n_shards]
            rows += fam_rows
            per_family[family] = [int(x) for x in fam_rows]
            if dig_list:
                digests = np.asarray(dig_list, np.uint64)
                digests_all.append(digests)
                digest_hist += np.bincount(
                    (digests >> shift).astype(np.int64),
                    minlength=DIGEST_BINS)[:DIGEST_BINS]
        mean = float(rows.mean()) if rows.size else 0.0
        skew = float(rows.max() / mean) if mean > 0 else None
        hot = [int(i) for i in np.nonzero(
            rows > HOT_SHARD_FACTOR * mean)[0]] if mean > 0 else []
        plane = getattr(self._store, "shard_plane", None)
        samples: Dict[str, list] = {}
        if plane is not None:
            for family, acc in list(plane._samples.items()):
                samples[family] = [int(x) for x in acc]
        out = {
            "n_shards": int(n_shards),
            "rows_per_shard": [int(x) for x in rows],
            "rows_per_shard_by_family": per_family,
            "samples_routed": samples,
            "digest_occupancy": [int(x) for x in digest_hist],
            "skew": skew,
            "hot_shards": hot,
        }
        plan = self._reshard_plan(digests_all, int(n_shards),
                                  self.reshard_plan_max_shards)
        if plan is not None:
            out["reshard_plan"] = plan
        return out

    @staticmethod
    def _reshard_plan(digests_all: List[np.ndarray], n_old: int,
                      max_m: int) -> Optional[dict]:
        """Project the live digests onto every shard count in 2..max_m
        but n_old and price the best: the lowest projected skew (max/mean
        rows), then the fewest rows moved, then the fewest shards; with
        the count of its migration cells. A recommendation only: the
        reshard controller cuts over."""
        if not digests_all:
            return None
        digests = np.concatenate(digests_all)
        if digests.size == 0 or max_m < 2:
            return None
        from veneur_tpu_torch.parallel.collectives import home_shards
        old_home = home_shards(digests, n_old)
        best = None
        for m in range(2, max_m + 1):
            if m == n_old:
                continue
            new_home = home_shards(digests, m)
            proj = np.bincount(new_home, minlength=m)[:m]
            mean = float(proj.mean())
            if mean <= 0:
                continue
            cand = (float(proj.max() / mean),
                    int(np.count_nonzero(old_home != new_home)), m)
            if best is None or cand < best:
                best = cand
        if best is None:
            return None
        proj_skew, moved, m = best
        from veneur_tpu_torch.parallel.reshard import migration_cells
        return {
            "from_shards": n_old,
            "to_shards": m,
            "projected_skew": proj_skew,
            "rows_moved": moved,
            "migration_cells": len(migration_cells(n_old, m)),
        }

    def shard_skew(self) -> Optional[float]:
        """max/mean live rows over the shards; None when the store is not
        sharded or holds no rows. The `shard_skew` alert rule's and the
        `device.shard.skew` gauge's source."""
        tables = self._sharded_tables()
        if not tables:
            return None
        n_shards = tables[0][1]._n_shards
        rows = np.zeros(n_shards, np.int64)
        for _family, table in tables:
            homes, _digests = self._live_homes(table)
            rows += np.bincount(homes, minlength=n_shards)[:n_shards]
        mean = float(rows.mean()) if rows.size else 0.0
        if mean <= 0:
            return None
        return float(rows.max() / mean)

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------

    def telemetry_rows(self) -> List[tuple]:
        if not self.enabled:
            return []
        rows: List[tuple] = []
        led = self.ledger()
        rows.append(("device.mem.total_bytes", "gauge",
                     float(led["total_bytes"]), ()))
        rows.append(("device.mem.peak_bytes", "gauge",
                     float(led["peak_bytes"]), ()))
        rows.append(("device.mem.forecast_next_resize_bytes", "gauge",
                     float(led["forecast_next_resize_bytes"]), ()))
        rows.append(("device.mem.generations", "gauge",
                     float(led["generations"]), ()))
        for family, states in sorted(led["by_family"].items()):
            for state, nbytes in sorted(states.items()):
                if nbytes:
                    rows.append(("device.mem.bytes", "gauge",
                                 float(nbytes),
                                 (f"family:{family}", f"state:{state}")))
        with self._lock:
            dispatch = dict(self._dispatch)
            hists = dict(self._kernel_hists)
            compiles = dict(self._compiles)
        for (kind, family), count in sorted(dispatch.items()):
            rows.append(("device.kernel.dispatches", "counter",
                         float(count),
                         (f"kind:{kind}", f"family:{family}")))
        for kernel, count in sorted(self.kernel_launches().items()):
            rows.append(("device.kernel.launches", "counter", float(count),
                         (f"kernel:{kernel}",)))
        for (kind, family), hist in sorted(hists.items()):
            snap = hist.snapshot()
            tags = (f"family:{family}",)
            base = f"device.kernel.{kind}_s"
            for label in ("p50", "p99", "max"):
                rows.append((f"{base}.{label}", "gauge", snap[label],
                             tags))
            rows.append((f"{base}.count", "counter",
                         float(snap["count"]), tags))
        for kernel, count in sorted(compiles.items()):
            rows.append(("device.compile.count", "counter", float(count),
                         (f"kernel:{kernel}",)))
        skew = self.shard_skew()
        if skew is not None:
            rows.append(("device.shard.skew", "gauge", skew, ()))
        return rows

    def report(self) -> dict:
        """The `/debug/device` payload: ledger + allocator reconciliation
        + kernel table + shard balance (a sharded store only)."""
        led = self.ledger()
        backend = backend_memory_stats()
        recon = None
        if backend:
            in_use = sum(r["bytes_in_use"] for r in backend)
            recon = {
                "backend_bytes_in_use": in_use,
                "backend_bytes_reserved": sum(r["reserved_bytes"]
                                              for r in backend),
                "ledger_bytes": led["total_bytes"],
                # allocator slack: bytes the ledger doesn't model (readout
                # outputs, pending-column copies, other servers' tables)
                "unaccounted_bytes": in_use - led["total_bytes"],
            }
        out = {
            "generated_unix": time.time(),
            "enabled": self.enabled,
            "ledger": led,
            "backend_devices": backend,
            "reconciliation": recon,
            **self.kernel_report(),
        }
        balance = self.shard_balance()
        if balance is not None:
            out["shard_balance"] = balance
        return out
