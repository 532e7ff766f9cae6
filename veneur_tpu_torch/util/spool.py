"""Durable interval WAL: a bounded on-disk log of forward intervals (port
of veneur_tpu/util/spool.py; the on-disk format is the JAX package's,
byte for byte, so a directory written by either package drains through
the other's forward client).

Two modes share one on-disk format:

* **Carryover spill** (the original role): in-memory carryover
  (util/resilience.py) is bounded to `carryover_max_intervals`; past the
  bound the merged ForwardableState is serialized to metricpb wire bytes
  (the SAME encoding a forward send uses) and appended here instead of
  shed. Because every forwarded family merges associatively and
  commutatively (counters sum, t-digests recompress, HLL/llhist
  registers max/add), a failed interval's state is just as valid
  delivered minutes later from disk as seconds later from memory.
* **Write-ahead log** (`forward_wal: true`): EVERY forwardable interval
  snapshot is appended BEFORE its send attempt, stamped with the
  interval-start timestamp, and removed only once the receiver acked
  it. A crash (`kill -9`) at any point between the append and the ack
  replays the interval at restart — and because each segment's
  idempotency token derives from its on-disk name (stable across
  restarts), a segment whose send landed but whose ack was lost is
  dropped by the receiver's token dedupe, not merged twice.

Segments carry their interval-start timestamp in the JSON header (and
the drain stamps it onto the send as `x-veneur-interval` metadata), so
the receiving tier can bucket a replayed interval under its ORIGINAL
interval instead of folding hours-stale state into the current flush —
the difference between backfilled history and a false traffic spike.

Segments are drained oldest-first by the forward client once the
destination is reachable (each segment body is already a valid
SendMetrics V1 MetricList framing), and a process restart simply
re-scans the directory — a crash mid-outage loses nothing that reached
disk. Appends are atomic
(tmp + rename + fsync, then a directory fsync) so a crash mid-spill
leaves either a whole segment or none.

Bounded loudly, like everything else in the resilience layer: past
`max_segments` or `max_bytes` the OLDEST segments are dropped (counted,
logged) so the newest state — the most likely to still matter — wins.
Undeliverable segments move to a bounded `quarantine/` subdirectory
(an inventory stock the flow ledger books, not a silent aside); past
the quarantine bound the oldest quarantined segments are purged and
their metrics booked as explained shed.

stdlib-only, no grpc (the caller hands in pre-serialized wire bytes and
gets them back).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from typing import List, Optional, Tuple

logger = logging.getLogger("veneur_tpu_torch.util.spool")

_SEGMENT_SUFFIX = ".vspool"
_HEADER_MAX = 4096  # sanity bound on the JSON header line
QUARANTINE_DIR = "quarantine"


def frame_metrics(metrics: List[bytes]) -> bytes:
    """Concatenated MetricList `metrics` entries (field 1,
    length-delimited): the V1 forward body framing, inlined here so the
    spool stays grpc-free."""
    out = []
    for b in metrics:
        n = len(b)
        out.append(b"\x0a")
        while n >= 0x80:
            out.append(bytes((n & 0x7F | 0x80,)))
            n >>= 7
        out.append(bytes((n,)))
        out.append(b)
    return b"".join(out)


def unframe_metrics(body: bytes) -> List[bytes]:
    """Inverse of frame_metrics: split a MetricList body back into
    per-Metric wire bytes. Raises ValueError on malformed framing (a
    truncated segment from a crash mid-write never reaches the sender —
    append() is write-tmp-then-rename, so this only fires on external
    corruption)."""
    out: List[bytes] = []
    i, n = 0, len(body)
    while i < n:
        if body[i] != 0x0A:
            raise ValueError(f"bad MetricList frame tag at {i}")
        i += 1
        size = shift = 0
        while True:
            if i >= n:
                raise ValueError("truncated frame length")
            byte = body[i]
            i += 1
            size |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
            if shift > 35:
                raise ValueError("frame length varint overflow")
        if i + size > n:
            raise ValueError("truncated frame body")
        out.append(body[i:i + size])
        i += size
    return out


class SpoolSegment:
    """One on-disk interval: a JSON header line + a MetricList body.
    `interval_unix` is the interval-start timestamp the snapshot covers
    (0.0 for pre-WAL segments written without a stamp)."""

    __slots__ = ("path", "created_unix", "count", "nbytes",
                 "interval_unix", "extra")

    def __init__(self, path: str, created_unix: float, count: int,
                 nbytes: int, interval_unix: float = 0.0,
                 extra: Optional[dict] = None):
        self.path = path
        self.created_unix = created_unix
        self.count = count
        self.nbytes = nbytes
        self.interval_unix = interval_unix
        # caller-owned header metadata (the reshard WAL stamps its cell
        # bounds and cutover token here); None for plain segments
        self.extra = extra

    def read_metrics(self) -> List[bytes]:
        with open(self.path, "rb") as f:
            f.readline()  # header
            return unframe_metrics(f.read())


class CarryoverSpool:
    """Bounded directory WAL of forward intervals.

    Thread-safe. `append` is called from whatever thread owns the
    interval (the forward thread, or the flush loop tripping the
    carryover bound); `oldest`/`pop` from the forward thread's drain;
    counters from the telemetry scraper."""

    def __init__(self, directory: str,
                 max_bytes: int = 256 * 1024 * 1024,
                 max_segments: int = 1024,
                 quarantine_max_bytes: int = 64 * 1024 * 1024,
                 quarantine_max_segments: int = 256,
                 dwell_hist=None, ledger=None):
        self.directory = directory
        self.max_bytes = max(0, int(max_bytes))
        self.max_segments = max(1, int(max_segments))
        self.quarantine_max_bytes = max(0, int(quarantine_max_bytes))
        self.quarantine_max_segments = max(1, int(quarantine_max_segments))
        # flow ledger (core/ledger.py; the server passes its own): the
        # spool is an inventory stock
        # of the forward conservation identity; bound sheds and
        # quarantine purges stamp forward.shed so a dropped segment is
        # explained loss, never unexplained imbalance. A quarantined
        # segment is NOT shed — it moves into the spool_quarantine
        # stock (set aside on disk, still inventoried) until the
        # quarantine bound purges it. Notes fire outside self._lock.
        self.ledger = ledger
        # optional latency-observatory llhist: spill->drain dwell rides
        # the shared queue.dwell telemetry under the caller's queue name
        self._dwell_hist = dwell_hist
        self._lock = threading.Lock()
        # serializes whole append() bodies: seq assignment, the disk
        # write, and the publish must be one atomic unit or concurrent
        # spills (forward thread + flush loop both stash) could order
        # _segments out of seq order — and the bound shed would then
        # evict a NEWER segment while believing it took the oldest
        self._append_lock = threading.Lock()
        self._segments: List[SpoolSegment] = []
        # quarantined segments, oldest first (path, count, nbytes);
        # count is 0 when the header was unreadable (those never
        # entered the books, so their purge sheds nothing)
        self._quarantined: List[Tuple[str, int, int]] = []
        self._seq = 0
        self.spilled_total = 0          # segments written
        self.spilled_metrics_total = 0  # metrics across them
        self.drained_total = 0          # segments delivered and removed
        self.drained_metrics_total = 0
        self.shed_total = 0             # segments dropped at the bound
        self.shed_metrics_total = 0
        self.quarantined_total = 0      # segments set aside undeliverable
        self.quarantine_purged_total = 0        # segments purged at bound
        self.quarantine_purged_metrics_total = 0
        self.replayed_total = 0         # segments recovered at startup
        os.makedirs(directory, exist_ok=True)
        os.makedirs(self.quarantine_path, exist_ok=True)
        self._scan()

    @property
    def quarantine_path(self) -> str:
        return os.path.join(self.directory, QUARANTINE_DIR)

    # -- startup replay --------------------------------------------------

    def _scan(self) -> None:
        """Recover segments left by a previous process (crash or SIGUSR2
        handoff mid-outage). Unreadable files are quarantined aside, not
        deleted — loud beats silent for data that exists because of a
        failure. The quarantine directory is re-scanned too, so its
        stock (and bound) survives restarts."""
        found: List[Tuple[str, SpoolSegment]] = []
        for name in os.listdir(self.directory):
            if not name.endswith(_SEGMENT_SUFFIX):
                continue
            path = os.path.join(self.directory, name)
            seg = self._read_header(path)
            if seg is None:
                logger.error("spool segment %s unreadable; quarantined",
                             path)
                self._quarantine_file(path, 0)
                continue
            found.append((name, seg))
        found.sort(key=lambda pair: pair[0])  # seq-prefixed names: oldest first
        # seed the sequence PAST everything on disk — including the
        # quarantine: a fresh process restarting at seq 1 would
        # interleave its segment names with a predecessor's, breaking
        # the oldest-first drain/shed ordering the zero-padded prefix
        # exists to give (and a re-quarantined name must never collide)
        max_seq = 0
        for name, _seg in found:
            max_seq = max(max_seq, _name_seq(name))
        quarantined: List[Tuple[str, int, int]] = []
        qdir = self.quarantine_path
        try:
            qnames = sorted(os.listdir(qdir))
        except OSError:
            qnames = []
        for name in qnames:
            if not name.endswith(_SEGMENT_SUFFIX):
                continue
            qpath = os.path.join(qdir, name)
            max_seq = max(max_seq, _name_seq(name))
            seg = self._read_header(qpath)
            try:
                nbytes = os.stat(qpath).st_size
            except OSError:
                continue
            quarantined.append((qpath, seg.count if seg else 0, nbytes))
        with self._lock:
            self._segments = [seg for _, seg in found]
            self._quarantined = quarantined
            self._seq = max(self._seq, max_seq)
            self.replayed_total = len(found)
        if found:
            logger.warning(
                "durable spool: replaying %d segment(s) (%d metrics) "
                "left by a previous process", len(found),
                sum(seg.count for _, seg in found))
        self._enforce_quarantine_bound()

    @staticmethod
    def _read_header(path: str) -> Optional[SpoolSegment]:
        try:
            with open(path, "rb") as f:
                header = f.readline(_HEADER_MAX)
                meta = json.loads(header)
                nbytes = os.fstat(f.fileno()).st_size
            return SpoolSegment(path, float(meta["created_unix"]),
                                int(meta["count"]), nbytes,
                                float(meta.get("interval_unix", 0.0)),
                                extra=meta.get("extra"))
        except (OSError, ValueError, KeyError):
            return None

    # -- state -----------------------------------------------------------

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._segments)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return sum(seg.nbytes for seg in self._segments)

    @property
    def pending_metrics(self) -> int:
        """Metric rows across all live segments — the ledger's stock."""
        with self._lock:
            return sum(seg.count for seg in self._segments)

    @property
    def quarantined_metrics(self) -> int:
        """Metric rows set aside in the quarantine directory — the
        spool_quarantine inventory stock the ledger books (a quarantined
        segment left the drainable spool but not the node's disk)."""
        with self._lock:
            return sum(count for _p, count, _b in self._quarantined)

    @property
    def quarantined_bytes(self) -> int:
        with self._lock:
            return sum(b for _p, _c, b in self._quarantined)

    @property
    def quarantine_depth(self) -> int:
        with self._lock:
            return len(self._quarantined)

    def _note_shed(self, n: int, key: str) -> None:
        led = self.ledger
        if led is not None and n:
            led.note("forward.shed", n, key=key)

    # -- spill / WAL append ----------------------------------------------

    def append(self, metrics: List[bytes],
               interval_unix: float = 0.0,
               extra: Optional[dict] = None) -> int:
        """Append one interval's serialized metrics as a new segment;
        returns the count written. `interval_unix` is the interval-start
        timestamp the snapshot covers (stamped into the header and onto
        every drain of this segment as x-veneur-interval metadata); 0
        keeps the pre-WAL unstamped behavior. Atomic (tmp + rename +
        fsync) so a crash mid-spill leaves either a whole segment or
        none."""
        if not metrics:
            return 0
        with self._append_lock:
            return self._append_locked(metrics, interval_unix, extra)

    def _append_locked(self, metrics: List[bytes],
                       interval_unix: float,
                       extra: Optional[dict] = None) -> int:
        body = frame_metrics(metrics)
        created = time.time()
        header_fields = {"created_unix": round(created, 3),
                         "count": len(metrics)}
        if interval_unix:
            header_fields["interval_unix"] = round(float(interval_unix), 3)
        if extra:
            # caller metadata (reshard WAL cell bounds / cutover token);
            # must stay small — the whole header line is bounded by
            # _HEADER_MAX at replay
            header_fields["extra"] = extra
        header = json.dumps(header_fields).encode() + b"\n"
        with self._lock:
            self._seq += 1
            name = f"spill-{self._seq:08d}-{uuid.uuid4().hex[:8]}"
        path = os.path.join(self.directory, name + _SEGMENT_SUFFIX)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(body)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # the rename itself must reach disk too, or a power loss leaves
        # a segment that was counted "spilled" (not shed) yet vanishes
        # from the restart scan — the durability the spool exists for
        self._fsync_dir(self.directory)
        seg = SpoolSegment(path, created, len(metrics),
                           len(header) + len(body), float(interval_unix),
                           extra=extra)
        shed: List[SpoolSegment] = []
        with self._lock:
            self._segments.append(seg)
            self.spilled_total += 1
            self.spilled_metrics_total += len(metrics)
            total = sum(s.nbytes for s in self._segments)
            while (len(self._segments) > self.max_segments
                   or (self.max_bytes and total > self.max_bytes)) \
                    and len(self._segments) > 1:
                victim = self._segments.pop(0)
                total -= victim.nbytes
                shed.append(victim)
                self.shed_total += 1
                self.shed_metrics_total += victim.count
        for victim in shed:
            logger.error(
                "durable spool over bound: shedding oldest segment %s "
                "(%d metrics — counter deltas in it are permanently lost)",
                victim.path, victim.count)
            self._note_shed(victim.count, "spool_bound")
            try:
                os.unlink(victim.path)
            except OSError:
                pass
        return len(metrics)

    @staticmethod
    def _fsync_dir(directory: str) -> None:
        try:
            dirfd = os.open(directory, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except OSError:
            pass  # non-POSIX dir-fsync (or odd fs): best effort

    # -- drain -----------------------------------------------------------

    def live_paths(self) -> set:
        with self._lock:
            return {seg.path for seg in self._segments}

    def oldest(self) -> Optional[SpoolSegment]:
        with self._lock:
            return self._segments[0] if self._segments else None

    def segments(self) -> List[SpoolSegment]:
        """Snapshot of the live segments, oldest first — the drain
        iterates this so it can reorder (fresh-before-stale in WAL mode)
        without holding the spool lock across sends."""
        with self._lock:
            return list(self._segments)

    def pop(self, seg: SpoolSegment) -> None:
        """Remove a successfully-delivered segment and observe its
        spill->drain dwell."""
        with self._lock:
            try:
                self._segments.remove(seg)
            except ValueError:
                return
            self.drained_total += 1
            self.drained_metrics_total += seg.count
        if self._dwell_hist is not None:
            self._dwell_hist.observe(max(0.0, time.time() - seg.created_unix))
        try:
            os.unlink(seg.path)
        except OSError:
            logger.warning("could not unlink drained spool segment %s",
                           seg.path)

    # -- quarantine ------------------------------------------------------

    def discard(self, seg: SpoolSegment) -> None:
        """Move an undeliverable (corrupt) segment into the bounded
        quarantine directory. The metrics shift from the forward_spool
        stock to the spool_quarantine stock — set aside, not shed; only
        a quarantine-bound purge books them as lost."""
        with self._lock:
            try:
                self._segments.remove(seg)
            except ValueError:
                return
        self._quarantine_file(seg.path, seg.count)

    def _quarantine_file(self, path: str, count: int) -> None:
        qpath = os.path.join(self.quarantine_path,
                             os.path.basename(path))
        try:
            # the subdir may have been removed out from under us (an
            # operator cleanup, an aggressive tmp reaper) — recreate
            os.makedirs(self.quarantine_path, exist_ok=True)
            os.replace(path, qpath)
            nbytes = os.stat(qpath).st_size
        except OSError:
            # cannot set the segment aside: its metrics have already
            # left the forward_spool stock, so book them as explained
            # shed and remove the file — leaving it in the main dir
            # would re-adopt (and re-fail) it on every restart
            logger.error("could not quarantine spool segment %s; "
                         "shedding it", path)
            self._note_shed(count, "quarantine_failed")
            try:
                os.unlink(path)
            except OSError:
                pass
            return
        with self._lock:
            self._quarantined.append((qpath, count, nbytes))
            self.quarantined_total += 1
        self._enforce_quarantine_bound()

    def _enforce_quarantine_bound(self) -> None:
        purged: List[Tuple[str, int, int]] = []
        with self._lock:
            total = sum(b for _p, _c, b in self._quarantined)
            while (len(self._quarantined) > self.quarantine_max_segments
                   or (self.quarantine_max_bytes
                       and total > self.quarantine_max_bytes)) \
                    and self._quarantined:
                victim = self._quarantined.pop(0)
                total -= victim[2]
                purged.append(victim)
                self.quarantine_purged_total += 1
                self.quarantine_purged_metrics_total += victim[1]
        for qpath, count, _nbytes in purged:
            logger.error(
                "spool quarantine over bound: purging oldest segment %s "
                "(%d metrics permanently lost)", qpath, count)
            self._note_shed(count, "quarantine_purged")
            try:
                os.unlink(qpath)
            except OSError:
                pass

    # -- telemetry -------------------------------------------------------

    def telemetry_rows(self) -> List[tuple]:
        with self._lock:
            depth = len(self._segments)
            nbytes = sum(s.nbytes for s in self._segments)
            q_metrics = sum(c for _p, c, _b in self._quarantined)
            q_bytes = sum(b for _p, _c, b in self._quarantined)
            rows = [
                ("carryover.spool.depth", "gauge", float(depth), ()),
                ("carryover.spool.bytes", "gauge", float(nbytes), ()),
                ("carryover.spool.spilled", "counter",
                 float(self.spilled_metrics_total), ()),
                ("carryover.spool.drained", "counter",
                 float(self.drained_metrics_total), ()),
                ("carryover.spool.shed", "counter",
                 float(self.shed_metrics_total), ()),
                ("carryover.spool.replayed", "counter",
                 float(self.replayed_total), ()),
                ("carryover.spool.quarantined", "gauge",
                 float(q_metrics), ()),
                ("carryover.spool.quarantined_bytes", "gauge",
                 float(q_bytes), ()),
                ("carryover.spool.quarantine_purged", "counter",
                 float(self.quarantine_purged_metrics_total), ()),
            ]
        return rows


def _name_seq(name: str) -> int:
    """The zero-padded sequence prefix of a segment file name (0 when
    unparseable) — the total order drains follow."""
    try:
        return int(name.split("-")[1])
    except (IndexError, ValueError):
        return 0
