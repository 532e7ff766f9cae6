"""Ingest admission control, overload degradation and pipeline
supervision (port of veneur_tpu/core/overload.py; it imports no torch).

- `TokenBucket` / admission: per-plane (statsd, ssf) token-bucket rate
  limits. A packet over budget is not dropped in silence: the shed
  ladder drops spans first, then histogram/set samples, and never
  counter/gauge deltas. An over-limit statsd batch still parses, and
  only its essential (counter/gauge) samples are kept. Every shed sample
  is counted in `ingest.shed_total` (class and reason tags). The same
  bucket is the forward client's WAL replay limiter.
- `KernelDropMonitor`: the kernel's own UDP drop counter, polled from
  `/proc/net/udp{,6}` by socket inode, becomes `ingest.kernel_drops`.
  Off Linux, or where the proc file lacks the socket's inode, the
  monitor is inert.
- `WatermarkMonitor`: soft/hard RSS thresholds stepping the server
  through ok -> degraded -> shedding. Degraded keeps
  `overload_watermark_degraded_keep` of histogram/set samples and pauses
  span ingest; shedding drops histogram/set samples entirely.
  Counter/gauge deltas are admitted in every state. Chaos adds simulated
  pressure (`chaos_ingest_rss_bytes`, `Chaos.set_simulated_rss`).
- `Supervisor`: heartbeat watcher over the long-lived pipeline threads
  (pump dispatch, span workers, flush loop, alert loop). A component
  whose heartbeat goes stale beyond its deadline is logged and exported
  (`supervisor.stalls_total`); one stalled past
  `supervisor_escalation_deadline` escalates, by default through the
  crash reporters (util/crash.py), a faulthandler dump and `os._exit(3)`.
  The largest heartbeat age seen per component is kept (a port
  addition, `max_heartbeat_ages`).

`OverloadManager` holds them all, runs the one monitor thread that
polls the watermarks and the kernel drops, and exports everything
through `telemetry_rows`. The device rung (`attach_device_source`)
reads the device observatory's HBM-ledger total (core/deviceobs.py)
against `overload_device_soft_bytes` / `_hard_bytes`; the combined state
is the severity max of the two rungs.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("veneur_tpu_torch.overload")

# degradation ladder states (gauge values for /metrics)
OK = "ok"
DEGRADED = "degraded"
SHEDDING = "shedding"
STATE_CODES = {OK: 0, DEGRADED: 1, SHEDDING: 2}

# shed ladder classes, least- to most-protected. Spans go first (they
# are derived/redundant observability), histogram/set samples next
# (they lose precision, not truth), counter/gauge deltas never (losing
# a delta corrupts the sum forever).
CLASS_SPAN = "span"
CLASS_HISTOGRAM = "histogram"
CLASS_SET = "set"

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def current_rss_bytes() -> Optional[int]:
    """Current resident set from /proc/self/statm (field 2, pages);
    None off Linux."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, IndexError, ValueError):
        return None


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill, `burst` capacity.
    `admit(n)` takes n tokens if available (all-or-nothing, packets are
    atomic); thread-safe; a rate of 0 admits everything."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        self.rate = max(0.0, float(rate))
        self.burst = max(1.0, float(burst)) if self.rate else 0.0
        self._tokens = self.burst
        self._clock = clock
        self._last = clock()
        self._lock = threading.Lock()

    def admit(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def admit_debt(self, n: float = 1.0) -> bool:
        """Batch-metering variant: admit whenever the bucket is positive
        and charge the FULL cost, letting the balance go negative (debt
        repaid by refill before anything else admits). All-or-nothing
        `admit` starves any batch larger than one burst forever; debt
        admission keeps the long-run rate exactly `rate` for arbitrarily
        large batches, with overshoot bounded by one batch."""
        if self.rate <= 0:
            return True
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens > 0:
                self._tokens -= n
                return True
            return False


class KernelDropMonitor:
    """Polls /proc/net/udp{,6} for the drops column of watched sockets.

    Sockets are matched by inode (stable across the socket's life,
    immune to REUSEPORT port sharing). The exported value is the summed
    per-socket delta since watching began, so a listener restart never
    double-counts. Off Linux (no /proc/net/udp) the monitor is inert.
    """

    PROC_FILES = ("/proc/net/udp", "/proc/net/udp6")

    def __init__(self):
        self._lock = threading.Lock()
        # inode -> [label, baseline (first-seen drops), last-seen drops]
        self._watched: Dict[int, list] = {}
        self._totals: Dict[str, int] = {}  # label -> accumulated delta

    @property
    def watching(self) -> bool:
        with self._lock:
            return bool(self._watched)

    def watch_socket(self, sock, label: str) -> None:
        """Register a bound UDP socket for drop polling."""
        try:
            inode = os.fstat(sock.fileno()).st_ino
        except OSError:
            return
        with self._lock:
            self._watched[inode] = [label, None, 0]
            self._totals.setdefault(label, 0)

    @staticmethod
    def parse_proc_udp(text: str) -> Dict[int, int]:
        """`/proc/net/udp` rows -> {inode: drops}. The drops column is
        the last field; inode is field 9 (0-based, after the header)."""
        out: Dict[int, int] = {}
        for line in text.splitlines()[1:]:
            fields = line.split()
            if len(fields) < 13:
                continue
            try:
                out[int(fields[9])] = int(fields[12])
            except ValueError:
                continue
        return out

    def _read_proc(self) -> Dict[int, int]:
        merged: Dict[int, int] = {}
        for path in self.PROC_FILES:
            try:
                with open(path) as f:
                    merged.update(self.parse_proc_udp(f.read()))
            except OSError:
                continue
        return merged

    def poll(self) -> int:
        """One scan; returns the total new drops observed this poll."""
        with self._lock:
            if not self._watched:
                return 0
        by_inode = self._read_proc()
        fresh = 0
        with self._lock:
            for inode, entry in self._watched.items():
                drops = by_inode.get(inode)
                if drops is None:
                    continue  # socket gone or proc row unreadable
                label, baseline, last = entry
                if baseline is None:
                    # first sighting: pre-existing drops are not ours
                    entry[1] = entry[2] = drops
                    continue
                delta = drops - last
                if delta > 0:
                    self._totals[label] = self._totals.get(label, 0) + delta
                    fresh += delta
                entry[2] = drops
        return fresh

    def totals(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._totals)


class WatermarkMonitor:
    """RSS watermarks -> the ok/degraded/shedding ladder.

    `observe(rss)` applies the thresholds; `tick()` reads real RSS
    (plus any chaos-simulated pressure) and applies it. Recovery is
    immediate — one observation below the soft watermark returns to ok
    (the acceptance contract: back to ok within one interval of
    pressure release)."""

    def __init__(self, soft_bytes: int = 0, hard_bytes: int = 0,
                 on_transition: Optional[Callable[[str, str, int], None]]
                 = None, rss_reader=current_rss_bytes,
                 pressure: Optional[Callable[[], int]] = None):
        self.soft_bytes = int(soft_bytes)
        self.hard_bytes = int(hard_bytes)
        self.on_transition = on_transition
        self._rss_reader = rss_reader
        self._pressure = pressure  # chaos: extra simulated bytes
        self._lock = threading.Lock()
        self.state = OK
        self.last_rss = 0
        self.transitions = 0

    @property
    def enabled(self) -> bool:
        return self.soft_bytes > 0 or self.hard_bytes > 0

    def tick(self) -> str:
        if not self.enabled:
            return self.state  # don't even read /proc when disabled
        rss = self._rss_reader()
        if rss is None:
            # off-Linux: chaos-simulated pressure must still drive the
            # ladder (the soak/drill path), just without a real reading
            rss = 0
        if self._pressure is not None:
            try:
                rss += int(self._pressure())
            except Exception:
                pass
        return self.observe(rss)

    def observe(self, rss: int) -> str:
        if not self.enabled:
            return OK
        if self.hard_bytes and rss >= self.hard_bytes:
            new = SHEDDING
        elif self.soft_bytes and rss >= self.soft_bytes:
            new = DEGRADED
        else:
            new = OK
        with self._lock:
            self.last_rss = rss
            old, self.state = self.state, new
            if new != old:
                self.transitions += 1
        if new != old:
            log = (logger.error if new == SHEDDING
                   else logger.warning if new == DEGRADED else logger.info)
            log("overload state %s -> %s (rss=%d soft=%d hard=%d)",
                old, new, rss, self.soft_bytes, self.hard_bytes)
            if self.on_transition is not None:
                try:
                    self.on_transition(old, new, rss)
                except Exception:
                    logger.exception("overload transition hook failed")
        return new


class Supervisor:
    """Heartbeat watcher for the long-lived pipeline threads.

    Components `register` (or implicitly via the first `beat`) and then
    beat from their loop bodies; `probe`s are polled callables returning
    a monotonic stall counter (the native pump's `vnt_pump_stalls`).
    The watch loop runs on its own daemon thread at `poll_interval`;
    a component overdue past `deadline` is flagged (ERROR log + stall
    counter + event), and one overdue past `escalation_deadline` (when
    > 0) calls `escalate` — by default the flush-watchdog abort path:
    dump all thread stacks and exit hard so the process supervisor
    restarts a wedged instance (crash = recovery)."""

    def __init__(self, deadline: float, poll_interval: float = 1.0,
                 escalation_deadline: float = 0.0,
                 on_stall: Optional[Callable[[str, float], None]] = None,
                 escalate: Optional[Callable[[str, float], None]] = None,
                 clock=time.monotonic):
        self.deadline = float(deadline)
        self.poll_interval = max(0.05, float(poll_interval))
        self.escalation_deadline = float(escalation_deadline)
        self.on_stall = on_stall
        self._escalate = escalate if escalate is not None else _hard_abort
        self._clock = clock
        self._lock = threading.Lock()
        self._beats: Dict[str, float] = {}
        self._deadlines: Dict[str, float] = {}  # per-component overrides
        self._stalled: Dict[str, float] = {}  # name -> first-flagged at
        self.stall_counts: Dict[str, int] = {}
        self._probes: List[Tuple[str, Callable[[], int], int]] = []
        self.probe_stalls: Dict[str, int] = {}
        # the largest heartbeat age each check() saw per component
        self._max_age: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- component API ---------------------------------------------------

    def register(self, name: str,
                 deadline: Optional[float] = None) -> None:
        """`deadline` overrides the global one for this component — the
        flush loop beats once per interval, so its deadline must exceed
        the interval regardless of how tight the global deadline is."""
        with self._lock:
            self._beats.setdefault(name, self._clock())
            if deadline is not None:
                self._deadlines[name] = float(deadline)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._beats.pop(name, None)
            self._deadlines.pop(name, None)
            self._stalled.pop(name, None)
            # drop the component's probes too: a probe closure keeps its
            # owner (e.g. the native Pump) alive and polled forever, and
            # a listener restart would double-register under the name
            self._probes = [p for p in self._probes if p[0] != name]
            self.probe_stalls.pop(name, None)

    def beat(self, name: str) -> None:
        now = self._clock()
        with self._lock:
            self._beats[name] = now
            if name in self._stalled:
                del self._stalled[name]
                recovered = True
            else:
                recovered = False
        if recovered:
            logger.info("supervisor: %s heartbeat recovered", name)

    def add_probe(self, name: str, fn: Callable[[], int]) -> None:
        """A monotonic counter to watch; increases surface as stalls."""
        with self._lock:
            self._probes.append((name, fn, 0))
            self.probe_stalls.setdefault(name, 0)

    # -- watch loop ------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.deadline > 0

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="pipeline-supervisor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.check()
            except Exception:
                logger.exception("supervisor check failed")

    def check(self) -> List[str]:
        """One supervision pass; returns the names flagged stalled."""
        now = self._clock()
        flagged: List[str] = []
        with self._lock:
            beats = dict(self._beats)
            deadlines = dict(self._deadlines)
            probes = list(self._probes)
        with self._lock:
            for name, last in beats.items():
                if now - last > self._max_age.get(name, 0.0):
                    self._max_age[name] = now - last
        for name, last in beats.items():
            age = now - last
            if age <= deadlines.get(name, self.deadline):
                continue
            with self._lock:
                fresh = name not in self._stalled
                if fresh:
                    self._stalled[name] = now
                    self.stall_counts[name] = \
                        self.stall_counts.get(name, 0) + 1
                first = self._stalled[name]
            if fresh:
                flagged.append(name)
                logger.error(
                    "supervisor: %s stalled — no heartbeat for %.1fs "
                    "(deadline %.1fs)", name, age,
                    deadlines.get(name, self.deadline))
                if self.on_stall is not None:
                    try:
                        self.on_stall(name, age)
                    except Exception:
                        logger.exception("supervisor stall hook failed")
            stalled_for = now - first
            if (self.escalation_deadline > 0
                    and stalled_for >= self.escalation_deadline):
                logger.critical(
                    "supervisor: %s stalled past the escalation deadline "
                    "(%.1fs); escalating", name, stalled_for)
                self._escalate(name, age)
        for name, fn, seen in probes:
            try:
                value = int(fn())
            except Exception:
                continue
            if value > seen:
                with self._lock:
                    # identity-matched update: unregister() may have
                    # removed entries since the snapshot, so positional
                    # indexing would corrupt a different probe
                    for j, entry in enumerate(self._probes):
                        if entry[0] == name and entry[1] is fn:
                            self._probes[j] = (name, fn, value)
                            break
                    else:
                        continue  # unregistered mid-check: discard
                    self.probe_stalls[name] = \
                        self.probe_stalls.get(name, 0) + (value - seen)
                    total = self.probe_stalls[name]
                logger.warning(
                    "supervisor: probe %s advanced by %d (total %d)",
                    name, value - seen, total)
        return flagged

    def stalled_components(self) -> List[str]:
        with self._lock:
            return sorted(self._stalled)

    def max_heartbeat_ages(self) -> Dict[str, float]:
        """The largest heartbeat age (seconds) any check() saw per
        component, unregistered ones included."""
        with self._lock:
            return dict(self._max_age)

    def counts_snapshot(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """(stall_counts, probe_stalls) copies for scrape-time export —
        check() mutates both concurrently on the watch thread."""
        with self._lock:
            return dict(self.stall_counts), dict(self.probe_stalls)


def _hard_abort(name: str, age: float) -> None:
    """Default escalation: the flush-watchdog abort path (crash =
    recovery). Reports through the crash machinery (util/crash.py —
    Sentry-equivalent reporters see the stall before the process
    dies), dumps every thread's stack so the wedge is attributable
    post-mortem, then exits hard — daemon threads can't block it."""
    from veneur_tpu_torch.util import crash
    try:
        raise RuntimeError(
            f"pipeline supervisor: {name} stalled for {age:.1f}s "
            f"past the escalation deadline")
    except RuntimeError as exc:
        try:
            crash.consume_panic(exc)  # logs critical + notifies reporters
        except RuntimeError:
            pass  # consume_panic re-raises by contract; we exit below
    import faulthandler
    faulthandler.dump_traceback(all_threads=True)
    os._exit(3)


class OverloadManager:
    """One server's overload posture: admission buckets, the watermark
    ladder, kernel-drop polling, and the supervisor — plus the single
    monitor thread that ticks the pollable pieces and the telemetry
    collector that exports all of it."""

    def __init__(self, config, chaos=None,
                 on_transition: Optional[Callable] = None,
                 on_stall: Optional[Callable] = None,
                 escalate: Optional[Callable] = None):
        burst_s = max(0.1, float(
            getattr(config, "ingest_rate_limit_burst", 1.0)))
        statsd_rate = float(getattr(config, "ingest_rate_limit_statsd", 0))
        span_rate = float(getattr(config, "ingest_rate_limit_spans", 0))
        self.statsd_bucket = TokenBucket(
            statsd_rate, statsd_rate * burst_s)
        self.span_bucket = TokenBucket(span_rate, span_rate * burst_s)
        self.degraded_keep = min(1.0, max(0.0, float(
            getattr(config, "overload_watermark_degraded_keep", 0.25))))
        self._keep_roll = 0  # deterministic 1-in-N admission counter
        self.watermarks = WatermarkMonitor(
            soft_bytes=getattr(config, "overload_watermark_soft_bytes", 0),
            hard_bytes=getattr(config, "overload_watermark_hard_bytes", 0),
            on_transition=on_transition,
            pressure=(chaos.simulated_rss_bytes if chaos is not None
                      else None))
        # device watermark rung: HBM occupancy from the device
        # observatory's ledger, beside the host-RSS rung. The byte
        # source attaches late (attach_device_source) because the
        # observatory is constructed after this manager; until then the
        # reader returns None and the rung observes 0.
        self._device_source: Optional[Callable[[], int]] = None
        self.device_watermarks = WatermarkMonitor(
            soft_bytes=getattr(config, "overload_device_soft_bytes", 0),
            hard_bytes=getattr(config, "overload_device_hard_bytes", 0),
            on_transition=on_transition,
            rss_reader=self._read_device_bytes)
        self.kernel_drops = KernelDropMonitor()
        self.supervisor = Supervisor(
            deadline=getattr(config, "supervisor_deadline", 0.0),
            poll_interval=getattr(config, "supervisor_poll", 1.0),
            escalation_deadline=getattr(
                config, "supervisor_escalation_deadline", 0.0),
            on_stall=on_stall, escalate=escalate)
        self.poll_interval = max(0.05, float(
            getattr(config, "overload_watermark_poll", 1.0)))
        self._shed_lock = threading.Lock()
        self.shed_total: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- state -----------------------------------------------------------

    def attach_device_source(self, fn: Callable[[], int]) -> None:
        """Wire the HBM-ledger byte source (DeviceObservatory
        .total_bytes) into the device watermark rung."""
        self._device_source = fn

    def _read_device_bytes(self) -> Optional[int]:
        fn = self._device_source
        if fn is None:
            return None
        try:
            return int(fn())
        except Exception:
            logger.exception("device watermark byte source failed")
            return None

    @property
    def state(self) -> str:
        # severity max across the RSS and device-HBM rungs: either
        # breaching degrades/sheds, so the ladder below reads ONE state
        code = max(STATE_CODES[self.watermarks.state],
                   STATE_CODES[self.device_watermarks.state])
        return (OK, DEGRADED, SHEDDING)[code]

    # -- admission (the shed ladder) -------------------------------------

    def shed(self, cls: str, n: int = 1, reason: str = "") -> None:
        """Account one shed decision; every dropped sample lands here."""
        key = f"{cls}|{reason}" if reason else cls
        with self._shed_lock:
            self.shed_total[key] = self.shed_total.get(key, 0) + n

    def shed_snapshot(self) -> Dict[str, int]:
        """Copy of the shed table (class|reason -> n) — the flow
        ledger's ingress.shed probe source."""
        with self._shed_lock:
            return dict(self.shed_total)

    def admit_span(self) -> bool:
        """Spans shed first: any degradation state pauses span ingest,
        and the span-plane token bucket bounds the happy path."""
        if self.state != OK:
            self.shed(CLASS_SPAN, reason="overload")
            return False
        if not self.span_bucket.admit():
            self.shed(CLASS_SPAN, reason="rate_limit")
            return False
        return True

    def admit_spans(self, n: int) -> bool:
        """Batch form of admit_span for the native SSF buffer path
        (all-or-nothing: a native batch ingests as one unit). The token
        ask is clamped to the bucket's capacity — a batch larger than
        one burst would otherwise NEVER fit and be shed forever even on
        an idle server; clamping keeps the long-run rate bounded while
        treating an oversized batch as one full burst."""
        if self.state != OK:
            self.shed(CLASS_SPAN, n, reason="overload")
            return False
        bucket = self.span_bucket
        ask = min(float(n), bucket.burst) if bucket.burst else float(n)
        if not bucket.admit(ask):
            self.shed(CLASS_SPAN, n, reason="rate_limit")
            return False
        return True

    def admit_statsd_packet(self) -> bool:
        """Packet-level admission for the statsd plane (the TCP line
        path, where the line is the intake unit). False does NOT mean
        drop-the-packet — it means parse it in essential-only mode
        (the shed ladder protects counter/gauge deltas)."""
        return self.statsd_bucket.admit()

    def admit_statsd_batch(self, n: int) -> bool:
        """Batch admission for the columnar statsd plane: ONE bucket
        take per parsed batch, token cost = the batch's sample count —
        so the rate limit meters actual sample load, not packet counts,
        and admission overhead amortizes over tens of thousands of
        samples. Debt-style (TokenBucket.admit_debt): the full cost is
        always charged, so the limit holds exactly even when one pump
        chunk carries more samples than a whole burst — while a batch
        larger than the burst still gets through once the bucket is
        positive instead of starving forever. False means the batch's
        histogram/set/llhist columns are shed with exact per-class
        counts; counter/gauge columns still land."""
        return self.statsd_bucket.admit_debt(float(n))

    def histo_set_keep(self) -> float:
        """Fraction of histogram/set samples to admit right now, for
        batch (native-column) consumers: 1.0 in ok, the degraded keep
        ratio in degraded, 0.0 in shedding."""
        state = self.state
        if state == SHEDDING:
            return 0.0
        if state == DEGRADED:
            return self.degraded_keep
        return 1.0

    def admit_sample(self, cls: str, over_limit: bool = False) -> bool:
        """Per-sample ladder for histogram/set samples. Counter/gauge
        samples never pass through here — they are always admitted."""
        state = self.state
        if state == SHEDDING or over_limit:
            self.shed(cls, reason="rate_limit" if over_limit else "overload")
            return False
        if state == DEGRADED:
            # deterministic keep-1-in-N tightening: keeps the sample
            # stream statistically useful while cutting device pressure
            keep_every = max(1, round(1.0 / self.degraded_keep)) \
                if self.degraded_keep > 0 else 0
            if keep_every == 0:
                self.shed(cls, reason="degraded")
                return False
            with self._shed_lock:
                self._keep_roll += 1
                keep = (self._keep_roll % keep_every) == 0
            if not keep:
                self.shed(cls, reason="degraded")
            return keep
        return True

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self.supervisor.start()
        # the monitor thread only exists when it has something to poll:
        # watermarks configured, or UDP sockets registered for kernel-
        # drop visibility (Server.start() binds listeners before this)
        if self._thread is None and (self.watermarks.enabled
                                     or self.device_watermarks.enabled
                                     or self.kernel_drops.watching):
            self._thread = threading.Thread(
                target=self._monitor_loop, name="overload-monitor",
                daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.supervisor.stop()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.watermarks.tick()
                self.device_watermarks.tick()
                self.kernel_drops.poll()
            except Exception:
                logger.exception("overload monitor tick failed")

    # -- export ----------------------------------------------------------

    def telemetry_rows(self):
        """(name, kind, value, tags) rows for the /metrics collector."""
        rows = [("overload.state", "gauge",
                 float(STATE_CODES[self.state]), ()),
                ("overload.rss_state", "gauge",
                 float(STATE_CODES[self.watermarks.state]), ()),
                ("overload.rss_bytes", "gauge",
                 float(self.watermarks.last_rss), ()),
                ("overload.transitions", "counter",
                 float(self.watermarks.transitions), ()),
                ("overload.device_state", "gauge",
                 float(STATE_CODES[self.device_watermarks.state]), ()),
                ("overload.device_bytes", "gauge",
                 float(self.device_watermarks.last_rss), ()),
                ("overload.device_transitions", "counter",
                 float(self.device_watermarks.transitions), ())]
        with self._shed_lock:
            shed = dict(self.shed_total)
        for key, n in sorted(shed.items()):
            cls, _, reason = key.partition("|")
            tags = [f"class:{cls}"] + ([f"reason:{reason}"] if reason else [])
            rows.append(("ingest.shed_total", "counter", float(n), tags))
        for label, n in sorted(self.kernel_drops.totals().items()):
            rows.append(("ingest.kernel_drops", "counter", float(n),
                         [f"listener:{label}"]))
        sup = self.supervisor
        stall_counts, probe_stalls = sup.counts_snapshot()
        for name, n in sorted(stall_counts.items()):
            rows.append(("supervisor.stalls_total", "counter", float(n),
                         [f"component:{name}"]))
        for name, n in sorted(probe_stalls.items()):
            rows.append(("supervisor.probe_stalls_total", "counter",
                         float(n), [f"probe:{name}"]))
        rows.append(("supervisor.stalled_components", "gauge",
                     float(len(sup.stalled_components())), ()))
        return rows
