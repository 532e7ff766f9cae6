"""Config-driven fault injection at the egress, ingest and reshard seams
(port of veneur_tpu/util/chaos.py).

Every resilience behavior (retry, breaker trip/recover, carryover,
spill, ring ejection) must be testable deterministically, without a
flaky network under the test. This module plants four seams —
`forward_send` (the forward client and the proxy's destination
senders), `sink_flush` (the server's per-sink flush threads),
`http_post` (util/http.py) and `health_probe` (the proxy's ring health
probes) — and injects probabilistic errors and delays at them from a
SEEDED generator, so a 30 %-fault soak replays identically run to run,
and the same seed gives the JAX package's sequence.
`chaos_forward_latency_ms` adds a deterministic delay to every
`forward_send` crossing (hedging budgets, probe timeouts).

The ingest seams ride the same plan and the same seeded generator:

- `mangle_packets(batch)`: per-packet drop / truncate / duplicate rolls
  (`chaos_ingest_drop_rate`, `_truncate_rate`, `_duplicate_rate`),
  applied by the server's packet intake before parsing; exactly one
  action per packet, so surviving = sent - dropped + duplicated.
- `leak_sample()`: every `chaos_ledger_leak`-th admitted slow-path
  sample vanishes without accounting, the drill the flow ledger must
  catch.
- `simulated_rss_bytes()`: extra bytes (`chaos_ingest_rss_bytes`,
  settable at run time with `set_simulated_rss`) the overload watermark
  monitor adds to real RSS.

The reshard seams (parallel/reshard.py) are deterministic, with no roll:
`reshard_prewarm_delay()` sleeps in the plan thread
(`chaos_reshard_prewarm_delay_s`), `reshard_append_seam()` faults every
Nth range-segment append (`chaos_reshard_append_fault_nth`), and
`reshard_cutover_delay()` sleeps between the durable segments and their
merge-back (`chaos_reshard_cutover_delay_s`), the widest crash window.

Two ways to turn it on:

- config: `chaos_enabled: true` plus `chaos_error_rate` / `chaos_delay`
  / `chaos_delay_rate` / `chaos_seams` / `chaos_seed` /
  `chaos_forward_latency_ms`;
- tests: construct a `Chaos` directly and `install()` it (or pass it to
  the component under test).

The server owns its instance (two servers in one test process chaos
independently); the module-global `install()`ed instance backs the
seams with no object to hang state on (util.http.post, the proxy).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Dict, Optional, Sequence

logger = logging.getLogger("veneur_tpu_torch.util.chaos")

SEAMS = ("forward_send", "sink_flush", "http_post", "health_probe")


class ChaosError(RuntimeError):
    """The injected fault. Deliberately a plain exception (not an
    RpcError/HTTPError): every egress path must survive arbitrary
    transport blowups, not just the ones it expected."""

    def __init__(self, seam: str):
        super().__init__(f"chaos: injected fault at seam {seam!r}")
        self.seam = seam


class Chaos:
    """One fault-injection plan: per-seam probabilistic error/delay from
    a seeded RNG. Thread-safe; counters are exported as telemetry."""

    def __init__(self, enabled: bool = True, error_rate: float = 0.0,
                 delay_rate: float = 0.0, delay: float = 0.0,
                 seams: Sequence[str] = SEAMS, seed: int = 0,
                 forward_latency_ms: float = 0.0,
                 ingest_drop_rate: float = 0.0,
                 ingest_truncate_rate: float = 0.0,
                 ingest_duplicate_rate: float = 0.0,
                 ingest_rss_bytes: int = 0,
                 ledger_leak: int = 0,
                 reshard_prewarm_delay_s: float = 0.0,
                 reshard_append_fault_nth: int = 0,
                 reshard_cutover_delay_s: float = 0.0,
                 sleep=time.sleep):
        self.enabled = bool(enabled)
        self.error_rate = min(1.0, max(0.0, float(error_rate)))
        self.delay_rate = min(1.0, max(0.0, float(delay_rate)))
        self.delay = max(0.0, float(delay))
        # deterministic slow-destination seam: EVERY forward_send (and
        # every proxy destination send, which shares the seam) sleeps
        # this long before the real I/O — no RNG roll, so hedging
        # latency budgets and health-probe timeouts are testable without
        # a probabilistic soak. Independent of delay/delay_rate.
        self.forward_latency_ms = max(0.0, float(forward_latency_ms))
        self.seams = frozenset(seams or SEAMS)
        unknown = self.seams - set(SEAMS)
        if unknown:
            raise ValueError(f"unknown chaos seam(s) {sorted(unknown)}; "
                             f"veneur_tpu_torch has {list(SEAMS)}")
        self.ingest_drop_rate = min(1.0, max(0.0, float(ingest_drop_rate)))
        self.ingest_truncate_rate = min(
            1.0, max(0.0, float(ingest_truncate_rate)))
        self.ingest_duplicate_rate = min(
            1.0, max(0.0, float(ingest_duplicate_rate)))
        self._ingest_rss_bytes = max(0, int(ingest_rss_bytes))
        # ledger drill: every Nth admitted sample is dropped with no
        # shed accounting; the count lets the drill assert the ledger
        # found exactly it
        self.ledger_leak = max(0, int(ledger_leak))
        self._leak_roll = 0
        self.leaked_samples = 0
        # the reshard seams: no roll, so a crash drill hits the same
        # crossing every run
        self.reshard_prewarm_delay_s = max(0.0, float(reshard_prewarm_delay_s))
        self.reshard_append_fault_nth = max(0, int(reshard_append_fault_nth))
        self.reshard_cutover_delay_s = max(0.0, float(reshard_cutover_delay_s))
        self._reshard_append_roll = 0
        self.reshard_faulted_appends = 0
        self.reshard_injected_delays = 0
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._lock = threading.Lock()
        self.injected_errors: Dict[str, int] = {}
        self.injected_delays: Dict[str, int] = {}
        # per-action packet fault counts (drop/truncate/duplicate)
        self.packet_faults: Dict[str, int] = {}

    @classmethod
    def from_config(cls, config) -> Optional["Chaos"]:
        """Build from a Config's chaos_* fields; None when disabled."""
        if not config.chaos_enabled:
            return None
        return cls(enabled=True,
                   error_rate=config.chaos_error_rate,
                   delay_rate=config.chaos_delay_rate,
                   delay=config.chaos_delay,
                   seams=config.chaos_seams or SEAMS,
                   seed=config.chaos_seed,
                   forward_latency_ms=config.chaos_forward_latency_ms,
                   ingest_drop_rate=config.chaos_ingest_drop_rate,
                   ingest_truncate_rate=config.chaos_ingest_truncate_rate,
                   ingest_duplicate_rate=config.chaos_ingest_duplicate_rate,
                   ingest_rss_bytes=config.chaos_ingest_rss_bytes,
                   ledger_leak=config.chaos_ledger_leak,
                   reshard_prewarm_delay_s=config.chaos_reshard_prewarm_delay_s,
                   reshard_append_fault_nth=(
                       config.chaos_reshard_append_fault_nth),
                   reshard_cutover_delay_s=config.chaos_reshard_cutover_delay_s)

    def inject(self, seam: str) -> None:
        """Run the seam: maybe sleep, maybe raise ChaosError. Called on
        the egress thread right before the real I/O."""
        if not self.enabled or seam not in self.seams:
            return
        if self.forward_latency_ms > 0 and seam == "forward_send":
            # deterministic (not rolled) slow-destination delay; counted
            # with the probabilistic delays so a soak's accounting sums
            with self._lock:
                self.injected_delays[seam] = \
                    self.injected_delays.get(seam, 0) + 1
            self._sleep(self.forward_latency_ms / 1000.0)
        with self._lock:
            delay = (self.delay_rate > 0 and self.delay > 0
                     and self._rng.random() < self.delay_rate)
            fail = self.error_rate > 0 and self._rng.random() < self.error_rate
            if delay:
                self.injected_delays[seam] = \
                    self.injected_delays.get(seam, 0) + 1
            if fail:
                self.injected_errors[seam] = \
                    self.injected_errors.get(seam, 0) + 1
        if delay:
            self._sleep(self.delay)
        if fail:
            raise ChaosError(seam)

    # -- ingest-side faults ------------------------------------------------

    @property
    def ingest_faults_planned(self) -> bool:
        return (self.ingest_drop_rate > 0 or self.ingest_truncate_rate > 0
                or self.ingest_duplicate_rate > 0)

    def mangle_packets(self, batch):
        """Apply per-packet drop/truncate/duplicate rolls to a list of
        raw datagrams; returns the surviving (possibly mangled) batch.
        Exactly ONE action fires per packet (one uniform roll against
        stacked rate bands), so a soak's accounting is exact:
        surviving = sent - dropped + duplicated, of which `truncated`
        survive shortened by at least one byte (a single-metric line
        whose every prefix is invalid therefore parse-errors)."""
        if not self.enabled or not self.ingest_faults_planned:
            return batch
        out = []
        d, t = self.ingest_drop_rate, self.ingest_truncate_rate
        u = self.ingest_duplicate_rate
        for pkt in batch:
            with self._lock:
                roll = self._rng.random()
                if roll < d:
                    action = "drop"
                elif roll < d + t:
                    if len(pkt) < 2:
                        # 1-byte packets can't shorten; pass untouched
                        # rather than counting a fault that wasn't
                        out.append(pkt)
                        continue
                    action = "truncate"
                elif roll < d + t + u:
                    action = "duplicate"
                else:
                    out.append(pkt)
                    continue
                self.packet_faults[action] = \
                    self.packet_faults.get(action, 0) + 1
                cut = (1 + self._rng.randrange(len(pkt) - 1)
                       if action == "truncate" else 0)
            if action == "truncate":
                # runt datagram: cut mid-line, never the full packet
                out.append(pkt[:cut])
            elif action == "duplicate":
                out.append(pkt)
                out.append(pkt)
            # drop: the packet simply vanishes (counted above)
        return out

    def leak_sample(self) -> bool:
        """The deliberate silent-drop seam: True for every
        `ledger_leak`-th call (deterministic, no RNG), meaning the
        caller must drop the sample WITHOUT any shed accounting — the
        exact bug class the flow ledger exists to catch."""
        if not self.enabled or self.ledger_leak <= 0:
            return False
        with self._lock:
            self._leak_roll += 1
            if self._leak_roll >= self.ledger_leak:
                self._leak_roll = 0
                self.leaked_samples += 1
                return True
        return False

    # -- reshard seams -----------------------------------------------------

    def reshard_prewarm_delay(self) -> None:
        """Plan-thread crossing: a fixed sleep before the prewarm."""
        if not self.enabled or self.reshard_prewarm_delay_s <= 0:
            return
        with self._lock:
            self.reshard_injected_delays += 1
        self._sleep(self.reshard_prewarm_delay_s)

    def reshard_append_seam(self) -> None:
        """Cutover crossing: every `reshard_append_fault_nth`-th range
        segment append raises."""
        if not self.enabled or self.reshard_append_fault_nth <= 0:
            return
        with self._lock:
            self._reshard_append_roll += 1
            if self._reshard_append_roll >= self.reshard_append_fault_nth:
                self._reshard_append_roll = 0
                self.reshard_faulted_appends += 1
                raise ChaosError("reshard_append")

    def reshard_cutover_delay(self) -> None:
        """Handoff crossing: a fixed sleep after the range segments are
        durable, before any of them merges back."""
        if not self.enabled or self.reshard_cutover_delay_s <= 0:
            return
        with self._lock:
            self.reshard_injected_delays += 1
        self._sleep(self.reshard_cutover_delay_s)

    def simulated_rss_bytes(self) -> int:
        """Extra bytes the watermark monitor adds to real RSS."""
        if not self.enabled:
            return 0
        with self._lock:
            return self._ingest_rss_bytes

    def set_simulated_rss(self, nbytes: int) -> None:
        """Dial memory pressure up/down at runtime (soak control)."""
        with self._lock:
            self._ingest_rss_bytes = max(0, int(nbytes))

    def telemetry_rows(self):
        """(name, kind, value, tags) rows for the /metrics collectors."""
        with self._lock:
            rows = [("chaos.injected_errors", "counter", float(n),
                     [f"seam:{seam}"])
                    for seam, n in self.injected_errors.items()]
            rows.extend(("chaos.injected_delays", "counter", float(n),
                         [f"seam:{seam}"])
                        for seam, n in self.injected_delays.items())
            rows.extend(("chaos.packet_faults", "counter", float(n),
                         [f"action:{action}"])
                        for action, n in self.packet_faults.items())
            if self.leaked_samples:
                rows.append(("chaos.ledger_leaked", "counter",
                             float(self.leaked_samples), ()))
            if self.reshard_faulted_appends:
                rows.append(("chaos.injected_errors", "counter",
                             float(self.reshard_faulted_appends),
                             ["seam:reshard_append"]))
            if self.reshard_injected_delays:
                rows.append(("chaos.injected_delays", "counter",
                             float(self.reshard_injected_delays),
                             ["seam:reshard"]))
        return rows


# -- module-global instance (backs seams with no owning object) -----------

_active: Optional[Chaos] = None
_active_lock = threading.Lock()


def install(chaos: Optional[Chaos]) -> None:
    """Make `chaos` the process-global plan (None uninstalls). The server
    installs its instance at start when chaos_enabled, so the http_post
    seam inside util.http sees it too."""
    global _active
    with _active_lock:
        if chaos is not None:
            logger.warning(
                "CHAOS ENABLED: error_rate=%.2f delay_rate=%.2f "
                "delay=%.3fs seams=%s", chaos.error_rate,
                chaos.delay_rate, chaos.delay, sorted(chaos.seams))
        _active = chaos


def active() -> Optional[Chaos]:
    return _active


def inject(seam: str) -> None:
    """Module-level seam: no-op unless a plan is installed."""
    c = _active
    if c is not None:
        c.inject(seam)
