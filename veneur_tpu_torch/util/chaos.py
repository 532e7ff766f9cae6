"""Config-driven fault injection at the egress seams (the egress half of
veneur_tpu/util/chaos.py; its ingest, ledger-leak and reshard seams
wait for their planes).

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
                 forward_latency_ms: float = 0.0, sleep=time.sleep):
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
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._lock = threading.Lock()
        self.injected_errors: Dict[str, int] = {}
        self.injected_delays: Dict[str, int] = {}

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
                   forward_latency_ms=config.chaos_forward_latency_ms)

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

    def telemetry_rows(self):
        """(name, kind, value, tags) rows for the /metrics collectors."""
        with self._lock:
            rows = [("chaos.injected_errors", "counter", float(n),
                     [f"seam:{seam}"])
                    for seam, n in self.injected_errors.items()]
            rows.extend(("chaos.injected_delays", "counter", float(n),
                         [f"seam:{seam}"])
                        for seam, n in self.injected_delays.items())
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
