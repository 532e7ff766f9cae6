"""Token bucket and RSS reader of veneur_tpu/core/overload.py: the
forward client's WAL replay limiter (a stale backlog drains under it,
behind live traffic), and `current_rss_bytes`, which the diagnostics
self-metrics read. The rest of the JAX module, admission control and
the RSS watermark ladder, is not ported yet."""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

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
