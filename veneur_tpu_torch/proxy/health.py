"""Active ring-membership health checks for the proxy's destination pool
(a copy of veneur_tpu/proxy/health.py).

Before this module the ring only reacted to a dead global instance
PASSIVELY: keys kept hashing at it until enough sends failed to open its
breaker (one full failure streak of real traffic, lost). The prober
turns that around — a dedicated loop probes every destination on a fixed
cadence, EJECTS a node from the hash ring after `unhealthy_after`
consecutive failures (traffic re-shards onto the survivors immediately,
~1/N of keys move), and READMITS it after `healthy_after` consecutive
passes (the original assignment is restored exactly, because ejection
never forgets the member's virtual points — they are recomputed from the
same address).

Probe kinds:

- ``tcp`` (default): a TCP connect to the destination's gRPC address —
  cheap, no HTTP surface needed on the import server, and exactly the
  reachability the sender cares about.
- ``http``: GET `url_template.format(host=..., port=...)` expecting 200
  — for deployments whose globals expose /healthcheck on a known port
  (template e.g. ``http://{host}:8127/healthcheck``), this is the
  richer readiness signal: a global that is listening but SHEDDING
  answers 503 and gets ejected before it blackholes merges.

Membership is re-resolved every probe round (`refresh` callback → the
proxy's discovery refresh): a DNS/SRV-backed discoverer re-resolves on
that cadence, so scale-ups surface at probe speed, not discovery speed.

The `health_probe` chaos seam (util/chaos.py) runs before every probe:
an injected fault fails the probe deterministically, which is how the
ejection/readmission machinery is tested without killing real sockets.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional

from veneur_tpu_torch.util import chaos as chaos_mod

logger = logging.getLogger("veneur_tpu_torch.proxy.health")


class _MemberHealth:
    __slots__ = ("failures", "passes", "ejected", "last_ok")

    def __init__(self):
        self.failures = 0
        self.passes = 0
        self.ejected = False
        self.last_ok = True


class RingHealth:
    """The probe loop. Owns per-member streak state; ejection/readmission
    act through the Destinations pool (which keeps the member OUT of the
    ring while ejected, even across discovery re-adds)."""

    def __init__(self, destinations, interval: float = 2.0,
                 timeout: float = 1.0, unhealthy_after: int = 3,
                 healthy_after: int = 2, probe: str = "tcp",
                 http_url_template: str = "",
                 refresh: Optional[Callable[[], None]] = None,
                 on_event: Optional[Callable[..., None]] = None):
        self.destinations = destinations
        self.interval = max(0.05, float(interval))
        self.timeout = max(0.05, float(timeout))
        self.unhealthy_after = max(1, int(unhealthy_after))
        self.healthy_after = max(1, int(healthy_after))
        if probe not in ("tcp", "http"):
            raise ValueError(f"unknown probe kind {probe!r}")
        if probe == "http" and not http_url_template:
            raise ValueError("http probe needs a url template")
        self.probe = probe
        self.http_url_template = http_url_template
        self._refresh = refresh
        self._on_event = on_event
        self._lock = threading.Lock()
        self._members: Dict[str, _MemberHealth] = {}
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.probes_total = 0
        self.probe_failures_total = 0
        self.ejections_total = 0
        self.readmissions_total = 0

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="ring-health", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.timeout + self.interval)

    def _loop(self) -> None:
        while not self._shutdown.wait(self.interval):
            try:
                self.run_round()
            except Exception:
                logger.exception("health probe round failed")

    # -- one round -------------------------------------------------------

    def run_round(self) -> None:
        """Refresh membership, probe every pool member, apply streaks.
        Public so tests (and the soak driver) can step it
        deterministically without the timer thread."""
        if self._refresh is not None:
            try:
                self._refresh()
            except Exception:
                logger.exception("membership refresh failed; probing "
                                 "current pool")
        addresses = self.destinations.addresses()
        with self._lock:
            # forget members discovery dropped entirely
            for address in list(self._members):
                if address not in addresses:
                    del self._members[address]
        if self._shutdown.is_set():
            return
        # probe concurrently: serial probing would make detection (and
        # stop()) latency scale as dead_members x timeout — with 5 of 20
        # globals down at a 1s timeout, a "2s" round would really take
        # ~5s. A straggler past the join bound counts as a failed probe.
        results: Dict[str, bool] = {}
        workers = []
        for address in addresses:
            t = threading.Thread(
                target=lambda a=address: results.__setitem__(
                    a, self._probe(a)),
                name=f"ring-probe-{address}", daemon=True)
            t.start()
            workers.append(t)
        # ONE wall-clock deadline for the whole round: per-thread join
        # budgets would let k hung probes (e.g. an unbounded
        # getaddrinfo) stretch a round to k x timeout
        round_deadline = time.monotonic() + self.timeout + 0.25
        for t in workers:
            t.join(timeout=max(0.0, round_deadline - time.monotonic()))
        pool_ejected = set(self.destinations.ejected_addresses())
        for address in addresses:
            if self._shutdown.is_set():
                return
            self._apply(address, results.get(address, False),
                        pool_ejected=address in pool_ejected)

    def _probe(self, address: str) -> bool:
        # runs on per-round probe threads: counters go under the lock
        with self._lock:
            self.probes_total += 1
        try:
            chaos_mod.inject("health_probe")
            if self.probe == "tcp":
                host, _, port = address.rpartition(":")
                host = host.strip("[]") or "127.0.0.1"
                with socket.create_connection((host, int(port)),
                                              timeout=self.timeout):
                    return True
            host, _, port = address.rpartition(":")
            bare = host.strip("[]")
            # an IPv6 literal must be re-bracketed inside a URL
            url = self.http_url_template.format(
                host=f"[{bare}]" if ":" in bare else bare, port=port)
            with urllib.request.urlopen(url, timeout=self.timeout) as resp:
                return 200 <= resp.status < 300
        except Exception:
            with self._lock:
                self.probe_failures_total += 1
            return False

    def _apply(self, address: str, ok: bool,
               pool_ejected: bool = False) -> None:
        eject = readmit = False
        with self._lock:
            mh = self._members.get(address)
            if mh is None:
                # a first-seen member may already be pool-ejected (our
                # streak state was pruned during a discovery blip while
                # the pool's ejection survived): seed it ejected so
                # passing probes readmit it instead of leaving a
                # healthy node out of the ring forever
                mh = self._members[address] = _MemberHealth()
                mh.ejected = pool_ejected
            mh.last_ok = ok
            if ok:
                mh.failures = 0
                mh.passes += 1
                readmit = mh.ejected and mh.passes >= self.healthy_after
            else:
                mh.passes = 0
                mh.failures += 1
                if not mh.ejected and mh.failures >= self.unhealthy_after:
                    mh.ejected = True
                    eject = True
        # its port answers, but its gRPC channel may still be in the
        # reconnect backoff of the outage: a batch routed to it now would
        # fail (and count toward its breaker), so it stays ejected, in
        # this table too, until a round finds the channel connected
        if readmit and self.destinations.channel_ready(address,
                                                       self.timeout):
            with self._lock:
                mh.ejected = False
        else:
            readmit = False
        if eject:
            self.ejections_total += 1
            self.destinations.eject(address)
            logger.warning("ring: ejected %s after %d failed probes",
                           address, self.unhealthy_after)
            self._event("ring_ejection", destination=address,
                        consecutive_failures=self.unhealthy_after)
        elif mh.ejected:
            # re-assert a standing ejection every round (idempotent):
            # a discovery drop-and-re-add between rounds clears the
            # pool's ejection mark and puts the member back in the ring
            # — without this, a still-dead node could serve keys while
            # this table reports it ejected
            self.destinations.eject(address)
        elif readmit:
            self.readmissions_total += 1
            self.destinations.readmit(address)
            logger.info("ring: readmitted %s after %d passing probes",
                        address, self.healthy_after)
            self._event("ring_readmission", destination=address,
                        consecutive_passes=self.healthy_after)

    def _event(self, kind: str, **fields) -> None:
        if self._on_event is not None:
            try:
                self._on_event(kind, **fields)
            except Exception:
                pass

    # -- state -----------------------------------------------------------

    def member_table(self) -> List[dict]:
        """Per-member health snapshot (the /healthcheck/ready body and
        /debug surfaces)."""
        with self._lock:
            return [{"address": address,
                     "ejected": mh.ejected,
                     "last_probe_ok": mh.last_ok,
                     "consecutive_failures": mh.failures,
                     "consecutive_passes": mh.passes}
                    for address, mh in sorted(self._members.items())]

    def ejected_count(self) -> int:
        with self._lock:
            return sum(1 for mh in self._members.values() if mh.ejected)

    def telemetry_rows(self) -> List[tuple]:
        with self._lock:
            ejected = sum(1 for mh in self._members.values() if mh.ejected)
            tracked = len(self._members)
        return [
            ("proxy.ring.members", "gauge", float(tracked - ejected), ()),
            ("proxy.ring.ejected", "gauge", float(ejected), ()),
            ("proxy.ring.ejections", "counter",
             float(self.ejections_total), ()),
            ("proxy.ring.readmissions", "counter",
             float(self.readmissions_total), ()),
            ("proxy.ring.probes", "counter", float(self.probes_total), ()),
            ("proxy.ring.probe_failures", "counter",
             float(self.probe_failures_total), ()),
        ]
