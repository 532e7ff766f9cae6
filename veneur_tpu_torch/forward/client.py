"""Forward client: sends a local server's mergeable state to the global
tier once per interval (port of veneur_tpu/forward/client.py, reference
flusher.go:516-591), hardened with the resilience layer
(util/resilience.py, util/spool.py):

* each interval's payload carries one idempotency token, on every
  attempt. It goes out as one unary /forwardrpc.Forward/SendMetrics
  MetricList body first; an importer that refuses V1 (UNIMPLEMENTED,
  RESOURCE_EXHAUSTED) gets the same batch over the SendMetricsV2 stream,
  and the client stays on V2 from then on;
* transient failures (UNAVAILABLE, DEADLINE_EXCEEDED) retry with
  jittered backoff inside the interval's budget, each attempt's timeout
  the budget that remains;
* a circuit breaker stops hammering a down global (one half-open probe
  per recovery window);
* a FAILED interval is not dropped: its state is carried over and merged
  into the next interval's snapshot (counters sum, digests recompress,
  HLL registers max, llhist bins add), and past the carryover's bound
  spilled to the durable spool when one is configured, else shed loudly
  and counted;
* with `wal=True` every interval is appended to the spool (fsync'd,
  stamped with its interval start) BEFORE it is sent, and the spool's
  drain is the only send path: a crash between the append and the ack
  replays the interval at restart, exactly once through the segment's
  token (derived from its file name).

Chaos injection, the flow ledger, trace sidecars, shard metadata and TLS
are not ported yet.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Dict, Optional

import grpc

from veneur_tpu_torch.core.flusher import ForwardableState
from veneur_tpu_torch.forward.convert import forwardable_to_wire
from veneur_tpu_torch.forward.wire import (_serialize_metric,
                                           combine_metadata,
                                           decode_flow_counts,
                                           interval_metadata, send_batch,
                                           stamp_interval_wire,
                                           token_metadata)
from veneur_tpu_torch.util.resilience import (Carryover, CircuitBreaker,
                                              RetryPolicy)
from veneur_tpu_torch.util.spool import CarryoverSpool

logger = logging.getLogger("veneur_tpu_torch.forward.client")

# a V1 body scales with the key count (tens of MB at tens of thousands of
# digests): far past gRPC's 4 MB default
MAX_MESSAGE_BYTES = 256 << 20
# structural V1 refusals that pin the client to the V2 stream
_PIN_CODES = (grpc.StatusCode.UNIMPLEMENTED,
              grpc.StatusCode.RESOURCE_EXHAUSTED)
# transient transport states worth another attempt inside the budget;
# anything else (INTERNAL, INVALID_ARGUMENT, ...) fails fast
_RETRYABLE_CODES = (grpc.StatusCode.UNAVAILABLE,
                    grpc.StatusCode.DEADLINE_EXCEEDED)


def _raw(b):
    return b


class ForwardClient:
    """gRPC client for /forwardrpc.Forward on the generic channel API (no
    generated stubs). `stats` holds forwarded_total, the errors_* counts,
    retries_total, breaker_refused_total, and the receiver's cumulative
    FlowCounts (remote_received, remote_merged, remote_duplicates);
    `last_flow` is the last acknowledged send's decoded FlowCounts (None
    from a peer that answers Empty); `last_timings` the host seconds of
    the last forward() call's carryover merge, encode, WAL append and
    spool drain."""

    # drain attempts (while the destination is demonstrably up) before a
    # spool segment is declared undeliverable and quarantined
    SEGMENT_ATTEMPTS_MAX = 10

    def __init__(self, address: str, deadline: float = 10.0,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 carryover: Optional[Carryover] = None,
                 spool: Optional[CarryoverSpool] = None,
                 wal: bool = False, replay_limiter=None,
                 replay_stale_after: float = 0.0):
        self.address = address
        self.deadline = deadline
        self.retry = retry or RetryPolicy()
        self.breaker = breaker or CircuitBreaker(name=f"forward:{address}")
        self.carryover = carryover or Carryover()
        # durable spill: carryover past its age bound serializes into the
        # spool (instead of shedding) and drains oldest-first after the
        # next successful send; segments left by a dead process were
        # already re-scanned by the spool's constructor
        self.spool = spool
        if spool is not None and self.carryover.spill is None:
            self.carryover.spill = self._spill
        # WAL mode: append before send, the drain is the send path
        self.wal = bool(wal) and spool is not None
        # backfill throttle: segments older than `replay_stale_after`
        # seconds drain behind fresh ones and pay metric tokens from
        # `replay_limiter` (core.overload.TokenBucket)
        self.replay_limiter = replay_limiter
        self.replay_stale_after = float(replay_stale_after)
        self.wal_appended_metrics = 0
        self.wal_acked_metrics = 0
        self.wal_replay_throttled = 0
        # token = client identity + interval sequence
        self._token_id = uuid.uuid4().hex[:12]
        self._token_seq = 0
        # per-segment drain attempts that indict the segment (the peer
        # answered with a non-transient error)
        self._segment_attempts: Dict[str, int] = {}
        self._channel = grpc.insecure_channel(
            address, options=[
                ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
                ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                # a restarted global stays dialable within an interval
                ("grpc.initial_reconnect_backoff_ms", 250),
                ("grpc.min_reconnect_backoff_ms", 250),
                ("grpc.max_reconnect_backoff_ms", 2000)])
        self._send_v2 = self._channel.stream_unary(
            "/forwardrpc.Forward/SendMetricsV2",
            request_serializer=_serialize_metric,
            response_deserializer=_raw)
        # the V1 body is assembled from already-serialized metrics
        # (MetricList = repeated field-1 Metric): identity serializer
        self._send_v1 = self._channel.unary_unary(
            "/forwardrpc.Forward/SendMetrics",
            request_serializer=_raw, response_deserializer=_raw)
        self._v1_ok = True
        self.stats: Dict[str, int] = {
            "forwarded_total": 0, "errors_deadline": 0,
            "errors_unavailable": 0, "errors_send": 0,
            "retries_total": 0, "breaker_refused_total": 0,
            "remote_received": 0, "remote_merged": 0,
            "remote_duplicates": 0}
        self.last_flow: Optional[dict] = None
        self.last_timings: Dict[str, float] = {}

    @property
    def errors(self) -> int:
        return (self.stats["errors_deadline"]
                + self.stats["errors_unavailable"]
                + self.stats["errors_send"])

    def _note_flow(self, resp) -> None:
        flow = self.last_flow = decode_flow_counts(resp)
        if flow is not None:
            self.stats["remote_received"] += flow["received"]
            self.stats["remote_merged"] += flow["merged"]
            self.stats["remote_duplicates"] += int(flow["duplicate"])

    def _encode(self, fwd: ForwardableState):
        """`fwd.wire` when the caller encoded it already (a carryover
        merge invalidates it), else the frames encoded here."""
        if fwd.wire is not None:
            return fwd.wire
        t0 = time.perf_counter()
        protos = forwardable_to_wire(fwd)
        self.last_timings["forward_encode_s"] = time.perf_counter() - t0
        return protos

    def forward(self, fwd: ForwardableState,
                interval_start: float = 0.0) -> int:
        """Send one flush's state; returns the metrics delivered (0 on a
        failure, which is counted and logged and leaves the state in the
        carryover or the spool). `interval_start` is the unix time the
        snapshot's interval began (0 = unstamped): the WAL stamps it
        into the segment and onto the segment's sends, so a replay lands
        under its original interval at the global.

        Any pending carryover from failed intervals is first merged into
        `fwd`, so a success delivers everything owed."""
        self.last_timings = {}
        t0 = time.perf_counter()
        fwd = self.carryover.drain_into(fwd)
        self.last_timings["carryover_merge_s"] = time.perf_counter() - t0
        if self.wal:
            return self._forward_wal(fwd, interval_start)
        spool_pending = self.spool is not None and self.spool.depth > 0
        if not len(fwd) and not spool_pending:
            return 0
        if not self.breaker.allow():
            self.stats["breaker_refused_total"] += 1
            if len(fwd):
                self.carryover.stash(fwd)
                logger.warning(
                    "forward breaker %s to %s: carrying %d metrics over",
                    self.breaker.state, self.address, len(fwd))
            return 0
        protos = self._encode(fwd) if len(fwd) else []
        if not protos and not spool_pending:
            return 0
        deadline_ts = time.monotonic() + self.deadline
        resp = None
        if protos:
            # one token per interval payload, stable across every retry
            # and the V1->V2 fallback of this call
            self._token_seq += 1
            token = f"fwd:{self._token_id}:{self._token_seq}"
            delays = self.retry.delays(self.deadline)
            while True:
                try:
                    # per-attempt timeout is the REMAINING budget
                    timeout = max(0.05, deadline_ts - time.monotonic())
                    self._v1_ok, resp = send_batch(
                        self._send_v1, self._send_v2, protos, timeout,
                        self._v1_ok, pin_codes=_PIN_CODES,
                        metadata=token_metadata(token))
                    break
                except grpc.RpcError as e:
                    code = e.code()
                    delay = (next(delays, None) if code in _RETRYABLE_CODES
                             else None)
                    if delay is None:
                        self._record_failure(code, fwd, len(protos),
                                             e.details())
                        return 0
                    self.stats["retries_total"] += 1
                    logger.info(
                        "forward to %s failed (%s); retrying in %.2fs",
                        self.address, code, delay)
                    if delay > 0:
                        time.sleep(delay)
            self._note_flow(resp)
        # nothing fresh to send but the spool holds spilled state: the
        # drain itself probes the destination
        drained, drain_err, attempted = self._drain_spool(
            deadline_ts, destination_up=bool(protos))
        if not protos and drained == 0:
            if drain_err is not None:
                # the spool-only probe failed: destination still down
                self._record_failure(drain_err.code(), fwd, 0,
                                     drain_err.details())
                return 0
            if not attempted:
                # nothing sendable was found (every segment quarantined on
                # read): no evidence the peer is up, so release a
                # half-open probe pessimistically
                self.breaker.record_failure()
                return 0
        self.breaker.record_success()
        self.carryover.clear_age()
        self.stats["forwarded_total"] += len(protos)
        logger.debug("forwarded %d metrics to %s", len(protos), self.address)
        return len(protos) + drained

    def _record_failure(self, code, fwd: ForwardableState, n_protos: int,
                        details: str = "") -> None:
        if code == grpc.StatusCode.DEADLINE_EXCEEDED:
            self.stats["errors_deadline"] += 1
        elif code == grpc.StatusCode.UNAVAILABLE:
            self.stats["errors_unavailable"] += 1
        else:
            self.stats["errors_send"] += 1
        self.breaker.record_failure()
        if len(fwd):
            self.carryover.stash(fwd)
        logger.warning(
            "could not forward %d metrics to %s: %s %s (carryover depth %d)",
            n_protos, self.address, code, details, self.carryover.depth)

    # -- durable WAL -----------------------------------------------------

    def _forward_wal(self, fwd: ForwardableState,
                     interval_start: float) -> int:
        """WAL-mode forward: append the interval to disk first (fsync'd,
        stamped with its interval start), then drain the log oldest-
        first. Returns the metrics delivered."""
        if len(fwd):
            protos = self._encode(fwd)
            if protos:
                t0 = time.perf_counter()
                stamp = interval_start or time.time()
                self.spool.append(
                    [stamp_interval_wire(p, stamp) for p in protos],
                    interval_unix=stamp)
                self.last_timings["wal_append_s"] = (time.perf_counter()
                                                     - t0)
                self.wal_appended_metrics += len(protos)
        if self.spool.depth == 0:
            return 0
        if not self.breaker.allow():
            self.stats["breaker_refused_total"] += 1
            return 0
        deadline_ts = time.monotonic() + self.deadline
        drained, err, _attempted = self._drain_spool(deadline_ts,
                                                     destination_up=False)
        if drained:
            self.breaker.record_success()
            self.carryover.clear_age()
            self.stats["forwarded_total"] += drained
            self.wal_acked_metrics += drained
        elif err is not None:
            self._record_failure(err.code(), ForwardableState(), 0,
                                 err.details())
        else:
            # no RPC evidence the peer is up (every segment quarantined on
            # read): release a half-open probe pessimistically
            self.breaker.record_failure()
        return drained

    def _spill(self, fwd: ForwardableState) -> int:
        """Carryover's overflow hook: serialize the shed-bound state to
        the on-disk spool (the wire bytes a send would carry)."""
        return self.spool.append(forwardable_to_wire(fwd))

    def _drain_spool(self, deadline_ts: float, destination_up: bool):
        """Deliver spilled segments oldest-first until the spool is
        empty, the budget runs out, or a send fails (the segment stays for
        the next interval). Returns (metrics_drained, last_error,
        attempted); `attempted` is False when no RPC was made.

        Each segment's send carries its own token, `spool:<file name>`,
        stable for the segment's lifetime (across restarts too), and the
        segment's interval stamp. In WAL mode with `replay_stale_after`
        set, fresh segments drain first and stale ones behind them under
        the replay limiter (the first segment of a drain is exempt, so
        every drain makes progress).

        `destination_up` gates the quarantine count: a failure right
        after a successful main send indicts the segment, a failure on
        the spool-only probe is the outage continuing."""
        if self.spool is None:
            return 0, None, False
        t_drain = time.perf_counter()
        drained = 0
        err = None
        attempted = False
        sent_any = False
        now = time.time()
        stale_after = self.replay_stale_after if self.wal else 0.0
        ordered = self.spool.segments()
        if stale_after > 0:
            fresh = [s for s in ordered
                     if not s.interval_unix
                     or now - s.interval_unix <= stale_after]
            fresh_set = set(id(s) for s in fresh)
            ordered = fresh + [s for s in ordered
                               if id(s) not in fresh_set]
        for seg in ordered:
            remaining = deadline_ts - time.monotonic()
            if remaining <= 0.05:
                break
            is_stale = (stale_after > 0 and seg.interval_unix
                        and now - seg.interval_unix > stale_after)
            if (is_stale and sent_any and self.replay_limiter is not None
                    and not self.replay_limiter.admit(seg.count)):
                # out of replay tokens: everything after this segment is
                # at least as stale, so the backlog trickles next interval
                self.wal_replay_throttled += 1
                logger.info("WAL replay throttled at %s (%d segments "
                            "remain)", seg.path, self.spool.depth)
                break
            try:
                metrics = seg.read_metrics()
            except (OSError, ValueError) as e:
                logger.error("undeliverable spool segment %s: %s",
                             seg.path, e)
                self.spool.discard(seg)
                self._segment_attempts.pop(seg.path, None)
                continue
            token = "spool:" + seg.path.rsplit("/", 1)[-1]
            try:
                attempted = True
                self._v1_ok, resp = send_batch(
                    self._send_v1, self._send_v2, metrics, remaining,
                    self._v1_ok, pin_codes=_PIN_CODES,
                    metadata=combine_metadata(
                        token_metadata(token),
                        interval_metadata(seg.interval_unix)))
            except grpc.RpcError as e:
                err = e
                code = e.code()
                attempts = self._segment_attempts.get(seg.path, 0)
                # only a non-transient answer from a peer known to be up
                # indicts the segment; quarantining a deliverable interval
                # on an outage would BE the loss the spool prevents
                if (destination_up or sent_any) and code not in (
                        grpc.StatusCode.DEADLINE_EXCEEDED,
                        grpc.StatusCode.UNAVAILABLE):
                    attempts += 1
                    self._segment_attempts[seg.path] = attempts
                if attempts >= self.SEGMENT_ATTEMPTS_MAX:
                    logger.error(
                        "spool segment %s failed %d drain attempts; "
                        "quarantining", seg.path, attempts)
                    self.spool.discard(seg)
                    self._segment_attempts.pop(seg.path, None)
                    continue
                logger.warning(
                    "spool drain to %s stopped at %s: %s (%d segments "
                    "remain)", self.address, seg.path, e, self.spool.depth)
                break
            self.spool.pop(seg)
            sent_any = True
            self._segment_attempts.pop(seg.path, None)
            self._note_flow(resp)
            drained += len(metrics)
        if drained:
            logger.info("drained %d spilled metrics to %s (%d segments "
                        "remain)", drained, self.address, self.spool.depth)
        if len(self._segment_attempts) > 64:
            # segments can also leave through the spool's own bound shed:
            # prune to live paths so the map stays bounded
            live = self.spool.live_paths()
            self._segment_attempts = {p: n for p, n
                                      in self._segment_attempts.items()
                                      if p in live}
        self.last_timings["spool_drain_s"] = (
            self.last_timings.get("spool_drain_s", 0.0)
            + time.perf_counter() - t_drain)
        return drained, err, attempted

    def telemetry_rows(self):
        """(name, kind, value, tags) rows: the send and error counters,
        breaker, carryover, spool and WAL state."""
        rows = [(f"forward.{key}", "counter", float(value), ())
                for key, value in self.stats.items()]
        rows.append(("resilience.breaker_state", "gauge",
                     float(self.breaker.state_code), ["target:forward"]))
        rows.append(("resilience.breaker_opens", "counter",
                     float(self.breaker.open_total), ["target:forward"]))
        rows.append(("resilience.carryover_depth", "gauge",
                     float(self.carryover.depth), ()))
        rows.append(("resilience.carryover_merged", "counter",
                     float(self.carryover.merged_total), ()))
        rows.append(("resilience.carryover_shed", "counter",
                     float(self.carryover.shed_total), ()))
        rows.append(("resilience.carryover_spilled", "counter",
                     float(self.carryover.spilled_total), ()))
        if self.spool is not None:
            rows.extend(self.spool.telemetry_rows())
        if self.wal:
            rows.append(("wal.appended", "counter",
                         float(self.wal_appended_metrics), ()))
            rows.append(("wal.acked", "counter",
                         float(self.wal_acked_metrics), ()))
            rows.append(("wal.replay_throttled", "counter",
                         float(self.wal_replay_throttled), ()))
            rows.append(("wal.pending", "gauge",
                         float(self.spool.pending_metrics), ()))
        return rows

    def close(self) -> None:
        self._channel.close()
