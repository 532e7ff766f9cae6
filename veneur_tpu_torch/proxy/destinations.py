"""Destination pool: one buffered gRPC sender per global instance, plus
the consistent-hash ring that maps metric keys onto them (a copy of
veneur_tpu/proxy/destinations.py, with each send queue counting what
enters it and what leaves it under its own lock: see `_SendQueue`).
With the proxy's latency observatory, each send queue is the queue
`proxy_dest:<address>`: its depth and each metric's enqueue-to-send
dwell. Each batch carries the routing tier's active trace
lineage and exemplar sidecar, and its send is a `proxy.dest.send` span.

Parity with reference proxy/destinations/destinations.go:14-152 and
proxy/connect/connect.go: each destination has a bounded send queue
drained by a sender thread that batches metrics into
Forward.SendMetricsV2 client streams; a destination that keeps failing
closes itself and is removed from the ring, so traffic re-shards onto
the survivors until discovery re-adds it.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import uuid
from collections import deque
from typing import Callable, Dict, List, Optional

import grpc

from veneur_tpu_torch.forward.protos import metric_pb2
from veneur_tpu_torch.forward.wire import (_frame_v1, _serialize_metric,
                                           combine_metadata,
                                           decode_flow_counts,
                                           interval_metadata, send_batch,
                                           token_metadata, trace_metadata)
from veneur_tpu_torch.ops import hll_ref
from veneur_tpu_torch.proxy.ring import (ConsistentRing, EmptyRingError,
                                   ShardGroupRing, parse_shard_suffix)
from veneur_tpu_torch.util import chaos as chaos_mod
from veneur_tpu_torch.util.chaos import ChaosError
from veneur_tpu_torch.util.grpctls import (RECONNECT_BACKOFF_OPTIONS,
                                           GrpcTLS,
                                           secure_or_insecure_channel)
from veneur_tpu_torch.trace.store import EXEMPLAR_KEY
from veneur_tpu_torch.util.resilience import CircuitBreaker

logger = logging.getLogger("veneur_tpu_torch.proxy.destinations")

_EMPTY_DESERIALIZER = lambda _: b""  # noqa: E731


class _Sealed(Exception):
    """A put into a closed destination's queue."""


class _SendQueue(queue.Queue):
    """A destination's bounded send queue that counts, under the queue's
    own lock, the metrics put into it (`enqueued`) and those a drain took
    out that no outcome has booked yet (`taken`). The destination books
    outcomes under the same lock, so a ledger close, which reads depth +
    taken beside the counters, never finds a metric on neither side or
    on both (the JAX package counts after each queue call returns, and a
    close landing in between sees an imbalance that the next one
    reverses). With `dwell` (a LatencyHist) each item's enqueue-to-take
    seconds are observed, the stamps kept in FIFO order under the same
    lock (core/latency.py InstrumentedQueue)."""

    def __init__(self, maxsize: int = 0, dwell=None):
        self._dwell = dwell
        self._stamps: deque = deque()
        super().__init__(maxsize)

    def _init(self, maxsize):
        super()._init(maxsize)
        self.enqueued = 0
        self.taken = 0
        # set under the lock by the destination's close(): a put after
        # the close's final drain raises _Sealed instead of leaving a
        # metric in a queue no sender reads
        self.sealed = False

    def _put(self, item):
        if self.sealed:
            raise _Sealed()
        super()._put(item)
        self.enqueued += 1
        if self._dwell is not None:
            self._stamps.append(time.monotonic())

    def _get(self):
        self.taken += 1
        if self._dwell is not None and self._stamps:
            self._dwell.observe(time.monotonic() - self._stamps.popleft())
        return super()._get()


class Destination:
    def __init__(self, address: str,
                 on_close: Callable[["Destination"], None],
                 send_buffer: int = 4096, batch: int = 512,
                 flush_interval: float = 0.5,
                 max_consecutive_failures: int = 3,
                 tls: Optional[GrpcTLS] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 observatory=None,
                 hedge_after: float = 0.0,
                 hedge_peer: Optional[Callable[[], Optional["Destination"]]]
                 = None, ledger=None, trace_source=None, trace_plane=None):
        self.address = address
        self._on_close = on_close
        # self-tracing: `trace_source()` -> the routing tier's active
        # (trace_id, parent_span_id, exemplar_blob), re-injected on every
        # batch (hedges included); `trace_plane` records the send spans
        self._trace_source = trace_source
        self._trace_plane = trace_plane
        # proxy flow ledger: successful sends reconcile against the
        # receiver's FlowCounts response (proxy_tier identity); the
        # enqueue/sent/drop counters below feed the proxy_egress
        # identity via Destinations.flow_totals()
        self.ledger = ledger
        # hedged sends: when a batch's primary send exceeds
        # `hedge_after` seconds, the SAME batch (same idempotency token)
        # fires at the next healthy ring member via `hedge_peer`; the
        # import server's token dedupe keeps a late-landing primary from
        # double-merging on ITS node. 0 disables hedging.
        self._hedge_after = max(0.0, float(hedge_after))
        self._hedge_peer = hedge_peer
        self.hedge_fired_total = 0
        self.hedge_wins_total = 0
        # idempotency token namespace for this sender's batches
        self._token_id = uuid.uuid4().hex[:12]
        self._token_seq = 0
        # the latency observatory's `proxy_dest:<address>` queue: depth
        # and enqueue-to-send dwell (retired with the destination)
        self._observatory = (observatory if observatory is not None
                             and observatory.enabled else None)
        qname = f"proxy_dest:{address}"
        self._queue = _SendQueue(
            maxsize=send_buffer,
            dwell=(self._observatory.queue_hist(qname)
                   if self._observatory is not None else None))
        if self._observatory is not None:
            self._observatory.register_queue(qname, self._queue.qsize,
                                             send_buffer)
        self._batch = batch
        self._flush_interval = flush_interval
        # shared breaker replaces the old ad-hoc _failures counter: the
        # sender thread feeds it; opening it closes the destination
        # (ring removal — traffic re-shards onto the survivors until
        # discovery re-adds the address, reference destinations.go:99)
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=max_consecutive_failures,
            name=f"proxy-dest:{address}")
        self.closed = threading.Event()
        # the pool this destination's totals were folded into when it
        # left the ring (retire); None while it is live
        self._retired_into: Optional["Destinations"] = None
        # sent_total is written by this sender's thread AND (on a hedge
        # win) by a hedging peer's thread; += is not atomic, and the
        # soaks pin exact accounting. The queue's own lock: outcomes
        # book atomically with the queue's counts (never call a queue
        # method while holding it)
        self._counter_lock = self._queue.mutex
        self.sent_total = 0
        self.dropped_total = 0
        self.shed_open_total = 0  # immediate sheds while the breaker is open
        # wall seconds in batch sends, hedges included (a port addition:
        # the destination's side of the tier's time)
        self.send_seconds_total = 0.0
        # flow-ledger stage counters: metrics that made it INTO the
        # queue (the queue's `enqueued`), and the subset of dropped_total
        # lost AFTER enqueue (batch send failures, close-time drains) —
        # together with the live queue depth and the metrics drained but
        # not yet booked (`inflight_batch`) they satisfy enqueued ==
        # sent + dropped_enqueued + queued, pool-wide (hedge wins credit
        # the delivering peer's sent_total, so the identity holds only
        # in aggregate — and in aggregate is how the ledger checks it)
        self.dropped_enqueued_total = 0
        # distinct forwarded metric keys, as a p=14 HLL over the ring-key
        # hash (the proxy's side of the cardinality observatory: which
        # destination is absorbing a key explosion). Fed by note_key on
        # the routing path; cumulative for the destination's lifetime.
        self.key_hll = hll_ref.HLL()
        # shared backoff cap: a readmitted member must be dialable the
        # moment its probes pass, not whenever grpc's post-outage
        # backoff (20s+) next fires
        self._channel = secure_or_insecure_channel(
            address, tls, options=list(RECONNECT_BACKOFF_OPTIONS))
        # batches hold Metric objects (the V2 ingest path) or raw wire
        # bytes (the native V1 re-scatter): the serializer passes both
        self._send_v2 = self._channel.stream_unary(
            "/forwardrpc.Forward/SendMetricsV2",
            request_serializer=_serialize_metric,
            response_deserializer=_EMPTY_DESERIALIZER)
        # bulk path: one unary MetricList per batch instead of a
        # per-metric stream; a reference-style receiver that refuses it
        # pins this destination to V2 (same policy as ForwardClient)
        self._send_v1 = self._channel.unary_unary(
            "/forwardrpc.Forward/SendMetrics",
            request_serializer=lambda b: b,
            response_deserializer=_EMPTY_DESERIALIZER)
        self._v1_ok = True
        # the health prober's pending wait for the channel to connect
        # before a readmission (channel_ready)
        self._ready_future = None
        self._thread = threading.Thread(
            target=self._run, name=f"proxy-dest-{address}", daemon=True)
        self._thread.start()

    @property
    def enqueued_total(self) -> int:
        return self._queue.enqueued

    @property
    def inflight_batch(self) -> int:
        """Metrics drained from the queue and not yet booked sent or
        dropped: an inventory stock, so a close landing mid-send
        balances."""
        return self._queue.taken

    def _book(self, sent: int = 0, dropped: int = 0) -> None:
        """Book drained metrics as sent or dropped (after enqueue)."""
        self._count(sent=sent, dropped=dropped, dropped_enqueued=dropped,
                    taken=sent + dropped)

    def _count(self, sent: int = 0, dropped: int = 0,
               dropped_enqueued: int = 0, shed_open: int = 0,
               taken: int = 0) -> None:
        """Book outcomes into this destination's counters, or, once the
        pool has folded them into its retired counters (`retire`), into
        the pool's: every outcome lands in exactly one row, whichever
        side of the fold it is booked on. `taken` leaves the in-flight
        stock."""
        with self._counter_lock:
            pool = self._retired_into
            if pool is None:
                self.sent_total += sent
                self.dropped_total += dropped
                self.dropped_enqueued_total += dropped_enqueued
                self.shed_open_total += shed_open
                self._queue.taken -= taken
                return
        pool._count_retired(sent=sent, dropped=dropped,
                            dropped_enqueued=dropped_enqueued,
                            shed_open=shed_open, inflight=-taken)

    def retire(self, pool: "Destinations") -> dict:
        """Hand this destination's totals to `pool` (which folds them
        under its own lock) and route every later booking there."""
        with self._counter_lock:
            self._retired_into = pool
            return {"sent": self.sent_total, "dropped": self.dropped_total,
                    "shed_open": self.shed_open_total,
                    "enqueued": self._queue.enqueued,
                    "dropped_enqueued": self.dropped_enqueued_total,
                    "inflight": self._queue.taken + self._queue._qsize(),
                    "hedge_fired": self.hedge_fired_total,
                    "hedge_wins": self.hedge_wins_total}

    def note_key(self, key_hash: int) -> None:
        """Record one routed metric key (pre-hashed 64-bit). Lock-free
        register max: concurrent updates may lose a race, which can only
        UNDER-estimate by a hair — a counter-style lock on the per-metric
        routing path would cost more than the estimate is worth."""
        self.key_hll.insert_hash(key_hash)

    def send(self, metric: metric_pb2.Metric,
             interval: float = 0.0) -> bool:
        """Non-blocking enqueue first; fall back to a short blocking wait;
        drop if the destination is closed or still saturated (reference
        handlers.go:100-164 semantics).

        `interval` is the sender's ``x-veneur-interval`` stamp (0.0 =
        live traffic): it rides the queue with the metric and is
        re-attached as metadata on the outgoing batch, so a WAL replay
        routed THROUGH the proxy still backfills into its original
        interval on the global instead of folding into the live flush.

        The blocking fallback intentionally applies backpressure to the
        caller's stream — matching the reference, where a saturated
        destination channel stalls that gRPC handler goroutine. One sick
        destination therefore slows (but doesn't kill) streams whose
        metrics hash to it; the bound is one flush_interval per metric,
        after which the metric drops.

        A sick destination sheds immediately instead: with the breaker
        OPEN (or the queue full while the destination is mid failure
        streak) there is nothing to apply backpressure FOR — the old
        behavior stalled the gRPC handler a full flush_interval per
        metric that hashed here, for the whole window between the first
        failure and the breaker tripping."""
        if self.closed.is_set():
            self._count(dropped=1)
            return False
        if not self.breaker.is_dispatchable:
            self._count(dropped=1, shed_open=1)
            return False
        entry = (metric, float(interval))
        try:
            self._queue.put_nowait(entry)  # counts itself enqueued
            return True
        except queue.Full:
            pass
        except _Sealed:
            self._count(dropped=1)
            return False
        if self.breaker.consecutive_failures > 0:
            # failing-but-not-yet-open: the queue is full because the
            # sender can't drain it — blocking would stall the handler
            # without ever creating room
            self._count(dropped=1, shed_open=1)
            return False
        try:
            self._queue.put(entry, timeout=self._flush_interval)
            return True
        except (queue.Full, _Sealed):
            self._count(dropped=1)
            return False

    def _drain_batch(self) -> List[tuple]:
        """Up to one batch of (metric, interval) queue entries."""
        out: List[tuple] = []
        try:
            out.append(self._queue.get(timeout=self._flush_interval))
        except queue.Empty:
            return out
        while len(out) < self._batch:
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return out

    def _run(self) -> None:
        while not self.closed.is_set():
            entries = self._drain_batch()
            if not entries:
                continue
            # one RPC per interval stamp: queue entries carry the
            # sender's x-veneur-interval (0.0 = live), and metadata is
            # per-RPC, so a drained batch mixing a WAL replay with live
            # traffic splits on the stamp boundaries (order preserved —
            # consecutive runs, no reordering)
            # every drained entry must be accounted (sent or dropped)
            # before this thread exits, or the proxy_egress identity
            # (enqueued == sent + dropped_enqueued + queued) leaks: a
            # mid-batch abort books the not-yet-attempted remainder as
            # dropped — close() only drains what is still queued
            start = 0
            while start < len(entries):
                interval = entries[start][1]
                end = start
                while end < len(entries) and entries[end][1] == interval:
                    end += 1
                batch = [m for m, _iv in entries[start:end]]
                start = end
                if not self._send_one(batch, interval):
                    leftover = len(entries) - start
                    if leftover:
                        self._book(dropped=leftover)
                    return

    def _trace_open(self, batch_len: int):
        """(extra metadata, proxy.dest.send span) for one batch; both
        None when no lineage is active."""
        src = self._trace_source
        if src is None:
            return None, None
        trace_id, parent_sid, blob = src()
        if not trace_id:
            return None, None
        span = None
        if self._trace_plane is not None:
            span = self._trace_plane.span(
                "proxy.dest.send", trace_id, parent_id=parent_sid,
                tags={"destination": self.address,
                      "metrics": str(batch_len)})
        parts = [trace_metadata(
            trace_id, span.id if span is not None else parent_sid)]
        if blob:
            parts.append(((EXEMPLAR_KEY, blob),))
        return combine_metadata(*parts), span

    def _send_one(self, batch: List, interval: float) -> bool:
        """One batch's send attempt (breaker, hedging, accounting);
        returns False when the destination closed itself (breaker
        open) and the sender thread must exit. The batch was drained
        (in flight) and is booked sent or dropped here."""
        booked = False
        self._token_seq += 1
        token = f"dest:{self._token_id}:{self._token_seq}"
        extra_md, send_span = self._trace_open(len(batch))
        if interval:
            extra_md = combine_metadata(extra_md,
                                        interval_metadata(interval))
        t0 = time.perf_counter()
        try:
            hedge_won = False
            if self._hedge_after > 0 and self._hedge_peer is not None:
                # the chaos seam runs INSIDE the hedge-timed window
                # (chaos_forward_latency_ms makes THIS the slow
                # primary the budget fires against)
                hedge_won = self._send_hedged(batch, token,
                                              extra_md=extra_md)
            else:
                # the forward_send chaos seam covers proxy senders
                # too: injected errors exercise the breaker and
                # ejection paths deterministically
                chaos_mod.inject("forward_send")
                self.send_now(batch, token, extra_md=extra_md)
            if send_span is not None and hedge_won:
                send_span.set_tag("hedged", "true")
            if hedge_won:
                # the PEER delivered (and was credited inside
                # _send_hedged); the blown budget is a failure
                # signal for THIS node — a destination that never
                # completes inside the budget must eventually trip
                # its breaker so routing fails over instead of
                # paying hedge_after + a doubled RPC forever. No
                # close() here: probes/half-open own recovery.
                self.breaker.record_failure()
                self._count(taken=len(batch))
            else:
                # credit + in-flight clear under ONE lock hold so a
                # concurrent flow_totals() never sees the batch as
                # both sent and in flight
                self._book(sent=len(batch))
                self.breaker.record_success()
            booked = True
        except (grpc.RpcError, ChaosError) as e:
            if send_span is not None:
                send_span.error()
            self.breaker.record_failure()
            self._book(dropped=len(batch))
            booked = True
            code = e.code() if hasattr(e, "code") else None
            logger.warning("send to %s failed (%s), breaker %s",
                           self.address, code, self.breaker.state)
            if not self.breaker.is_dispatchable:
                self.close(notify=True)
                return False
        finally:
            if not booked:
                # an unexpected error loses the batch: clearing it from
                # the stock shows the loss as an imbalance
                self._count(taken=len(batch))
            with self._counter_lock:
                self.send_seconds_total += time.perf_counter() - t0
            if send_span is not None:
                send_span.finish()
        return True

    def send_now(self, batch, token: str, timeout: float = 10.0,
                 extra_md=None):
        """One blocking batch send with the idempotency token attached —
        also the entry point a PEER uses to deliver a hedged batch
        through this destination's channel. Raises grpc.RpcError on
        failure (the caller owns breaker/drop accounting). Returns the
        raw response bytes (the receiver's FlowCounts, when upgraded),
        already reconciled into the proxy's flow ledger. `extra_md`
        carries the batch's interval stamp, identical across a hedge
        pair.

        Proxy batches are <= self._batch small metrics, so
        RESOURCE_EXHAUSTED is far likelier transient receiver overload
        than an oversized body: retry via V2 but keep preferring V1;
        only UNIMPLEMENTED pins."""
        self._v1_ok, resp = send_batch(
            self._send_v1, self._send_v2, batch, timeout,
            self._v1_ok,
            pin_codes=(grpc.StatusCode.UNIMPLEMENTED,),
            retry_codes=(grpc.StatusCode.RESOURCE_EXHAUSTED,),
            metadata=combine_metadata(token_metadata(token), extra_md))
        self._note_tier(len(batch), resp)
        return resp

    def _note_tier(self, sent: int, resp) -> None:
        """Reconcile one acked batch against the receiver's FlowCounts
        (the proxy_tier identity); empty response = un-upgraded peer."""
        led = self.ledger
        if led is None or not sent:
            return
        counts = decode_flow_counts(resp)
        if counts is None:
            return
        # one lock hold: the proxy's ledger closes on its own thread
        if counts["duplicate"]:
            led.note_all((("dest.acked_reported", sent),
                          ("dest.remote_deduped", sent)))
            return
        merged = int(counts["merged"])
        received = int(counts["received"])
        led.note_all((("dest.acked_reported", sent),
                      ("dest.remote_merged", merged),
                      ("dest.remote_rejected", max(0, received - merged))))

    def _send_hedged(self, batch, token: str,
                     timeout: float = 10.0, extra_md=None) -> bool:
        """Primary send with a latency budget: past `hedge_after`
        seconds the same batch (same token) fires at the next healthy
        ring member. First success wins; the loser is cancelled. The
        token makes a retry/hedge landing twice on ONE node merge once;
        see the README's hedging caveats for the cross-node window.
        Returns True when the PEER delivered the batch (the caller
        treats that as a failure signal for this node's breaker).

        The forward_send chaos seam runs inside the budget window, so
        chaos_forward_latency_ms >= the budget deterministically fires
        the hedge (the knob's reason to exist)."""
        budget_start = time.monotonic()
        chaos_mod.inject("forward_send")
        md = combine_metadata(token_metadata(token), extra_md)
        was_v1 = self._v1_ok
        if was_v1:
            body = b"".join(_frame_v1(m) for m in batch)
            fut = self._send_v1.future(body, timeout=timeout, metadata=md)
        else:
            fut = self._send_v2.future(iter(batch), timeout=timeout,
                                       metadata=md)
        remaining = max(0.0, self._hedge_after
                        - (time.monotonic() - budget_start))
        try:
            self._note_tier(len(batch), fut.result(timeout=remaining))
            return False
        except grpc.FutureTimeoutError:
            pass  # primary slow: hedge below
        except grpc.RpcError as e:
            code = e.code() if hasattr(e, "code") else None
            if was_v1 and code in (grpc.StatusCode.UNIMPLEMENTED,
                                   grpc.StatusCode.RESOURCE_EXHAUSTED):
                # V1 refusal: re-send through the SHARED transport
                # helper (send_now -> wire.send_batch) so the pin/retry
                # fallback policy lives in exactly one place; the token
                # makes the repeat attempt duplicate-safe
                self.send_now(batch, token, timeout=timeout,
                              extra_md=extra_md)
                return False
            raise
        peer = None
        try:
            peer = self._hedge_peer()
        except Exception:
            logger.exception("hedge peer selection failed")
        if peer is None or peer is self or peer.closed.is_set():
            # nobody to hedge to: wait out the primary
            self._note_tier(len(batch), fut.result())
            return False
        self.hedge_fired_total += 1
        logger.info("hedging slow send to %s via %s (budget %.3fs)",
                    self.address, peer.address, self._hedge_after)
        try:
            # the SAME token rides the hedge: whichever attempt the
            # global accepts merges, the loser is dropped whole by it
            peer.send_now(batch, token, timeout=timeout,
                          extra_md=extra_md)
        except (grpc.RpcError, ChaosError):
            # hedge lost too: the primary is the last hope (may raise)
            self._note_tier(len(batch), fut.result())
            return False
        self.hedge_wins_total += 1
        # delivery is credited to the node that actually absorbed it
        peer._count(sent=len(batch))
        fut.cancel()
        return True

    def channel_ready(self, timeout: float) -> bool:
        """Whether the gRPC channel is connected, waiting up to `timeout`
        (a connection attempt starts when none runs). A member that
        answers its probes again may still sit in its channel's
        reconnect backoff, where a batch fails at once; the prober
        readmits it only once this holds. Called by the prober only."""
        if self._ready_future is None:
            self._ready_future = grpc.channel_ready_future(self._channel)
        try:
            self._ready_future.result(timeout=timeout)
        except grpc.FutureTimeoutError:
            return False
        self._ready_future = None
        return True

    def close(self, notify: bool = False) -> None:
        if self.closed.is_set():
            return
        self.closed.set()
        if self._ready_future is not None:
            self._ready_future.cancel()
        with self._counter_lock:
            self._queue.sealed = True
        # final drain: items still queued at shutdown will never send —
        # they count as drops instead of vanishing from the accounting
        drained = 0
        while True:
            try:
                self._queue.get_nowait()
                drained += 1
            except queue.Empty:
                break
        if drained:
            self._book(dropped=drained)
            logger.info("destination %s closed with %d undelivered "
                        "metrics (counted dropped)", self.address, drained)
        if self._observatory is not None:
            # discovery churn must not grow the observatory
            self._observatory.unregister_queue(f"proxy_dest:{self.address}")
        if notify:
            self._on_close(self)
        try:
            self._channel.close()
        except Exception:
            pass


class Destinations:
    """The live pool: address -> Destination plus the ring."""

    def __init__(self, send_buffer: int = 4096, batch: int = 512,
                 flush_interval: float = 0.5,
                 tls: Optional[GrpcTLS] = None,
                 max_consecutive_failures: int = 3,
                 observatory=None,
                 hedge_after: float = 0.0,
                 failover_walk: int = 2,
                 ledger=None, trace_plane=None,
                 shard_groups: int = 0):
        self._ledger = ledger
        # latest active trace lineage: (trace_id, parent_span_id,
        # exemplar_blob), set by the routing handlers per RPC (one tuple
        # assignment) and read by every sender at batch time;
        # (0, 0, None) is untraced traffic
        self._trace_plane = trace_plane
        self._active_trace = (0, 0, None)
        self._lock = threading.RLock()
        self._pool: Dict[str, Destination] = {}
        # shard-aware ring (shard_groups > 1): the key-digest space
        # splits into G contiguous ranges, each with its own consistent
        # ring of the global instances serving that range's device
        # shards — ejection re-homes only the sick member's key range
        # within its group (proxy/ring.py ShardGroupRing)
        self.shard_groups = max(0, int(shard_groups))
        self.ring = (ShardGroupRing(self.shard_groups)
                     if self.shard_groups > 1 else ConsistentRing())
        self.group_spill_total = 0
        self._send_buffer = send_buffer
        self._batch = batch
        self._flush_interval = flush_interval
        self._tls = tls
        self._max_failures = max_consecutive_failures
        self._observatory = observatory
        self._hedge_after = max(0.0, float(hedge_after))
        # bounded failover: how many ADDITIONAL ring members past the
        # primary a sick key's lookup may walk; deterministic, so every
        # proxy re-homes the key to the same survivor
        self._failover_walk = max(0, int(failover_walk))
        # health-ejected members: kept in the POOL (their sender drains
        # and probes keep targeting them) but out of the RING, so no new
        # keys hash there — and discovery re-adding the address must not
        # sneak it back into the ring before the prober readmits it
        self._ejected: set = set()
        self.failover_routed_total = 0
        # point -> (survivor address, stamp): while a primary is sick
        # but not yet health-ejected, every routed metric would re-walk
        # the ring for the same answer — memoized for a short TTL (the
        # window itself ends at ejection, which removes the node from
        # the ring and makes normal hashing correct again)
        self._failover_cache: Dict[int, tuple] = {}
        # counters of destinations that left the pool (self-closed on
        # breaker open, or dropped by discovery): without this fold the
        # pool's lifetime sent/dropped accounting silently resets on
        # churn — exactly when an operator is trying to balance a loss.
        # The flow-ledger stage counters (enqueued, dropped-after-
        # enqueue, hedge outcomes) fold too, so /debug/ledger totals
        # survive ring membership changes instead of going negative at
        # the next probe delta.
        self.retired_sent_total = 0
        self.retired_dropped_total = 0
        self.retired_shed_open_total = 0
        self.retired_enqueued_total = 0
        self.retired_dropped_enqueued_total = 0
        self.retired_hedge_fired_total = 0
        self.retired_hedge_wins_total = 0
        # metrics retired destinations had drained and not yet booked:
        # their senders book them here after the fold (Destination._count)
        self.retired_inflight = 0

    def set_destinations(self, addresses: List[str]) -> None:
        """Reconcile the pool with a fresh discovery result. With shard
        groups enabled, a discovered address may pin its group with an
        ``addr#<g>`` suffix (stripped before dialing); unsuffixed
        addresses hash to a group stably."""
        with self._lock:
            parsed = []
            for raw_addr in addresses:
                address, group = parse_shard_suffix(raw_addr)
                if group is not None \
                        and isinstance(self.ring, ShardGroupRing):
                    try:
                        self.ring.assign(address, group)
                    except ValueError:
                        logger.warning(
                            "discovery tried to move live member %s to "
                            "shard group %d; keeping its current group",
                            address, group)
                parsed.append(address)
            addresses = parsed
            wanted = set(addresses)
            for address in list(self._pool):
                if address not in wanted:
                    self._remove_locked(address)
            for address in addresses:
                if address not in self._pool:
                    self._pool[address] = Destination(
                        address, self._on_destination_closed,
                        send_buffer=self._send_buffer, batch=self._batch,
                        flush_interval=self._flush_interval, tls=self._tls,
                        max_consecutive_failures=self._max_failures,
                        observatory=self._observatory,
                        hedge_after=self._hedge_after,
                        hedge_peer=(lambda a=address:
                                    self.hedge_peer_for(a)),
                        ledger=self._ledger,
                        trace_source=self._trace_context,
                        trace_plane=self._trace_plane)
                    if address not in self._ejected:
                        self.ring.add(address)

    def regroup(self, shard_groups: int) -> int:
        """Follow a serving-tier elastic reshard (parallel/reshard.py):
        re-partition the door's digest-range groups to the new shard
        count. Sticky assignments survive (proxy/ring.py regroup), so
        every key whose group membership didn't change keeps its owner
        exactly; ejected members stay out of the ring and rejoin their
        (re-derived) group at readmission. Returns the number of
        members whose group changed."""
        with self._lock:
            if not isinstance(self.ring, ShardGroupRing):
                raise ValueError(
                    "shard groups are not enabled on this pool")
            moved = self.ring.regroup(int(shard_groups))
            self.shard_groups = int(shard_groups)
            # memoized failover survivors reference old-group walks
            self._failover_cache.clear()
            return moved

    def addresses(self) -> List[str]:
        """Current pool membership (discovery/elasticity observability)."""
        with self._lock:
            return sorted(self._pool)

    def note_trace(self, trace_id: int, parent_span_id: int,
                   exemplar_blob) -> None:
        """Latch the routing tier's active lineage (latest wins); the
        senders re-inject it on their next batch. (0, 0, None) clears."""
        self._active_trace = (int(trace_id), int(parent_span_id),
                              exemplar_blob)

    def _trace_context(self):
        return self._active_trace

    def _retire_locked(self, dest: Destination) -> None:
        """Fold a departing destination's totals into the retired
        counters; what it books afterwards (a route that raced its
        close, its sender's leftover, a hedge credited to it) comes
        here through _count_retired."""
        t = dest.retire(self)
        self.retired_sent_total += t["sent"]
        self.retired_dropped_total += t["dropped"]
        self.retired_shed_open_total += t["shed_open"]
        self.retired_enqueued_total += t["enqueued"]
        self.retired_dropped_enqueued_total += t["dropped_enqueued"]
        self.retired_inflight += t["inflight"]
        self.retired_hedge_fired_total += t["hedge_fired"]
        self.retired_hedge_wins_total += t["hedge_wins"]

    def _count_retired(self, sent: int = 0, dropped: int = 0,
                       dropped_enqueued: int = 0, shed_open: int = 0,
                       inflight: int = 0) -> None:
        with self._lock:
            self.retired_sent_total += sent
            self.retired_dropped_total += dropped
            self.retired_dropped_enqueued_total += dropped_enqueued
            self.retired_shed_open_total += shed_open
            self.retired_inflight += inflight

    def _remove_locked(self, address: str) -> None:
        dest = self._pool.pop(address, None)
        self.ring.remove(address)
        # discovery dropped the member outright: clear its ejection so a
        # future re-add starts fresh in the ring
        self._ejected.discard(address)
        if dest is not None:
            dest.close()
            # close() drained the queue into dropped_total, so the fold
            # runs after it — nothing in flight escapes the accounting
            self._retire_locked(dest)

    def _on_destination_closed(self, dest: Destination) -> None:
        """Self-removal on connection failure (destinations.go:99-110);
        discovery re-adds the address when it becomes healthy again."""
        with self._lock:
            if self._pool.get(dest.address) is dest:
                self._pool.pop(dest.address)
                self.ring.remove(dest.address)
                self._retire_locked(dest)

    # -- health ejection (proxy/health.py drives these) ------------------

    def eject(self, address: str) -> None:
        """Take a member out of the RING (keys re-shard onto survivors)
        while keeping its pool entry alive for probes and queue drain."""
        with self._lock:
            self._ejected.add(address)
            self.ring.remove(address)

    def readmit(self, address: str) -> None:
        """Restore an ejected member's ring points — identical virtual
        points recompute from the same address, so every key it owned
        returns to it exactly."""
        with self._lock:
            self._ejected.discard(address)
            if address in self._pool:
                self.ring.add(address)

    def ejected_addresses(self) -> List[str]:
        with self._lock:
            return sorted(self._ejected)

    def channel_ready(self, address: str, timeout: float) -> bool:
        """Destination.channel_ready of `address` (True when it left the
        pool: nothing routes to it)."""
        with self._lock:
            dest = self._pool.get(address)
        return dest is None or dest.channel_ready(timeout)

    def group_table(self) -> List[dict]:
        """Per-shard-group membership/health snapshot (ready-state and
        /debug surfaces); empty when shard groups are disabled. A group
        with live=[] has lost its whole key range to clockwise spill —
        the degraded-mesh runbook's page-now condition."""
        if self.shard_groups <= 1:
            return []
        with self._lock:
            live = self.ring.group_members()
            ejected_by_group: List[List[str]] = [
                [] for _ in range(self.shard_groups)]
            for address in sorted(self._ejected):
                ejected_by_group[self.ring.group_of(address)].append(
                    address)
        return [{"group": g, "live": live[g],
                 "ejected": ejected_by_group[g]}
                for g in range(self.shard_groups)]

    def _note_group_spill(self, point: int, address: str) -> None:
        """Count a metric routed onto a member outside its key's shard
        group (caller holds _lock). Every return path of get_at runs
        this — primary hop, failover cache hit, failover walk — so
        proxy.ring.group_spill is the complete off-range routing count,
        not just the empty-group clockwise spill."""
        if (self.shard_groups > 1
                and self.ring.group_of(address)
                != self.ring.group_of_point(point)):
            self.group_spill_total += 1

    def hedge_peer_for(self, address: str) -> Optional[Destination]:
        """The next healthy DISTINCT ring member clockwise from
        `address`'s own first virtual point — the deterministic hedge
        target for a slow primary. With shard groups the candidates are
        confined to `address`'s OWN group (a hedge duplicates a batch
        of the primary's key range; landing it on another group would
        merge those keys off-range silently) — a group with no healthy
        sibling simply doesn't hedge."""
        with self._lock:
            if isinstance(self.ring, ShardGroupRing):
                candidates = self.ring.group_siblings(
                    address, len(self._pool) or 1)
            else:
                try:
                    candidates = self.ring.walk_at(
                        self.ring.point_of(address), len(self._pool) or 1)
                except EmptyRingError:
                    return None
            for candidate in candidates:
                if candidate == address:
                    continue
                dest = self._pool.get(candidate)
                if (dest is not None and not dest.closed.is_set()
                        and dest.breaker.likely_dispatchable):
                    return dest
            return None

    def get(self, key: str) -> Destination:
        return self.get_at(self.ring.point_of(key))

    def get_at(self, point: int) -> Destination:
        """Lookup by pre-computed ring point (ring.point_of): the proxy
        route cache stores points so the per-metric hot path skips the
        Python fnv hash entirely.

        Failover: a healthy primary answers directly (ejected members
        are already out of the ring, so this is the common path). A
        primary whose breaker is open or whose sender closed re-homes
        the key with a bounded deterministic walk to the next healthy
        member — mergeable state keeps flowing through a partial outage
        instead of shedding at the sick node's door."""
        with self._lock:
            address = self.ring.get_at(point)
            # a routed member outside the key's shard group means its
            # range spilled — whole group empty at the primary hop, or
            # a failover walk that ran past the group's live members —
            # loud either way: these keys merge on instances that don't
            # serve their device-shard range
            self._note_group_spill(point, address)
            dest = self._pool.get(address)
            # likely_dispatchable: lock-free in the common healthy case
            # — this runs per routed metric, and send() re-checks the
            # breaker authoritatively anyway
            if (dest is not None and not dest.closed.is_set()
                    and dest.breaker.likely_dispatchable):
                return dest
            now = time.monotonic()
            cached = self._failover_cache.get(point)
            if cached is not None and now - cached[1] < 1.0:
                alt = self._pool.get(cached[0])
                if (alt is not None and not alt.closed.is_set()
                        and alt.breaker.likely_dispatchable):
                    self.failover_routed_total += 1
                    self._note_group_spill(point, cached[0])
                    return alt
            for candidate in self.ring.walk_at(
                    point, self._failover_walk + 1)[1:]:
                alt = self._pool.get(candidate)
                if (alt is not None and not alt.closed.is_set()
                        and alt.breaker.likely_dispatchable):
                    self.failover_routed_total += 1
                    self._note_group_spill(point, candidate)
                    if len(self._failover_cache) > 100_000:
                        self._failover_cache.clear()
                    self._failover_cache[point] = (candidate, now)
                    return alt
            # every walked member is sick: keep the primary's accounting
            # (its send() sheds and counts) rather than inventing a drop
            if dest is None:
                raise EmptyRingError(f"no destination for {address}")
            return dest

    def size(self) -> int:
        with self._lock:
            return len(self._pool)

    def flow_totals(self) -> Dict[str, float]:
        """Pool-wide cumulative flow counters (live + retired) plus the
        live queue depth — the proxy ledger's probe/stock source. The
        retired folds make every figure monotonic across ring churn,
        which is what lets the ledger treat them as counters."""
        with self._lock:
            pool = list(self._pool.values())
            out = {
                "enqueued": float(self.retired_enqueued_total),
                "sent": float(self.retired_sent_total),
                "dropped_enqueued":
                    float(self.retired_dropped_enqueued_total),
                "queued": float(self.retired_inflight),
            }
        for dest in pool:
            # one lock hold per destination: the sender clears its
            # in-flight stock under the same lock it credits sent/
            # dropped, so this read can't see a batch on both sides
            with dest._counter_lock:
                out["enqueued"] += dest.enqueued_total
                out["sent"] += dest.sent_total
                out["dropped_enqueued"] += dest.dropped_enqueued_total
                # _qsize: the queue's unlocked size (its lock is held)
                out["queued"] += dest._queue._qsize() + dest.inflight_batch
        return out

    def telemetry_rows(self) -> List[tuple]:
        """(name, kind, value, tags) rows for the proxy's /metrics
        registry: per-destination send/drop/shed totals, queue depth,
        and breaker state."""
        with self._lock:
            pool = list(self._pool.values())
            failover = self.failover_routed_total
            retired = (self.retired_sent_total, self.retired_dropped_total,
                       self.retired_shed_open_total,
                       self.retired_enqueued_total,
                       self.retired_dropped_enqueued_total,
                       self.retired_hedge_fired_total,
                       self.retired_hedge_wins_total)
        rows: List[tuple] = [
            ("proxy.ring.failover_routed", "counter", float(failover), ()),
            ("proxy.ring.shard_groups", "gauge",
             float(self.shard_groups), ()),
            ("proxy.ring.group_spill", "counter",
             float(self.group_spill_total), ()),
            # churn-proof totals: per-destination rows below reset when a
            # destination is replaced; these fold in the retired ones
            ("proxy.dest.retired_sent", "counter", float(retired[0]), ()),
            ("proxy.dest.retired_dropped", "counter", float(retired[1]), ()),
            ("proxy.dest.retired_shed_open", "counter",
             float(retired[2]), ()),
            ("proxy.dest.retired_enqueued", "counter",
             float(retired[3]), ()),
            ("proxy.dest.retired_dropped_enqueued", "counter",
             float(retired[4]), ()),
            ("proxy.dest.retired_hedge_fired", "counter",
             float(retired[5]), ()),
            ("proxy.dest.retired_hedge_wins", "counter",
             float(retired[6]), ()),
        ]
        for dest in pool:
            tags = [f"destination:{dest.address}"]
            rows.append(("forward.hedge.fired", "counter",
                         float(dest.hedge_fired_total), tags))
            rows.append(("forward.hedge.wins", "counter",
                         float(dest.hedge_wins_total), tags))
            rows.append(("proxy.dest.sent", "counter",
                         float(dest.sent_total), tags))
            rows.append(("proxy.dest.send_seconds", "counter",
                         dest.send_seconds_total, tags))
            rows.append(("proxy.dest.enqueued", "counter",
                         float(dest.enqueued_total), tags))
            rows.append(("proxy.dest.dropped", "counter",
                         float(dest.dropped_total), tags))
            rows.append(("proxy.dest.dropped_enqueued", "counter",
                         float(dest.dropped_enqueued_total), tags))
            rows.append(("proxy.dest.shed_open", "counter",
                         float(dest.shed_open_total), tags))
            rows.append(("proxy.dest.queue_depth", "gauge",
                         float(dest._queue.qsize()), tags))
            rows.append(("proxy.dest.forwarded_keys", "gauge",
                         dest.key_hll.estimate(), tags))
            rows.append(("resilience.breaker_state", "gauge",
                         float(dest.breaker.state_code), tags))
        return rows

    def clear(self) -> None:
        with self._lock:
            for address in list(self._pool):
                self._remove_locked(address)

    def flush_wait(self, timeout: float = 5.0) -> None:
        """Best-effort wait until queued metrics drain (for tests and
        graceful shutdown)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            pool = list(self._pool.values())
        for dest in pool:
            while (not dest._queue.empty()
                   and time.monotonic() < deadline):
                time.sleep(0.01)
